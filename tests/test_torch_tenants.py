"""The port's tenant plane (``twtml_tpu_torch/parallel/tenants.py``,
``--tenants M``) on the CPU, where B1's plain twin stands in for the card,
held against itself and against the JAX package's (tests/test_tenants.py
is the oracle).

- Routing: route keys, ``tenant_rows`` and the split parts are byte-equal
  to the JAX functions' (hash and lang keys; the ragged, padded and
  host-hashed wires), and so are the stacked and group tenant wires.
- M = 1 is bitwise the plain port learner; at M > 1 each tenant is bitwise
  a standalone port learner on its routed rows (per-tenant step sizes and
  L2s, the logistic residual, a dry tenant, 2^18 dims). Against the JAX
  ``TenantStackModel``: weights and predictions within rtol/atol 2e-3
  (tests/test_torch_step.py's tolerance: the port's fused route stores X
  in bf16), counts exact.
- Aggregation, checkpoints (a JAX-written stack too), the app (one fetch a
  tick, the JAX app's lines, the forced M = 1 plane, the sentinel's
  rollback of the stack), the flags and the refusals.

Every wait is bounded, and each test runs under a time limit of its own.
"""

import contextlib
import dataclasses
import faulthandler
import io
import json
import time

import numpy as np
import pytest
import torch

from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features import batch as jax_batch
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel.tenants import TenantStackModel as JaxStack
from twtml_tpu.parallel.tenants import aggregate_tenant_output as jax_aggregate
from twtml_tpu.streaming import faults as jax_faults
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.telemetry import lineage as jax_lineage
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry import modelwatch as jax_modelwatch
from twtml_tpu.telemetry import tenants as jax_tenants
from tools.bench_suite import _status_json

from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.apps import logistic_regression as logistic_app
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.convert import weights_from_jax, weights_to_numpy
from twtml_tpu_torch.features import batch as port_batch
from twtml_tpu_torch.features.batch import PackedBatch, RaggedUnitBatch
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD as Linear
from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD as Logistic
from twtml_tpu_torch.parallel import tenants as port_tenants
from twtml_tpu_torch.parallel.tenants import (
    MultiHostTenantModel,
    TenantStackModel,
    aggregate_tenant_output,
    split_tenant_output,
)
from twtml_tpu_torch.streaming import faults
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import lineage, modelwatch
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.telemetry import tenants as _tenants
from twtml_tpu_torch.telemetry.session_stats import SessionStats

NOW_MS = 1785320000000
CLOSED = "http://127.0.0.1:9"
TOL = 2e-3
LIMIT_S = 150.0
STATS = ("count", "mse", "real_stdev", "pred_stdev")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: a test past it fails, and a hang prints every
    thread's stack."""
    faulthandler.dump_traceback_later(LIMIT_S, exit=False)
    t0 = time.monotonic()
    yield
    faulthandler.cancel_dump_traceback_later()
    assert time.monotonic() - t0 < LIMIT_S, f"the test outlived its {LIMIT_S:.0f} s limit"


@pytest.fixture(autouse=True)
def _clean():
    """Fresh registries, tenant views, model watches and lineage FIFOs (an
    app run in this worker may have left records: ROADMAP C5)."""
    def reset():
        for mod in (_metrics, jax_metrics, _tenants, jax_tenants, modelwatch,
                    jax_modelwatch, lineage, jax_lineage):
            mod.reset_for_tests()
        faults.uninstall_chaos()
        jax_faults.uninstall_chaos()

    reset()
    yield
    reset()


# ---- inputs ------------------------------------------------------------------

def _statuses(n, seed, cls, unicode_mix):
    sts = list(cls(total=n, seed=seed, base_ms=NOW_MS).produce())
    if unicode_mix:
        for i, s in enumerate(sts):
            if i % 3 == 0:
                o = s.retweeted_status
                sts[i] = dataclasses.replace(s, retweeted_status=dataclasses.replace(
                    o, text=o.text + (" café 中文" if i % 2 else " привет")))
    return sts


def batches(kind="ragged", n=2, rows=64, seed=3, unicode_mix=True, jax=False):
    """``n`` host batches of ``rows`` synthetic tweets on one wire, for the
    port (or with ``jax`` the same tweets for the JAX package)."""
    feat = (JaxFeaturizer if jax else Featurizer)(now_ms=NOW_MS)
    sts = _statuses(n * rows, seed, JaxSynthetic if jax else SyntheticSource, unicode_mix)
    chunks = [sts[i * rows:(i + 1) * rows] for i in range(n)]
    if kind == "ragged":
        return [feat.featurize_batch_ragged(c, row_bucket=rows, pre_filtered=True)
                for c in chunks]
    if kind == "padded":
        return [feat.featurize_batch_units(c, row_bucket=rows, unit_bucket=128)
                for c in chunks]
    return [feat.featurize_batch(c, row_bucket=rows, token_bucket=128) for c in chunks]


def fields(b):
    if isinstance(b, (RaggedUnitBatch, jax_batch.RaggedUnitBatch)):
        return [b.units, b.offsets, b.numeric, b.label, b.mask]
    return list(b)


def assert_same_bytes(ours, theirs):
    for a, b in zip(fields(ours), fields(theirs), strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(ours, RaggedUnitBatch):
        assert ours.row_len == theirs.row_len


def stack(m=4, **kw):
    kw.setdefault("device", "cpu")
    return TenantStackModel(m, **kw)


def assert_bitwise(out, ref, m):
    """Tenant m of a stacked device output against a standalone step's."""
    for f in STATS:
        assert float(getattr(out, f)[m]) == float(getattr(ref, f)), f
    assert torch.equal(out.predictions[m], ref.predictions)


def assert_close_to_jax(port_stack, jax_stack, outs, jax_outs):
    np.testing.assert_allclose(port_stack.latest_weights, np.asarray(jax_stack.latest_weights),
                               rtol=TOL, atol=TOL)
    for out, jout in zip(outs, jax_outs):
        np.testing.assert_array_equal(out.count.numpy(), np.asarray(jout.count))
        np.testing.assert_allclose(out.predictions.numpy(), np.asarray(jout.predictions),
                                   rtol=TOL, atol=TOL)


# ---- routing -------------------------------------------------------------------

ROUTES = [("ragged", "hash"), ("ragged", "lang"), ("padded", "hash"), ("padded", "lang"),
          ("hashed", "hash")]


@pytest.mark.parametrize("kind,mode", ROUTES, ids=["-".join(r) for r in ROUTES])
def test_route_keys_rows_and_parts_are_the_jax_packages(kind, mode):
    m = 4
    for ours, theirs in zip(batches(kind), batches(kind, jax=True)):
        ids = port_batch.tenant_route_keys(ours, m, mode)
        jids = jax_batch.tenant_route_keys(theirs, m, mode)
        assert ids.dtype == jids.dtype and ids.tobytes() == jids.tobytes()
        assert ids.min() >= 0 and ids.max() < m
        rows = port_batch.tenant_rows(ours, ids, m)
        for r, jr in zip(rows, jax_batch.tenant_rows(theirs, jids, m), strict=True):
            assert r.tobytes() == jr.tobytes()
        parts = port_batch.split_batch_tenants(ours, ids, m)
        jparts = jax_batch.split_batch_tenants(theirs, jids, m)
        for p, jp in zip(parts, jparts, strict=True):
            assert_same_bytes(p, jp)
        valid = int(np.asarray(ours.mask).sum())
        assert sum(int(p.mask.sum()) for p in parts) == valid
    if mode == "lang":
        assert len(set(ids[np.asarray(ours.mask) > 0].tolist())) > 1


def test_lang_key_refuses_a_host_hashed_batch():
    fb, = batches("hashed", n=1)
    jfb, = batches("hashed", n=1, jax=True)
    for fn, b in ((port_batch.tenant_route_keys, fb), (jax_batch.tenant_route_keys, jfb)):
        with pytest.raises(ValueError, match="lang"):
            fn(b, 4, "lang")


def test_a_dry_tenants_part_is_all_padding_and_tenant_0_gets_the_batch_back():
    rb, = batches(n=1)
    parts = port_batch.split_batch_tenants(rb, np.zeros(rb.mask.shape[0], np.int32), 3)
    for p in parts[1:]:
        assert int(p.mask.sum()) == 0 and int(p.offsets[-1]) == 0
    assert_same_bytes(parts[0], rb)


@pytest.mark.parametrize("wire_pack", ["stacked", "group"])
def test_tenant_wires_are_the_jax_packages(wire_pack):
    rb, = batches(n=1)
    jrb, = batches(n=1, jax=True)
    wire = stack(4, wire_pack=wire_pack).prepare_wire(rb)
    jwire = JaxStack(4, wire_pack=wire_pack).prepare_wire(jrb)
    if wire_pack == "group":
        assert isinstance(wire, PackedBatch)
        assert wire.layout == jwire.layout
        assert np.asarray(wire.buffer).tobytes() == np.asarray(jwire.buffer).tobytes()
    else:
        assert_same_bytes(wire, jwire)


def test_the_coded_tenant_group_wire_is_the_jax_packages():
    """``--wireCodec dict`` on the group tenant wire: each tenant segment
    digram-coded in one shared bucket, bytes and layout the JAX package's,
    and the tick bitwise the raw wire's."""
    rb, = batches(n=1, unicode_mix=False)
    jrb, = batches(n=1, jax=True, unicode_mix=False)
    coded = stack(4, wire_pack="group", wire_codec="dict")
    wire = coded.prepare_wire(rb)
    jwire = JaxStack(4, wire_pack="group", wire_codec="dict").prepare_wire(jrb)
    assert wire.layout == jwire.layout and wire.layout[2][4][0] == "dict"
    assert np.asarray(wire.buffer).tobytes() == np.asarray(jwire.buffer).tobytes()
    raw = stack(4, wire_pack="group")
    outs = [m.fetch_output(m.step(w)) for m, w in ((raw, raw.prepare_wire(rb)), (coded, wire))]
    for pending in outs:
        pending.wait()
    for f, g in zip(outs[0].result(), outs[1].result()):
        if f is not None:
            np.testing.assert_array_equal(np.asarray(f), np.asarray(g))
    np.testing.assert_array_equal(raw.latest_weights, coded.latest_weights)


# ---- the stack's steps ----------------------------------------------------------

@pytest.mark.parametrize("kind,wire_pack", [("ragged", "stacked"), ("ragged", "group"),
                                            ("padded", "stacked")])
def test_m1_is_bitwise_the_plain_learner(kind, wire_pack):
    single = Linear(device="cpu", quality=True)
    mt = stack(1, step_size=single.default_step_size, wire_pack=wire_pack, quality=True)
    for b in batches(kind):
        ref, out = single.step(b), mt.step(b)
        assert_bitwise(out, ref, 0)
        assert torch.equal(out.quality[0], ref.quality)
    assert single.latest_weights.tobytes() == mt.latest_weights[0].tobytes()


@pytest.mark.parametrize("wire_pack", ["stacked", "group"])
def test_m4_each_tenant_is_bitwise_a_standalone_learner_and_near_the_jax_stack(wire_pack):
    m = 4
    mt = stack(m, step_size=0.1, wire_pack=wire_pack)
    singles = [Linear(step_size=0.1, device="cpu") for _ in range(m)]
    jmt = JaxStack(m, step_size=0.1, wire_pack=wire_pack)
    outs, jouts = [], []
    for rb, jrb in zip(batches(), batches(jax=True)):
        out = mt.step(rb)
        for i, part in enumerate(mt.split(rb)):
            assert_bitwise(out, singles[i].step(part), i)
        outs.append(out)
        jouts.append(jmt.step(jrb))
    for i in range(m):
        assert singles[i].latest_weights.tobytes() == mt.latest_weights[i].tobytes()
    assert_close_to_jax(mt, jmt, outs, jouts)


def test_per_tenant_hyperparams_match_standalone_learners_and_the_jax_stack():
    """Batches of 256 rows, the oracle's (tests/test_tenants.py): at step
    0.4 a part of ~16 rows drives the learner itself, standalone in either
    package, past 2e-3 between the packages (bf16 X's last bits grow)."""
    sizes, l2s = (0.05, 0.1, 0.2, 0.4), (0.0, 0.01, 0.1, 0.0)
    mt = stack(4, step_sizes=sizes, l2_regs=l2s)
    singles = [Linear(step_size=s, l2_reg=l, device="cpu") for s, l in zip(sizes, l2s)]
    jmt = JaxStack(4, step_sizes=list(sizes), l2_regs=list(l2s))
    outs, jouts = [], []
    for rb, jrb in zip(batches(rows=256), batches(rows=256, jax=True)):
        out = mt.step(rb)
        for i, part in enumerate(mt.split(rb)):
            assert_bitwise(out, singles[i].step(part), i)
        outs.append(out)
        jouts.append(jmt.step(jrb))
    for i in range(4):
        assert singles[i].latest_weights.tobytes() == mt.latest_weights[i].tobytes()
    assert_close_to_jax(mt, jmt, outs, jouts)
    # tenants with equal hyperparameters share one step; these do not
    assert len({id(s) for s in mt._steps}) == 4
    with pytest.raises(ValueError, match="per-tenant"):
        stack(4, step_sizes=[0.1, 0.2])


def test_logistic_residual_rides_the_stack():
    m = 2
    mt = stack(m, step_size=Logistic.default_step_size, residual_fn=Logistic.residual_fn,
               prediction_fn=Logistic.prediction_fn,
               round_predictions=Logistic.round_predictions)
    singles = [Logistic(device="cpu") for _ in range(m)]
    jmt = JaxStack(m, step_size=JaxLogistic.default_step_size,
                   residual_fn=JaxLogistic.residual_fn, prediction_fn=JaxLogistic.prediction_fn,
                   round_predictions=JaxLogistic.round_predictions)
    rb, = batches(n=1)
    jrb, = batches(n=1, jax=True)
    out = mt.step(rb)
    for i, part in enumerate(mt.split(rb)):
        assert_bitwise(out, singles[i].step(part), i)
        assert singles[i].latest_weights.tobytes() == mt.latest_weights[i].tobytes()
    assert_close_to_jax(mt, jmt, [out], [jmt.step(jrb)])


def test_dry_tenant_stats_stay_finite_and_weights_frozen():
    mt = stack(4)
    rb, = batches(n=1)
    wire = mt.prepare_wire_from_parts(
        port_batch.split_batch_tenants(rb, np.zeros(rb.mask.shape[0], np.int32), 4))
    out = mt.step(wire)
    for f in STATS:
        assert torch.isfinite(getattr(out, f)).all(), f
    assert out.count[1:].tolist() == [0.0, 0.0, 0.0]
    w = mt.latest_weights
    assert not w[1:].any() and w[0].any()


def test_m2_at_2_18_dims_matches_standalone_learners():
    f = 2 ** 18
    m = 2
    mt = stack(m, num_text_features=f, step_size=0.005, l2_reg=0.1, quality=True)
    singles = [Linear(num_text_features=f, step_size=0.005, l2_reg=0.1, device="cpu",
                      quality=True) for _ in range(m)]
    assert mt.route == singles[0].route == "gram"
    feat = Featurizer(num_text_features=f, now_ms=NOW_MS)
    sts = _statuses(64, 5, SyntheticSource, False)
    for i in range(2):
        rb = feat.featurize_batch_ragged(sts[i * 32:(i + 1) * 32], row_bucket=32,
                                         pre_filtered=True)
        out = mt.step(rb)
        for k, part in enumerate(mt.split(rb)):
            ref = singles[k].step(part)
            assert_bitwise(out, ref, k)
            assert torch.equal(out.quality[k], ref.quality)
    for k in range(m):
        assert singles[k].latest_weights.tobytes() == mt.latest_weights[k].tobytes()


# ---- aggregation ----------------------------------------------------------------

def host_out(mt, rb):
    return mt.fetch_output(mt.step(rb)).result()


def test_aggregate_m4_exact_counts_mse_and_original_order_equal_to_the_jax_rule():
    mt = stack(4)
    jmt = JaxStack(4)
    rb, = batches(n=1)
    jrb, = batches(n=1, jax=True)
    out = host_out(mt, rb)
    agg = aggregate_tenant_output(out, rb, mt)
    jagg = jax_aggregate(out, jrb, jmt)  # the JAX rule on the same host arrays
    for f in ("predictions",) + STATS:
        assert np.asarray(getattr(agg, f)).tobytes() == np.asarray(getattr(jagg, f)).tobytes()
    counts = np.asarray(out.count, np.float64)
    assert float(agg.count) == counts.sum()
    for i, rows in enumerate(port_batch.tenant_rows(rb, mt.route_ids(rb), 4)):
        np.testing.assert_array_equal(agg.predictions[rows], out.predictions[i][:rows.size])


def test_m1_aggregate_is_a_passthrough():
    mt = stack(1, step_size=Linear.default_step_size, quality=True)
    rb, = batches(n=1)
    ref = Linear(device="cpu", quality=True)
    single = ref.fetch_output(ref.step(rb)).result()
    agg = aggregate_tenant_output(host_out(mt, rb), rb, mt)
    for f in ("predictions", "quality") + STATS:
        assert np.asarray(getattr(agg, f)).tobytes() == np.asarray(getattr(single, f)).tobytes()


def test_a_nonfinite_tenant_poisons_the_aggregate():
    mt = stack(2)
    rb, = batches(n=1)
    out = host_out(mt, rb)
    poisoned = out._replace(mse=np.array([out.mse[0], np.nan], np.float32))
    assert not np.isfinite(float(aggregate_tenant_output(poisoned, rb, mt).mse))


def test_split_tenant_output_views():
    mt = stack(3)
    rb, = batches(n=1)
    out = host_out(mt, rb)
    parts = split_tenant_output(out, 3)
    assert len(parts) == 3
    for i, p in enumerate(parts):
        assert float(p.mse) == float(out.mse[i])
        assert np.shares_memory(p.predictions, out.predictions)


def test_one_fetch_brings_the_whole_tick():
    mt = stack(4, quality=True)
    rb, = batches(n=1)
    dev = mt.step(rb)
    host = mt.fetch_output(dev).result()
    for f in ("predictions", "quality") + STATS:
        np.testing.assert_array_equal(getattr(host, f), getattr(dev, f).numpy())
    assert host.predictions.shape == (4, 64) and host.quality.shape[0] == 4


# ---- state ------------------------------------------------------------------------

def test_checkpoint_round_trip_a_jax_written_stack_and_the_flat_broadcast(tmp_path):
    mt = stack(3)
    for rb in batches():
        mt.step(rb)
    state = mt.latest_weights
    Checkpointer(str(tmp_path / "port")).save(2, state, {"count": 1, "batches": 2})
    restored, _ = JaxCheckpointer(str(tmp_path / "port")).restore()
    assert np.asarray(restored).tobytes() == state.tobytes()
    fresh = stack(3).set_initial_weights(Checkpointer(str(tmp_path / "port")).restore()[0])
    assert fresh.latest_weights.tobytes() == state.tobytes()
    # a JAX --tenants 3 stack restores into the port, bit for bit
    jmt = JaxStack(3)
    for jrb in batches(jax=True):
        jmt.step(jrb)
    jstate = np.asarray(jmt.latest_weights)
    JaxCheckpointer(str(tmp_path / "jax")).save(2, jstate, {"count": 1, "batches": 2})
    port_state, _ = Checkpointer(str(tmp_path / "jax")).restore()
    fresh.set_initial_weights(port_state)
    assert fresh.latest_weights.tobytes() == jstate.tobytes()
    # the sentinel's flat zeros reset every tenant
    fresh.set_initial_weights(np.zeros(state.shape[1], np.float32))
    assert not fresh.latest_weights.any()
    with pytest.raises(ValueError, match="tenants"):
        fresh.set_initial_weights(np.zeros((2, state.shape[1]), np.float32))


def test_convert_moves_a_stack_both_ways():
    jmt = JaxStack(2)
    jmt.step(batches(n=1, jax=True)[0])
    w = weights_from_jax(np.asarray(jmt.latest_weights), device="cpu")
    assert tuple(w.shape) == (2, 1004)
    np.testing.assert_array_equal(weights_to_numpy(w), np.asarray(jmt.latest_weights))
    with pytest.raises(ValueError):
        weights_from_jax(np.zeros((2, 2, 1004), np.float32), device="cpu")


def test_a_stack_is_a_fresh_tensor_each_tick():
    mt = stack(2)
    rb, = batches(n=1)
    before = mt._weights
    snapshot = before.clone()
    mt.step(rb)
    assert mt._weights.data_ptr() != before.data_ptr()
    assert torch.equal(before, snapshot)  # the old stack is never written in place
    assert mt._weights[1].is_contiguous()


# ---- the app ------------------------------------------------------------------------

BASE = ["--source", "replay", "--seconds", "0", "--backend", "cpu", "--batchBucket", "16",
        "--tokenBucket", "64", "--master", "local[1]", "--lightning", CLOSED,
        "--twtweb", CLOSED, "--webTimeout", "0.2"]


def corpus(tmp_path, total=8 * 16, seed=51, two_class=False):
    path = tmp_path / "tweets.jsonl"
    sts = list(JaxSynthetic(total=total, seed=seed, base_ms=NOW_MS).produce())
    if two_class:
        words = ("great", "awful")
        sts = [dataclasses.replace(s, retweeted_status=dataclasses.replace(
            s.retweeted_status, text=f"{s.retweeted_status.text} {words[i % 2]}"))
            for i, s in enumerate(sts)]
    with open(path, "w") as fh:
        for s in sts:
            fh.write(json.dumps(_status_json(s)) + "\n")
    return path


def run_port(argv, module=app, count_fetches=False, monkeypatch=None):
    """An in-process port app run: (totals, printed lines, fetches)."""
    calls = {"n": 0}
    if count_fetches:
        real = port_tenants.fetch_output

        def counting(out):
            calls["n"] += 1
            return real(out)

        monkeypatch.setattr(port_tenants, "fetch_output", counting)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        totals = module.run(ConfArguments().parse(list(argv)))
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("count:")]
    return totals, lines, calls["n"]


def run_jax(argv, capsys, module="linear_regression"):
    import importlib

    jax_app = importlib.import_module(f"twtml_tpu.apps.{module}")
    capsys.readouterr()
    jax_app.run(JaxConf().parse(list(argv)))
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]


def test_app_m8_makes_one_fetch_a_tick_and_conserves_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = corpus(tmp_path)
    totals, lines, fetches = run_port(BASE + ["--replayFile", str(path), "--tenants", "8"],
                                      count_fetches=True, monkeypatch=monkeypatch)
    assert totals["batches"] == 8 and totals["tenants"] == 8 and len(lines) == 8
    assert fetches == 8 + 1  # ONE a tick, plus the pre-stream warm-up's
    view = _tenants.last_tenants()
    assert view is not None and len(view["tenants"]) == 8 and view["ticks"] == 8
    assert sum(t["rows"] for t in view["tenants"]) == totals["count"] == 128
    assert view["gating"] == max(view["tenants"], key=lambda t: t["batch"])["tenant"]
    assert _metrics.get_registry().snapshot()["gauges"]["tenants.configured"] == 8
    assert _metrics.get_registry().counter("fetch.count").snapshot() == 8


APP_CASES = {
    "linear-m4": (["--tenants", "4"], "linear_regression", False),
    "linear-m4-group-wire": (["--tenants", "4", "--wirePack", "group"],
                             "linear_regression", False),
    "linear-m4-padded-wire": (["--tenants", "4", "--wire", "padded"],
                              "linear_regression", False),
    "linear-m4-group-codec": (["--tenants", "4", "--wirePack", "group", "--wireCodec", "dict"],
                              "linear_regression", False),
    "linear-m4-lang-key": (["--tenants", "4", "--tenantKey", "lang"],
                           "linear_regression", False),
    "logistic-m2": (["--tenants", "2"], "logistic_regression", True),
}


@pytest.mark.parametrize("case", list(APP_CASES))
def test_app_prints_the_jax_apps_lines(tmp_path, monkeypatch, capsys, case):
    extra, module, two_class = APP_CASES[case]
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    argv = BASE + ["--replayFile", str(corpus(tmp_path, two_class=two_class))] + extra
    port_module = app if module == "linear_regression" else logistic_app
    totals, lines, _ = run_port(argv, module=port_module)
    port_view = _tenants.last_tenants()
    jax_lines = run_jax(argv, capsys, module)
    assert lines == jax_lines and len(lines) == totals["batches"] == 8
    jview = jax_tenants.last_tenants()
    assert [t["rows"] for t in port_view["tenants"]] == [t["rows"] for t in jview["tenants"]]


def test_app_forced_m1_plane_prints_the_plain_lines_and_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = corpus(tmp_path)

    def run(extra, ck):
        _metrics.reset_for_tests()
        lineage.reset_for_tests()
        return run_port(BASE + ["--replayFile", str(path), "--checkpointDir", str(ck),
                                "--checkpointEvery", "1"] + extra)

    plain, plain_lines, _ = run([], tmp_path / "ck_plain")
    monkeypatch.setenv(common.FORCE_TENANT_PLANE_ENV, "1")
    forced, forced_lines, _ = run(["--tenants", "1"], tmp_path / "ck_m1")
    monkeypatch.delenv(common.FORCE_TENANT_PLANE_ENV)
    assert forced["tenants"] == 1 and plain["batches"] == forced["batches"] == 8
    assert forced_lines == plain_lines
    for a, b in zip(plain["steps"], forced["steps"]):
        assert [a[k] for k in STATS + ("quality",)] == [b[k] for k in STATS + ("quality",)]
    w1, _ = Checkpointer(str(tmp_path / "ck_plain")).restore()
    w2, _ = Checkpointer(str(tmp_path / "ck_m1")).restore()
    assert w2.shape == (1, 1004) and np.asarray(w1).tobytes() == np.asarray(w2)[0].tobytes()


def test_app_m4_sentinel_rolls_back_the_whole_stack(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = corpus(tmp_path)
    argv = BASE + ["--replayFile", str(path), "--tenants", "4", "--checkpointEvery", "1"]
    clean, clean_lines, _ = run_port(argv + ["--checkpointDir", str(tmp_path / "clean")])
    _metrics.reset_for_tests()
    lineage.reset_for_tests()
    try:
        totals, lines, fetches = run_port(
            argv + ["--checkpointDir", str(tmp_path / "ck"), "--chaos", "source.nan@5"],
            count_fetches=True, monkeypatch=monkeypatch)
    finally:
        faults.uninstall_chaos()
    reg = _metrics.get_registry()
    assert reg.counter("model.rollbacks").snapshot() == 1
    assert totals["batches"] == 8 and totals["count"] == 128
    assert reg.counter("model.rows_lost").snapshot() == 0
    assert reg.counter("journal.replayed_rows").snapshot() > 0
    assert fetches == 9 + 1  # 8 + the replayed batch, plus the warm-up
    # the rollback restored all four tenants: the run ends where the clean one does
    assert lines == clean_lines
    w, _ = Checkpointer(str(tmp_path / "ck")).restore()
    w_clean, _ = Checkpointer(str(tmp_path / "clean")).restore()
    assert w.shape == (4, 1004) and np.asarray(w).tobytes() == np.asarray(w_clean).tobytes()


def test_superbatch_is_ignored_with_tenants(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = corpus(tmp_path)
    argv = BASE + ["--replayFile", str(path), "--tenants", "2"]
    _, lines, _ = run_port(argv)
    _metrics.reset_for_tests()
    lineage.reset_for_tests()
    with caplog.at_level("WARNING"):
        _, sb_lines, _ = run_port(argv + ["--superBatch", "4"])
    assert sb_lines == lines
    assert "--superBatch 4 ignored with --tenants 2" in caplog.text


def test_the_tenants_view_is_published(monkeypatch):
    posts = []
    conf = ConfArguments().parse(["--lightning", CLOSED, "--twtweb", CLOSED])
    session = SessionStats(conf)
    monkeypatch.setattr(session.web, "_post", posts.append)
    _tenants.record_tick(np.array([3, 0, 5]), np.array([1.5, np.nan, 2.25]))
    session.publish_metrics()
    view = next(p for p in posts if type(p).__name__ == "Tenants")
    assert view.gating == 2 and view.active == 2
    assert [t["rows"] for t in view.tenants] == [3, 0, 5]
    assert view.tenants[1]["mse"] == -1.0
    jax_tenants.record_tick(np.array([3, 0, 5]), np.array([1.5, np.nan, 2.25]))
    assert jax_tenants.last_tenants() == _tenants.last_tenants()


# ---- flags and refusals ---------------------------------------------------------------

def test_conf_flags():
    conf = ConfArguments().parse(["--tenants", "4", "--tenantKey", "lang", "--abtest", "on"])
    assert (conf.tenants, conf.tenantKey, conf.abtest) == (4, "lang", "on")
    common.select_backend(conf)
    for bad in (["--tenantKey", "bogus"], ["--tenants", "0"]):
        with pytest.raises(SystemExit):
            ConfArguments().parse(bad)
        with pytest.raises((SystemExit, ValueError)):
            JaxConf().parse(bad)


REFUSALS = {
    "vmap": (lambda: stack(2, mapping="vmap"), NotImplementedError,
             "tenant grid dimension.*ROADMAP B10"),
    "mesh": (lambda: stack(2, mesh=object()), NotImplementedError, "ROADMAP A10"),
    "multi_host": (lambda: MultiHostTenantModel(None, None), NotImplementedError,
                   "ROADMAP A10"),
    "coordinator": (lambda: common.build_model(ConfArguments().parse(
        ["--backend", "cpu", "--tenants", "2", "--coordinator", "h:1"])),
        NotImplementedError, "ROADMAP A10"),
    "lang_on_host_hashing": (lambda: common.build_model(ConfArguments().parse(
        ["--backend", "cpu", "--tenants", "2", "--tenantKey", "lang", "--hashOn", "host"])),
        SystemExit, "--hashOn device"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    make, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        make()


def test_the_tenant_plane_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--backend cpu"):
        TenantStackModel(2)
    model = common.build_model(ConfArguments().parse(["--backend", "cpu", "--tenants", "3"]))
    assert isinstance(model, TenantStackModel) and model.device.type == "cpu"
    assert model.num_tenants == 3 and model.route == "fused_dense_sgd"
