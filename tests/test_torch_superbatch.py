"""The port's superbatch on the CPU: ``step_many`` is bitwise K sequential
``step`` calls (dense, ragged stacked and grouped, host-hashed, logistic),
agrees with the JAX package's ``step_many``, its group wire is the JAX
package's buffer byte for byte, and the app at ``--superBatch`` prints the
plain run's lines and the JAX app's. The ``SuperBatcher`` cases of
tests/test_superbatch.py: pinned buckets, mixed shapes, the partial tail,
the checkpoint cadence across group boundaries, refunds.

Tolerances: bitwise wherever the port is held against itself; against the
JAX learner, weights and predictions within rtol/atol 2e-3 (the port's
fused route stores X in bf16) and the counts exactly; group buffers and
layouts exactly."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features.batch import pack_ragged_group as jax_pack_ragged_group
from twtml_tpu.features.batch import stack_batches as jax_stack_batches
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from tools.bench_suite import _status_json

from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.apps.common import SuperBatcher
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import assemble, native
from twtml_tpu_torch.features.batch import (
    PackedBatch,
    pack_batch,
    pack_ragged_group,
    stack_batches,
    unpack_batch,
)
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import modelwatch

NOW_MS = 1_785_320_000_000
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]
TOL = 2e-3


def tweets(n, seed=3, cls=SyntheticSource):
    return list(cls(total=n, seed=seed, base_ms=NOW_MS).produce())


def batches(kind, n=4, rows=32, seed=3):
    """``n`` host batches of ``rows`` synthetic tweets on one wire."""
    f = Featurizer(now_ms=NOW_MS, num_retweet_begin=0)
    chunks = [tweets(n * rows, seed)[i * rows:(i + 1) * rows] for i in range(n)]
    if kind == "ragged":
        return [f.featurize_batch_ragged(c, row_bucket=rows) for c in chunks]
    if kind == "hashed":
        return [f.featurize_batch(c, row_bucket=rows, token_bucket=128) for c in chunks]
    return [f.featurize_batch_units(c, row_bucket=rows, unit_bucket=128) for c in chunks]


def wire(kind, bs):
    return pack_ragged_group(bs) if kind == "group" else stack_batches(bs)


def assert_bitwise_k_steps(make_model, bs, group):
    seq = make_model()
    outs = [seq.step(pack_batch(b) if group == "group" else b) for b in bs]
    sup = make_model()
    many = sup.step_many(wire(group, bs))
    np.testing.assert_array_equal(sup.latest_weights, seq.latest_weights)
    for k, out in enumerate(outs):
        for field in ("count", "mse", "real_stdev", "pred_stdev"):
            assert float(getattr(many, field)[k]) == float(getattr(out, field))
        assert torch.equal(many.predictions[k], out.predictions)
        assert torch.equal(many.quality[k], out.quality)
    return sup, many


CASES = [("dense", "stacked"), ("ragged", "stacked"), ("ragged", "group"),
         ("hashed", "stacked")]


@pytest.mark.parametrize("kind,group", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("learner", [StreamingLinearRegressionWithSGD,
                                     StreamingLogisticRegressionWithSGD],
                         ids=["linear", "logistic"])
def test_step_many_is_bitwise_k_steps(kind, group, learner):
    bs = batches(kind)
    assert_bitwise_k_steps(lambda: learner(device="cpu", quality=True, num_iterations=10),
                           bs, group)


def test_step_many_on_the_torch_loop_is_bitwise_k_steps():
    bs = batches("dense")
    assert_bitwise_k_steps(
        lambda: StreamingLinearRegressionWithSGD(device="cpu", quality=True,
                                                 mini_batch_fraction=0.5, num_iterations=10),
        bs, "stacked")


def test_step_many_chains_across_calls():
    bs = batches("ragged", n=4)
    seq = StreamingLinearRegressionWithSGD(device="cpu")
    for b in bs:
        seq.step(b)
    sup = StreamingLinearRegressionWithSGD(device="cpu")
    sup.step_many(pack_ragged_group(bs[:2]))
    sup.step_many(pack_ragged_group(bs[2:]))
    np.testing.assert_array_equal(sup.latest_weights, seq.latest_weights)


def test_group_outputs_fetch_as_one_vector():
    model = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    bs = batches("ragged")
    many = model.step_many(pack_ragged_group(bs))
    host = model.fetch_output(many).result()
    for field in ("predictions", "count", "mse", "real_stdev", "pred_stdev", "quality"):
        np.testing.assert_array_equal(getattr(host, field), getattr(many, field).numpy())


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_step_many_agrees_with_the_jax_packages(kind):
    rows, n = 32, 4
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    ours, ref = tweets(n * rows), tweets(n * rows, cls=JaxSynthetic)
    method = "featurize_batch_ragged" if kind == "ragged" else "featurize_batch_units"
    kw = {} if kind == "ragged" else {"unit_bucket": 128}
    bs = [getattr(f, method)(ours[i * rows:(i + 1) * rows], row_bucket=rows, **kw)
          for i in range(n)]
    jbs = [getattr(jf, method)(ref[i * rows:(i + 1) * rows], row_bucket=rows, **kw)
           for i in range(n)]
    port = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    jax_model = JaxLinear(quality=True)
    many = port.step_many(stack_batches(bs))
    jmany = jax_model.step_many(jax_stack_batches(jbs))
    np.testing.assert_allclose(port.latest_weights, np.asarray(jax_model.latest_weights),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(many.count.numpy(), np.asarray(jmany.count))
    np.testing.assert_allclose(many.predictions.numpy(), np.asarray(jmany.predictions),
                               rtol=TOL, atol=1.0)  # HALF_UP-rounded predictions
    np.testing.assert_allclose(many.mse.numpy(), np.asarray(jmany.mse), rtol=TOL)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("mode", ["on", "off"], ids=["native", "numpy"])
def test_group_buffer_is_the_jax_packages(k, mode):
    rows = 16
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    ours, ref = tweets(k * rows, seed=k), tweets(k * rows, seed=k, cls=JaxSynthetic)
    bs = [f.featurize_batch_ragged(ours[i * rows:(i + 1) * rows], row_bucket=rows)
          for i in range(k)]
    jbs = [jf.featurize_batch_ragged(ref[i * rows:(i + 1) * rows], row_bucket=rows)
           for i in range(k)]
    packs = native.COUNTERS["packs_native"]
    with assemble.forced(mode):
        got = pack_ragged_group(bs)
    assert native.COUNTERS["packs_native"] - packs == (1 if mode == "on" else 0)
    want = jax_pack_ragged_group(jbs)
    assert got.layout == want.layout
    np.testing.assert_array_equal(np.asarray(got.buffer), np.asarray(want.buffer))
    # unpacked on the host and as a tensor: the stacked batch
    stacked = stack_batches(bs)
    for unpacked in (unpack_batch(np.asarray(got.buffer), got.layout),
                     unpack_batch(torch.from_numpy(np.asarray(got.buffer)), got.layout)):
        for field in ("units", "offsets", "numeric", "label", "mask"):
            a, b = getattr(unpacked, field), getattr(stacked, field)
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_array_equal(a.view(b.dtype) if a.dtype != b.dtype else a, b)


def test_group_pack_refuses_mixed_signatures():
    a = batches("ragged", n=1, rows=16)[0]
    b = batches("ragged", n=1, rows=32)[0]
    with pytest.raises(ValueError, match="one wire signature"):
        pack_ragged_group([a, b])
    with pytest.raises(ValueError, match="empty group"):
        pack_ragged_group([])


# ---- the SuperBatcher ----------------------------------------------------------

def collect():
    seen = []

    def handle(out, batch, t, at_boundary=True, stamp=None):
        seen.append((batch.mask.shape[0], float(out.count), at_boundary, stamp))

    return seen, handle


def test_mixed_shape_batches_close_the_group_not_drop():
    small = batches("dense", n=5, rows=16)
    big = batches("dense", n=1, rows=32, seed=8)[0]
    stream = [small[0], small[1], big, small[2], small[3], small[4]]
    model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    seen, handle = collect()
    sb = SuperBatcher(model, 2, handle)
    for i, b in enumerate(stream):
        sb.on_batch(b, float(i))
    sb.flush()
    assert [rows for rows, *_ in seen] == [16, 16, 32, 16, 16, 16]
    ref = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    for b in stream:
        ref.step(b)
    np.testing.assert_array_equal(model.latest_weights, ref.latest_weights)


def test_partial_tail_uses_plain_steps():
    bs = batches("dense", n=3)
    model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    calls = []
    model.step_many = lambda w: calls.append(w)
    seen, handle = collect()
    sb = SuperBatcher(model, 4, handle)
    for i, b in enumerate(bs):
        sb.on_batch(b, float(i))
    sb.flush()
    assert len(seen) == 3 and not calls  # no group ran
    assert all(at for *_, at, _ in seen)
    ref = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    for b in bs:
        ref.step(b)
    np.testing.assert_array_equal(model.latest_weights, ref.latest_weights)


class _NotDoneAtFirst:
    """A host fetch that reports not done the first time it is asked (the
    batcher's early-delivery probe), as a card's would while it runs."""

    def __init__(self, inner):
        self.inner, self.asked = inner, False

    def done(self):
        asked, self.asked = self.asked, True
        return asked

    def wait(self):
        pass

    def result(self):
        return self.inner.result()


def test_boundary_cadence_immune_to_refunds():
    """Refunds move only the cap: with a cadence of 4 over groups of 2, the
    drains land after batches 4 and 8 all the same."""
    bs = batches("dense", n=8)
    model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    fetch = model.fetch_output
    model.fetch_output = lambda out: _NotDoneAtFirst(fetch(out))
    seen, handle = collect()
    sb = SuperBatcher(model, 2, handle, boundary_every=4, fetch_depth=8)
    for i, b in enumerate(bs):
        sb.on_batch(b, 0.0)
        if i == 1:
            sb.refund_dispatch()
            sb.refund_dispatch()
    sb.flush()
    assert [at for *_, at, _ in seen] == [False, False, False, True,
                                          False, False, False, True]


def test_stamps_share_the_group(monkeypatch):
    bs = batches("ragged", n=4)
    model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=5)
    seen, handle = collect()
    sb = SuperBatcher(model, 4, handle, wire_pack="group", stamp=lambda: {"featurize_ms": 1.0})
    for b in bs:
        sb.on_batch(b, 0.0)
    sb.flush()
    stamps = [s for *_, s in seen]
    assert all(s["group"] == 4 and s["featurize_ms"] == 1.0 for s in stamps)
    assert all(s["step_ms"] >= 0 and s["fetch_wait_ms"] >= 0 for s in stamps)
    assert len({s["wire_bytes"] for s in stamps}) == 1


# ---- the app -------------------------------------------------------------------

def corpus(path, total, seed=9):
    with open(path, "w") as fh:
        for s in tweets(total, seed, cls=JaxSynthetic):
            fh.write(json.dumps(_status_json(s)) + "\n")


def run_port(path, extra, module=app, max_batches=0):
    # a fresh model watch, as a new process starts with: its tracks outlive
    # a run, and an alert held over from an earlier test in this process
    # forces a checkpoint off the cadence a test holds
    modelwatch.reset_for_tests()
    out = io.StringIO()
    argv = ["--backend", "cpu", "--source", "replay", "--replayFile", str(path),
            "--seconds", "0", "--batchBucket", "16", "--tokenBucket", "64", *QUIET, *extra]
    with contextlib.redirect_stdout(out):
        totals = module.run(ConfArguments().parse(argv), max_batches=max_batches)
    return totals, [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]


def test_app_superbatch_prints_the_plain_runs_lines_and_the_jax_apps(tmp_path, monkeypatch,
                                                                     capsys):
    """7 batches at --superBatch 4 (one group, a 3-batch tail) on both
    wires and both group wires: the plain run's lines, weights and totals,
    and the JAX app's lines at the same flags."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = tmp_path / "tweets.jsonl"
    corpus(path, 7 * 16)
    plain_totals, plain = run_port(path, [])
    assert len(plain) == 7
    for extra in (["--superBatch", "4"], ["--superBatch", "4", "--wirePack", "group"],
                  ["--superBatch", "4", "--wire", "padded"]):
        totals, lines = run_port(path, extra)
        assert lines == plain, extra
        assert (totals["count"], totals["batches"]) == (plain_totals["count"], 7)
    jax.devices()
    capsys.readouterr()
    jax_app.run(JaxConf().parse([
        "--source", "replay", "--replayFile", str(path), "--seconds", "0",
        "--batchBucket", "16", "--tokenBucket", "64", "--master", "local[1]",
        "--superBatch", "4", "--wirePack", "group", *QUIET]))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert jax_lines == plain


def test_logistic_app_superbatch_prints_the_plain_runs_lines(tmp_path, monkeypatch):
    from twtml_tpu_torch.apps import logistic_regression

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = tmp_path / "tweets.jsonl"
    corpus(path, 6 * 16)
    _, plain = run_port(path, [], logistic_regression)
    _, grouped = run_port(path, ["--superBatch", "3", "--wirePack", "group"],
                          logistic_regression)
    assert grouped == plain and len(plain) == 6


def test_superbatch_requires_pinned_buckets(tmp_path):
    path = tmp_path / "tweets.jsonl"
    path.write_text("")
    conf = ConfArguments().parse(["--backend", "cpu", "--source", "replay", "--replayFile",
                                  str(path), "--seconds", "0", "--superBatch", "4", *QUIET])
    with pytest.raises(ValueError, match="superBatch needs pinned shapes"):
        app.run(conf)


def test_superbatch_is_ignored_under_a_wall_clock(caplog):
    from twtml_tpu_torch.apps.common import super_batch_k

    conf = ConfArguments().parse(["--seconds", "1", "--superBatch", "4"])
    stream = type("S", (), {"row_bucket": 16, "token_bucket": 64})()
    assert super_batch_k(conf, stream) == 1
    assert "ignored" in caplog.text


def test_checkpoint_cadence_crosses_group_boundaries(tmp_path, monkeypatch):
    """8 batches in groups of 3 with a checkpoint every 2: saves at the
    first boundary past each cadence point (3, 6) and the final 8."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = tmp_path / "tweets.jsonl"
    corpus(path, 8 * 16)
    ckdir = tmp_path / "ck"
    saved = []
    real_save = Checkpointer.save

    def save(self, step, *a, **k):
        saved.append(step)
        return real_save(self, step, *a, **k)

    monkeypatch.setattr(Checkpointer, "save", save)
    totals, lines = run_port(path, ["--superBatch", "3", "--checkpointDir", str(ckdir),
                                    "--checkpointEvery", "2"])
    assert totals["batches"] == 8 and len(lines) == 8
    assert saved == [3, 6, 8]
    _, meta = Checkpointer(str(ckdir)).restore()
    assert meta["batches"] == 8


def test_warmup_steps_a_padding_group(monkeypatch):
    """With --superBatch the warm-up also runs one all-padding group
    through step_many (on the group wire when it is the stream's), which
    trains nothing."""
    from twtml_tpu_torch.apps.common import warmup_compile
    from twtml_tpu_torch.streaming.context import FeatureStream

    model = StreamingLinearRegressionWithSGD(device="cpu")
    model.set_initial_weights(np.linspace(-1, 1, 1004, dtype=np.float32))
    before = model.latest_weights
    wires = []
    real = model.step_many

    def step_many(w):
        wires.append(w)
        return real(w)

    model.step_many = step_many
    stream = FeatureStream(Featurizer(now_ms=NOW_MS), row_bucket=16, token_bucket=64,
                           ragged=True)
    warmup_compile(stream, model, super_batch=4, group_wire=pack_ragged_group)
    assert len(wires) == 1 and isinstance(wires[0], PackedBatch)
    assert wires[0].layout[0] == "RaggedGroupSegments" and wires[0].layout[2][2] == 4
    np.testing.assert_array_equal(model.latest_weights, before)


@pytest.mark.parametrize("every", [1, 4])
def test_poisoned_superbatch_run_equals_the_clean_run(tmp_path, monkeypatch, every):
    """The runtime guards per batch of a group: batch 7 of 8 poisoned
    (``source.nan@7``: every 7th featurize call, and the replay's 4 calls
    are the 9th-12th) at --superBatch 4 on the group wire, with a
    checkpoint every ``every`` batches. The sentinel rolls back once, the
    group's later batches drain as tainted skips, the journal replays the
    rows after the checkpoint (at the group boundary, batch 4), so batches
    5-6, delivered before the poison showed, print again as the replay
    trains them: the clean run's lines 1-6 then 5-8, the clean run's
    totals and weights, bitwise; every lineage record is delivered."""
    from twtml_tpu_torch.streaming import faults
    from twtml_tpu_torch.telemetry import lineage
    from twtml_tpu_torch.telemetry import metrics as _metrics

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = tmp_path / "tweets.jsonl"
    corpus(path, 8 * 16, seed=51)
    group = ["--superBatch", "4", "--wirePack", "group", "--checkpointEvery", str(every)]
    lineage.reset_for_tests()
    _metrics.reset_for_tests()
    try:
        totals, lines = run_port(path, [*group, "--checkpointDir", str(tmp_path / "poisoned"),
                                        "--chaos", "source.nan@7"])
        reg = _metrics.get_registry()
        assert reg.counter("model.rollbacks").snapshot() == 1
        assert reg.counter("model.rows_lost").snapshot() == 0
        assert lineage.depths() == (0, 0)
    finally:
        faults.uninstall_chaos()
    clean_totals, clean_lines = run_port(path, [*group, "--checkpointDir",
                                                str(tmp_path / "clean")])
    assert len(clean_lines) == 8 and lines == clean_lines[:6] + clean_lines[4:]
    assert (totals["count"], totals["batches"]) == (clean_totals["count"], 8)
    w_p, _ = Checkpointer(str(tmp_path / "poisoned")).restore()
    w_c, _ = Checkpointer(str(tmp_path / "clean")).restore()
    np.testing.assert_array_equal(w_p, w_c)
