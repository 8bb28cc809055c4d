"""The port's serving plane (``twtml_tpu_torch/serving``, ``apps/serve.py``)
against itself and against the JAX package's (``twtml_tpu/serving``), on
the CPU, where the fused kernel's plain twin stands in for the card.

- Served predictions are BITWISE the port train step's pre-update
  predictions (the predict program is the train step at zero iterations).
- Against the JAX ``ServingPlane`` on the same rows and weights: rounded
  predictions equal, raw margins within 2e-3 (tests/test_torch_step.py's
  tolerance: bf16 X and another summation order), for the linear and the
  logistic learner and the 2^18 regime.
- The fused kernel's twin at zero iterations against the Pallas kernel in
  interpret mode (tests/test_torch_fused_sgd.py's tolerance, 2e-3).
- The promotion predicate, checkpoints written by either package, the
  coalescer, the hot swap, the fetch watchdog, a co-located trainer, the
  HTTP front door (statuses and bodies equal to the JAX server's) and the
  serve entry point.

Every wait is bounded (futures, joins, HTTP timeouts), and each test runs
under a time limit of its own (``_time_limit``).
"""

import faulthandler
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.ops import pallas_sgd
from twtml_tpu.serving import is_promotable as jax_is_promotable
from twtml_tpu.serving import load_servable as jax_load_servable
from twtml_tpu.serving.plane import ServingPlane as JaxPlane
from twtml_tpu.serving.snapshot import ServingSnapshot as JaxSnapshot
from twtml_tpu.streaming import faults as jax_faults
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.web.cache import ApiCache as JaxCache
from twtml_tpu.web.server import Server as JaxServer

from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as train_app
from twtml_tpu_torch.apps import serve as serve_app
from twtml_tpu_torch.apps.common import FetchPipeline
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models import sgd as port_sgd
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD as PortLinear
from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD as PortLogistic
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.serving import (
    ServingClient, ServingSnapshot, SnapshotPromoter, is_promotable, load_servable,
)
from twtml_tpu_torch.serving.client import ServingError
from twtml_tpu_torch.serving.engine import PredictEngine
from twtml_tpu_torch.serving.plane import ServingPlane
from twtml_tpu_torch.streaming import faults
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import blackbox
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.web.cache import ApiCache
from twtml_tpu_torch.web.server import Server

NOW_MS = 1785320000000
CLOSED = "http://127.0.0.1:9"  # a closed port: best-effort publishes fail fast
F = 1004
RAW_ATOL = 2e-3
LIMIT_S = 120.0


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
    for m in (_metrics, jax_metrics):
        m.reset_for_tests()
    faults.uninstall_chaos()
    jax_faults.uninstall_chaos()
    yield
    faults.uninstall_chaos()
    jax_faults.uninstall_chaos()
    for m in (_metrics, jax_metrics):
        m.reset_for_tests()


# ---- inputs ---------------------------------------------------------------------

def make_rows(n, seed=3):
    """The JSON request face of ``n`` synthetic originals, creation times
    pinned: one input for both packages."""
    return [{
        "text": s.retweeted_status.text,
        "followers_count": s.retweeted_status.followers_count,
        "favourites_count": s.retweeted_status.favourites_count,
        "friends_count": s.retweeted_status.friends_count,
        "created_at_ms": s.retweeted_status.created_at_ms,
        "retweet_count": s.retweeted_status.retweet_count,
    } for s in SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce()]


def statuses(n, seed=3):
    return ServingPlane.statuses_from_rows(make_rows(n, seed))


def weights(seed=0, width=F, scale=5.0):
    """Weights that give margins of tens: predictions that round to many
    distinct integers."""
    return (np.random.default_rng(seed).standard_normal(width) * scale).astype(np.float32)


def plane(snapshot, **kw):
    kw.setdefault("featurizer", Featurizer(now_ms=NOW_MS, num_text_features=kw.get(
        "num_text_features", 1000)))
    kw.setdefault("batch_rows", 32)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("depth", 4)
    if "engine" not in kw:
        kw.setdefault("device", "cpu")
    return ServingPlane(snapshot, **kw)


def jax_plane(snapshot, **kw):
    kw.setdefault("featurizer", JaxFeaturizer(now_ms=NOW_MS, num_text_features=kw.get(
        "num_text_features", 1000)))
    kw.setdefault("batch_rows", 32)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("depth", 4)
    return JaxPlane(snapshot, **kw)


def serve(p, rows_or_statuses, timeout=60):
    """One request through a started plane: its result dict."""
    return p.submit(rows_or_statuses).result(timeout=timeout)


def train_step_predictions(w, sts, model_cls=PortLinear, num_text_features=1000):
    """The port train step's pre-update predictions of ``sts`` (valid rows)
    from weights ``w``, and the model after the step."""
    batch = Featurizer(now_ms=NOW_MS, num_text_features=num_text_features
                       ).featurize_batch_ragged(sts, row_bucket=32, pre_filtered=True)
    model = model_cls(num_text_features=num_text_features, device="cpu")
    model.set_initial_weights(w)
    out = model.fetch_output(model.step(batch)).result()
    return out.predictions[np.asarray(batch.mask) > 0], model


@pytest.fixture()
def b1_calls(monkeypatch):
    """Calls of the fused kernel's wrapper from the step (its CPU twin
    here; on the card each is one launch)."""
    calls = []
    real = port_sgd.fused_dense_sgd

    def counting(*a, **kw):
        calls.append(kw["num_iterations"])
        return real(*a, **kw)

    monkeypatch.setattr(port_sgd, "fused_dense_sgd", counting)
    return calls


def save(directory, step, w, level=None, finite=True, ckpt=Checkpointer):
    meta = {"count": step * 10, "batches": step}
    if level is not None:
        meta["quality"] = {"level": level, "drift_score": 5.0, "loss_trend": 0.1}
    w = np.array(w, np.float32)
    if not finite:
        w.reshape(-1)[0] = np.nan
    return ckpt(str(directory)).save(step, w, meta)


def test_pre_filtered_featurize_equals_the_jax_featurizers():
    """A request row is scored whatever its retweet count: the serve
    featurize skips the retweet filter, byte-equal to the JAX package's."""
    rows = make_rows(20) + [{"text": "no retweets yet", "created_at_ms": NOW_MS}]
    ours = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        ServingPlane.statuses_from_rows(rows), row_bucket=32, pre_filtered=True)
    theirs = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(
        JaxPlane.statuses_from_rows(rows), row_bucket=32, pre_filtered=True)
    for field in ("units", "offsets", "numeric", "label", "mask"):
        assert np.array_equal(np.asarray(getattr(ours, field)),
                              np.asarray(getattr(theirs, field))), field
    assert ours.row_len == theirs.row_len and ours.mask.sum() == len(rows)
    filtered = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        ServingPlane.statuses_from_rows(rows), row_bucket=32)
    assert filtered.mask.sum() < len(rows)


# ---- the promotion predicate ---------------------------------------------------

METAS = [
    None, "not a dict", {}, {"finite": True}, {"finite": False},
    {"finite": True, "quality": {"level": "ok"}},
    {"finite": True, "quality": {"level": "warn"}},
    {"finite": True, "quality": {"level": "alert", "drift_score": 9.0, "loss_trend": 0.25}},
    {"finite": False, "quality": {"level": "ok"}},
    {"quality": {"level": "unknown"}}, {"quality": {}},
]


@pytest.mark.parametrize("meta", METAS, ids=lambda m: json.dumps(m))
def test_is_promotable_gives_the_jax_packages_verdict(meta):
    assert is_promotable(meta) == jax_is_promotable(meta)


SERVABLE_DIRS = ["ok", "warn", "alert", "unstamped", "quarantined", "missing", "kmeans",
                 "alert_over_ok"]


@pytest.mark.parametrize("kind", SERVABLE_DIRS)
def test_load_servable_gives_the_jax_packages_verdict(tmp_path, kind):
    d = tmp_path / "ck"
    w = np.arange(F, dtype=np.float32)
    if kind in ("ok", "warn", "alert"):
        save(d, 1, w, level=kind)
    elif kind == "unstamped":
        save(d, 2, w)
    elif kind == "quarantined":
        save(d, 1, w, level="ok", finite=False)
    elif kind == "kmeans":
        Checkpointer(str(d)).save(1, {"centers": np.zeros((3, 2)), "weights": np.ones(3)})
    elif kind == "alert_over_ok":  # the newest is refused: no fallback to the older
        save(d, 1, w, level="ok")
        save(d, 2, w, level="alert")
    ours, why = load_servable(str(d))
    theirs, jax_why = jax_load_servable(str(d))
    assert why.replace(str(d), "") == jax_why.replace(str(d), "")
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.step == theirs.step and ours.num_tenants == theirs.num_tenants == 1
        assert ours.quality_level == theirs.quality_level
        assert np.array_equal(ours.weights, theirs.weights)


# ---- parity of the read path -----------------------------------------------------

def test_serve_predictions_bit_equal_train_step(b1_calls):
    """A served prediction is bitwise the train step's pre-update
    prediction of the same row under the same snapshot, and serving leaves
    the snapshot as it is while training moves it."""
    w = weights(1)
    sts = statuses(24, seed=5)
    p = plane(ServingSnapshot(step=3, weights=w, meta={"quality": {"level": "ok"}})).start()
    try:
        res = serve(p, sts)
    finally:
        p.stop()
    got = np.asarray(res["predictions"], np.float32)
    assert res["snapshot_step"] == 3 and len(got) == 24
    assert b1_calls == [0], "one predict-only call of the fused kernel a batch"
    ref, trained = train_step_predictions(w, sts)
    assert np.array_equal(ref, got)
    assert len(set(got.tolist())) > 5  # the predictions are not trivial
    assert not np.array_equal(trained.latest_weights, w)
    assert np.array_equal(p._engine.model.latest_weights, w)


class _RawPort(PortLinear):
    round_predictions = False


class _RawJax(JaxLinear):
    round_predictions = False


class _RawPortLogit(PortLogistic):
    prediction_fn = None


class _RawJaxLogit(JaxLogistic):
    prediction_fn = None


LEARNERS = {
    # name: (text features, port model, jax model, port raw, jax raw)
    "linear": (1000, None, None, _RawPort, _RawJax),
    "logistic": (1000, PortLogistic, JaxLogistic, _RawPortLogit, _RawJaxLogit),
    "sparse_2^18": (2 ** 18, None, None, _RawPort, _RawJax),
}


@pytest.mark.parametrize("learner", list(LEARNERS))
def test_serve_equals_the_jax_serving_plane(learner, b1_calls):
    """The same rows and weights through both packages' planes: rounded
    (or class) predictions equal, raw margins within 2e-3."""
    nf, port_cls, jax_cls, port_raw, jax_raw = LEARNERS[learner]
    scale = 0.05 if learner == "logistic" else 5.0
    w = weights(7, nf + 4, scale)
    rows = make_rows(30, seed=9)
    got = {}
    for name, make, cls, snap_cls in (("port", plane, port_cls, ServingSnapshot),
                                      ("jax", jax_plane, jax_cls, JaxSnapshot),
                                      ("port_raw", plane, port_raw, ServingSnapshot),
                                      ("jax_raw", jax_plane, jax_raw, JaxSnapshot)):
        p = make(snap_cls(step=1, weights=w), num_text_features=nf, model_cls=cls).start()
        try:
            sts = p.statuses_from_rows(rows)
            got[name] = np.asarray(serve(p, sts)["predictions"], np.float64)
        finally:
            p.stop()
    assert np.array_equal(got["port"], got["jax"])
    np.testing.assert_allclose(got["port_raw"], got["jax_raw"], rtol=0, atol=RAW_ATOL)
    assert len(set(got["port"].tolist())) > 1
    # the dense route serves through the fused kernel, the 2^18 one never
    assert b1_calls == ([] if nf > 8192 else [0, 0])


@pytest.mark.parametrize("rows,features", [(16, 64), (256, 1004), (13, 1004)])
def test_fused_twin_at_zero_iterations_equals_the_pallas_kernel(rows, features):
    """The predict-only mode: preds = X·w0 within 2e-3 of the Pallas kernel
    (interpret mode, as tests/test_pallas_sgd.py runs it), w returned
    bitwise w0, padding rows predicting 0; an all-padding batch predicts
    zeros. w0 is bf16-exact: the Pallas kernel rounds w to bf16 at each
    product (its documented envelope), which the port's f32 w does not."""
    rng = np.random.default_rng(rows)
    x = rng.integers(0, 4, size=(rows, features)).astype(np.float32)
    x[:, -4:] = rng.normal(size=(rows, 4)) * 0.1
    label = rng.uniform(50, 900, size=rows).astype(np.float32)
    mask = np.ones(rows, np.float32)
    mask[rows - 3:] = 0.0
    w0 = torch.from_numpy(weights(rows, features, 0.5)).to(torch.bfloat16).float().numpy()
    kw = dict(num_iterations=0, step_size=0.005)
    w, preds = fused_sgd.fused_dense_sgd(torch.from_numpy(x), torch.from_numpy(label),
                                         torch.from_numpy(mask), torch.from_numpy(w0), **kw)
    assert np.array_equal(w.numpy(), w0)
    pw, ppreds = pallas_sgd.fused_dense_sgd(
        jnp.asarray(x), jnp.asarray(label), jnp.asarray(mask), jnp.asarray(w0),
        interpret=True, **kw)
    assert np.array_equal(np.asarray(pw), w0)
    valid = mask > 0
    np.testing.assert_allclose(preds.numpy()[valid], np.asarray(ppreds)[valid], rtol=2e-3,
                               atol=2e-3)
    assert not preds.numpy()[~valid].any()
    _, empty = fused_sgd.fused_dense_sgd(torch.from_numpy(x), torch.from_numpy(label),
                                         torch.zeros(rows), torch.from_numpy(w0), **kw)
    assert not empty.numpy().any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_serve_across_packages(tmp_path, writer):
    """A JAX-written checkpoint served by the port and a port-written one
    served by the JAX plane: the same snapshot, the same predictions."""
    d = tmp_path / "ck"
    w = weights(11)
    save(d, 6, w, level="warn", ckpt=JaxCheckpointer if writer == "jax" else Checkpointer)
    ours, _ = load_servable(str(d))
    theirs, _ = jax_load_servable(str(d))
    assert ours.step == theirs.step == 6 and np.array_equal(ours.weights, w)
    rows = make_rows(20, seed=4)
    out = {}
    for name, make, snap in (("port", plane, ours), ("jax", jax_plane, theirs)):
        p = make(snap).start()
        try:
            res = serve(p, p.statuses_from_rows(rows))
        finally:
            p.stop()
        assert res["snapshot_step"] == 6
        out[name] = res["predictions"]
    assert out["port"] == out["jax"]


# ---- the coalescer ---------------------------------------------------------------

def test_coalescer_one_dispatch_for_queued_requests(b1_calls):
    """Requests queued together ride ONE featurize, dispatch and fetch, and
    each future gets exactly its own rows back."""
    w = weights(2)
    p = plane(ServingSnapshot(step=1, weights=w), batch_rows=64, max_wait_ms=20.0)
    parts = [statuses(8, seed=s) for s in range(4)]
    futs = [p.submit(part) for part in parts]
    p.start()  # queued before the loop runs: one group
    try:
        results = [f.result(timeout=60) for f in futs]
    finally:
        p.stop()
    assert b1_calls == [0]
    reg = _metrics.get_registry()
    assert reg.counter("serve.batches").snapshot() == 1
    assert reg.counter("serve.requests").snapshot() == 4
    for part, res in zip(parts, results):
        ref, _ = train_step_predictions(w, part)
        assert np.array_equal(ref, np.asarray(res["predictions"], np.float32))


def test_partial_batch_dispatches_after_the_bounded_wait():
    """A lone request smaller than the bucket dispatches once it has waited
    ``max_wait_ms``, not when the bucket fills."""
    p = plane(ServingSnapshot(step=1, weights=weights()), batch_rows=256,
              max_wait_ms=50.0).start()
    try:
        t0 = time.perf_counter()
        res = serve(p, statuses(4))
        waited = time.perf_counter() - t0
    finally:
        p.stop()
    assert len(res["predictions"]) == 4
    assert waited >= 0.05


def test_a_request_that_does_not_fit_waits_for_the_next_batch(b1_calls):
    """A request is never split: one that would overflow the bucket goes to
    the next batch."""
    p = plane(ServingSnapshot(step=1, weights=weights()), batch_rows=16, max_wait_ms=20.0)
    futs = [p.submit(statuses(10, seed=1)), p.submit(statuses(10, seed=2))]
    p.start()
    try:
        results = [f.result(timeout=60) for f in futs]
    finally:
        p.stop()
    assert [len(r["predictions"]) for r in results] == [10, 10]
    assert b1_calls == [0, 0]


def test_oversized_and_empty_requests():
    p = plane(ServingSnapshot(step=1, weights=weights()), batch_rows=8).start()
    try:
        with pytest.raises(ValueError, match="serveBatchRows"):
            serve(p, statuses(9))
        assert serve(p, []) == {"predictions": [], "snapshot_step": 1}
    finally:
        p.stop()


def test_statuses_from_rows_faces_equal_the_jax_planes():
    rows = [
        "bare text",
        {"text": "plain", "followers_count": 10, "created_at_ms": NOW_MS, "lang": "en"},
        {"text": "rt wrapper ignored", "retweeted_status": {
            "text": "original", "retweet_count": 7, "user": {"followers_count": 3},
            "timestamp_ms": str(NOW_MS)}},
    ]
    ours = ServingPlane.statuses_from_rows(rows)
    theirs = JaxPlane.statuses_from_rows(rows)
    fields = ("text", "retweet_count", "followers_count", "favourites_count",
              "friends_count", "lang")
    for a, b in zip(ours, theirs):
        for obj_a, obj_b in ((a, b), (a.retweeted_status, b.retweeted_status)):
            assert [getattr(obj_a, f) for f in fields] == [getattr(obj_b, f) for f in fields]
    assert [s.retweeted_status.text for s in ours] == ["bare text", "plain", "original"]
    assert ours[1].retweeted_status.created_at_ms == NOW_MS
    assert ours[2].retweeted_status.created_at_ms == theirs[2].retweeted_status.created_at_ms
    for bad in ([42], [None], [["x"]]):
        with pytest.raises(ValueError):
            ServingPlane.statuses_from_rows(bad)
        with pytest.raises(ValueError):
            JaxPlane.statuses_from_rows(bad)


# ---- promotion and the hot swap ----------------------------------------------------

def test_promoter_promotes_ok_and_refuses_alert(tmp_path):
    ck = tmp_path / "ck"
    save(ck, 1, np.zeros(F, np.float32), level="ok")
    snap, reason = load_servable(str(ck))
    assert snap is not None and "ok" in reason
    p = plane(snap).start()
    promoter = SnapshotPromoter(str(ck), p, poll_s=600.0)
    swapped = threading.Event()
    real_install = p._install

    def install(s):
        real_install(s)
        swapped.set()

    p._install = install
    try:
        save(ck, 2, np.full(F, 0.5, np.float32), level="alert")
        assert promoter.poll_once() is False and p.snapshot_step == 1
        assert promoter.poll_once() is False  # counted once a refused step
        reg = _metrics.get_registry()
        assert reg.counter("serve.promotions_refused").snapshot() == 1
        w3 = weights(3)
        save(ck, 3, w3, level="warn")
        assert promoter.poll_once() is True
        assert swapped.wait(30) and p.snapshot_step == 3
        assert reg.counter("serve.promotions").snapshot() == 1
        sts = statuses(8)
        res = serve(p, sts)
        assert res["snapshot_step"] == 3
        ref, _ = train_step_predictions(w3, sts)
        assert np.array_equal(ref, np.asarray(res["predictions"], np.float32))
        assert p.stats()["level"] == "warn"
    finally:
        promoter.stop()
        p.stop()


def test_hot_swap_under_load_tears_nothing():
    """Swap while requests stream: every request resolves, and each
    response equals the snapshot its step names, never a mix."""
    sts = statuses(8, seed=21)
    w = {1: weights(1), 2: weights(2)}
    refs = {step: train_step_predictions(ws, sts)[0] for step, ws in w.items()}
    p = plane(ServingSnapshot(step=1, weights=w[1]), max_wait_ms=0.5).start()
    results, errors, sent = [], [], []
    first, second = threading.Event(), threading.Event()

    def loader():
        # at least 12 requests each, and on until the new snapshot answered
        try:
            while (len(sent) < 3 * 12 or not second.is_set()) and len(sent) < 3000:
                sent.append(1)
                res = serve(p, list(sts))
                results.append(res)
                first.set()
                if res["snapshot_step"] == 2:
                    second.set()
        except Exception as exc:  # the failure is asserted below
            errors.append(exc)

    threads = [threading.Thread(target=loader) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        assert first.wait(60)
        p.hot_swap(ServingSnapshot(step=2, weights=w[2]))
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads)
    finally:
        p.stop()
    assert not errors and len(results) == len(sent) >= 36  # none lost
    for res in results:
        assert np.array_equal(refs[res["snapshot_step"]],
                              np.asarray(res["predictions"], np.float32))
    assert {r["snapshot_step"] for r in results} == {1, 2}
    assert _metrics.get_registry().counter("serve.hot_swaps").snapshot() == 1


# ---- the fetch watchdog ----------------------------------------------------------

def test_chaos_fetch_error_rejects_instead_of_hanging(monkeypatch):
    monkeypatch.setenv("TWTML_FETCH_DEADLINE_S", "0.5")
    monkeypatch.setenv("TWTML_FETCH_RETRIES", "1")
    faults.install_chaos("fetch:error@1")
    p = plane(ServingSnapshot(step=1, weights=weights())).start()
    try:
        with pytest.raises(RuntimeError, match="watchdog|abort"):
            serve(p, statuses(4))
        assert p.failed
        reg = _metrics.get_registry()
        assert reg.counter("fetch.aborts").snapshot() == 1
        assert reg.counter("fetch.retries").snapshot() >= 1
        assert reg.counter("serve.errors").snapshot() >= 1
        with pytest.raises(RuntimeError, match="aborted"):
            serve(p, statuses(2), timeout=10)  # a dead plane fails fast
    finally:
        faults.uninstall_chaos()
        p.stop()


class _Stalled:
    """A fetch that reports unfinished until ``until``."""

    def __init__(self, inner, until):
        self.inner, self.until = inner, until

    def done(self):
        return time.monotonic() >= self.until and self.inner.done()

    def wait(self):
        time.sleep(max(0.0, self.until - time.monotonic()))

    def result(self):
        return self.inner.result()


def test_idle_stalled_fetch_is_reissued(monkeypatch):
    """One stalled fetch and no traffic behind it: the idle loop's poll
    holds the watchdog's deadline, re-issues the fetch and the request
    completes instead of waiting for a next request."""
    monkeypatch.setenv("TWTML_FETCH_DEADLINE_S", "0.3")
    monkeypatch.setenv("TWTML_FETCH_RETRIES", "3")
    engine = PredictEngine(device="cpu")
    calls = []

    def stall_first(out):
        calls.append(1)
        pending = engine.model.fetch_output(out)
        return _Stalled(pending, time.monotonic() + 30.0) if len(calls) == 1 else pending

    engine.fetch_output = stall_first
    p = plane(ServingSnapshot(step=1, weights=weights()), engine=engine).start()
    try:
        t0 = time.monotonic()
        res = serve(p, statuses(4))
        assert time.monotonic() - t0 < 20.0
    finally:
        p.stop()
    assert len(res["predictions"]) == 4 and not p.failed
    assert len(calls) == 2
    assert _metrics.get_registry().counter("fetch.retries").snapshot() == 1


def test_a_failed_dispatch_rejects_its_batch_and_the_plane_serves_on():
    engine = PredictEngine(device="cpu")
    real_step, calls = engine.step, []

    def step(wire):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("launch refused")
        return real_step(wire)

    engine.step = step
    p = plane(ServingSnapshot(step=1, weights=weights()), engine=engine).start()
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            serve(p, statuses(3))
        assert len(serve(p, statuses(5))["predictions"]) == 5
    finally:
        p.stop()
    assert not p.failed and _metrics.get_registry().counter("serve.errors").snapshot() == 1


class _FakeOut:
    def __init__(self, ready):
        self.ready = ready

    def done(self):
        return self.ready.is_set()

    def wait(self):
        self.ready.wait(30)

    def result(self):
        return "host"


class _FakeModel:
    device = None

    def __init__(self):
        self.ready = []

    def step(self, wire):
        self.ready.append(threading.Event())
        return self.ready[-1]

    def fetch_output(self, ready):
        return _FakeOut(ready)


def test_fetch_pipeline_poll_delivers_finished_heads_without_a_dispatch():
    model, delivered = _FakeModel(), []
    pipe = FetchPipeline(model, lambda host, batch, t, at_boundary, stamp: delivered.append(t),
                         depth=8)
    for t in range(3):
        pipe.on_batch(None, t)
    assert pipe.pending_fetches == 3 and delivered == []
    model.ready[1].set()
    pipe.poll()  # an unfinished head holds the later finished one back
    assert delivered == [] and pipe.pending_fetches == 3
    model.ready[0].set()
    pipe.poll()
    assert delivered == [0, 1] and pipe.pending_fetches == 1
    assert len(model.ready) == 3  # poll dispatched nothing
    model.ready[2].set()
    pipe.poll()
    assert delivered == [0, 1, 2] and pipe.pending_fetches == 0


def test_serve_loop_binds_the_models_thread_before_its_first_dispatch():
    engine = PredictEngine(device="cpu")
    events = []
    real_step = engine.step
    engine.bind_thread = lambda: events.append(("bind", threading.current_thread().name))

    def step(wire):
        events.append(("step", threading.current_thread().name))
        return real_step(wire)

    engine.step = step
    p = plane(ServingSnapshot(step=1, weights=weights()), engine=engine).start()
    try:
        serve(p, statuses(3))
    finally:
        p.stop()
    assert events == [("bind", "twtml-serve-loop"), ("step", "twtml-serve-loop")]


# ---- beside a trainer --------------------------------------------------------------

def _write_replay(path, n, seed=31):
    with open(path, "w", encoding="utf-8") as fh:
        for s in SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce():
            r = s.retweeted_status
            fh.write(json.dumps({
                "text": s.text, "timestamp_ms": str(s.created_at_ms), "lang": "en",
                "user": {"followers_count": 0},
                "retweeted_status": {
                    "text": r.text, "retweet_count": r.retweet_count,
                    "user": {"followers_count": r.followers_count,
                             "favourites_count": r.favourites_count,
                             "friends_count": r.friends_count},
                    "timestamp_ms": str(r.created_at_ms)},
            }) + "\n")


def test_a_trainer_beside_a_serve_plane_adds_no_train_fetch_and_keeps_its_weights(
        tmp_path, monkeypatch):
    """With a plane and its promoter live on the trainer's checkpoint
    directory (and requests served meanwhile), the trainer fetches as often
    as a run with no serving, and ends with bitwise-equal weights."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    replay = tmp_path / "tweets.jsonl"
    _write_replay(replay, 8 * 16)
    base = ["--source", "replay", "--replayFile", str(replay), "--seconds", "0",
            "--backend", "cpu", "--master", "local[1]", "--batchBucket", "16",
            "--tokenBucket", "64", "--lightning", CLOSED, "--twtweb", CLOSED,
            "--webTimeout", "0.2", "--checkpointEvery", "2"]
    fetches = {"n": 0}
    real_build = common.build_model

    def counting_build(conf, *args):
        model = real_build(conf, *args)
        fetch = model.fetch_output

        def counted(out):
            fetches["n"] += 1
            return fetch(out)

        model.fetch_output = counted
        return model

    monkeypatch.setattr(train_app, "build_model", counting_build)
    ck_a = str(tmp_path / "ck_a")
    train_app.run(ConfArguments().parse(base + ["--checkpointDir", ck_a]))
    control_fetches = fetches["n"]
    control_state, control_meta = Checkpointer(ck_a).restore()

    ck_b = tmp_path / "ck_b"
    save(ck_b, 0, np.zeros(F, np.float32), level="ok")
    snap, _ = load_servable(str(ck_b))
    p = plane(snap).start()
    promoter = SnapshotPromoter(str(ck_b), p, poll_s=0.05).start()
    stop, served = threading.Event(), []

    def loader():
        while not stop.is_set():
            served.append(serve(p, statuses(4)))

    load = threading.Thread(target=loader)
    load.start()
    fetches["n"] = 0
    try:
        totals = train_app.run(ConfArguments().parse(base + ["--checkpointDir", str(ck_b)]))
    finally:
        stop.set()
        load.join(timeout=60)
    try:
        assert not load.is_alive()
        assert totals["batches"] == 8
        assert fetches["n"] == control_fetches == totals["batches"] + 1  # + the warm-up
        deadline = time.monotonic() + 30
        while p.snapshot_step != totals["batches"] and time.monotonic() < deadline:
            promoter.poll_once()
            time.sleep(0.01)
        assert p.snapshot_step == totals["batches"]
    finally:
        promoter.stop()
        p.stop()
    assert served
    state, meta = Checkpointer(str(ck_b)).restore()
    assert meta["count"] == control_meta["count"]
    assert np.array_equal(control_state, state)


# ---- the HTTP front door -----------------------------------------------------------

def _post(port, body: bytes, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/predict", data=body,
                                 headers={"content-type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


BODIES = {
    "rows": json.dumps({"rows": make_rows(3, seed=8)}).encode(),
    "bare_list": json.dumps(["served over http", "a bare string row"]).encode(),
    "empty": b'{"rows": []}',
    "rows_not_a_list": b'{"rows": 7}',
    "no_rows_key": b'{"nope": []}',
    "bad_row": b'{"rows": [42]}',
    "not_json": b"not json",
    "bad_utf8": b'{"rows": ["\xff\xfe"]}',
    "oversized": json.dumps({"rows": make_rows(33, seed=2)}).encode(),
}


@pytest.fixture(scope="module")
def front_doors(tmp_path_factory):
    """The port's server with a port plane, the JAX server with a JAX
    plane, over the same weights: {kind: port number}."""
    d = tmp_path_factory.mktemp("doors")
    w = weights(5)
    ours = plane(ServingSnapshot(step=9, weights=w, meta={"quality": {"level": "ok"}}))
    theirs = jax_plane(JaxSnapshot(step=9, weights=w, meta={"quality": {"level": "ok"}}))
    servers = {
        "port": Server(port=0, host="127.0.0.1", cache=ApiCache(str(d / "p.json"))
                       ).attach_serving(ours.start()),
        "jax": JaxServer(port=0, host="127.0.0.1", cache=JaxCache(str(d / "j.json"))
                         ).attach_serving(theirs.start()),
    }
    for s in servers.values():
        s.start_background()
    try:
        yield {"port": servers["port"].port,
               "jax": servers["jax"]._runner.addresses[0][1], "plane": ours}
    finally:
        for s in servers.values():
            s.stop()
        ours.stop()
        theirs.stop()


@pytest.mark.parametrize("case", list(BODIES))
def test_http_predict_statuses_and_bodies_equal_the_jax_servers(front_doors, case):
    got = _post(front_doors["port"], BODIES[case])
    want = _post(front_doors["jax"], BODIES[case])
    assert got[0] == want[0], (got, want)
    assert set(got[1]) == set(want[1])
    if got[0] == 200:
        for key in ("predictions", "snapshotStep", "servedRows"):
            assert got[1][key] == want[1][key]
        assert got[1]["snapshotStep"] == 9
    else:
        assert got[0] == 400 and got[1]["error"] == want[1]["error"]


def test_http_serving_view_and_client_round_trip(front_doors, tmp_path):
    from twtml_tpu_torch.telemetry.web_client import WebClient

    url = f"http://127.0.0.1:{front_doors['port']}"
    client = ServingClient(url)
    res = client.predict([{"text": "served", "followers_count": 5, "created_at_ms": NOW_MS},
                          "bare string row"])
    assert res["snapshotStep"] == 9 and res["servedRows"] == 2
    assert res["modelStalenessS"] >= 0.0
    WebClient(url).serving(front_doors["plane"].stats())
    view = client.serving()
    assert view["jsonClass"] == "Serving" and view["snapshotStep"] == 9
    assert view["level"] == "ok" and view["requests"] >= 1


def test_http_predict_without_a_plane_is_503_in_both(tmp_path):
    ours = Server(port=0, host="127.0.0.1", cache=ApiCache(str(tmp_path / "c1.json")))
    theirs = JaxServer(port=0, host="127.0.0.1", cache=JaxCache(str(tmp_path / "c2.json")))
    ours.start_background()
    theirs.start_background()
    try:
        body = b'{"rows": ["x"]}'
        got, want = _post(ours.port, body), _post(theirs._runner.addresses[0][1], body)
        assert got[0] == want[0] == 503 and set(got[1]) == set(want[1]) == {"error"}
        with pytest.raises(ServingError) as err:
            ServingClient(f"http://127.0.0.1:{ours.port}", retries=0).predict(["x"])
        assert err.value.status == 503
    finally:
        ours.stop()
        theirs.stop()


def test_http_predict_after_a_plane_abort_is_503(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_FETCH_DEADLINE_S", "0.3")
    monkeypatch.setenv("TWTML_FETCH_RETRIES", "0")
    faults.install_chaos("fetch:error@1")
    p = plane(ServingSnapshot(step=1, weights=weights())).start()
    srv = Server(port=0, host="127.0.0.1", cache=ApiCache(str(tmp_path / "c.json")))
    srv.attach_serving(p).start_background()
    try:
        status, body = _post(srv.port, b'{"rows": ["x"]}')
        assert status == 503 and "watchdog" in body["error"]
        status, body = _post(srv.port, b'{"rows": ["y"]}')
        assert status == 503 and "aborted" in body["error"]
    finally:
        faults.uninstall_chaos()
        srv.stop()
        p.stop()


# ---- the serve entry point ---------------------------------------------------------

def _serve_in_thread(argv):
    """apps/serve.run in a thread: (stop event, thread, result dict, port)."""
    ready, result, stop = threading.Event(), {}, threading.Event()

    def started(server, plane_, promoter):
        result["port"] = server.port
        result["plane"] = plane_
        ready.set()

    def runner():
        try:
            result["stats"] = serve_app.run(ConfArguments().parse(argv), started=started,
                                            stop_event=stop)
        except BaseException as exc:  # reported by the caller
            result["error"] = exc
            ready.set()

    thread = threading.Thread(target=runner)
    thread.start()
    assert ready.wait(60), "the serve app never came up"
    assert "error" not in result, result.get("error")
    return stop, thread, result


def test_serve_app_end_to_end(tmp_path, monkeypatch):
    """apps/serve.run on the CPU over a checkpoint directory: a predict over
    HTTP equal to the train step's, a promotion mid-run, a clean stop."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    ck = tmp_path / "ck"
    w4, w5 = weights(4), weights(5)
    save(ck, 4, w4, level="ok")
    stop, thread, result = _serve_in_thread([
        "--backend", "cpu", "--master", "local[1]", "--checkpointDir", str(ck),
        "--servePort", "0", "--serveBatchRows", "32", "--serveMaxWaitMs", "2",
        "--servePromoteEvery", "0.05", "--servingStaleSloS", "600",
    ])
    try:
        client = ServingClient(f"http://127.0.0.1:{result['port']}")
        rows = make_rows(6, seed=2)
        res = client.predict(rows)
        assert res["snapshotStep"] == 4 and res["servedRows"] == 6
        save(ck, 5, w5, level="ok")
        deadline = time.monotonic() + 30
        while result["plane"].snapshot_step != 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        res5 = client.predict(rows)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and "error" not in result
    assert result["stats"]["requests"] == 2
    assert res5["snapshotStep"] == 5
    sts = ServingPlane.statuses_from_rows(rows)
    for w, r in ((w4, res), (w5, res5)):
        ref, _ = train_step_predictions(w, sts)
        assert np.array_equal(ref, np.asarray(r["predictions"], np.float32))


REFUSALS = {
    "no_checkpoint_dir": ([], SystemExit, "checkpointDir"),
    "no_servable_snapshot": (["--checkpointDir", "{missing}"], SystemExit,
                             "no servable snapshot"),
    "alert_only": (["--checkpointDir", "{alert}"], SystemExit, "no servable snapshot"),
    "multi_host": (["--checkpointDir", "{ok}", "--numProcesses", "2"], SystemExit,
                   "single-host"),
    # --abtest on serves a tenant stack (tests/test_torch_abtest.py): a
    # single-model checkpoint, or a stack of one, is refused
    "abtest_on": (["--checkpointDir", "{ok}", "--abtest", "on"], SystemExit,
                  "needs a tenant-stack checkpoint"),
    "tenant_stack": (["--checkpointDir", "{stack}", "--abtest", "on"], SystemExit,
                     r"tenant-stack checkpoint \(1 tenant"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_serve_app_refusals(tmp_path, case):
    dirs = {k: tmp_path / k for k in ("missing", "alert", "ok", "stack")}
    save(dirs["alert"], 1, np.zeros(F), level="alert")
    save(dirs["ok"], 1, np.zeros(F), level="ok")
    save(dirs["stack"], 1, np.zeros((1, F)), level="ok")
    argv, exc, match = REFUSALS[case]
    argv = ["--backend", "cpu", *(a.format(**dirs) for a in argv)]
    with pytest.raises(exc, match=match):
        serve_app.run(ConfArguments().parse(argv), max_seconds=0.1)


# ---- the Serving view ------------------------------------------------------------

def test_stats_view_has_the_jax_planes_keys_and_round_trips_the_wire():
    from twtml_tpu_torch.telemetry.api_types import Serving, decode, encode

    w = weights()
    ours = plane(ServingSnapshot(step=2, weights=w, meta={"quality": {"level": "warn"}}))
    theirs = jax_plane(JaxSnapshot(step=2, weights=w, meta={"quality": {"level": "warn"}}))
    for p in (ours, theirs):
        p.start()
        try:
            serve(p, p.statuses_from_rows(make_rows(16)))
        finally:
            p.stop()
    view, jax_view = ours.stats(), theirs.stats()
    assert set(view) == set(jax_view)
    for key in ("snapshotStep", "level", "requests", "rows", "errors", "tenants"):
        assert view[key] == jax_view[key]
    assert view["qps"] > 0 and view["p99Ms"] > 0
    known = Serving.__dataclass_fields__
    msg = Serving(**{k: v for k, v in view.items() if k in known})
    assert decode(encode(msg)) == msg


def test_stale_slo_breach_counts_one_episode(monkeypatch):
    recorded = []
    monkeypatch.setattr(blackbox, "record", lambda kind, **kw: recorded.append(kind))
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    p = plane(ServingSnapshot(step=1, weights=weights()), stale_slo_s=10.0)
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS + 5_000))
    assert p.stats()["snapshotAgeS"] == 5.0
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS + 20_000))
    p.stats()
    p.stats()  # the same episode
    reg = _metrics.get_registry()
    assert reg.counter("serve.stale_breaches").snapshot() == 1
    assert recorded == ["serving_stale_breach"]
    assert reg.gauge("serving.snapshot_age_s").snapshot() == 20.0
