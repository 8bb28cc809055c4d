"""The port's fetch pipeline and fetch watchdog (``twtml_tpu_torch/apps/
common.py``), case for case against the JAX package's own tests
(tests/test_fetch_pipeline.py, the watchdog cases of
tests/test_runtime_guards.py): in-order delivery and flush, the exact
``max_dispatch`` cap, the ``boundary_every`` cadence, the cap drain, refunds;
re-issue and abort on a pending fetch that never completes; the host fetch
of a StepOutput; lease retirement; and the app at fetch depth 8 equal to
the app at depth 1 with synchronous copies."""

import threading
import time

import numpy as np
import pytest
import torch

from twtml_tpu_torch.apps.common import (
    FETCH_DEADLINE_MAX_S,
    FETCH_DEADLINE_MIN_S,
    FetchAbort,
    FetchPipeline,
    FetchWatchdog,
    attach_super_batcher,
    warmup_compile,
)
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.arena import LeaseChain, WireArena, chain_leases
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.base import StepOutput
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.models.sgd import fetch_output
from twtml_tpu_torch.streaming.context import FeatureStream
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import metrics as _metrics

NOW_MS = 1_700_000_000_000
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


@pytest.fixture(autouse=True)
def fresh_metrics():
    _metrics.reset_for_tests()
    yield
    _metrics.reset_for_tests()


class FakeModel:
    def __init__(self):
        self.dispatched = []

    def step(self, batch):
        self.dispatched.append(batch)
        return {"i": np.asarray(batch)}


class Pending:
    """A host fetch that completes at ``ready_at`` (never when None), or
    whose result raises ``error``."""

    def __init__(self, value, ready_at=0.0, error=None):
        self.value, self.ready_at, self.error = value, ready_at, error

    def done(self):
        return self.ready_at is not None and time.monotonic() >= self.ready_at

    def wait(self):
        while not self.done():
            time.sleep(0.001)

    def result(self):
        if self.error is not None:
            raise self.error
        return self.value


class FlakyFetchModel(FakeModel):
    """A model whose fetch of batch i stalls (``slow``: {i: {attempt:
    seconds or None = never}}) or fails (``errors``: {i: {attempt}})."""

    def __init__(self, slow=None, errors=None):
        super().__init__()
        self.slow, self.errors = slow or {}, errors or {}
        self.attempts: dict = {}

    def fetch_output(self, out):
        i = int(out["i"])
        n = self.attempts[i] = self.attempts.get(i, 0) + 1
        if n in self.errors.get(i, ()):
            return Pending(out, error=ConnectionError(f"injected failure b{i} a{n}"))
        if n in self.slow.get(i, {}):
            delay = self.slow[i][n]
            return Pending(out, None if delay is None else time.monotonic() + delay)
        return Pending(out)


def recorder(events, with_boundary=False):
    def handle(out, b, t, at_boundary, stamp):
        events.append((int(out["i"]), at_boundary) if with_boundary else int(out["i"]))

    return handle


# ---- tests/test_fetch_pipeline.py ---------------------------------------------

def test_emits_in_order_and_flush_drains():
    model, events = FakeModel(), []
    pipe = FetchPipeline(model, recorder(events, True), depth=3)
    for i in range(10):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert model.dispatched == list(range(10))
    assert [e[0] for e in events] == list(range(10))
    assert events[-1][1] is True


def test_max_dispatch_is_exact_and_stop_vetoes():
    model, events = FakeModel(), []
    stop = {"flag": False}

    def handle(out, b, t, at_boundary, stamp):
        events.append(int(out["i"]))
        if out["i"] >= 4:
            stop["flag"] = True

    pipe = FetchPipeline(model, handle, depth=3, stop_requested=lambda: stop["flag"],
                         max_dispatch=5)
    for i in range(20):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert model.dispatched == [0, 1, 2, 3, 4]
    assert events == [0, 1, 2, 3, 4]


def test_boundary_every_drains_at_cadence():
    model, events = FakeModel(), []
    pipe = FetchPipeline(model, recorder(events, True), depth=4, boundary_every=3)
    for i in range(9):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert {i for i, at_b in events if at_b} >= {2, 5, 8}
    assert [e[0] for e in events] == list(range(9))


def test_cap_reached_still_delivers_pending_handles():
    model, events = FakeModel(), []
    pipe = FetchPipeline(model, recorder(events), depth=8, max_dispatch=2)
    pipe.on_batch(0, 0.0)
    pipe.on_batch(1, 0.0)
    pipe.on_batch(2, 0.0)
    assert model.dispatched == [0, 1]
    assert events == [0, 1]


def test_refund_does_not_perturb_checkpoint_cadence():
    model, events = FakeModel(), []
    pipe = FetchPipeline(model, recorder(events, True), depth=4, boundary_every=3,
                         max_dispatch=50)
    for i in range(9):
        pipe.on_batch(i, 0.0)
        pipe.refund_dispatch()
    pipe.flush()
    assert {i for i, at_b in events if at_b} >= {2, 5, 8}
    assert [e[0] for e in events] == list(range(9))
    assert _metrics.get_registry().counter("fetch.refunds").snapshot() == 9


def test_pending_heads_deliver_only_when_done():
    """A head whose copy has not finished stays in flight until the depth
    forces the wait; finished heads deliver early, in order."""
    model, events = FlakyFetchModel(slow={0: {1: 0.2}}), []
    pipe = FetchPipeline(model, recorder(events), depth=3, fetch_deadline_s=5.0)
    pipe.on_batch(0, 0.0)
    pipe.on_batch(1, 0.0)
    assert events == [] and len(pipe._pending) == 2
    pipe.on_batch(2, 0.0)
    pipe.on_batch(3, 0.0)  # depth 3 reached: waits for batch 0, then 1, 2 are done
    assert events == [0, 1, 2]
    pipe.flush()
    assert events == [0, 1, 2, 3]


def test_stamps_carry_each_batchs_timings():
    model, stamps = FakeModel(), []
    pipe = FetchPipeline(model, lambda out, b, t, at_boundary, stamp: stamps.append(stamp),
                         depth=2, stamp=lambda: {"featurize_ms": 1.5})
    for i in range(3):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert [s["featurize_ms"] for s in stamps] == [1.5] * 3
    for s in stamps:
        assert s["dispatch_ms"] >= 0 and s["fetch_wait_ms"] >= 0 and s["step_ms"] >= 0
        assert "step_events" not in s
    assert [s["depth"] for s in stamps] == [0, 0, 0]  # instant fetches drain early


# ---- the watchdog (tests/test_runtime_guards.py) ------------------------------

def test_fetch_deadline_derives_from_health_rtt(monkeypatch):
    class H:
        def __init__(self, ms):
            self.ms = ms

        def median_ms(self):
            return self.ms

    assert FetchWatchdog(H(0)).deadline() == FETCH_DEADLINE_MAX_S
    assert FetchWatchdog(H(70)).deadline() == FETCH_DEADLINE_MIN_S
    assert FetchWatchdog(H(10_000)).deadline() == FETCH_DEADLINE_MAX_S
    monkeypatch.setenv("TWTML_FETCH_DEADLINE_S", "0.25")
    assert FetchWatchdog(H(70)).deadline() == 0.25


def test_fetch_timeout_reissues_and_preserves_order():
    model, events = FlakyFetchModel(slow={0: {1: None}}), []
    pipe = FetchPipeline(model, recorder(events), depth=3, fetch_deadline_s=0.1,
                         fetch_retries=2)
    for i in range(5):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert events == [0, 1, 2, 3, 4]
    assert model.attempts[0] == 2
    assert _metrics.get_registry().counter("fetch.retries").snapshot() == 1
    assert _metrics.get_registry().counter("fetch.aborts").snapshot() == 0


def test_fetch_error_reissues_and_delivers():
    model, events = FlakyFetchModel(errors={1: {1}}), []
    pipe = FetchPipeline(model, recorder(events), depth=2, fetch_deadline_s=5.0,
                         fetch_retries=2)
    for i in range(4):
        pipe.on_batch(i, 0.0)
    pipe.flush()
    assert events == [0, 1, 2, 3]
    assert _metrics.get_registry().counter("fetch.retries").snapshot() == 1


def test_watchdog_aborts_a_fetch_that_never_completes():
    """A pending result that never completes, a 0.05 s deadline: one
    re-issue, then the abort hook and FetchAbort, in bounded time."""
    aborted, reissued = [], []

    def reissue():
        reissued.append(1)
        return Pending(None, ready_at=None)

    dog = FetchWatchdog(_metrics.get_health_monitor(), abort=lambda: aborted.append(1),
                        deadline_s=0.05, retries=1)
    t0 = time.perf_counter()
    with pytest.raises(FetchAbort):
        dog.await_result(Pending(None, ready_at=None), reissue)
    assert time.perf_counter() - t0 < 2.0
    assert dog.aborted and aborted == [1] and reissued == [1]
    reg = _metrics.get_registry()
    assert reg.counter("fetch.retries").snapshot() == 1
    assert reg.counter("fetch.aborts").snapshot() == 1


def test_fetch_abort_discards_leases_and_stops_training():
    arena = WireArena()
    model, events, aborted = FlakyFetchModel(
        slow={0: {n: None for n in range(1, 10)}}), [], []

    class Batch(int):
        pass

    leased = []

    def make(i):
        b = Batch(i)
        b.lease = arena.lease(64)
        leased.append(b.lease)
        return b

    pipe = FetchPipeline(model, recorder(events), depth=1, fetch_deadline_s=0.05,
                         fetch_retries=1, abort=lambda: aborted.append(True))
    pipe.on_batch(make(0), 0.0)
    with pytest.raises(FetchAbort):
        pipe.on_batch(make(1), 0.0)  # depth backpressure forces the wait
    assert aborted == [True]
    dispatched = len(model.dispatched)
    pipe.on_batch(make(2), 0.0)
    assert len(model.dispatched) == dispatched
    pipe.flush()
    assert events == []
    # batch 0's lease was discarded, never recycled
    assert arena.stats()["free_buffers"] == 0
    assert all(le._done for le in leased[:1])


def test_leases_retire_after_the_handler_reads_the_batch():
    arena = WireArena()
    model, seen = FakeModel(), []

    class Batch(int):
        pass

    def handle(out, b, t, at_boundary, stamp):
        seen.append((int(b), b.lease._done))

    pipe = FetchPipeline(model, handle, depth=2)
    for i in range(3):
        b = Batch(i)
        b.lease = arena.lease(32)
        pipe.on_batch(b, 0.0)
    pipe.flush()
    assert seen == [(0, False), (1, False), (2, False)]
    # batch 0's buffer retired when batch 1 delivered it early, and batch 2
    # leased it again; all three are back in the pool after the flush
    stats = arena.stats()
    assert (stats["in_use"], stats["recycled"], stats["free_buffers"]) == (0, 1, 2)


def test_chain_leases_dedups_and_chains():
    arena = WireArena()
    a, b = arena.lease(8), arena.lease(16)
    assert chain_leases(None, None) is None
    assert chain_leases(a, None, a) is a
    chain = chain_leases(a, b)
    assert isinstance(chain, LeaseChain) and chain.leases == [a, b]
    chain.retire()
    assert arena.stats()["in_use"] == 0


def test_arena_serves_pinned_buffers_to_a_cuda_model_only():
    arena = WireArena()
    arena.use_device("cpu")
    assert not arena.pinned
    arena.lease(64).retire()
    assert arena.stats()["free_buffers"] == 1
    if torch.cuda.is_available():
        arena.use_device("cuda")
        assert arena.pinned and arena.stats()["free_buffers"] == 0
    else:
        arena.use_device("cuda")  # no fallback: the first lease raises
        with pytest.raises(RuntimeError):
            arena.lease(64)


# ---- the host fetch of a StepOutput ------------------------------------------

@pytest.mark.parametrize("quality", [True, False])
def test_host_fetch_returns_the_step_outputs_bits(quality):
    g = torch.Generator().manual_seed(0)
    out = StepOutput(
        predictions=torch.randn(7, generator=g), count=torch.tensor(5.0),
        mse=torch.tensor(1.25), real_stdev=torch.tensor(0.5), pred_stdev=torch.tensor(3.0),
        quality=torch.randn(19, generator=g) if quality else None,
    )
    pending = fetch_output(out)
    assert pending.done()
    pending.wait()
    host = pending.result()
    assert isinstance(host.predictions, np.ndarray)
    np.testing.assert_array_equal(host.predictions, out.predictions.numpy())
    for k in ("count", "mse", "real_stdev", "pred_stdev"):
        assert float(getattr(host, k)) == float(getattr(out, k))
    if quality:
        np.testing.assert_array_equal(host.quality, out.quality.numpy())
    else:
        assert host.quality is None


def test_warmup_steps_one_all_padding_batch_and_keeps_the_weights():
    model = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    model.set_initial_weights(np.linspace(-1, 1, 1004, dtype=np.float32))
    before = model.latest_weights
    for ragged in (False, True):
        stream = FeatureStream(Featurizer(now_ms=NOW_MS), row_bucket=16, ragged=ragged)
        warmup_compile(stream, model)
    np.testing.assert_array_equal(model.latest_weights, before)


def test_wall_clock_path_fetches_each_batch_synchronously():
    conf = ConfArguments().parse(["--backend", "cpu", "--seconds", "1"])
    model = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    stream = FeatureStream(Featurizer(now_ms=NOW_MS), row_bucket=32)
    got = []
    flush = attach_super_batcher(
        conf, stream, model,
        lambda out, b, t, at_boundary, stamp: got.append((float(out.count), at_boundary, stamp)),
        stamp=lambda: stream.last_featurize,
    )
    tweets = list(SyntheticSource(total=40, seed=2, base_ms=NOW_MS).produce())
    stream._process(tweets[:20], 0.0)
    assert len(got) == 1  # delivered before the next batch arrives
    stream._process([], 0.0)  # an empty interval is skipped before the step
    stream._process(tweets[20:], 0.0)
    flush()
    assert [(c, b) for c, b, _ in got] == [(20.0, True), (20.0, True)]
    assert all(s["depth"] == 0 and s["featurize_ms"] > 0 for _, _, s in got)
    assert _metrics.get_registry().counter("fetch.count").snapshot() == 2


# ---- the app ------------------------------------------------------------------

def test_linear_app_max_batches_exact_under_fetch_pipeline(monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    conf = ConfArguments().parse(["--backend", "cpu", "--source", "synthetic",
                                  "--seconds", "0", "--batchBucket", "16", *QUIET])
    totals = app.run(conf, max_batches=3)
    assert totals["batches"] == 3
    assert totals["count"] == 3 * 16


def test_depth_8_run_equals_depth_1_with_synchronous_copies(monkeypatch):
    """The chip check, rehearsed on the CPU: the pipelined run and the run
    with one batch in flight and blocking copies give the same lines,
    stats, quality and final weights."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    argv = ["--backend", "cpu", "--source", "synthetic", "--seconds", "0",
            "--batchBucket", "32", *QUIET]
    runs = []
    for depth, blocking in ((8, False), (1, True)):
        models = []
        base = app.build_model

        def build(conf, _base=base, _blocking=blocking):
            model = _base(conf)
            model.non_blocking = not _blocking
            models.append(model)
            return model

        monkeypatch.setattr(app, "build_model", build)
        totals = app.run(ConfArguments().parse(argv), max_batches=5, fetch_depth=depth)
        runs.append((totals, models[0].latest_weights))
    (a, wa), (b, wb) = runs
    keys = ("count", "mse", "real_stdev", "pred_stdev", "quality")
    assert [{k: s[k] for k in keys} for s in a["steps"]] == [
        {k: s[k] for k in keys} for s in b["steps"]]
    np.testing.assert_array_equal(wa, wb)
    assert max(s["depth"] for s in b["steps"]) == 0


def test_pipeline_threads_are_the_scheduler_and_main_only(monkeypatch):
    """The fetch pipeline adds no thread: dispatch and delivery run on the
    scheduler thread (and the final flush on the caller's)."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    names = set()
    base = app.build_model

    def build(conf):
        model = base(conf)
        step = model.step

        def traced(batch):
            names.add(threading.current_thread().name)
            return step(batch)

        model.step = traced
        return model

    monkeypatch.setattr(app, "build_model", build)
    before = threading.active_count()
    app.run(ConfArguments().parse(["--backend", "cpu", "--source", "synthetic",
                                   "--seconds", "0", "--batchBucket", "16", *QUIET]),
            max_batches=3)
    assert names == {"MainThread", "twtml-batch-scheduler"}  # warm-up, then the stream
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
