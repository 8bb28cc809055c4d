"""The port's streaming runtime (``twtml_tpu_torch/streaming``) and its
config, case for case against the JAX package's own tests of the same
behaviour (tests/test_streaming.py, tests/test_backpressure.py): wall-clock
and back-to-back batching, output order, source supervision, the bounded
intake queue, the fill gate, the bucket-overflow warning; the flags and
defaults the port takes, equal to the JAX package's; and the app, whose
lines equal the JAX app's on the replay fixture."""

import contextlib
import io
import json
import logging
import os
import threading
import time
from types import SimpleNamespace

import jax
import pytest

from tools.bench_suite import _status_json
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.batch import RaggedUnitBatch, UnitBatch
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.streaming.context import FeatureStream, StreamingContext, _RowCountQueue
from twtml_tpu_torch.streaming.sources import (
    QueueSource,
    ReplayFileSource,
    Source,
    SyntheticSource,
)
from twtml_tpu_torch.telemetry import metrics as _metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
NOW_MS = "1700000000000"
CLOSED = "http://127.0.0.1:9"  # a closed loopback port: publishing fails fast
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


@pytest.fixture(autouse=True)
def fresh_metrics():
    _metrics.reset_for_tests()
    yield
    _metrics.reset_for_tests()


def rt(label=500, text="some tweet text"):
    return Status(text="RT", retweeted_status=Status(text=text, retweet_count=label))


def _block_item(rows: int, tag: int = 0):
    return SimpleNamespace(rows=rows, tag=tag)


def run_port(argv, max_batches=0, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(["--backend", "cpu", *QUIET, *argv]),
                         max_batches=max_batches, **kw)
    return totals, out.getvalue().splitlines()


def write_replay(path, total, seed):
    """A replay file of the JAX package's synthetic tweets, as its own
    tests write one."""
    with open(path, "w") as fh:
        for s in JaxSynthetic(total=total, seed=seed, base_ms=1785320000000).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")


# ---- the streaming context (tests/test_streaming.py) ------------------------

def test_wall_clock_batching():
    src = QueueSource()
    ssc = StreamingContext(batch_interval=0.1)
    seen = []
    ssc.source_stream(src, Featurizer(now_ms=0)).foreach_batch(
        lambda batch, t: seen.append(batch.num_valid)
    )
    ssc.start()
    for _ in range(3):
        src.push(rt())
    time.sleep(0.25)
    src.close()
    assert ssc.await_termination(timeout=5)
    ssc.stop()
    assert sum(seen) == 3
    assert len(seen) >= 1


def test_outputs_fire_in_registration_order():
    src = QueueSource()
    ssc = StreamingContext(batch_interval=0.05)
    order = []
    stream = ssc.source_stream(src, Featurizer(now_ms=0))
    stream.foreach_batch(lambda b, t: order.append("stats"))
    stream.foreach_batch(lambda b, t: order.append("train"))
    src.push(rt())
    src.close()
    ssc.start()
    assert ssc.await_termination(timeout=5)
    ssc.stop()
    assert order[:2] == ["stats", "train"]


def test_source_supervision_restarts():
    class Flaky(Source):
        name = "flaky"
        attempts = 0

        def produce(self):
            Flaky.attempts += 1
            if Flaky.attempts == 1:
                raise RuntimeError("simulated receiver crash")
            yield rt()

    src = Flaky(restart_backoff=0.01)
    got = []
    src.start(got.append)
    deadline = time.time() + 2
    while not src.exhausted and time.time() < deadline:
        time.sleep(0.01)
    src.stop()
    assert Flaky.attempts == 2
    assert len(got) == 1


def test_source_gives_up_after_max_restarts():
    class Dead(Source):
        name = "dead"

        def produce(self):
            raise RuntimeError("always broken")
            yield  # pragma: no cover

    src = Dead(max_restarts=2, restart_backoff=0.01)
    src.start(lambda s: None)
    deadline = time.time() + 2
    while not src.exhausted and time.time() < deadline:
        time.sleep(0.01)
    assert src.exhausted
    src.stop()


def test_max_restarts_bounds_consecutive_failures_only():
    class DropsEveryTime(Source):
        name = "droppy"

        def produce(self):
            yield rt()
            raise ConnectionError("disconnect after healthy streaming")

    src = DropsEveryTime(max_restarts=2, restart_backoff=0.001)
    got = []
    src.start(got.append)
    deadline = time.time() + 2
    while len(got) < 8 and time.time() < deadline:
        time.sleep(0.005)
    src.stop()
    assert len(got) >= 8
    assert not src.exhausted


def test_source_stop_names_wedged_producer_thread(caplog):
    release = threading.Event()

    class Wedged(Source):
        name = "wedged"

        def produce(self):
            release.wait(5.0)  # ignores the stop event
            return iter(())

    src = Wedged()
    src.JOIN_TIMEOUT_S = 0.1
    src.start(lambda s: None)
    time.sleep(0.05)
    with caplog.at_level(logging.WARNING):
        src.stop()
    release.set()
    warnings = [r for r in caplog.records if "did not stop" in r.message]
    assert len(warnings) == 1
    assert "twtml-source-wedged" in warnings[0].getMessage()


def test_replay_run_to_completion():
    ssc = StreamingContext()
    batches = []
    ssc.source_stream(ReplayFileSource(DATA), Featurizer(now_ms=0)).foreach_batch(
        lambda batch, t: batches.append(batch)
    )
    n = ssc.run_to_completion()
    assert n == len(batches) >= 1
    assert sum(b.num_valid for b in batches) == 6  # 6 in-range retweets


@pytest.mark.parametrize("ragged", [False, True])
def test_feature_stream_wires_carry_the_same_rows(ragged):
    """Both device-hash wires go through the scheduler with the same valid
    rows and labels (host hashing is not ported)."""
    src = QueueSource()
    ssc = StreamingContext(batch_interval=0.05)
    batches = []
    ssc.source_stream(src, Featurizer(now_ms=0), ragged=ragged).foreach_batch(
        lambda b, t: batches.append(b)
    )
    for lab in (150, 300, 700):
        src.push(rt(label=lab, text=f"tweet number {lab}"))
    src.close()
    ssc.start()
    assert ssc.await_termination(timeout=5)
    ssc.stop()
    assert all(isinstance(b, RaggedUnitBatch if ragged else UnitBatch) for b in batches)
    labels = sorted(float(v) for b in batches for v in b.label[b.mask.astype(bool)])
    assert labels == [150.0, 300.0, 700.0]


def test_bucket_overflow_warns_once(caplog):
    stream = FeatureStream(Featurizer(now_ms=0), row_bucket=8, token_bucket=8)
    long_tweet = rt(text="x" * 100)
    with caplog.at_level(logging.WARNING):
        stream._process([long_tweet], 0.0)
        stream._process([long_tweet], 0.0)
    warnings = [r for r in caplog.records if "overflowed" in r.message]
    assert len(warnings) == 1


def test_fill_gate_batches_a_full_bucket_while_the_source_lives():
    """--seconds 0 with a pinned row bucket: the scheduler runs a batch as
    soon as a full bucket is queued, not only when the source ends (this
    source waits for that batch before it goes on)."""
    batch_done = threading.Event()

    class Gated(Source):
        name = "gated"

        def produce(self):
            for i in range(4):
                yield rt(label=100 + i)
            assert batch_done.wait(5.0), "no batch while the source lives"
            for i in range(2):
                yield rt(label=200 + i)

    ssc = StreamingContext(batch_interval=0)
    stream = ssc.source_stream(Gated(max_restarts=0), Featurizer(now_ms=0), row_bucket=4)
    seen = []

    def on_batch(batch, t):
        seen.append(batch.num_valid)
        batch_done.set()

    stream.foreach_batch(on_batch)
    ssc.start()
    assert ssc.await_termination(timeout=15)
    ssc.stop()
    assert seen == [4, 2]


def test_scheduler_thread_runs_its_init_first():
    names = []
    src = QueueSource()
    ssc = StreamingContext(
        batch_interval=0.02,
        thread_init=lambda: names.append(threading.current_thread().name),
    )
    ssc.source_stream(src, Featurizer(now_ms=0)).foreach_batch(
        lambda b, t: names.append(threading.current_thread().name)
    )
    src.push(rt())
    src.close()
    ssc.start()
    assert ssc.await_termination(timeout=5)
    ssc.stop()
    assert names[0] == "twtml-batch-scheduler" and len(names) >= 2
    assert set(names) == {"twtml-batch-scheduler"}


def test_a_failing_batch_is_logged_and_skipped(caplog):
    src = QueueSource()
    ssc = StreamingContext(batch_interval=0)
    seen = []

    def out(batch, t):
        seen.append(batch.num_valid)
        if len(seen) == 1:
            raise RuntimeError("handler failure")

    ssc.source_stream(src, Featurizer(now_ms=0), row_bucket=1).foreach_batch(out)
    src.push(rt())
    src.push(rt())
    src.close()
    with caplog.at_level(logging.ERROR):
        ssc.start()
        assert ssc.await_termination(timeout=5)
        ssc.stop()
    assert seen == [1, 1]
    assert ssc.batches_processed == 1
    assert any("failed" in r.message for r in caplog.records)


# ---- the bounded intake queue (tests/test_backpressure.py) -----------------

def test_unbounded_queue_is_the_plain_path():
    q = _RowCountQueue()
    for i in range(100):
        q.put(i)
    assert q.rows_queued == 100
    assert [q.get_nowait() for _ in range(100)] == list(range(100))


def test_block_policy_blocks_producer_at_the_row_bound():
    q = _RowCountQueue()
    q.configure_bound(10, "block")
    for i in range(10):
        q.put(i)
    landed = threading.Event()

    def producer():
        q.put(10)
        landed.set()

    threading.Thread(target=producer, daemon=True).start()
    assert not landed.wait(0.25), "producer sailed past the row bound"
    assert q.rows_queued == 10
    q.get_nowait()
    assert landed.wait(2.0), "producer never released after the drain"
    assert q.rows_queued == 10
    assert [q.get_nowait() for _ in range(10)] == list(range(1, 11))


def test_block_policy_admits_oversized_item_alone():
    q = _RowCountQueue()
    q.configure_bound(4, "block")
    q.put(_block_item(100))
    assert q.rows_queued == 100


def test_close_releases_a_blocked_producer():
    q = _RowCountQueue()
    q.configure_bound(2, "block")
    q.put(0)
    q.put(1)
    released = threading.Event()

    def producer():
        q.put(2)
        released.set()

    threading.Thread(target=producer, daemon=True).start()
    assert not released.wait(0.2)
    q.close()
    assert released.wait(2.0)


def test_shed_oldest_sheds_counted_and_never_reorders_survivors():
    q = _RowCountQueue()
    q.configure_bound(8, "shed-oldest")
    for i in range(20):
        q.put(i)
    assert q.rows_queued <= 8
    survivors = []
    while not q.empty():
        survivors.append(q.get_nowait())
    assert survivors == list(range(20 - len(survivors), 20))
    shed = 20 - len(survivors)
    assert shed > 0
    assert q.rows_shed_total == shed
    assert _metrics.get_registry().counter("ingest.rows_shed").snapshot() == shed


def test_shed_oldest_counts_block_rows_not_items():
    q = _RowCountQueue()
    q.configure_bound(100, "shed-oldest")
    q.put(_block_item(60, tag=0))
    q.put(_block_item(40, tag=1))
    q.put(_block_item(30, tag=2))
    assert q.rows_queued == 70
    assert q.rows_shed_total == 60
    assert [it.tag for it in (q.get_nowait(), q.get_nowait())] == [1, 2]


def test_putback_is_exempt_from_the_bound():
    q = _RowCountQueue()
    q.configure_bound(4, "shed-oldest")
    for i in range(4):
        q.put(i)
    q.putback(_block_item(100))
    assert q.rows_queued == 104
    assert q.rows_shed_total == 0
    assert q.get_nowait().rows == 100


def test_drain_rows_caps_rows_and_splits_an_overshooting_item():
    q = _RowCountQueue()
    q.put(_block_item(3, tag=0))
    q.put(_block_item(5, tag=1))
    out = q.drain_rows(6, slicer=lambda it, cut: (
        _block_item(cut, it.tag), _block_item(it.rows - cut, it.tag)))
    assert [(it.rows, it.tag) for it in out] == [(3, 0), (3, 1)]
    assert q.rows_queued == 2 and q.get_nowait().rows == 2


def test_bad_policy_rejected():
    with pytest.raises(ValueError):
        _RowCountQueue().configure_bound(8, "newest-first")


def test_backoff_is_jittered_and_capped():
    src = Source(restart_backoff=1.0)
    for restarts in (1, 3, 8, 200):
        ladder = min(1.0 * 2 ** min(restarts - 1, 12), Source.BACKOFF_CAP_S)
        samples = {src._backoff(RuntimeError(), restarts) for _ in range(32)}
        assert all(0.5 * ladder <= s <= ladder for s in samples)
    assert len({src._backoff(RuntimeError(), 4) for _ in range(32)}) > 1


def test_source_restarts_are_registry_state():
    class Flaky(Source):
        name = "flaky-test"

        def __init__(self, **kw):
            super().__init__(**kw)
            self.runs = 0

        def produce(self):
            self.runs += 1
            yield SimpleNamespace(rows=1)
            if self.runs < 3:
                raise ConnectionError("boom")

    src = Flaky(max_restarts=5, restart_backoff=0.001)
    src.start(lambda s: None)
    deadline = time.time() + 5.0
    while not src.exhausted and time.time() < deadline:
        time.sleep(0.01)
    src.stop()
    assert src.exhausted
    reg = _metrics.get_registry()
    assert reg.counter("source.restarts").snapshot() == 2
    assert reg.counter("source.flaky-test.restarts").snapshot() == 2


def test_shed_oldest_accounting_closes_under_a_burst():
    """shed-oldest: a source far ahead of a slow consumer loses rows, and
    every emitted row is either batched or counted as shed."""
    src = QueueSource()
    ssc = StreamingContext(batch_interval=0.02, max_queue_rows=8,
                           shed_policy="shed-oldest")
    seen = []

    def slow(batch, t):
        seen.append(batch.num_valid)
        time.sleep(0.01)

    ssc.source_stream(src, Featurizer(now_ms=0)).foreach_batch(slow)
    for i in range(200):
        src.push(rt(label=100 + i % 800))
    src.close()
    ssc.start()
    assert ssc.await_termination(timeout=20)
    ssc.stop()
    shed = _metrics.get_registry().counter("ingest.rows_shed").snapshot()
    assert shed > 0
    assert sum(seen) + shed == 200


# ---- config: the JAX package's flags, defaults and rules --------------------

PORT_KEYS = sorted(k for k in vars(ConfArguments()) if k not in ("appName", "backend"))


@pytest.mark.parametrize("key", PORT_KEYS)
def test_defaults_equal_the_jax_packages(key):
    """Every key the port takes defaults as in the JAX package. ``backend``
    is the one deliberate difference (cuda|cpu against auto|tpu|cpu)."""
    assert getattr(ConfArguments(), key) == getattr(JaxConf(), key)


@pytest.mark.parametrize("argv", [
    [], ["--seconds", "0"], ["--seconds", "3"], ["--wire", "ragged"],
    ["--seconds", "0", "--wire", "padded"], ["--seconds", "1", "--wire", "ragged"],
])
def test_effective_wire_follows_the_jax_rule(argv):
    assert ConfArguments().parse(argv).effective_wire() == JaxConf().parse(argv).effective_wire()


@pytest.mark.parametrize("argv", [
    ["--batchBucket", "256"], ["--batchBucket", "256", "--maxQueueRows", "1000"],
    ["--batchBucket", "256", "--maxQueueRows", "-1"], [],
])
def test_effective_max_queue_rows_resolution(argv):
    conf = ConfArguments().parse(argv)
    assert conf.effective_max_queue_rows() == JaxConf().parse(argv).effective_max_queue_rows()


def test_streaming_flags_parse_with_their_aliases():
    conf = ConfArguments().parse([
        "-s", "2", "-l", "http://lgn", "-w", "http://web", "--webTimeout", "0.25",
        "--replaySpeed", "3.5", "--tokenBucket", "64", "--maxQueueRows", "100",
        "--shedPolicy", "shed-oldest",
    ])
    assert (conf.seconds, conf.lightning, conf.twtweb, conf.webTimeout) == (
        2, "http://lgn", "http://web", 0.25)
    assert (conf.replaySpeed, conf.tokenBucket, conf.maxQueueRows, conf.shedPolicy) == (
        3.5, 64, 100, "shed-oldest")
    with pytest.raises(SystemExit):
        ConfArguments().parse(["--shedPolicy", "newest"])


# ---- the app --------------------------------------------------------------------

def test_app_lines_equal_the_jax_apps_on_the_replay_fixture(monkeypatch, capsys):
    """The port's app and the JAX app (``run``), each back to back at its
    defaults otherwise, print identical lines on the fixture."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    argv = ["--source", "replay", "--replayFile", DATA, "--seconds", "0",
            "--batchBucket", "4", "--backend", "cpu", *QUIET]
    totals, lines = run_port(argv)
    jax.devices()  # the conftest's backend, before local[1]
    jax_totals = jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert lines == jax_lines and len(lines) == 3
    assert (totals["count"], totals["batches"]) == (jax_totals["count"], jax_totals["batches"])


def test_e2e_linear_app_on_replay_under_a_wall_clock():
    totals, lines = run_port(["--source", "replay", "--replayFile", DATA, "--seconds", "1"])
    assert totals["count"] == 6
    assert totals["batches"] >= 1
    assert all(st["wire"] == "padded" and st["depth"] == 0 for st in totals["steps"])
    assert lines[-1].startswith("count: 6")


def test_app_block_policy_trains_every_row(tmp_path):
    path = tmp_path / "tweets.jsonl"
    write_replay(path, 8 * 16, seed=41)
    totals, _ = run_port(["--source", "replay", "--replayFile", str(path),
                          "--seconds", "0", "--batchBucket", "16", "--tokenBucket", "64",
                          "--maxQueueRows", "32"])
    assert totals["count"] == 8 * 16
    assert totals["batches"] == 8
    assert _metrics.get_registry().counter("ingest.rows_shed").snapshot() == 0


def test_app_records_each_batch_and_the_stream_window(tmp_path):
    path = tmp_path / "tweets.jsonl"
    write_replay(path, 5 * 16, seed=7)
    totals, lines = run_port(["--source", "replay", "--replayFile", str(path),
                              "--seconds", "0", "--batchBucket", "16"])
    assert len(lines) == len(totals["steps"]) == totals["batches"] == 5
    assert totals["stream_seconds"] > 0
    for st in totals["steps"]:
        assert st["wire"] == "ragged" and st["count"] == 16
        for key in ("featurize_ms", "dispatch_ms", "fetch_wait_ms", "step_ms",
                    "publish_ms", "pack_ms"):
            assert st[key] >= 0, key
        assert 0 <= st["depth"] < 8
        assert len(st["quality"]) == 19


def test_default_app_without_a_gpu_fails_before_publishing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        app.run(ConfArguments().parse(["--source", "synthetic", *QUIET]))


def test_synthetic_source_rate_paces_the_stream():
    src = SyntheticSource(total=20, rate=200.0, seed=1, base_ms=0)
    got = []
    t0 = time.perf_counter()
    src.start(got.append)
    deadline = time.time() + 5
    while not src.exhausted and time.time() < deadline:
        time.sleep(0.005)
    src.stop()
    assert len(got) == 20
    assert time.perf_counter() - t0 >= 19 / 200.0
