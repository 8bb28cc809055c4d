"""The port's flight recorder, tracer and fault injector
(``twtml_tpu_torch/telemetry/blackbox.py``, ``trace.py``,
``streaming/faults.py``) against the JAX package's: the bundle and the trace
file are what the JAX package's own readers (tools/postmortem_report.py,
tools/trace_report.py) accept; the abort funnel and SIGTERM dump once; the
app's trace carries the JAX stage names; the chaos grammar parses and fires
as the JAX package's, and its injections drive the fetch watchdog, the
breaker, the supervision and the sentinel end to end."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tools import postmortem_report, trace_report
from twtml_tpu.streaming import faults as jax_faults
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.batch import RaggedUnitBatch, UnitBatch
from twtml_tpu_torch.features.featurizer import Status
from twtml_tpu_torch.streaming import faults
from twtml_tpu_torch.streaming.context import StreamingContext
from twtml_tpu_torch.streaming.sources import QueueSource, Source
from twtml_tpu_torch.telemetry import blackbox, trace
from twtml_tpu_torch.telemetry import metrics as _metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
CLOSED = "http://127.0.0.1:9"
QUIET = ["--backend", "cpu", "--lightning", CLOSED, "--twtweb", CLOSED,
         "--webTimeout", "0.2"]


@pytest.fixture(autouse=True)
def clean_state():
    _metrics.reset_for_tests()
    faults.uninstall_chaos()
    yield
    faults.uninstall_chaos()
    blackbox.uninstall()
    trace.uninstall()
    _metrics.reset_for_tests()


def run_app(argv, max_batches=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse([*QUIET, *argv]), max_batches=max_batches)
    return totals, out.getvalue().splitlines()


# ---- the flight recorder -----------------------------------------------------

def test_bundle_passes_the_jax_packages_report(tmp_path, capsys):
    rec = blackbox.install(config={"seconds": 0}, out_dir=str(tmp_path))
    blackbox.note("last_checkpoint", {"step": 4, "count": 64})
    blackbox.record("sentinel_rollback", delivered=5, episode=1)
    blackbox.record("payload", value=np.float32(1.5), arr=np.arange(3))
    path = blackbox.abort_dump("divergence sentinel rollback budget")
    assert path == rec.last_dump_path == str(tmp_path / f"postmortem.p0.{os.getpid()}.json")
    with open(path) as fh:
        bundle = json.load(fh)
    assert set(blackbox.REQUIRED_KEYS) <= set(bundle)
    assert bundle["notes"]["last_checkpoint"] == {"step": 4, "count": 64}
    assert [e["kind"] for e in bundle["events"]] == ["sentinel_rollback", "payload", "abort"]
    assert bundle["events"][1]["arr"] == [0, 1, 2]
    assert postmortem_report.main([path]) == 0
    capsys.readouterr()


def test_one_bundle_a_process_unless_forced(tmp_path):
    blackbox.install(out_dir=str(tmp_path))
    first = blackbox.abort_dump("first")
    os.unlink(first)
    assert blackbox.dump("second") == first and not os.path.exists(first)
    assert blackbox.dump("forced", force=True) == first and os.path.exists(first)


def test_ring_is_bounded_and_counts_drops(tmp_path):
    rec = blackbox.install(out_dir=str(tmp_path), capacity=4)
    for i in range(10):
        blackbox.record("tick", i=i)
    bundle = rec.bundle("x")
    assert [e["i"] for e in bundle["events"]] == [6, 7, 8, 9]
    assert bundle["events_dropped"] == 6


def test_recording_without_a_recorder_is_a_no_op():
    blackbox.uninstall()
    blackbox.record("tick")
    blackbox.note("k", 1)
    assert blackbox.abort_dump("x") is None and blackbox.last_dump_path() is None


def test_request_abort_dumps_through_the_funnel(tmp_path):
    blackbox.install(out_dir=str(tmp_path))
    ssc = StreamingContext(batch_interval=0)
    ssc.request_abort("fetch watchdog")
    assert ssc.failed and ssc.stop_requested
    with open(blackbox.last_dump_path()) as fh:
        assert json.load(fh)["reason"] == "fetch watchdog"


def test_install_follows_the_flags(tmp_path):
    from twtml_tpu_torch.apps.common import install_blackbox

    install_blackbox(ConfArguments().parse(["--checkpointDir", str(tmp_path / "ck")]))
    rec = blackbox.get()
    assert rec.out_dir == str(tmp_path) and rec.config["checkpointDir"] == str(tmp_path / "ck")
    install_blackbox(ConfArguments().parse(["--blackbox", "off"]))
    assert blackbox.get() is None


_SIGTERM = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from twtml_tpu_torch.telemetry import blackbox
blackbox.install(out_dir={out!r})
assert blackbox.install_signal_handler()
blackbox.record("tick", i=1)
os.kill(os.getpid(), signal.SIGTERM)
"""


def test_sigterm_dumps_then_terminates(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _SIGTERM.format(repo=REPO, out=str(tmp_path))],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM, proc.stderr
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "SIGTERM"
    assert [e["kind"] for e in bundle["events"]] == ["tick", "sigterm"]


def test_signal_handler_off_the_main_thread_is_refused(monkeypatch):
    import threading

    monkeypatch.setattr(blackbox, "_SIGTERM_INSTALLED", False)
    got = []
    t = threading.Thread(target=lambda: got.append(blackbox.install_signal_handler()))
    t.start()
    t.join()
    assert got == [False] and not blackbox._SIGTERM_INSTALLED


# ---- the tracer ------------------------------------------------------------------

def test_trace_file_passes_the_jax_packages_report(tmp_path, capsys):
    path = str(tmp_path / "run.trace")
    tr = trace.install(path)
    with tr.span("featurize", items=3) as sp:
        sp.add(rows=4)
    tr.complete("fetch", 1.0, 0.002, depth=8)
    tr.instant("sentinel_rollback", delivered=5)
    tr.counter("depth", value=3)
    trace.uninstall()
    assert trace_report.main([path]) == 0
    capsys.readouterr()
    with open(path) as fh:
        lines = fh.read().splitlines()
    events = [json.loads(ln.rstrip(",")) for ln in lines[1:]]
    assert [e["ph"] for e in events] == ["M", "X", "X", "i", "C"]
    assert events[1]["args"] == {"items": 3, "rows": 4}


def test_trace_rotates_and_counts_dropped_events(tmp_path):
    path = str(tmp_path / "run.trace")
    tr = trace.install(path, max_bytes=400)
    for i in range(40):
        tr.instant("tick", i=i)
    trace.uninstall()
    assert os.path.exists(path + ".1")
    assert _metrics.get_registry().counter("trace.dropped_events").snapshot() > 0


def test_null_tracer_is_inert():
    tr = trace.get()
    assert not tr.enabled
    with tr.span("x") as sp:
        sp.add(a=1)
    tr.complete("x", 0.0, 1.0)


def test_trace_events_reach_the_flight_recorder(tmp_path):
    rec = blackbox.install(out_dir=str(tmp_path))
    tr = trace.install(str(tmp_path / "t.trace"))
    tr.complete("dispatch", 0.0, 0.003, depth=2)
    tr.counter("depth", value=1)
    (event,) = rec.bundle("x")["events"]
    assert event["kind"] == "span" and event["name"] == "dispatch" and event["depth"] == 2


def test_app_trace_has_the_jax_stage_names(tmp_path):
    path = str(tmp_path / "app.trace")
    run_app(["--source", "replay", "--replayFile", DATA, "--seconds", "0",
             "--batchBucket", "4", "--trace", path])
    with open(path) as fh:
        names = {json.loads(ln.rstrip(","))["name"] for ln in fh.read().splitlines()[1:]}
    assert {"source_read", "featurize", "wire_pack", "dispatch", "fetch",
            "stats_publish"} <= names
    assert set(trace.STAGES) - names == {"parse"}  # object parse is untraced
    assert not trace.get().enabled  # the run closed its tracer


# ---- the fault injector -----------------------------------------------------

SPECS = ["fetch:delay=0.001@3", "step:error@p0.5,seed=7", "web:stall=0.001@from4",
         "source.nan@5", "source.burst:rows=2@p0.3,seed=3", "source.garbage",
         "fetch:error@2,web:error@3,source.nan@4"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_parses_and_fires_as_the_jax_packages(spec):
    ours, theirs = faults.ChaosInjector(spec), jax_faults.ChaosInjector(spec)
    assert ({t: [repr(r) for r in rs] for t, rs in ours._rules.items()}
            == {t: [repr(r) for r in rs] for t, rs in theirs._rules.items()})
    for target in ("fetch", "step", "web", "source.nan", "source.burst"):
        for _ in range(12):
            if target.startswith("source."):
                assert ours.should(target) == theirs.should(target)
                continue
            fired = []
            for inj in (ours, theirs):
                try:
                    inj.perturb(target)
                    fired.append(None)
                except (faults.InjectedFault, jax_faults.InjectedFault):
                    fired.append("error")
            assert fired[0] == fired[1]


@pytest.mark.parametrize("spec", ["nope:error", "fetch:explode", "fetch:delay=-1",
                                  "source.nan:rows=2", "source.burst:rows=0",
                                  "fetch:error@p2", "fetch:error@0", "seed=3"])
def test_bad_chaos_specs_are_refused_as_by_the_jax_package(spec):
    with pytest.raises(ValueError):
        faults.ChaosInjector(spec)
    with pytest.raises(ValueError):
        jax_faults.ChaosInjector(spec)


def test_bad_chaos_flag_exits(tmp_path):
    with pytest.raises(SystemExit, match="bad --chaos spec"):
        run_app(["--source", "replay", "--replayFile", DATA, "--seconds", "0",
                 "--chaos", "fetch:explode"])


def test_poison_labels_on_both_wires_keeps_padding_and_the_lease():
    faults.install_chaos("source.nan")
    label = np.array([500.0, 600.0, 0.0], np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    units = UnitBatch(np.zeros((3, 4), np.uint8), np.zeros(3, np.int32),
                      np.zeros((3, 4), np.float32), label, mask)
    got = faults.maybe_poison_labels(units)
    assert np.isnan(got.label[:2]).all() and got.label[2] == 0 and label[0] == 500.0
    lease = SimpleNamespace(tag="lease")
    ragged = RaggedUnitBatch(np.zeros(4, np.uint8), np.zeros(4, np.int32),
                             np.zeros((3, 4), np.float32), label, mask, row_len=4,
                             lease=lease)
    got = faults.maybe_poison_labels(ragged)
    assert got is ragged and got.lease is lease and np.isnan(got.label[:2]).all()
    assert label[1] == 600.0  # the batch's own array is not written


def test_burst_reemits_tweets_from_the_source_loop():
    faults.install_chaos("source.burst:rows=2@2")
    src = QueueSource()
    for i in range(4):
        src.push(Status(text=f"t{i}", id=i))
    src.close()
    got = []
    src.start(got.append)
    src._thread.join(timeout=10)
    assert [s.id for s in got] == [0, 1, 1, 1, 2, 3, 3, 3]


class _Counting(Source):
    name = "counting"

    def __init__(self, n, **kw):
        super().__init__(**kw)
        self.n = n

    def produce(self):
        for i in range(self.n):
            yield Status(text=f"t{i}", id=i)


def test_fault_injecting_source_crashes_every_n_tweets():
    src = faults.FaultInjectingSource(_Counting(10), crash_every=4, max_crashes=2)
    got = []
    src.start(got.append)
    src._thread.join(timeout=10)
    assert src.crashes == 2
    assert len(got) == 3 + 3 + 10  # the crossing tweet is lost in flight, twice
    assert _metrics.get_registry().counter("source.restarts").snapshot() == 2


def test_fetch_error_is_retried_by_the_watchdog():
    totals, lines = run_app(["--source", "replay", "--replayFile", DATA, "--seconds", "0",
                             "--batchBucket", "4", "--chaos", "fetch:error@2"])
    reg = _metrics.get_registry()
    assert totals["count"] == 6 and len(lines) == 3
    assert reg.counter("fetch.retries").snapshot() >= 1
    assert reg.counter("chaos.fetch.errors").snapshot() >= 1
    assert reg.counter("fetch.aborts").snapshot() == 0


def test_web_errors_are_counted_by_the_breaker():
    run_app(["--source", "replay", "--replayFile", DATA, "--seconds", "0",
             "--batchBucket", "4", "--chaos", "web:error"])
    assert _metrics.get_registry().counter("chaos.web.errors").snapshot() >= 1


def test_step_error_fails_that_batch_only(caplog):
    totals, lines = run_app(["--source", "replay", "--replayFile", DATA, "--seconds", "0",
                             "--batchBucket", "4", "--chaos", "step:error@2"])
    assert len(lines) == 2 and totals["batches"] == 2
    assert any("failed" in r.getMessage() for r in caplog.records)
    from twtml_tpu_torch.telemetry import lineage

    assert lineage.depths() == (0, 0)  # the failed batch's record went with it


def test_fault_every_wraps_the_source():
    from twtml_tpu_torch.apps.common import build_source

    src = build_source(ConfArguments().parse(["--source", "replay", "--replayFile", DATA,
                                              "--faultEvery", "3"]))
    assert isinstance(src, faults.FaultInjectingSource)
    assert (src.crash_every, src.max_crashes) == (3, 3)
