"""The port's runtime guards (``twtml_tpu_torch/apps/common.py``) against the
JAX package's: the divergence sentinel's cases of tests/test_sentinel.py;
the JAX app and the port's app on one poisoned corpus printing the same
lines and counting the same rollbacks, replays and fetches; a rollback with
batches in flight (fetches held pending, as tests/test_torch_fetch_pipeline.py
holds them); the recycler's exact resume in a subprocess; the model-watch
and freshness guards' forced saves; the intake queue's putback; and the
settings outside this slice failing loudly, naming their ROADMAP item."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest

from tools.bench_suite import _status_json
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.streaming import faults as jax_faults
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.apps.common import (
    DivergenceSentinel,
    FreshnessGuard,
    ModelWatchGuard,
    ProcessRecycler,
)
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.streaming import faults
from twtml_tpu_torch.streaming.context import _RowCountQueue
from twtml_tpu_torch.telemetry import freshness, lineage, modelwatch
from twtml_tpu_torch.telemetry import metrics as _metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSED = "http://127.0.0.1:9"
NOW_MS = "1785320000000"
COUNTERS = ("model.rollbacks", "model.nonfinite_batches", "model.rows_lost",
            "journal.replayed_rows", "journal.torn_tails", "fetch.aborts",
            "model.sentinel_aborts")


@pytest.fixture(autouse=True)
def clean_state():
    _metrics.reset_for_tests()
    faults.uninstall_chaos()
    jax_faults.uninstall_chaos()
    yield
    faults.uninstall_chaos()
    jax_faults.uninstall_chaos()
    freshness.reset_for_tests()
    _metrics.reset_for_tests()


def counters(registry=None):
    reg = (registry or _metrics).get_registry()
    return {k: int(reg.counter(k).snapshot()) for k in COUNTERS}


# ---- the sentinel's state machine (tests/test_sentinel.py) -----------------

def _out(mse=1.0, real=2.0, pred=3.0, count=16):
    return SimpleNamespace(mse=mse, real_stdev=real, pred_stdev=pred, count=count)


class _FakeCkpt:
    def __init__(self, meta=None):
        self.meta = meta
        self.calls = 0

    def rollback_to_verified(self):
        self.calls += 1
        return self.meta


class _FakeSsc:
    def __init__(self):
        self.aborted = False
        self.rollback_count_fn = None

    def request_abort(self, reason=""):
        self.aborted = True


class _FakeModel:
    def __init__(self):
        self.set_calls = []

    def set_initial_weights(self, w):
        self.set_calls.append(np.asarray(w))


def _sentinel(conf_args=(), ckpt=None, model=None):
    ssc = _FakeSsc()
    s = DivergenceSentinel(ConfArguments().parse(list(conf_args)),
                           model or _FakeModel(), ckpt or _FakeCkpt({"step": 7}), ssc)
    return s, ssc


def test_finite_batches_admit_and_cost_nothing_extra():
    s, _ = _sentinel()
    assert s.enabled
    assert all(s.admit(_out(), None) for _ in range(10))
    assert s.rollbacks == 0


def test_nonfinite_rolls_back_once_per_episode_and_skips_tainted():
    ckpt = _FakeCkpt({"step": 4})
    s, ssc = _sentinel(ckpt=ckpt)
    assert s.admit(_out(), None)
    assert not s.admit(_out(mse=float("nan")), None)
    assert not s.admit(_out(pred=float("inf")), None)
    assert not s.admit(_out(mse=float("nan")), None)
    assert ckpt.calls == 1 and s.rollbacks == 1
    assert s.admit(_out(), None)
    assert not s.admit(_out(real=float("nan")), None)
    assert ckpt.calls == 2 and not ssc.aborted
    assert counters() == dict.fromkeys(COUNTERS, 0) | {
        "model.rollbacks": 2, "model.nonfinite_batches": 4, "model.rows_lost": 4 * 16}


def test_no_verified_checkpoint_resets_to_initial_zeros():
    model = _FakeModel()
    s, _ = _sentinel(ckpt=_FakeCkpt(None), model=model)
    assert not s.admit(_out(mse=float("nan")), None)
    (w,) = model.set_calls
    assert w.shape == (1000 + 4,) and not w.any()


def test_rollback_storm_aborts_via_request_abort():
    s, ssc = _sentinel(["--sentinelRollbacks", "2", "--sentinelWindow", "100"])
    assert not s.admit(_out(mse=float("nan")), None)
    assert s.admit(_out(), None)
    assert not ssc.aborted
    assert not s.admit(_out(mse=float("nan")), None)
    assert ssc.aborted
    assert counters()["model.sentinel_aborts"] == 1


def test_rollbacks_outside_the_window_do_not_abort():
    s, ssc = _sentinel(["--sentinelRollbacks", "2", "--sentinelWindow", "3"])
    assert not s.admit(_out(mse=float("nan")), None)
    for _ in range(5):
        assert s.admit(_out(), None)
    assert not s.admit(_out(mse=float("nan")), None)
    assert not ssc.aborted and s.rollbacks == 2


def test_sentinel_off_is_inert():
    s, ssc = _sentinel(["--sentinel", "off"])
    assert not s.enabled and ssc.rollback_count_fn is None


def test_rollback_count_rides_the_ssc_hook():
    s, ssc = _sentinel()
    assert ssc.rollback_count_fn() == 0
    s.admit(_out(mse=float("nan")), None)
    assert ssc.rollback_count_fn() == 1


@pytest.mark.parametrize("case", ["finite", "nan_label", "nan_weights", "inf_pred"])
def test_verdict_equals_the_jax_sentinels(case):
    from twtml_tpu.apps.common import DivergenceSentinel as JaxSentinel

    out = {"finite": _out(), "nan_label": _out(mse=float("nan"), real=float("nan")),
           "nan_weights": _out(pred=float("nan")), "inf_pred": _out(pred=float("inf"))}[case]
    assert DivergenceSentinel._finite(out) == JaxSentinel._finite(out)


# ---- end to end ---------------------------------------------------------------

def _corpus(path, total, seed):
    with open(path, "w") as fh:
        for s in JaxSynthetic(total=total, seed=seed, base_ms=int(NOW_MS)).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")


BASE = ["--source", "replay", "--seconds", "0", "--backend", "cpu",
        "--batchBucket", "16", "--tokenBucket", "64", "--history", "off",
        "--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


class _Delayed:
    """A host fetch that completes ``delay`` seconds after it started."""

    def __init__(self, inner, delay):
        self.inner, self.at = inner, time.monotonic() + delay

    def done(self):
        return time.monotonic() >= self.at

    def wait(self):
        while not self.done():
            time.sleep(0.001)

    def result(self):
        return self.inner.result()


@contextlib.contextmanager
def counted_fetches(hold=None):
    """Count the host fetches the pipeline starts (the warm-up's is the
    first); ``hold`` {fetch number: seconds} keeps those pending."""
    calls = {"n": 0}
    base = StreamingLinearRegressionWithSGD.fetch_output

    def fetch(out):
        calls["n"] += 1
        got = base(out)
        delay = (hold or {}).get(calls["n"] - 1)
        return _Delayed(got, delay) if delay else got

    with mock.patch.object(StreamingLinearRegressionWithSGD, "fetch_output",
                           staticmethod(fetch)):
        yield calls


def port_run(argv, max_batches=0, hold=None):
    out = io.StringIO()
    with counted_fetches(hold) as calls, contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv), max_batches=max_batches)
    return totals, out.getvalue().splitlines(), calls["n"] - 1


def jax_run(argv, capsys):
    """The JAX app (``--master local[1]``) with its ``jax.device_get``s
    counted, as tests/test_sentinel.py counts them."""
    from twtml_tpu.apps import linear_regression as jax_app

    jax.devices()
    jax_metrics.reset_for_tests()
    calls = {"n": 0}
    real = jax.device_get

    def counting(x):
        calls["n"] += 1
        return real(x)

    capsys.readouterr()
    jax.device_get = counting
    try:
        totals = jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]))
    finally:
        jax.device_get = real
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    return totals, lines, calls["n"]


def test_poisoned_run_equals_the_jax_apps_and_the_clean_run(tmp_path, monkeypatch, capsys):
    """THE acceptance case on the CPU: batch 5 of 8 poisoned
    (``source.nan@5``), a checkpoint every batch. Both apps print the same
    lines and count 1 rollback, 0 rows lost, 16 rows replayed and 9 fetches;
    the port's poisoned run is bitwise equal to its clean run, and within
    the learners' 2e-3 of the JAX app's weights."""
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 8 * 16, seed=51)
    poisoned = ["--replayFile", str(corpus), "--checkpointEvery", "1",
                "--chaos", "source.nan@5"]
    totals, lines, fetches = port_run(BASE + poisoned + ["--checkpointDir",
                                                         str(tmp_path / "port")])
    ours = counters()
    jax_totals, jax_lines, jax_fetches = jax_run(
        BASE + poisoned + ["--checkpointDir", str(tmp_path / "jax")], capsys)
    theirs = counters(jax_metrics)
    assert lines == jax_lines and len(lines) == 8
    assert ours == theirs == dict.fromkeys(COUNTERS, 0) | {
        "model.rollbacks": 1, "model.nonfinite_batches": 1, "journal.replayed_rows": 16}
    assert fetches == jax_fetches == 9
    assert (totals["count"], totals["batches"]) == (
        jax_totals["count"], jax_totals["batches"]) == (8 * 16, 8)

    faults.uninstall_chaos()
    clean_totals, clean_lines, clean_fetches = port_run(
        BASE + ["--replayFile", str(corpus), "--checkpointEvery", "1",
                "--checkpointDir", str(tmp_path / "clean")])
    assert clean_lines == lines and clean_fetches == 8
    w_p, meta_p = Checkpointer(str(tmp_path / "port")).restore()
    w_c, meta_c = Checkpointer(str(tmp_path / "clean")).restore()
    np.testing.assert_array_equal(w_p, w_c)
    assert meta_p["count"] == meta_c["count"] == 8 * 16
    w_j, _ = Checkpointer(str(tmp_path / "jax")).restore()
    np.testing.assert_allclose(w_p, w_j, rtol=2e-3, atol=2e-3)


def test_sentinel_adds_no_fetch(tmp_path):
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 4 * 16, seed=52)
    on = port_run(BASE + ["--replayFile", str(corpus)])
    _metrics.reset_for_tests()
    off = port_run(BASE + ["--replayFile", str(corpus), "--sentinel", "off"])
    assert on[0]["count"] == off[0]["count"] == 4 * 16
    assert on[2] == off[2] == 4


def test_without_a_checkpoint_the_model_resets_and_trains_on(tmp_path):
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 8 * 16, seed=53)
    totals, _, _ = port_run(BASE + ["--replayFile", str(corpus), "--chaos",
                                    "source.nan@5"])
    got = counters()
    assert got["model.rollbacks"] == 1 and got["model.sentinel_aborts"] == 0
    lost = got["model.rows_lost"]
    assert lost >= 16 and lost % 16 == 0
    assert totals["count"] == 8 * 16 - lost and totals["batches"] == totals["count"] // 16
    assert all(np.isfinite(totals["steps"][-1][k]) for k in ("mse", "pred_stdev"))


def test_rollback_storm_aborts_with_a_finite_checkpoint_and_a_bundle(tmp_path):
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 8 * 16, seed=54)
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="runtime guard"):
        port_run(BASE + ["--replayFile", str(corpus), "--checkpointDir", str(ck),
                         "--checkpointEvery", "1", "--chaos", "source.nan@2",
                         "--sentinelRollbacks", "2", "--sentinelWindow", "100"])
    got = counters()
    assert (got["model.rollbacks"], got["model.sentinel_aborts"]) == (2, 1)
    state, meta = Checkpointer(str(ck)).restore()
    assert np.isfinite(state).all()
    (bundle,) = [p for p in os.listdir(tmp_path) if p.startswith("postmortem.p0.")]
    with open(tmp_path / bundle) as fh:
        data = json.load(fh)
    assert data["notes"]["last_checkpoint"]["step"] == meta["step"]
    assert data["reason"] == "divergence sentinel rollback budget"
    assert [e["kind"] for e in data["events"]].count("sentinel_rollback") == 2


def test_rollback_with_batches_in_flight(tmp_path):
    """Batch 7 of 8 poisoned, a checkpoint every 4, batch 7's fetch held
    pending so batch 8 dispatches against the poisoned weights: one
    rollback for the episode, batch 8 drains as a tainted skip, every skip
    refunds its cap slot, the journal replays batches 5-8 once, every
    lineage record and journal token pops in dispatch order, and the run
    ends bitwise equal to the clean run with the cursor at the last row."""
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 8 * 16, seed=55)
    argv = BASE + ["--replayFile", str(corpus), "--checkpointEvery", "4"]
    clean, clean_lines, _ = port_run(argv + ["--checkpointDir", str(tmp_path / "c")])
    _metrics.reset_for_tests()
    totals, lines, fetches = port_run(
        argv + ["--checkpointDir", str(tmp_path / "p"), "--chaos", "source.nan@7"],
        max_batches=8, hold={7: 0.5})
    got = counters()
    assert got == dict.fromkeys(COUNTERS, 0) | {
        "model.rollbacks": 1, "model.nonfinite_batches": 2,
        "journal.replayed_rows": 4 * 16}
    reg = _metrics.get_registry()
    assert reg.counter("fetch.refunds").snapshot() == 2
    assert fetches == 8 + 4  # batches 1-8 and the replayed 5-8
    assert (totals["count"], totals["batches"]) == (8 * 16, 8)
    assert lines == clean_lines[:6] + clean_lines[4:]
    assert lineage.depths() == (0, 0)  # every record popped
    w_p, meta_p = Checkpointer(str(tmp_path / "p")).restore()
    w_c, _ = Checkpointer(str(tmp_path / "c")).restore()
    np.testing.assert_array_equal(w_p, w_c)
    assert meta_p["journal"] == {"cursor": 8, "rows": 8 * 16}  # the replay appended nothing
    # the freshness plane saw every delivery: 8 + the tainted one + 4 replays - 1
    assert freshness.last_freshness()["batches"] == fetches


def test_a_batch_featurized_before_a_rollback_is_dropped_for_the_replay(tmp_path):
    """Batch 7 poisoned and delivered before batch 8 dispatches (nothing in
    flight): batch 8, already past the journal's seam, must not train on
    the restored weights, since the replay brings its rows back."""
    corpus = tmp_path / "tweets.jsonl"
    _corpus(corpus, 8 * 16, seed=56)
    argv = BASE + ["--replayFile", str(corpus), "--checkpointEvery", "4"]
    _, clean_lines, _ = port_run(argv + ["--checkpointDir", str(tmp_path / "c")])
    _metrics.reset_for_tests()
    totals, lines, fetches = port_run(
        argv + ["--checkpointDir", str(tmp_path / "p"), "--chaos", "source.nan@7"])
    assert counters()["model.nonfinite_batches"] == 1
    assert fetches == 7 + 4
    assert (totals["count"], totals["batches"]) == (8 * 16, 8)
    assert lines == clean_lines[:6] + clean_lines[4:]
    np.testing.assert_array_equal(Checkpointer(str(tmp_path / "p")).restore()[0],
                                  Checkpointer(str(tmp_path / "c")).restore()[0])


def test_recycle_resumes_bit_identically(tmp_path):
    replay = tmp_path / "tweets.jsonl"
    _corpus(replay, 96, seed=11)
    env = dict(os.environ, PYTHONPATH=REPO, TWTML_RECYCLE_MAX="1",
               TWTML_RECYCLE_SAMPLE_EVERY="1", TWTML_NOW_MS=NOW_MS)
    env.pop("TWTML_RECYCLES", None)

    def launch(ckdir, *extra):
        return subprocess.run(
            [sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression",
             *BASE, "--replayFile", str(replay), "--checkpointDir", str(ckdir), *extra],
            capture_output=True, text=True, timeout=300, env=env, cwd=REPO)

    proc = launch(tmp_path / "ck", "--recycleAfterMb", "1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    recycles = re.findall(r"checkpointed at batch (\d+) \(count=(\d+), state crc "
                          r"([0-9a-f]+)\) and re-exec'ing", proc.stderr)
    resumes = re.findall(r"resumed from checkpoint step \d+ \(count=(\d+), state crc "
                         r"([0-9a-f]+)\)", proc.stderr)
    assert len(recycles) == 1 and len(resumes) == 1, proc.stderr[-3000:]
    assert resumes[0] == recycles[0][1:]
    boots = re.findall(r"journal: boot resume — (\d+) journaled row\(s\), (\d+) "
                       r"fast-forwarded", proc.stderr)
    assert len(boots) == 1 and boots[0][0] == boots[0][1]
    stats = [ln for ln in proc.stdout.splitlines() if ln.startswith("count:")]
    assert int(re.findall(r"count: (\d+)", stats[-1])[0]) == 96
    control = launch(tmp_path / "ctrl")
    assert control.returncode == 0, control.stderr[-3000:]
    w, meta = Checkpointer(str(tmp_path / "ck")).restore()
    w_ctrl, meta_ctrl = Checkpointer(str(tmp_path / "ctrl")).restore()
    assert meta["count"] == meta_ctrl["count"] == 96
    np.testing.assert_array_equal(w, w_ctrl)


def test_recycle_needs_a_checkpoint_dir():
    conf = ConfArguments().parse(["--recycleAfterMb", "1024"])
    with pytest.raises(SystemExit, match="--checkpointDir"):
        ProcessRecycler(conf, ckpt=None, totals={"count": 0, "batches": 0})


# ---- the forced-save guards ----------------------------------------------------

class _SaveCounter:
    def __init__(self):
        self.saves = 0

    def save_now(self, totals):
        self.saves += 1
        return True


def test_model_watch_alert_forces_one_save_an_episode():
    modelwatch.reset_for_tests()
    ckpt = _SaveCounter()
    guard = ModelWatchGuard(ConfArguments().parse(["--modelWatchWindow", "3"]), ckpt,
                            {"batches": 0})
    q = np.full(19, np.nan)
    for i in range(6):
        guard.observe(SimpleNamespace(quality=q, count=16.0, mse=1.0), at_boundary=True)
    assert ckpt.saves == 1  # alert held from the 3rd batch; one save an episode
    assert _metrics.get_registry().counter("model.alert_checkpoints").snapshot() == 1
    modelwatch.reset_for_tests()


def test_freshness_breach_forces_one_save_an_episode(monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    freshness.configure(on=True, slo_ms=10.0, window=2)
    ckpt = _SaveCounter()
    guard = FreshnessGuard(ConfArguments(), ckpt, {"batches": 0})
    stale = [SimpleNamespace(created_at_ms=int(NOW_MS) - 60_000)]
    for _ in range(4):
        lineage.open_batch(stale)
        lineage.mark_dispatch()
        guard.observe(None, at_boundary=True)
    assert ckpt.saves == 1
    assert _metrics.get_registry().counter("freshness.slo_breaches").snapshot() == 1


# ---- the intake queue's putback -------------------------------------------------

def _item(rows, tag):
    return SimpleNamespace(rows=rows, tag=tag)


def test_put_back_rows_are_counted_and_never_shed():
    q = _RowCountQueue()
    q.configure_bound(4, "shed-oldest")
    q.put(_item(2, "a"))
    q.putback(_item(3, "replayed"))
    assert q.rows_queued == 5
    q.put(_item(2, "b"))  # over the bound: only the admitted "a" may go
    assert [i.tag for i in q.queue] == ["replayed", "b"]
    assert q.rows_queued == 5 and q.rows_shed_total == 2
    assert [i.tag for i in q.drain_rows()] == ["replayed", "b"]
    q.put(_item(3, "c"))
    q.put(_item(3, "d"))  # nothing put back any more: the oldest sheds
    assert [i.tag for i in q.queue] == ["d"]


# ---- settings outside this slice -------------------------------------------------

def test_history_resolving_on_raises_naming_the_historian(tmp_path):
    conf = ConfArguments().parse(["--backend", "cpu", "--checkpointDir", str(tmp_path)])
    assert conf.effective_history()
    with pytest.raises(NotImplementedError, match="historian.*--history off"):
        app.run(conf)


@pytest.mark.parametrize("spec", ["peer.kill:tick=3", "peer.pause@2", "fetch:error@3,peer.kill"])
def test_peer_chaos_raises_naming_the_roadmap_item(spec):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        faults.install_chaos(spec)


@pytest.mark.parametrize("argv", [
    [], ["--checkpointDir", "/x"], ["--checkpointDir", "/x", "--journal", "off"],
    ["--journal", "on"], ["--history", "on"], ["--checkpointDir", "/x", "--history", "off"],
])
def test_effective_journal_and_history_follow_the_jax_rule(argv):
    ours, theirs = ConfArguments().parse(argv), JaxConf().parse(argv)
    assert ours.effective_journal() == theirs.effective_journal()
    assert ours.effective_history() == theirs.effective_history()


@pytest.mark.parametrize("argv", [
    ["--journal", "maybe"], ["--journalMaxMb", "0"], ["--sentinel", "yes"],
    ["--blackbox", "1"], ["--freshness", "x"], ["--freshnessSloMs", "-1"],
    ["--history", "sometimes"],
])
def test_bad_guard_flags_print_usage_and_exit_1(argv):
    with pytest.raises(SystemExit) as exc:
        ConfArguments().parse(argv)
    assert exc.value.code == 1
    with pytest.raises(SystemExit) as exc:
        JaxConf().parse(argv)
    assert exc.value.code != 0
