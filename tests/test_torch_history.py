"""The port's telemetry historian (``twtml_tpu_torch/telemetry/historian.py``)
on the CPU: the cases of ``tests/test_history.py`` against the port, and the
JAX package's historian as the oracle of its format.

- frames, restart continuity, torn tails, rotation and the disk ceiling;
- a killed run's leftovers rebuild the phase intervals and the RSS slope,
  and the JAX package's ``tools/history_report.py`` reads them;
- the perfGuard baseline round trip, episodes and the noise floor;
- the ``History`` view, the flight recorder's history tail and its
  post-mortem rendering;
- segments byte-equal in both directions: for the same records and
  samples both packages write the same bytes, and each reads and appends
  to the other's directory;
- the app: a checkpointed run at the defaults (``--history auto``) writes
  segments, fetches once a batch as with ``--history off``, and lands
  bitwise-equal weights; ``--history on`` without a checkpoint directory
  refuses; the resolution and validation of the flags; run ids shared
  with the JAX package.
"""

import contextlib
import io
import json
import os
import struct
from unittest import mock

import numpy as np
import pytest

from tools import history_report, postmortem_report
from tools.bench_suite import _status_json
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.telemetry import historian as JH
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry import sideband as jax_sideband
from twtml_tpu.utils import runid as jax_runid
from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.telemetry import blackbox as blackbox_mod
from twtml_tpu_torch.telemetry import historian as H
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.telemetry import sideband as _sideband
from twtml_tpu_torch.telemetry.api_types import History, decode, encode
from twtml_tpu_torch.utils import runid

NOW_MS = 1785320000000
CLOSED = "http://127.0.0.1:9"


@pytest.fixture(autouse=True)
def _fresh_state():
    for mod in (_metrics, _sideband, H, jax_metrics, jax_sideband, JH):
        mod.reset_for_tests()
    yield
    for mod in (H, JH, _metrics, _sideband, jax_metrics, jax_sideband):
        mod.reset_for_tests()


class _Clock:
    """Drives the TWTML_NOW_MS seam sample by sample."""

    def __init__(self, monkeypatch, t0=NOW_MS):
        self._mp = monkeypatch
        self.set(t0)

    def set(self, t_ms):
        self.t = t_ms
        self._mp.setenv("TWTML_NOW_MS", str(int(t_ms)))

    def tick(self, dt_ms=60000):
        self.set(self.t + dt_ms)


def _seed_stages(monkeypatch, *modules):
    """A driveable cumulative stage clock for each sideband module given."""
    cum = {}
    for mod in modules or (_sideband,):
        monkeypatch.setattr(mod, "stage_seconds", lambda: dict(cum))
    return cum


def _seed_rss(monkeypatch):
    import twtml_tpu.utils.rss as jax_rss
    import twtml_tpu_torch.utils.rss as rss_mod

    box = {"mb": 100.0}
    monkeypatch.setattr(rss_mod, "rss_mb", lambda: box["mb"])
    monkeypatch.setattr(jax_rss, "rss_mb", lambda: box["mb"])
    return box


def _flip_phase(phase, t_s, metrics=_metrics):
    mon = metrics.get_health_monitor()
    with mon._lock:
        mon.phase = phase
        mon.transitions.append((t_s, phase))


def _segment_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d)) if name.endswith(".twh")}


# ---- durability: frames, restart continuity, torn tails, the ceiling ---------

def test_frame_roundtrip_and_restart_continuity(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    d = str(tmp_path / "hist")
    H.configure(d, run_id=1, fingerprint="aaa111")
    for _ in range(3):
        clock.tick()
        H.sample()
    H.uninstall()
    recs = H.read_series(d)
    assert [r["k"] for r in recs] == ["r", "s", "s", "s"]
    assert recs[0]["run_id"] == 1 and recs[0]["fingerprint"] == "aaa111"
    assert [r["seq"] for r in recs if r["k"] == "s"] == [1, 2, 3]
    h2 = H.configure(d, run_id=2, fingerprint="bbb222")
    assert h2.next_seq == 5  # 4 recovered records + this run's header
    clock.tick()
    H.sample()
    H.uninstall()
    recs = H.read_series(d)
    assert [r["run_id"] for r in recs if r["k"] == "r"] == [1, 2]
    assert len([r for r in recs if r["k"] == "s"]) == 4


def test_torn_tail_truncates_loudly_and_reader_skips_it(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    d = str(tmp_path / "hist")
    H.configure(d, run_id=1)
    for _ in range(3):
        clock.tick()
        H.sample()
    H.uninstall()
    (seg,) = [p for p in os.listdir(d) if p.endswith(".twh")]
    path = os.path.join(d, seg)
    good_size = os.path.getsize(path)
    with open(path, "ab") as fh:  # a kill mid-append: torn mid-payload
        fh.write(H.MAGIC + struct.pack("<II", 500, 12345) + b"partial")
    assert len(H.read_series(d)) == 4
    H.configure(d, run_id=2)
    assert _metrics.get_registry().counter("history.torn_tails").snapshot() == 1
    assert os.path.getsize(path) == good_size
    clock.tick()
    H.sample()
    H.uninstall()
    assert [r["k"] for r in H.read_series(d)] == ["r", "s", "s", "s", "r", "s"]


def test_segment_rotation_and_disk_ceiling(tmp_path):
    d = str(tmp_path / "hist")
    h = H.configure(d, max_mb=1)  # segment_bytes = 256 KB
    assert h.segment_bytes == 256 * 1024
    pad = "x" * 20000
    for i in range(80):  # ~1.6 MB of records through a 1 MB ceiling
        h._write({"k": "s", "t_ms": NOW_MS + i, "rss_mb": 1.0, "pad": pad})
    reg = _metrics.get_registry()
    assert reg.counter("history.segments_dropped").snapshot() >= 1
    assert h.disk_bytes() <= h.max_bytes + h.segment_bytes
    segs = h._segments()
    assert len(segs) >= 2 and segs[0][0] > 0  # rotated; the oldest dropped
    assert reg.gauge("history.disk_mb").snapshot() > 0
    assert H.read_series(d)
    H.uninstall()


def test_killed_run_leftovers_reconstruct_phases_and_slope(tmp_path, monkeypatch, capsys):
    clock = _Clock(monkeypatch)
    rss = _seed_rss(monkeypatch)
    d = str(tmp_path / "hist")
    H.configure(d, run_id=5, fingerprint="deadbeef0001")

    def burst(n, phase=None):
        for _ in range(n):
            clock.tick()
            rss["mb"] += 2.0  # 2 MB a minute
            if phase is not None:
                _flip_phase(phase, clock.t / 1000.0)
                phase = None
            H.sample()

    burst(5)
    burst(5, phase="degraded")
    burst(5, phase="healthy")
    H.uninstall()  # the kill: no stamp, then a torn frame on the tail
    seg = sorted(p for p in os.listdir(d) if p.endswith(".twh"))[-1]
    with open(os.path.join(d, seg), "ab") as fh:
        fh.write(b"\x00garbage-from-a-kill-mid-write")
    records = H.read_series(d)
    intervals = H.phase_intervals(records)
    assert [iv["phase"] for iv in intervals] == ["healthy", "degraded", "healthy"]
    assert [iv["samples"] for iv in intervals] == [5, 5, 5]
    assert H.rss_slope(records) == pytest.approx(2.0, rel=0.05)
    trends = H.phase_trends(records)
    assert set(trends) == {"healthy", "degraded"} and trends["healthy"]["samples"] == 10
    # the derivations equal the JAX package's on the same records, and its
    # report reads the port's leftovers
    assert intervals == JH.phase_intervals(records)
    assert trends == JH.phase_trends(records)
    assert history_report.main([d, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["samples"] == 15 and len(summary["phase_intervals"]) == 3
    assert summary["runs"][0]["run_id"] == 5


# ---- the perfGuard sentinel --------------------------------------------------

def test_perf_guard_baseline_round_trip_and_sustained_regression(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    cum = _seed_stages(monkeypatch)
    d = str(tmp_path / "hist")
    rec = blackbox_mod.install(config={})
    reg = _metrics.get_registry()

    def ticks(n, ms):
        for _ in range(n):
            clock.tick()
            cum["featurize"] += ms / 1000.0
            H.sample()

    try:
        cum["featurize"] = 0.0
        H.configure(d, run_id=1, fingerprint="cfg1")
        ticks(10, 2.0)
        assert H.stamp_baseline() == {
            "version": 1, "run_id": 1, "fingerprint": "cfg1", "samples": 10,
            "stages_ms": {"featurize": 2.0},
        }
        H.uninstall()
        with open(os.path.join(d, H.BASELINE_NAME)) as fh:
            assert json.load(fh)["run_id"] == 1
        h2 = H.configure(d, run_id=2, fingerprint="cfg1")
        assert h2.baseline is not None
        ticks(3, 2.0)
        for i in range(H.GUARD_WINDOW):  # 2.5x: one episode after the window
            ticks(1, 5.0)
            if i < H.GUARD_WINDOW - 1:
                assert reg.counter("perf.regressions").snapshot() == 0
        assert reg.counter("perf.regressions").snapshot() == 1
        (event,) = [e for e in rec.bundle("t")["events"] if e["kind"] == "perf_regression"]
        assert event["stage"] == "featurize" and event["baseline_run_id"] == 1
        assert event["ratio"] == pytest.approx(2.5, abs=0.01)
        ticks(4, 5.0)  # the episode latch: no re-fire while sustained
        assert reg.counter("perf.regressions").snapshot() == 1
        ticks(1, 2.0)  # recovery closes the episode
        ticks(H.GUARD_WINDOW, 5.0)  # a new sustained breach fires again
        assert reg.counter("perf.regressions").snapshot() == 2
        H.uninstall()
        h3 = H.configure(d, run_id=3, perf_guard=False)
        ticks(H.GUARD_WINDOW + 2, 5.0)
        assert reg.counter("perf.regressions").snapshot() == 2
        assert H.stamp_baseline() is None and h3.baseline is not None
    finally:
        blackbox_mod.uninstall()


def test_guard_ignores_noise_scale_stages(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    cum = _seed_stages(monkeypatch)
    d = str(tmp_path / "hist")
    cum["tiny"] = 0.0
    H.configure(d, run_id=1)
    for _ in range(10):
        clock.tick()
        cum["tiny"] += 0.00001
        H.sample()
    assert H.stamp_baseline()["stages_ms"]["tiny"] == 0.01
    H.uninstall()
    H.configure(d, run_id=2)
    for _ in range(H.GUARD_WINDOW + 2):
        clock.tick()
        cum["tiny"] += 0.00005
        H.sample()
    assert _metrics.get_registry().counter("perf.regressions").snapshot() == 0


def test_baseline_needs_enough_healthy_samples(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    d = str(tmp_path / "hist")
    H.configure(d, run_id=1)
    for _ in range(H.BASELINE_MIN_SAMPLES - 1):
        clock.tick()
        H.sample()
    assert H.stamp_baseline() is None
    assert not os.path.exists(os.path.join(d, H.BASELINE_NAME))


# ---- views ---------------------------------------------------------------------------

def test_view_bundle_tail_and_postmortem_rendering(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    rss = _seed_rss(monkeypatch)
    d = str(tmp_path / "hist")
    rec = blackbox_mod.install(config={})
    try:
        assert H.last_history() is None and H.bundle_tail() is None
        H.configure(d, run_id=9, fingerprint="fff999")
        for _ in range(3):
            clock.tick()
            rss["mb"] += 1.0
            H.sample()
        view = H.last_history()
        assert view["samples"] == 3 and view["runId"] == 9 and view["phase"] == "healthy"
        assert len(view["rss"]) == 3 and view["rssMb"] == rss["mb"]
        wire = History(**view)  # the view is the wire type, field for field
        assert decode(encode(wire)) == wire
        bundle = rec.bundle("test-death")
        assert bundle["history"]["run_id"] == 9 and len(bundle["history"]["samples"]) == 3
        summary = postmortem_report.summarize(bundle)
        assert summary["history"]["samples"] == 3
        assert "history tail (run 9)" in postmortem_report.render(summary)
        bpath = tmp_path / "bundle.json"
        bpath.write_text(json.dumps(bundle))
        assert history_report.main([str(bpath)]) == 0
        H.uninstall()
        assert H.last_history() is None
        assert rec.bundle("after")["history"] is None
    finally:
        blackbox_mod.uninstall()


def test_session_stats_samples_before_the_breaker_and_posts_the_view(tmp_path, monkeypatch):
    """The one sampling seam: ``publish_metrics`` samples even with the
    dashboard's breaker open (the historian writes to local disk), and
    posts the ``History`` view when the dashboard takes posts."""
    from twtml_tpu_torch.telemetry.session_stats import SessionStats

    _Clock(monkeypatch)
    H.configure(str(tmp_path / "hist"), run_id=1)
    conf = ConfArguments().parse(["--twtweb", CLOSED, "--lightning", CLOSED])
    stats = SessionStats(conf)
    posted = []
    monkeypatch.setattr(stats.web, "_post", lambda obj: posted.append(obj))
    stats.publish_metrics()
    assert [type(p).__name__ for p in posted][-1] == "History"
    monkeypatch.setattr(stats._web_breaker, "allow", lambda: False)
    stats.publish_metrics()
    assert _metrics.get_registry().counter("history.samples").snapshot() == 2
    assert len([r for r in H.read_series(str(tmp_path / "hist")) if r["k"] == "s"]) == 2


# ---- the format: byte-equal in both directions ---------------------------------

def _drive(mod, metrics, d, clock, cum, rss, phases=True):
    """Header + 6 samples (stage deltas, an RSS ramp, one phase flip) into
    ``d`` through one package's historian module."""
    h = mod.configure(d, run_id=7, fingerprint="0123456789ab")
    for i in range(6):
        clock.tick()
        cum["featurize"] = cum.get("featurize", 0.0) + 0.0021 * (i + 1)
        cum["stats_publish"] = cum.get("stats_publish", 0.0) + 0.0004
        rss["mb"] += 1.25
        if phases and i == 3:
            _flip_phase("degraded", clock.t / 1000.0, metrics)
        mod.sample()
    h.stamp_baseline()
    mod.uninstall()


def test_segments_are_byte_equal_to_the_jax_packages(tmp_path, monkeypatch):
    cum = _seed_stages(monkeypatch, _sideband, jax_sideband)
    rss = _seed_rss(monkeypatch)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    clock = _Clock(monkeypatch)
    _drive(H, _metrics, ours, clock, cum, rss)
    cum.clear()
    rss["mb"] = 100.0
    clock.set(NOW_MS)
    _drive(JH, jax_metrics, theirs, clock, cum, rss)
    got, want = _segment_bytes(ours), _segment_bytes(theirs)
    assert got == want and len(got) == 1
    assert H.read_series(ours) == JH.read_series(theirs)
    # a record of every kind, bytes equal through both writers' framing
    for rec in ({"k": "p", "t_ms": 5, "phase": "degraded"},
                {"k": "s", "seq": 1, "t_ms": 9, "stages_ms": {"a": 0.125}, "txt": "é"}):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        H.Historian(a)._write(rec)
        JH.Historian(b)._write(rec)
        assert _segment_bytes(a) == _segment_bytes(b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_and_appends_to_the_others_segments(tmp_path, monkeypatch, writer):
    clock = _Clock(monkeypatch)
    d = str(tmp_path / "hist")
    first, second = (H, JH) if writer == "port" else (JH, H)
    first.configure(d, run_id=1)
    for _ in range(3):
        clock.tick()
        first.sample()
    first.uninstall()
    with open(os.path.join(d, os.listdir(d)[0]), "ab") as fh:
        fh.write(b"TWTH\x09\x00")  # a torn tail the other package truncates
    h = second.configure(d, run_id=2)
    assert h.next_seq == 5
    clock.tick()
    second.sample()
    second.uninstall()
    for mod in (H, JH):
        recs = mod.read_series(d)
        assert [r["k"] for r in recs] == ["r", "s", "s", "s", "r", "s"]
        assert [r["run_id"] for r in recs if r["k"] == "r"] == [1, 2]


# ---- the app -------------------------------------------------------------------------

BASE = ["--source", "replay", "--seconds", "0", "--backend", "cpu",
        "--batchBucket", "16", "--tokenBucket", "64", "--master", "local[1]",
        "--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


def _corpus(path, total=8 * 16, seed=51):
    with open(path, "w") as fh:
        for s in JaxSynthetic(total=total, seed=seed, base_ms=NOW_MS).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")
    return str(path)


def _run_counting_fetches(argv):
    calls = {"n": 0}
    base = StreamingLinearRegressionWithSGD.fetch_output

    def fetch(out):
        calls["n"] += 1
        return base(out)

    out = io.StringIO()
    with mock.patch.object(StreamingLinearRegressionWithSGD, "fetch_output",
                           staticmethod(fetch)), contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv))
    return totals, calls["n"] - 1  # the warm-up's fetch excluded


def test_app_default_history_counts_and_off_is_bit_exact(tmp_path, monkeypatch):
    """A checkpointed run at the defaults (``--history auto``, on with
    ``--checkpointDir``) completes, fetches once a batch, leaves CRC-valid
    segments the JAX package reads and a baseline; ``--history off`` lands
    bitwise-equal weights and creates no history directory."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    monkeypatch.setenv("TWTML_RUN_ID_FILE", str(tmp_path / "runid"))
    path = _corpus(tmp_path / "tweets.jsonl")
    ck_on, ck_off = str(tmp_path / "ck_on"), str(tmp_path / "ck_off")
    totals_on, fetches_on = _run_counting_fetches(
        BASE + ["--replayFile", path, "--checkpointDir", ck_on, "--checkpointEvery", "1"])
    assert totals_on["batches"] == 8 and fetches_on == 8
    hist = os.path.join(ck_on, "history")
    recs = JH.read_series(hist)
    (head,) = [r for r in recs if r["k"] == "r"]
    assert head["run_id"] == 1 and len(head["fingerprint"]) == 12
    samples = [r for r in recs if r["k"] == "s"]
    assert samples and samples[0]["rss_mb"] > 0
    assert samples[-1]["counters"]["history.samples"] == len(samples) - 1
    assert history_report.main([hist]) == 0
    assert H.last_history() is None  # uninstalled at the end of the run
    w_on, _ = Checkpointer(ck_on).restore()

    totals_off, fetches_off = _run_counting_fetches(
        BASE + ["--replayFile", path, "--history", "off", "--checkpointDir", ck_off,
                "--checkpointEvery", "1"])
    assert totals_off["batches"] == 8 and fetches_off == 8
    assert not os.path.exists(os.path.join(ck_off, "history"))
    w_off, _ = Checkpointer(ck_off).restore()
    assert np.asarray(w_on).tobytes() == np.asarray(w_off).tobytes()
    assert totals_on["count"] == totals_off["count"]


def test_a_clean_run_stamps_the_baseline_and_an_aborted_one_does_not(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    monkeypatch.setenv("TWTML_RUN_ID_FILE", str(tmp_path / "runid"))
    monkeypatch.setattr(H, "BASELINE_MIN_SAMPLES", 1)
    path = _corpus(tmp_path / "tweets.jsonl")
    ck = str(tmp_path / "ck")
    _run_counting_fetches(BASE + ["--replayFile", path, "--checkpointDir", ck])
    with open(os.path.join(ck, "history", H.BASELINE_NAME)) as fh:
        assert json.load(fh)["run_id"] == 1
    storm = str(tmp_path / "storm")
    with pytest.raises(RuntimeError, match="runtime guard"):
        _run_counting_fetches(BASE + ["--replayFile", path, "--checkpointDir", storm,
                                      "--checkpointEvery", "1", "--chaos", "source.nan@2",
                                      "--sentinelRollbacks", "2"])
    assert os.listdir(os.path.join(storm, "history")) == ["seg-00000000000000000000.twh"]


def test_history_on_without_checkpoint_dir_refuses():
    conf = ConfArguments().parse(BASE + ["--history", "on"])
    with pytest.raises(SystemExit, match="--checkpointDir"):
        common.install_historian(conf)


@pytest.mark.parametrize("argv,on", [
    ([], False), (["--checkpointDir", "/ck"], True),
    (["--checkpointDir", "/ck", "--history", "off"], False), (["--history", "on"], True),
])
def test_effective_history_resolution(argv, on):
    assert ConfArguments().parse(argv).effective_history() is on
    assert JaxConf().parse(argv).effective_history() is on


@pytest.mark.parametrize("bad", [["--history", "sometimes"], ["--historyMaxMb", "0"],
                                 ["--perfGuard", "abort"], ["--perfGuardRatio", "0.9"]])
def test_bad_history_flags_exit_as_in_the_jax_package(bad):
    for conf in (ConfArguments(), JaxConf()):
        with pytest.raises(SystemExit):
            conf.parse(bad)


def test_run_ids_are_one_sequence_with_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_RUN_ID_FILE", str(tmp_path / "runid"))
    ids = [runid.next_run_id(), jax_runid.next_run_id(), runid.next_run_id(),
           jax_runid.next_run_id()]
    assert ids == [1, 2, 3, 4]
    fp = runid.config_fingerprint({"batch": 2048, "wire": "ragged"})
    assert fp == runid.config_fingerprint({"wire": "ragged", "batch": 2048})
    assert fp == jax_runid.config_fingerprint({"batch": 2048, "wire": "ragged"})
    assert len(fp) == 12 and fp != runid.config_fingerprint({"batch": 1024, "wire": "ragged"})
    assert len(runid.config_fingerprint(ConfArguments())) == 12
