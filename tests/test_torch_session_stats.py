"""The port's telemetry (``twtml_tpu_torch/telemetry``): the metrics registry
and health monitor, the publish circuit breaker and the session publisher,
case for case against the JAX package's own tests (tests/test_metrics.py,
the breaker and shedding cases of tests/test_runtime_guards.py); the
dashboard's JSON byte-equal to the JAX package's; and the port's app and the
JAX app posting identical config, stats, series and Lightning payloads to
one loopback recorder."""

import contextlib
import io
import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest

from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.telemetry import api_types as jax_api
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.telemetry import api_types
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.telemetry.breaker import CircuitBreaker
from twtml_tpu_torch.telemetry.lightning import Lightning
from twtml_tpu_torch.telemetry.metrics import MetricsRegistry, TunnelHealthMonitor
from twtml_tpu_torch.telemetry.session_stats import (
    METRICS_EVERY,
    SERIES_MAX_POINTS,
    SERIES_SHED_EVERY,
    SessionStats,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
CLOSED = "http://127.0.0.1:9"


@pytest.fixture(autouse=True)
def fresh_metrics():
    _metrics.reset_for_tests()
    yield
    _metrics.reset_for_tests()


class Recorder:
    """A loopback HTTP server that records every POST (path, JSON body) and
    answers as the twtml web API and a Lightning server would: session
    ``s1``, visualization ``v1``."""

    def __init__(self):
        self.posts: list = []
        posts = self.posts

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length", 0)))
                posts.append((self.path, json.loads(body or b"{}")))
                reply = {"/sessions/": {"id": "s1"},
                         "/sessions/s1/visualizations/": {"id": "v1"}}.get(self.path, {})
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=5)

    def api(self, kind):
        return [body for path, body in self.posts
                if path == "/api" and body.get("jsonClass") == kind]


# ---- metrics (tests/test_metrics.py) ----------------------------------------------

def test_counter_gauge_semantics():
    reg = MetricsRegistry()
    c = reg.counter("pipeline.batches")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    assert reg.counter("pipeline.batches") is c
    g = reg.gauge("fetch.queue_depth")
    g.set(3)
    g.add(2)
    g.set(7)
    assert g.snapshot() == 7


def test_histogram_semantics():
    h = MetricsRegistry().histogram("fetch.latency_s")
    for v in (0.001, 0.002, 0.004, 0.1, 2.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 5
    assert abs(snap["sum"] - 2.107) < 1e-9
    assert snap["min"] == 0.001 and snap["max"] == 2.0
    assert sum(c for _, c in snap["buckets"]) == 5
    assert 0.002 <= h.percentile(0.5) <= 0.008
    assert h.percentile(1.0) >= 2.0


def test_histogram_snapshot_derived_percentiles_match_percentile():
    reg = MetricsRegistry()
    h = reg.histogram("fetch.latency_s")
    assert h.snapshot()["p50"] == 0.0
    rnd = random.Random(7)
    for _ in range(500):
        h.observe(rnd.uniform(0.001, 4.0))
    snap = h.snapshot()
    for key, p in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        assert snap[key] == h.percentile(p), key
    h2 = reg.histogram("stall_s")
    for v in (1000.0, 2000.0, 3000.0):
        h2.observe(v)
    assert h2.snapshot()["p99"] == 3000.0


def test_snapshot_isolation():
    reg = MetricsRegistry()
    reg.counter("a").inc(2)
    reg.gauge("b").set(1)
    reg.histogram("h").observe(0.5)
    snap = reg.snapshot()
    reg.counter("a").inc(10)
    reg.gauge("b").set(9)
    reg.histogram("h").observe(0.5)
    assert snap["counters"]["a"] == 2
    assert snap["gauges"]["b"] == 1
    assert snap["histograms"]["h"]["count"] == 1


def test_counter_thread_safety():
    c = MetricsRegistry().counter("x")

    def worker():
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert c.snapshot() == 8000


def test_health_steady_rtt_stays_healthy():
    mon = TunnelHealthMonitor(registry=MetricsRegistry())
    for i in range(50):
        mon.observe(0.07 + 0.005 * (i % 3), now=float(i))
    assert mon.phase == TunnelHealthMonitor.HEALTHY
    assert mon.transitions == []


def test_health_degrades_and_recovers():
    reg = MetricsRegistry()
    mon = TunnelHealthMonitor(registry=reg)
    t = iter(range(1000))
    for _ in range(20):
        mon.observe(0.07, now=float(next(t)))
    for _ in range(20):
        mon.observe(0.6, now=float(next(t)))
    assert mon.phase == TunnelHealthMonitor.DEGRADED
    for _ in range(40):
        mon.observe(0.07, now=float(next(t)))
    assert [p for _, p in mon.transitions] == ["degraded", "healthy"]
    assert reg.counter("tunnel.phase_transitions").snapshot() == 2
    summary = mon.summary()
    assert summary["phase"] == "healthy" and summary["transitions"] == 2
    assert summary["best_ms"] == 70.0


def test_health_floor_keeps_cpu_jitter_healthy():
    mon = TunnelHealthMonitor(registry=MetricsRegistry())
    for i in range(100):
        mon.observe(1e-6 if i % 2 else 2e-5, now=float(i))
    assert mon.phase == TunnelHealthMonitor.HEALTHY


def test_health_hysteresis_no_flap_on_single_outlier():
    mon = TunnelHealthMonitor(registry=MetricsRegistry())
    for i in range(30):
        mon.observe(0.07, now=float(i))
    mon.observe(5.0, now=31.0)
    assert mon.phase == TunnelHealthMonitor.HEALTHY and mon.transitions == []


# ---- the breaker and the publisher (tests/test_runtime_guards.py) --------------

def test_breaker_state_machine_with_half_open_probe():
    clock = {"t": 0.0}
    br = CircuitBreaker("t1", failure_threshold=3, cooldown_s=10.0, now=lambda: clock["t"])
    reg = _metrics.get_registry()
    for _ in range(2):
        assert br.allow()
        br.record_failure()
    assert br.state == br.CLOSED
    assert br.allow()
    br.record_failure()
    assert br.state == br.OPEN
    assert reg.gauge("publish.t1.breaker_open").snapshot() == 1
    assert not br.allow() and not br.allow()
    assert reg.counter("publish.t1.dropped").snapshot() == 2
    clock["t"] = 10.0
    assert br.allow() and br.state == br.HALF_OPEN
    assert not br.allow()
    br.record_failure()
    assert br.state == br.OPEN and not br.allow()
    clock["t"] = 20.0
    assert br.allow()
    br.record_success()
    assert br.state == br.CLOSED
    assert reg.gauge("publish.t1.breaker_open").snapshot() == 0
    br.record_failure()
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == br.CLOSED


class StubWeb:
    """A dashboard client whose calls are counted, optionally slow and
    failing."""

    timeout = 2.0

    def __init__(self, delay=0.0, fail=False):
        self.calls = {"stats": 0, "series": 0, "metrics": 0}
        self.series_points = []
        self.delay, self.fail = delay, fail

    def _call(self, kind):
        self.calls[kind] += 1
        time.sleep(self.delay)
        if self.fail:
            raise ConnectionError("dashboard down")

    def stats(self, *a, **k):
        self._call("stats")

    def series(self, real, pred, *a, **k):
        self.series_points.append((len(real), len(pred)))
        self._call("series")

    def metrics(self, *a, **k):
        self._call("metrics")


def session_with(web):
    session = SessionStats(ConfArguments().parse(
        ["--twtweb", CLOSED, "--lightning", CLOSED, "--webTimeout", "0.5"]))
    session.web = web  # no open(): the chart stays off
    return session


def test_breaker_keeps_hot_path_fast_when_dashboard_is_dead():
    session = session_with(StubWeb(delay=0.15, fail=True))
    real = np.array([1.0, 2.0])
    t0 = time.perf_counter()
    for i in range(5):
        session.update(10 * i, 2, 1.0, 1.0, 1.0, real, real)
    t_open = time.perf_counter()
    for i in range(20):
        session.update(10 * i, 2, 1.0, 1.0, 1.0, real, real)
    t_end = time.perf_counter()
    assert session._web_breaker.state == session._web_breaker.OPEN
    assert t_open - t0 >= 5 * 0.15
    assert t_end - t_open < 1.0
    reg = _metrics.get_registry()
    assert reg.counter("publish.web.failures").snapshot() == 5
    assert reg.counter("publish.web.dropped").snapshot() >= 20


def test_series_sheds_to_every_nth_when_transport_degraded():
    web = StubWeb()
    session = session_with(web)
    monitor = _metrics.get_health_monitor()
    monitor.phase = monitor.DEGRADED
    real = np.array([1.0])
    for i in range(2 * SERIES_SHED_EVERY):
        session.update(i, 1, 1.0, 1.0, 1.0, real, real)
    assert web.calls["stats"] == 2 * SERIES_SHED_EVERY
    assert web.calls["series"] == 2
    assert _metrics.get_registry().counter(
        "publish.series_shed").snapshot() == 2 * SERIES_SHED_EVERY - 2
    monitor.phase = monitor.HEALTHY
    before = web.calls["series"]
    for i in range(3):
        session.update(i, 1, 1.0, 1.0, 1.0, real, real)
    assert web.calls["series"] == before + 3


def test_series_is_cut_to_max_points_and_metrics_ship_every_nth():
    web = StubWeb()
    session = session_with(web)
    big = np.arange(5 * SERIES_MAX_POINTS, dtype=np.float64)
    for i in range(2 * METRICS_EVERY):
        session.update(i, big.size, 1.0, 1.0, 1.0, big, big)
    assert set(web.series_points) == {(SERIES_MAX_POINTS, SERIES_MAX_POINTS)}
    assert web.calls["metrics"] == 2


def test_web_timeout_flag_threads_through():
    assert ConfArguments().webTimeout == 2.0
    conf = ConfArguments().parse(["--webTimeout", "0.25"])
    assert SessionStats(conf).web.timeout == 0.25


# ---- the wire: byte-equal JSON ---------------------------------------------------

OBJECTS = [
    ("Config", dict(id="s1", host="http://lgn", viz=["v1", "v2"])),
    ("Config", dict()),
    ("Stats", dict(count=12, batch=4, mse=156250, realStddev=125, predStddev=0)),
    ("Series", dict(real=[1.0, 2.5, 900.0], pred=[0.0, -1.0, 3.0],
                    realStddev=125.0, predStddev=33.0)),
    ("Metrics", dict(counters={"fetch.count": 3}, gauges={"ingest.queue_rows": 0},
                     health={"phase": "healthy", "rtt_ms": 1.5},
                     histograms={"fetch.latency_s": {"count": 3, "p50": 0.001}})),
]


@pytest.mark.parametrize("kind,fields", OBJECTS, ids=[f"{k}{i}" for i, (k, _) in enumerate(OBJECTS)])
def test_encode_is_byte_equal_to_the_jax_packages(kind, fields):
    ours = api_types.encode(api_types.TYPES[kind](**fields))
    assert ours == jax_api.encode(jax_api.TYPES[kind](**fields))
    assert api_types.decode(ours) == api_types.TYPES[kind](**fields)


def test_decode_rejects_unknown_types():
    with pytest.raises(ValueError):
        api_types.decode('{"jsonClass": "Hosts", "hosts": []}')


def test_lightning_creates_a_session_and_appends():
    with Recorder() as rec:
        lgn = Lightning(host=rec.url)
        viz = lgn.line_streaming([[0.0]] * 2, size=[1.0, 2.0], color=[[1, 2, 3]] * 2)
        lgn.line_streaming([[1.0, 2.0], [3.0, 4.0]], viz=viz)
    assert (viz.id, viz.session) == ("v1", "s1")
    assert [p for p, _ in rec.posts] == [
        "/sessions/", "/sessions/s1/visualizations/", "/visualizations/v1/data/"]
    assert rec.posts[1][1]["type"] == "line-streaming"
    assert rec.posts[2][1] == {"data": {"series": [[1.0, 2.0], [3.0, 4.0]]}}


def test_open_registers_the_chart_with_the_dashboard():
    with Recorder() as rec:
        SessionStats(ConfArguments().parse(["--twtweb", rec.url, "--lightning", rec.url])).open()
    assert rec.api("Config") == [{"jsonClass": "Config", "id": "s1", "host": rec.url,
                                  "viz": ["v1"]}]


def compared(post):
    path, body = post
    return path != "/api" or body.get("jsonClass") in ("Config", "Stats", "Series")


def test_app_posts_what_the_jax_app_posts(monkeypatch, capsys):
    """The port's app and the JAX app on the replay fixture, each pointed at
    one loopback recorder, post identical config, stats, series and
    Lightning payloads. The metrics snapshots differ by design (each
    package counts its own pipeline), and the JAX package's additive views
    (model health, freshness, ...) belong to planes the port has not
    ported."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", "1700000000000")
    with Recorder() as rec:
        argv = ["--source", "replay", "--replayFile", DATA, "--seconds", "0",
                "--batchBucket", "4", "--backend", "cpu", "--lightning", rec.url,
                "--twtweb", rec.url]
        with contextlib.redirect_stdout(io.StringIO()):
            app.run(ConfArguments().parse(argv))
        ours = [p for p in rec.posts if compared(p)]
        rec.posts.clear()
        jax.devices()
        jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]))
        theirs = [p for p in rec.posts if compared(p)]
    capsys.readouterr()
    assert ours == theirs
    kinds = [body.get("jsonClass", path) for path, body in ours]
    assert kinds.count("Config") == 1
    assert kinds.count("Stats") == kinds.count("Series") == 3
    assert kinds.count("/visualizations/v1/data/") == 3
