"""The port's copy of the dashboard (``twtml_tpu_torch/web/assets``): byte-equal
to the JAX package's, every JS file parses on the in-repo jsmini interpreter
(tools/jsmini.py), and the port's ``index.html`` boots on the stub DOM
(tools/jsdom.py) against the port's own server: the backfill answered with
what its GET routes answer, then the frames its websocket broadcasts (Stats,
Config, Metrics, Series) drive the counters, the iframes, the pipeline panel
and the chart."""

import json
import os
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools.jsdom import Harness  # noqa: E402
from tools.jsmini import parse  # noqa: E402
from twtml_tpu_torch.web.cache import ApiCache  # noqa: E402
from twtml_tpu_torch.web.server import Server  # noqa: E402
from twtml_tpu_torch.web.websocket import WebSocketClient  # noqa: E402

ASSETS = REPO / "twtml_tpu_torch" / "web" / "assets"
JAX_ASSETS = REPO / "twtml_tpu" / "web" / "assets"
FILES = sorted(p.relative_to(JAX_ASSETS).as_posix() for p in JAX_ASSETS.rglob("*") if p.is_file())
JS = [f for f in FILES if f.endswith(".js")]
BACKFILL = ("stats", "hosts", "tenants", "model", "serving", "fleet", "freshness", "history",
            "metrics", "series")


def test_the_assets_are_the_same_files():
    assert FILES == sorted(p.relative_to(ASSETS).as_posix() for p in ASSETS.rglob("*")
                           if p.is_file())
    assert {"index.html", "test.html", "js/api.js", "js/index.js"} <= set(FILES)


@pytest.mark.parametrize("name", FILES)
def test_each_asset_is_byte_equal_to_the_jax_packages(name):
    assert (ASSETS / name).read_bytes() == (JAX_ASSETS / name).read_bytes()


@pytest.mark.parametrize("name", JS)
def test_each_js_file_parses(name):
    parse((ASSETS / name).read_text(encoding="utf-8"))


@pytest.fixture()
def server(tmp_path):
    srv = Server(port=0, host="127.0.0.1", cache=ApiCache(str(tmp_path / "b.json")))
    srv.start_background()
    yield srv
    srv.stop()


def post(srv, payload: dict) -> None:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/api",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=5) as resp:
        resp.read()


def get(srv, view: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/api/{view}", timeout=5) as resp:
        return json.loads(resp.read())


def broadcast(srv, payloads) -> list:
    """The frames the server's websocket sends for ``payloads`` posted over
    HTTP (after its connect push)."""
    c = WebSocketClient(f"ws://127.0.0.1:{srv.port}/api")
    try:
        frames = [c.recv_text()]
        for p in payloads:
            post(srv, p)
            frames.append(c.recv_text())
    finally:
        c.close()
    return frames


def dashboard(srv):
    """The port's index.html with its scripts, the backfill routes answered
    by the port's server."""
    h = Harness([str(ASSETS / "index.html")])
    for view in BACKFILL:
        h.fetch_routes[f"/api/{view}"] = get(srv, view)
    for name in ("api.js", "chart.js", "index.js"):
        h.load_script(str(ASSETS / "js" / name))
    h.dom_content_loaded()
    return h


STATS = {"jsonClass": "Stats", "count": 1234567, "batch": 678, "mse": 4321,
         "realStddev": 15, "predStddev": 25}
CONFIG = {"jsonClass": "Config", "id": "sess-1", "host": "http://lightning", "viz": ["101", "102"]}
METRICS = {"jsonClass": "Metrics", "counters": {"wire.bytes": 2500000},
           "gauges": {"host.rss_mb": 512.5, "fetch.queue_depth": 7},
           "health": {"phase": "degraded", "rtt_ms": 412.5, "transitions": 3}, "histograms": {}}
SERIES = {"jsonClass": "Series", "real": [100.0, 200.0, 300.0], "pred": [110.0, 190.0, 310.0],
          "realStddev": 15.0, "predStddev": 25.0}


def test_boot_opens_the_websocket_and_backfills_from_the_port_server(server):
    post(server, SERIES)
    h = dashboard(server)
    assert len(h.websockets) == 1 and h.ws.url == "ws://localhost:8888/api"
    urls = [u for u, _ in h.fetches]
    assert "/api/stats" in urls and "/api/series" in urls
    h.ws.server_open()
    assert h.el("conn").text == "live"
    h.ws.server_close()
    assert h.el("conn").text == "offline"


def test_a_stats_frame_of_the_port_server_updates_the_counters(server):
    h = dashboard(server)
    h.ws.server_open()
    _, stats = broadcast(server, [STATS])
    h.ws.server_message(stats)
    assert h.el("count").text == "1,234,567"
    assert (h.el("batch").text, h.el("mse").text) == ("678", "4,321")
    assert (h.el("realStddev").text, h.el("predStddev").text) == ("15", "25")


def test_the_connect_push_and_a_config_frame_rebuild_the_iframes(server):
    post(server, CONFIG)
    h = dashboard(server)
    h.ws.server_open()
    push, stats, config = broadcast(server, [STATS, CONFIG])
    assert json.loads(push) == CONFIG
    h.ws.server_message(stats)
    h.ws.server_message(config)
    for el_id in ("count", "batch", "mse", "realStddev", "predStddev"):
        assert h.el(el_id).text == "0"
    assert h.el("session").text == "sess-1"
    assert [f.get("src") for f in h.el("graphs").children] == [
        "http://lightning/visualizations/101/pym", "http://lightning/visualizations/102/pym"]


def test_a_metrics_frame_of_the_port_server_updates_the_panel(server):
    h = dashboard(server)
    h.ws.server_open()
    _, metrics = broadcast(server, [METRICS])
    h.ws.server_message(metrics)
    assert h.el("tunnelPhase").text == "degraded"
    assert "degraded" in h.el("tunnelPhase").class_set
    assert (h.el("rttMs").text, h.el("wireMb").text) == ("412.5", "2.5")
    assert (h.el("rssMb").text, h.el("fetchDepth").text) == ("512.5", "7")


def test_a_series_frame_of_the_port_server_draws_the_chart(server):
    h = dashboard(server)
    h.ws.server_open()
    ctx = h.el("livechart").ctx
    ctx.calls.clear()
    _, series = broadcast(server, [SERIES])
    h.ws.server_message(series)
    assert len(ctx.ops("stroke")) == 4
    labels = [args[0] for op, args in ctx.ops("fillText")]
    assert {"real", "predicted", "stdev real", "stdev pred"} <= set(labels)


def test_a_dashboard_post_reaches_the_port_server_over_the_websocket(server):
    """The page's api.postStats rides the open socket; the frame it sends,
    replayed into the port's server, is cached like the JAX server caches
    it."""
    h = dashboard(server)
    h.ws.server_open()
    h.interp.run("api.postStats(1, 2, 3, 4, 5);")
    h.interp.run_jobs()
    (sent,) = h.ws.sent
    c = WebSocketClient(f"ws://127.0.0.1:{server.port}/api")
    try:
        c.recv_text()
        c.send_text(sent)
        assert c.recv_text() == sent
    finally:
        c.close()
    assert get(server, "stats") == {"jsonClass": "Stats", "count": 1, "batch": 2, "mse": 3,
                                    "realStddev": 4, "predStddev": 5}


def test_the_harness_page_boots_and_posts(server):
    h = Harness([str(ASSETS / "test.html")])
    h.fetch_routes["/api"] = {"status": "OK"}
    for name in ("api.js", "test.js"):
        h.load_script(str(ASSETS / "js" / name))
    h.dom_content_loaded()
    h.click("wsToggle")
    assert len(h.websockets) == 1 and h.el("wsToggle").text == "websocket: on"
    for el_id, value in (("stCount", "10"), ("stBatch", "2"), ("stMse", "30"),
                         ("stReal", "4"), ("stPred", "5")):
        h.el(el_id).set("value", value)
    h.click("wsToggle")
    h.click("postStats")
    body = h.fetches[-1][1].get("body")
    post(server, json.loads(body))
    assert get(server, "stats") == {"jsonClass": "Stats", "count": 10, "batch": 2, "mse": 30,
                                    "realStddev": 4, "predStddev": 5}


def test_the_server_serves_the_port_assets(server):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=5) as resp:
        assert resp.read() == (ASSETS / "index.html").read_bytes()
    assert os.path.samefile(Path(str(server._assets)), ASSETS)
