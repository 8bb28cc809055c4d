"""The port's dashboard server (``twtml_tpu_torch/web``: the standard
library's asyncio streams and its own RFC 6455 websockets) against the JAX
package's aiohttp server (``twtml_tpu/web``), both on loopback ports: the
same posts and websocket frames in, the same statuses, content types, JSON
and frames out. The port's blocking websocket client
(``web/websocket.py``) drives both servers."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from twtml_tpu.web.cache import ApiCache as JaxCache
from twtml_tpu.web.server import Server as JaxServer
from twtml_tpu_torch.web import websocket as ws
from twtml_tpu_torch.web.cache import SERIES_WINDOW, ApiCache
from twtml_tpu_torch.web.server import VIEWS, Server
from twtml_tpu_torch.web.websocket import WebSocketClient

HOST = "127.0.0.1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("port", "jax")


@pytest.fixture()
def servers(tmp_path):
    """Both servers, each with its own backup file: {kind: (host, port)}."""
    ours = Server(port=0, host=HOST, cache=ApiCache(str(tmp_path / "port.json")))
    theirs = JaxServer(port=0, host=HOST, cache=JaxCache(str(tmp_path / "jax.json")))
    ours.start_background()
    theirs.start_background()
    try:
        yield {"port": (HOST, ours.port), "jax": (HOST, theirs._runner.addresses[0][1])}
    finally:
        ours.stop()
        theirs.stop()


def request(addr, method, path, body=None, headers=None):
    """(status, main content type, body bytes, headers) of one request on a
    connection of its own."""
    conn = http.client.HTTPConnection(*addr, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        ctype = (resp.getheader("Content-Type") or "").split(";")[0]
        return resp.status, ctype, data, dict(resp.getheaders())
    finally:
        conn.close()


def post(addr, payload) -> int:
    text = payload if isinstance(payload, str) else json.dumps(payload)
    status, _, body, _ = request(addr, "POST", "/api", text.encode(),
                                 {"content-type": "application/json"})
    assert json.loads(body) == {"status": "OK"}
    return status


def client(addr) -> WebSocketClient:
    return WebSocketClient(f"ws://{addr[0]}:{addr[1]}/api")


def messages(seed: int = 0) -> list:
    """One of each jsonClass the dashboard carries (values from a numpy
    seed), an unknown class and a malformed payload, as the app would post
    them."""
    rng = np.random.default_rng(seed)
    r = lambda: float(np.round(rng.normal(), 6))  # noqa: E731
    return [
        {"jsonClass": "Config", "id": "s1", "host": "http://127.0.0.1:3000", "viz": ["v1"]},
        {"jsonClass": "Stats", "count": int(rng.integers(1, 9999)), "batch": 4, "mse": 9,
         "realStddev": 3, "predStddev": 2},
        *({"jsonClass": "Series", "real": [r(), r()], "pred": [r()], "realStddev": r(),
           "predStddev": r()} for _ in range(3)),
        {"jsonClass": "Metrics", "counters": {"pipeline.batches": 3}, "gauges": {"g": r()},
         "health": {"phase": "healthy"}, "histograms": {}},
        {"jsonClass": "Hosts", "hosts": [{"host": 0}], "straggler": 0, "stage": "fetch",
         "skewMs": r()},
        {"jsonClass": "Tenants", "tenants": [{"tenant": 0}], "gating": 0, "active": 1},
        {"jsonClass": "ModelHealth", "level": "warn", "driftScore": r(), "mse": [r()]},
        {"jsonClass": "Serving", "qps": r(), "snapshotStep": 3, "level": "ok"},
        {"jsonClass": "Fleet", "policy": "p99", "replicas": [{"url": "a"}], "requests": 2},
        {"jsonClass": "Freshness", "batches": 2, "rows": 9, "eventLagMs": r()},
        {"jsonClass": "History", "samples": 4, "runId": 2, "rss": [r(), r()]},
        {"jsonClass": "Nope", "x": 1},
        "{not json",
        "[1, 2]",
    ]


def assert_same_response(a, b):
    (status, ctype, body, _), (t_status, t_ctype, t_body, _) = a, b
    assert (status, ctype) == (t_status, t_ctype)
    if ctype == "application/json":
        assert json.loads(body) == json.loads(t_body)
    else:
        assert body == t_body


# ---- HTTP routes ------------------------------------------------------------------

ROUTES = [f"/api/{v}" for v in VIEWS] + [
    "/", "/index.html", "/test.html", "/js/api.js", "/js/chart.js", "/js/index.js",
    "/js/test.js"]


@pytest.mark.parametrize("path", ROUTES)
def test_get_routes_equal_before_any_post(servers, path):
    assert_same_response(request(servers["port"], "GET", path),
                         request(servers["jax"], "GET", path))


@pytest.mark.parametrize("path", ROUTES)
def test_get_routes_equal_after_the_same_posts(servers, path):
    for msg in messages(seed=len(path)):
        assert post(servers["port"], msg) == post(servers["jax"], msg) == 200
    got = request(servers["port"], "GET", path)
    assert_same_response(got, request(servers["jax"], "GET", path))
    assert got[0] == 200


STATUS_CASES = [
    ("GET", "/nope"), ("GET", "/api/nope"), ("GET", "/api/"), ("GET", "/api/predict"),
    ("POST", "/api/predict"), ("POST", "/api/config"), ("PUT", "/api"), ("DELETE", "/api/stats"),
    ("POST", "/"), ("POST", "/js/api.js"), ("GET", "/api"), ("HEAD", "/api/stats"),
    ("HEAD", "/"), ("GET", "/js/missing.js"), ("GET", "/js/api.js?v=3"),
    # the traversal cases of tests/test_web.py
    ("GET", "//etc/passwd"), ("GET", "//var/lib/secret"), ("GET", "/a//b"), ("GET", "/a/./b"),
    ("GET", "/D:/secrets.txt"), ("GET", "/js/%00x"), ("GET", "/js/../index.html"),
]


@pytest.mark.parametrize("method,path", STATUS_CASES, ids=lambda v: v)
def test_status_codes_equal(servers, method, path):
    body = b"{}" if method in ("POST", "PUT") else None
    got = request(servers["port"], method, path, body)
    want = request(servers["jax"], method, path, body)
    assert got[0] == want[0]
    assert got[1] == want[1] or got[0] >= 400
    if path == "/api/predict" and method == "POST":
        # no plane and no router attached: both servers serve no model
        for resp in (got, want):
            assert resp[0] == 503
            assert json.loads(resp[2])["error"].startswith("serving not enabled on this server")
    if method == "HEAD":
        assert got[2] == want[2] == b""
    if got[0] == 405:
        assert set(got[3]["Allow"].split(", ")) == set(want[3]["Allow"].split(","))


@pytest.mark.parametrize("kind", KINDS)
def test_keep_alive_serves_many_requests_on_one_connection(servers, kind):
    conn = http.client.HTTPConnection(*servers[kind], timeout=10)
    try:
        for path in ("/api/config", "/api/stats", "/js/api.js"):
            conn.request("GET", path)
            resp = conn.getresponse()
            assert resp.status == 200 and resp.read()
        conn.request("POST", "/api", body=json.dumps(messages()[1]))
        assert json.loads(conn.getresponse().read()) == {"status": "OK"}
    finally:
        conn.close()


@pytest.mark.parametrize("kind", KINDS)
def test_a_chunked_post_is_cached(servers, kind):
    text = json.dumps(messages()[1]).encode()
    sock = socket.create_connection(servers[kind], timeout=10)
    try:
        chunks = b"".join(f"{len(p):x}\r\n".encode() + p + b"\r\n" for p in (text[:7], text[7:]))
        sock.sendall(b"POST /api HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n" + chunks + b"0\r\n\r\n")
        reply = b""
        while chunk := sock.recv(65536):
            reply += chunk
    finally:
        sock.close()
    assert reply.startswith(b"HTTP/1.1 200")
    assert json.loads(request(servers[kind], "GET", "/api/stats")[2]) == messages()[1]


def test_a_body_of_1_mib_is_refused_by_both(servers):
    body = b"x" * (1 << 20)
    assert request(servers["port"], "POST", "/api", body)[0] == 413
    assert request(servers["jax"], "POST", "/api", body)[0] == 413


# ---- websockets -------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_connect_push_and_broadcast_to_every_socket_sender_included(servers, kind):
    addr = servers[kind]
    post(addr, messages()[0])
    a, b = client(addr), client(addr)
    try:
        assert json.loads(a.recv_text()) == json.loads(b.recv_text()) == messages()[0]
        stats = json.dumps(messages(3)[1])
        a.send_text(stats)
        assert a.recv_text() == b.recv_text() == stats
        # an HTTP post reaches every socket too
        series = messages()[2]
        post(addr, series)
        assert json.loads(a.recv_text()) == json.loads(b.recv_text()) == series
    finally:
        a.close()
        b.close()
    # the frame was cached like a post
    assert json.loads(request(addr, "GET", "/api/stats")[2]) == json.loads(stats)


def sized(n: int) -> str:
    """A Series message of exactly ``n`` bytes of JSON text."""
    head = '{"jsonClass": "Series", "real": [], "pred": [], "pad": "'
    return head + "x" * (n - len(head) - 2) + '"}'


@pytest.mark.parametrize("size", [125, 126, 65535, 65536, 1 << 20])
@pytest.mark.parametrize("kind", KINDS)
def test_messages_round_trip_at_each_length_form(servers, kind, size):
    c = client(servers[kind])
    try:
        c.recv_text()
        text = sized(size)
        assert len(text.encode()) == size
        c.send_text(text)
        assert c.recv_text() == text
    finally:
        c.close()


@pytest.mark.parametrize("kind", KINDS)
def test_a_fragmented_message_is_reassembled_around_a_ping(servers, kind):
    c = client(servers[kind])
    try:
        c.recv_text()
        text = json.dumps(messages(5)[1]).encode()
        c.send_frame(ws.OP_TEXT, text[:5], fin=False)
        c.send_frame(ws.OP_PING, b"mid")  # a control frame inside the message
        c.send_frame(ws.OP_CONT, text[5:20], fin=False)
        c.send_frame(ws.OP_CONT, text[20:], fin=True)
        assert c.recv_frame() == (True, ws.OP_PONG, b"mid")
        assert c.recv_text() == text.decode()
    finally:
        c.close()


@pytest.mark.parametrize("kind", KINDS)
def test_ping_is_answered_with_its_payload(servers, kind):
    c = client(servers[kind])
    try:
        c.recv_text()
        c.send_frame(ws.OP_PING, b"twtml-ping")
        assert c.recv_frame() == (True, ws.OP_PONG, b"twtml-ping")
    finally:
        c.close()


@pytest.mark.parametrize("kind", KINDS)
def test_close_handshake_answers_1000(servers, kind):
    c = client(servers[kind])
    c.recv_text()
    assert c.close(1001) == ws.CLOSE_OK  # going away


@pytest.mark.parametrize("kind", KINDS)
def test_a_message_of_4_mib_closes_with_1009(servers, kind):
    c = client(servers[kind])
    try:
        c.recv_text()
        c.send_text(sized(ws.MAX_MESSAGE))
        assert c.recv_text() is None and c.close_code == ws.CLOSE_TOO_BIG
    finally:
        c.sock.close()


@pytest.mark.parametrize("kind", KINDS)
def test_text_that_is_not_utf8_closes_with_1007(servers, kind):
    c = client(servers[kind])
    try:
        c.recv_text()
        c.send_frame(ws.OP_TEXT, b"\xff\xfe")
        assert c.recv_text() is None and c.close_code == ws.CLOSE_INVALID_TEXT
    finally:
        c.sock.close()


@pytest.mark.parametrize("kind", KINDS)
def test_binary_frames_are_neither_cached_nor_broadcast(servers, kind):
    c = client(servers[kind])
    try:
        c.recv_text()
        c.send_frame(ws.OP_BINARY, json.dumps(messages()[1]).encode())
        stats = json.dumps(messages(7)[1])
        c.send_text(stats)
        assert c.recv_text() == stats
    finally:
        c.close()


def test_an_unmasked_client_frame_closes_with_1002(servers):
    """RFC 6455 5.1: the server closes on an unmasked client frame (aiohttp
    accepts one, so this is held on the port alone)."""
    c = client(servers["port"])
    try:
        c.recv_text()
        c.sock.sendall(ws.encode_frame(ws.OP_TEXT, b'{"jsonClass": "Stats"}'))
        assert c.recv_text() is None and c.close_code == ws.CLOSE_PROTOCOL
    finally:
        c.sock.close()


@pytest.mark.parametrize("answer", [True, False])
def test_heartbeat_closes_a_socket_whose_pong_does_not_come(tmp_path, answer):
    """Pinged after ``heartbeat`` s of silence: a client that answers stays
    connected across several pings; one that does not is cut half a
    heartbeat after the ping."""
    srv = Server(port=0, host=HOST, cache=ApiCache(str(tmp_path / "b.json")))
    srv.heartbeat = 1.0
    srv.start_background()
    try:
        c = client((HOST, srv.port))
        c.recv_text()
        c.sock.settimeout(10)
        fin, opcode, payload = c.recv_frame()  # the heartbeat's ping
        assert opcode == ws.OP_PING
        if answer:
            c.send_frame(ws.OP_PONG, payload)
            for _ in range(2):  # the next pings, answered as they come
                fin, opcode, payload = c.recv_frame()
                assert opcode == ws.OP_PING
                c.send_frame(ws.OP_PONG, payload)
            c.send_text(json.dumps(messages()[1]))
            assert c.recv_text() == json.dumps(messages()[1])
            c.close()
        else:
            with pytest.raises(ConnectionError):
                c.recv_frame()
            c.sock.close()
    finally:
        srv.stop()


def test_the_heartbeat_is_aiohttps():
    assert Server.heartbeat == 30.0 and ws.MAX_MESSAGE == 4 * 1024 * 1024


@pytest.mark.parametrize("kind", KINDS)
def test_stop_returns_within_5_s_with_sockets_live(tmp_path, kind):
    if kind == "port":
        srv = Server(port=0, host=HOST, cache=ApiCache(str(tmp_path / "b.json")))
        srv.start_background()
        addr = (HOST, srv.port)
    else:
        srv = JaxServer(port=0, host=HOST, cache=JaxCache(str(tmp_path / "b.json")))
        srv.start_background()
        addr = (HOST, srv._runner.addresses[0][1])
    socks = [client(addr) for _ in range(3)]
    for s in socks:
        s.recv_text()
    t0 = time.perf_counter()
    srv.stop()
    assert time.perf_counter() - t0 < 5
    for s in socks:
        s.sock.close()


def test_a_failed_bind_raises(tmp_path):
    first = Server(port=0, host=HOST, cache=ApiCache(str(tmp_path / "a.json")))
    first.start_background()
    try:
        with pytest.raises(OSError):
            Server(port=first.port, host=HOST,
                   cache=ApiCache(str(tmp_path / "b.json"))).start_background()
    finally:
        first.stop()


# ---- the cache and its backup -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_the_cache_answers_as_the_jax_cache(tmp_path, seed):
    ours = ApiCache(str(tmp_path / "a.json"))
    theirs = JaxCache(str(tmp_path / "b.json"))
    rng = np.random.default_rng(seed)
    msgs = messages(seed)
    for i in rng.integers(0, len(msgs), size=3 * SERIES_WINDOW):
        text = msgs[i] if isinstance(msgs[i], str) else json.dumps(msgs[i])
        ours.cache(text)
        theirs.cache(text)
    for view in VIEWS:
        assert json.loads(getattr(ours, view)()) == json.loads(getattr(theirs, view)()), view
    assert len(json.loads(ours.series())) <= SERIES_WINDOW


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_the_config_backup_restores_across_packages(tmp_path, direction):
    backup = str(tmp_path / "twtml-web.json")
    writer, reader = (ApiCache, JaxCache) if direction == "port-to-jax" else (JaxCache, ApiCache)
    w = writer(backup_file=backup)
    w.cache(json.dumps(messages()[0]))
    w.cache(json.dumps(messages()[1]))
    r = reader(backup_file=backup)
    r.restore()
    assert json.loads(r.config()) == messages()[0]
    assert json.loads(r.stats())["count"] == 0  # Stats live in memory only
    with open(backup) as fh:
        assert fh.read() == w.config() == r.config()


def test_restore_without_a_backup_keeps_the_default(tmp_path):
    cache = ApiCache(str(tmp_path / "missing.json"))
    cache.restore()
    assert json.loads(cache.config()) == {"jsonClass": "Config", "id": "", "host": "", "viz": []}


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nocache", [False, True])
def test_web_main_restores_the_backup_unless_nocache(tmp_path, nocache):
    """``python -m twtml_tpu_torch.web.main``: PORT and TMPDIR from the
    environment, the JAX server's backup in TMPDIR restored unless
    ``-nocache``, SIGTERM a clean exit."""
    JaxCache(backup_file=str(tmp_path / "twtml-web.json")).cache(json.dumps(messages()[0]))
    port = free_port()
    env = dict(os.environ, PORT=str(port), TMPDIR=str(tmp_path), PYTHONPATH=REPO)
    args = [sys.executable, "-m", "twtml_tpu_torch.web.main"] + (["-nocache"] if nocache else [])
    proc = subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            try:
                status, _, body, _ = request((HOST, port), "GET", "/api/config")
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
                time.sleep(0.05)
        assert status == 200
        want = {"jsonClass": "Config", "id": "", "host": "", "viz": []} if nocache else messages()[0]
        assert json.loads(body) == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
