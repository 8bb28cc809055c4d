"""The port's read-fleet router (``twtml_tpu_torch/serving/fleet.py``,
``apps/router.py``) and serving client, against the JAX package's
(``twtml_tpu/serving/fleet.py``): the same consistent-hash ring and
picks, the p99 policy's spread, ejection behind the jittered backoff and
retry on another replica, a clean 503 when every replica is down, a 400
passed through without ejection, the client's jittered retry, the front
door's statuses equal to the JAX router's, and two serve replica processes
behind the router with one killed mid-load: no client-visible error.

Replicas are the port's serve planes on the CPU behind the port's web
server. Every wait is bounded, and each test runs under a time limit of
its own (``_time_limit``); nothing waits on a fixed sleep for an event.
"""

import faulthandler
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.serving.fleet import FleetRouter as JaxRouter
from twtml_tpu.serving.fleet import _jittered_backoff as jax_backoff
from twtml_tpu.serving.plane import ServingPlane as JaxPlane
from twtml_tpu.serving.snapshot import ServingSnapshot as JaxSnapshot
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.web.cache import ApiCache as JaxCache
from twtml_tpu.web.server import Server as JaxServer

from twtml_tpu_torch.apps import router as router_app
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.serving import FleetRouter, ServingClient, ServingSnapshot
from twtml_tpu_torch.serving.client import ServingError
from twtml_tpu_torch.serving.fleet import _jittered_backoff
from twtml_tpu_torch.serving.plane import ServingPlane
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.web.cache import ApiCache
from twtml_tpu_torch.web.server import Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW_MS = 1785320000000
LIMIT_S = 150.0


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
    _metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    yield
    _metrics.reset_for_tests()
    jax_metrics.reset_for_tests()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def weights_for_step(step):
    return (np.random.default_rng(100 + step).standard_normal(1004) * 5.0).astype(np.float32)


def make_rows(n, seed=3):
    return [{
        "text": s.retweeted_status.text,
        "followers_count": s.retweeted_status.followers_count,
        "favourites_count": s.retweeted_status.favourites_count,
        "friends_count": s.retweeted_status.friends_count,
        "created_at_ms": s.retweeted_status.created_at_ms,
    } for s in SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce()]


def refs_for_steps(steps, rows):
    """The port train step's pre-update predictions of ``rows`` under each
    step's weights."""
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        ServingPlane.statuses_from_rows(rows), row_bucket=32, pre_filtered=True)
    refs = {}
    for step in steps:
        model = StreamingLinearRegressionWithSGD(device="cpu")
        model.set_initial_weights(weights_for_step(step))
        out = model.fetch_output(model.step(batch)).result()
        refs[step] = out.predictions[np.asarray(batch.mask) > 0]
    return refs


class Replica:
    """One in-process replica: a started plane behind a started server."""

    def __init__(self, tmp_path, name, step=1, port=0):
        self.plane = ServingPlane(
            ServingSnapshot(step=step, weights=weights_for_step(step)),
            featurizer=Featurizer(now_ms=NOW_MS), batch_rows=32, max_wait_ms=2.0, depth=4,
            device="cpu").start()
        self.server = Server(port=port, host="127.0.0.1",
                             cache=ApiCache(str(tmp_path / f"{name}.json")))
        self.server.attach_serving(self.plane).start_background()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def stop(self):
        self.server.stop()
        self.plane.stop()


@pytest.fixture()
def replicas(tmp_path):
    made = []

    def make(name, **kw):
        made.append(Replica(tmp_path, name, **kw))
        return made[-1]

    yield make
    for rep in made:
        rep.stop()


BODY = json.dumps({"rows": [{"text": "route me", "created_at_ms": NOW_MS}]}).encode()


# ---- the routing core --------------------------------------------------------------

def test_hash_ring_and_picks_equal_the_jax_routers():
    urls = [f"http://10.0.0.{i}:8888" for i in range(1, 5)]
    ours, theirs = FleetRouter(urls, policy="hash"), JaxRouter(urls, policy="hash")
    try:
        assert ours._ring == theirs._ring and len(ours._ring) == 64 * 4
        for i in range(200):
            key = json.dumps({"rows": [f"key {i}"]}).encode()
            for exclude in (set(), {1}, {0, 2}):
                a, b = ours._pick(key, exclude), theirs._pick(key, exclude)
                assert a.index == b.index
    finally:
        ours.stop()
        theirs.stop()


def test_the_backoff_ladder_is_the_jax_routers():
    for ejections, base in ((0, 0.5), (1, 0.5), (2, 1.0), (3, 2.0), (6, 15.0), (40, 15.0)):
        for fn in (_jittered_backoff, jax_backoff):
            for _ in range(8):
                assert 0.5 * base <= fn(ejections) <= base


def test_router_refuses_an_empty_fleet_and_an_unknown_policy():
    with pytest.raises(ValueError, match="at least one replica"):
        FleetRouter([])
    with pytest.raises(ValueError, match="routePolicy"):
        FleetRouter(["http://a:1"], policy="rr")
    with pytest.raises(SystemExit, match="--replicas is required"):
        router_app.run(ConfArguments().parse([]))


def test_route_policy_p99_spreads_and_hash_sticks(replicas):
    a, b = replicas("a"), replicas("b")
    p99 = FleetRouter([a.url, b.url], policy="p99")
    sticky = FleetRouter([a.url, b.url], policy="hash")
    try:
        for _ in range(8):
            assert p99.predict(BODY)[0] == 200
        assert all(r.requests > 0 for r in p99.replicas)  # ties round-robin
        for _ in range(6):
            assert sticky.predict(BODY)[0] == 200
        assert sorted(r.requests for r in sticky.replicas) == [0, 6]  # one key, one replica
        for i in range(32):
            assert sticky.predict(json.dumps({"rows": [f"key {i}"]}).encode())[0] == 200
        assert all(r.requests > 0 for r in sticky.replicas)
    finally:
        p99.stop()
        sticky.stop()


def test_dead_replica_ejects_retries_and_recovers(replicas):
    live = replicas("live")
    dead_port = free_port()
    dead = f"http://127.0.0.1:{dead_port}"
    router = FleetRouter([dead, live.url], policy="p99")
    try:
        for _ in range(6):
            status, payload = router.predict(BODY)
            assert status == 200, payload
        reg = _metrics.get_registry()
        assert reg.counter("router.retries").snapshot() >= 1
        assert reg.counter("fleet.replica_ejections").snapshot() >= 1
        view = router.stats()
        by_url = {r["url"]: r for r in view["replicas"]}
        assert not by_url[dead]["healthy"] and by_url[live.url]["healthy"]
        assert by_url[live.url]["snapshotStep"] == -1  # no probe ran yet
        # a replica coming up at the dead address: the probe restores it
        replicas("late", port=dead_port)
        router.replicas[0].ejected_until = 0.0  # skip the backoff
        router.health_check_once()
        assert router.replicas[0].healthy
        assert reg.counter("fleet.replica_restores").snapshot() == 1
    finally:
        router.stop()


def test_all_replicas_down_is_a_clean_503():
    urls = [f"http://127.0.0.1:{free_port()}" for _ in range(2)]
    router, jax_router = FleetRouter(urls), JaxRouter(urls)
    try:
        for rt, reg in ((router, _metrics), (jax_router, jax_metrics)):
            status, payload = rt.predict(b'{"rows": ["x"]}')
            assert status == 503
            assert "fleet has no live replica" in json.loads(payload)["error"]
            assert reg.get_registry().counter("router.errors").snapshot() == 1
    finally:
        router.stop()
        jax_router.stop()


def test_bad_request_passes_through_without_ejection(replicas):
    rep = replicas("r")
    router = FleetRouter([rep.url])
    try:
        status, payload = router.predict(b'{"rows": 7}')
        assert status == 400
        assert "bad predict request" in json.loads(payload)["error"]
        assert router.replicas[0].healthy
        reg = _metrics.get_registry()
        assert reg.counter("router.retries").snapshot() == 0
        assert reg.counter("fleet.replica_ejections").snapshot() == 0
    finally:
        router.stop()


def test_client_jittered_retry_on_503_and_connection_refused(tmp_path):
    client = ServingClient(f"http://127.0.0.1:{free_port()}", timeout=1.0, retries=2)
    t0 = time.monotonic()
    with pytest.raises(ServingError) as err:
        client.predict(["x"])
    assert err.value.status == 0
    assert time.monotonic() - t0 >= 0.15  # two sleeps of >= 0.5x (0.1 + 0.2)
    reg = _metrics.get_registry()
    assert reg.counter("serve.client_retries").snapshot() == 2
    for attempt, base in ((1, 0.1), (2, 0.2), (3, 0.4), (30, 2.0)):
        for _ in range(8):
            assert 0.5 * base <= ServingClient._backoff(attempt) <= base
    # a 503 retries too; a 400 raises at once
    bare = Server(port=0, host="127.0.0.1", cache=ApiCache(str(tmp_path / "c.json")))
    bare.start_background()
    try:
        url = f"http://127.0.0.1:{bare.port}"
        with pytest.raises(ServingError) as err:
            ServingClient(url, retries=1).predict(["x"])
        assert err.value.status == 503
        assert reg.counter("serve.client_retries").snapshot() == 3
    finally:
        bare.stop()
    with pytest.raises(ServingError):
        ServingClient(f"http://127.0.0.1:{free_port()}", timeout=1.0, retries=0).predict(["x"])
    assert reg.counter("serve.client_retries").snapshot() == 3


# ---- the front door ----------------------------------------------------------------

def _router_thread(argv):
    ready, result, stop = threading.Event(), {}, threading.Event()

    def started(server, router):
        result["port"], result["router"] = server.port, router
        ready.set()

    def runner():
        result["stats"] = router_app.run(ConfArguments().parse(argv), started=started,
                                         stop_event=stop)

    thread = threading.Thread(target=runner)
    thread.start()
    assert ready.wait(30), "the router never came up"
    return stop, thread, result


def test_router_app_smoke_single_replica(replicas):
    rep = replicas("r0")
    stop, thread, result = _router_thread(["--replicas", rep.url, "--routerPort", "0",
                                           "--routePolicy", "p99"])
    try:
        client = ServingClient(f"http://127.0.0.1:{result['port']}")
        res = client.predict(make_rows(6, seed=2))
        assert res["snapshotStep"] == 1 and res["servedRows"] == 6
        view = client.fleet()
        assert view["jsonClass"] == "Fleet" and view["policy"] == "p99"
        assert [r["healthy"] for r in view["replicas"]] == [True]
        assert view["requests"] >= 1 and view["ejections"] == 0
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert result["stats"]["requests"] >= 1


ROUTER_BODIES = {
    "rows": json.dumps({"rows": make_rows(3, seed=8)}).encode(),
    "empty": b'{"rows": []}',
    "rows_not_a_list": b'{"rows": 7}',
    "not_json": b"not json",
    "oversized": json.dumps({"rows": make_rows(33, seed=2)}).encode(),
}


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """The port's router over a port replica and the JAX router over a JAX
    replica, the same weights: {kind: front door port}."""
    d = tmp_path_factory.mktemp("routers")
    w = weights_for_step(1)
    ours = Replica(d, "port_replica")
    theirs_plane = JaxPlane(JaxSnapshot(step=1, weights=w), batch_rows=32, max_wait_ms=2.0,
                            depth=4, featurizer=JaxFeaturizer(now_ms=NOW_MS)).start()
    theirs = JaxServer(port=0, host="127.0.0.1", cache=JaxCache(str(d / "j.json")))
    theirs.attach_serving(theirs_plane).start_background()
    jax_url = f"http://127.0.0.1:{theirs._runner.addresses[0][1]}"
    router, jax_router = FleetRouter([ours.url]), JaxRouter([jax_url])
    doors = (Server(port=0, host="127.0.0.1", cache=ApiCache(str(d / "pr.json"))),
             JaxServer(port=0, host="127.0.0.1", cache=JaxCache(str(d / "jr.json"))))
    doors[0].attach_fleet(router).start_background()
    doors[1].attach_fleet(jax_router).start_background()
    try:
        yield {"port": doors[0].port, "jax": doors[1]._runner.addresses[0][1],
               "router": router, "jax_router": jax_router}
    finally:
        for door in doors:
            door.stop()
        router.stop()
        jax_router.stop()
        theirs.stop()
        theirs_plane.stop()
        ours.stop()


@pytest.mark.parametrize("case", list(ROUTER_BODIES))
def test_router_front_door_statuses_and_bodies_equal_the_jax_routers(routers, case):
    import urllib.error
    import urllib.request

    def post(port):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/predict",
                                     data=ROUTER_BODIES[case], method="POST",
                                     headers={"content-type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    got, want = post(routers["port"]), post(routers["jax"])
    assert got[0] == want[0] and set(got[1]) == set(want[1])
    if got[0] == 200:
        for key in ("predictions", "snapshotStep", "servedRows"):
            assert got[1][key] == want[1][key]
    else:
        assert got[1]["error"] == want[1]["error"]
    ours = ServingClient(f"http://127.0.0.1:{routers['port']}").fleet()
    theirs = ServingClient(f"http://127.0.0.1:{routers['jax']}").fleet()
    assert set(ours) == set(theirs) and ours["jsonClass"] == "Fleet"
    assert set(ours["replicas"][0]) == set(theirs["replicas"][0])


# ---- replica processes -------------------------------------------------------------

def _spawn_replica(ck, port, log_path):
    env = dict(os.environ, TWTML_NOW_MS=str(NOW_MS), PYTHONPATH=REPO)
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "twtml_tpu_torch.apps.serve", "--backend", "cpu",
             "--master", "local[1]", "--checkpointDir", str(ck), "--servePort", str(port),
             "--serveBatchRows", "32", "--serveMaxWaitMs", "2", "--servePromoteEvery", "0.1",
             "--blackbox", "off"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait_step(url, step, deadline_s=90.0):
    """Until the replica's published Serving view names ``step``."""
    client = ServingClient(url, timeout=2.0, retries=0)
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            if client.serving().get("snapshotStep", -1) >= step:
                return True
        except OSError:
            pass  # not listening yet
        time.sleep(0.2)
    return False


def test_two_replica_processes_tear_nothing_and_survive_a_kill(tmp_path):
    """Two ``python -m twtml_tpu_torch.apps.serve`` processes behind the
    router: every routed response equals the snapshot step it names across
    a promotion, and a replica killed mid-load costs no client an error."""
    ck = tmp_path / "ck"
    Checkpointer(str(ck)).save(1, weights_for_step(1), {"quality": {"level": "ok"}})
    rows = make_rows(8, seed=21)
    refs = refs_for_steps((1, 2), rows)
    ports = (free_port(), free_port())
    procs = [_spawn_replica(ck, port, tmp_path / f"r{i}.log") for i, port in enumerate(ports)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    stop = thread = None
    try:
        for url in urls:
            assert _wait_step(url, 1), (tmp_path / "r0.log").read_text()[-2000:]
        stop, thread, result = _router_thread(["--replicas", ",".join(urls),
                                               "--routerPort", "0"])
        client = ServingClient(f"http://127.0.0.1:{result['port']}", timeout=60.0, retries=2)
        responses = [client.predict(rows) for _ in range(6)]
        Checkpointer(str(ck)).save(2, weights_for_step(2), {"quality": {"level": "ok"}})
        responses += [client.predict(rows) for _ in range(4)]
        for url in urls:
            assert _wait_step(url, 2)
        responses += [client.predict(rows) for _ in range(4)]
        for res in responses:
            assert np.array_equal(refs[res["snapshotStep"]],
                                  np.asarray(res["predictions"], np.float32))
        assert {r["snapshotStep"] for r in responses} == {1, 2}

        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=30)
        for _ in range(12):  # raises on a client-visible error
            res = client.predict(rows)
            assert np.array_equal(refs[2], np.asarray(res["predictions"], np.float32))
        router = result["router"]
        deadline = time.monotonic() + 30.0
        while router.replicas[0].healthy and time.monotonic() < deadline:
            router.health_check_once()  # the health cadence, driven here
        view = router.stats()
        assert not view["replicas"][0]["healthy"] and view["replicas"][1]["healthy"]
        assert view["ejections"] >= 1
    finally:
        if stop is not None:
            stop.set()
            thread.join(timeout=30)
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
