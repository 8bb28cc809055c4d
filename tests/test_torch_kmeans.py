"""The port's streaming k-means on the CPU against the JAX package's: the
random centers' normal draw (bitwise for the app's (3, 2)), the update rule
(decay by batches and by points, the all-padding no-op, the dying-cluster
split), the per-batch standard scaler, the app's lines on the replay
fixture, its Lightning scatter payloads at a recorder, and its checkpoint.

Tolerances: the app's (3, 2) draw bitwise, other normal draws within 3 ulp
(XLA's erf_inv fuses multiply-adds the port does in float64); the update
and the scaler within rtol 1e-5 / atol 1e-6 (float32 summation order),
assignments and sizes exactly; the printed lines exactly; the chart's
points within 1e-6."""

import contextlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.models.kmeans import _update_step as jax_update_step
from twtml_tpu.ops.scaler import standard_scale as jax_standard_scale

from twtml_tpu_torch import convert
from twtml_tpu_torch.apps import kmeans as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.models.kmeans import StreamingKMeans, update_step
from twtml_tpu_torch.ops import prng
from twtml_tpu_torch.ops.scaler import standard_scale
from twtml_tpu_torch.telemetry.lightning import Lightning

NOW_MS = "1700000000000"
FIXTURE = "tests/data/tweets.jsonl"
CLOSED = "http://127.0.0.1:9"


def ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def test_the_apps_random_centers_are_jaxs_bitwise():
    ours = prng.normal(prng.prng_key(0), (3, 2), "cpu").numpy()
    theirs = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 2), dtype=jnp.float32))
    assert ours.dtype == np.float32 and ulps(ours, theirs).max() == 0
    model = StreamingKMeans(device="cpu").set_k(3).set_random_centers(2, 0.0)
    np.testing.assert_array_equal(model.latest_centers, theirs)
    np.testing.assert_array_equal(model.latest_weights, np.zeros(3, np.float32))


@pytest.mark.parametrize("seed,shape", [(1, (5, 3)), (7, (64,)), (0, (4096,))])
def test_other_normal_draws_within_3_ulp(seed, shape):
    ours = prng.normal(prng.prng_key(seed), shape, "cpu").numpy()
    theirs = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))
    assert ulps(ours, theirs).max() <= 3


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999])
    got = prng.erf_inv(x)
    assert torch.isneginf(got[0]) and torch.isposinf(got[1]) and got[2] == 0
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert ulps(got[2:].numpy(), want[2:]).max() <= 1


def update_inputs(seed, rows=64, valid=50, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)).astype(np.float32)
    weights = rng.uniform(0, 5, size=3).astype(np.float32)
    points = rng.normal(size=(rows, d)).astype(np.float32) * 2
    mask = (np.arange(rows) < valid).astype(np.float32)
    return centers, weights, points, mask


def check_update(args, decay, unit):
    ours = update_step(*(torch.from_numpy(a) for a in args), decay, unit)
    theirs = jax_update_step(*(jnp.asarray(a) for a in args), decay, unit)
    for got, want in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    return ours


@pytest.mark.parametrize("unit", ["batches", "points"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_matches_the_jax_rule(unit, seed):
    check_update(update_inputs(seed), 0.87, unit)


def test_all_padding_batch_is_a_state_no_op():
    centers, weights, points, _ = update_inputs(3)
    new_c, new_w, _ = check_update((centers, weights, points, np.zeros(64, np.float32)),
                                   0.5, "points")
    np.testing.assert_array_equal(new_c.numpy(), centers)
    np.testing.assert_array_equal(new_w.numpy(), weights)


def test_dying_cluster_splits_the_largest():
    centers = np.array([[0, 0], [10, 10], [100, 100]], np.float32)
    weights = np.array([1e9, 5, 1e-3], np.float32)
    points = np.zeros((8, 2), np.float32)
    new_c, new_w, _ = check_update((centers, weights, points, np.ones(8, np.float32)),
                                   1.0, "batches")
    assert new_w[0] == new_w[2] and new_c[0, 0] > 0 > new_c[2, 0]


def test_model_update_and_predict_match_the_jax_model():
    from twtml_tpu.models.kmeans import StreamingKMeans as JaxKMeans

    ours = StreamingKMeans(device="cpu").set_k(3).set_half_life(5, "batches") \
        .set_random_centers(2, 0.0)
    theirs = JaxKMeans().set_k(3).set_half_life(5, "batches").set_random_centers(2, 0.0)
    assert ours.decay_factor == theirs.decay_factor
    for seed in range(4):
        _, _, points, mask = update_inputs(10 + seed)
        np.testing.assert_array_equal(ours.update(points, mask), theirs.update(points, mask))
        np.testing.assert_allclose(ours.latest_centers, theirs.latest_centers, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(ours.predict(points), theirs.predict(points))


def test_a_mesh_of_one_rank_trains_as_one_device():
    """What raised naming ROADMAP A10 until k-means across hosts was ported:
    a mesh (with its group's Collectives) builds, and over a group of one
    it trains bitwise as the single-device model; a mesh without its group
    raises."""
    from twtml_tpu_torch.parallel.distributed import Collectives
    from twtml_tpu_torch.parallel.mesh import make_mesh

    def build(**kw):
        return (StreamingKMeans(device="cpu", **kw).set_k(3).set_half_life(5, "batches")
                .set_random_centers(2, 0.0))

    rng = np.random.default_rng(4)
    points = (rng.normal(size=(64, 2)) * [1.0, 5.0]).astype(np.float32)
    mesh, one = build(mesh=make_mesh(num_processes=1), group=Collectives()), build()
    for _ in range(3):
        np.testing.assert_array_equal(mesh.update(points), one.update(points))
    np.testing.assert_array_equal(mesh.latest_centers, one.latest_centers)
    np.testing.assert_array_equal(mesh.latest_weights, one.latest_weights)
    with pytest.raises(ValueError, match="needs its group"):
        StreamingKMeans(mesh=make_mesh(num_processes=1), device="cpu")


@pytest.mark.parametrize("valid", [0, 1, 2, 40, 64])
def test_standard_scale_matches_the_jax_scaler(valid):
    rng = np.random.default_rng(valid)
    points = rng.normal(size=(64, 2)).astype(np.float32) * [1e3, 2.0]
    points[:, 1][::3] = 7.0
    mask = (np.arange(64) < valid).astype(np.float32)
    points[valid:] = np.nan if valid else points[valid:]  # masked rows never reach the fit
    ours = standard_scale(torch.from_numpy(points), torch.from_numpy(mask)).numpy()
    theirs = np.asarray(jax_standard_scale(jnp.asarray(points), jnp.asarray(mask)))
    np.testing.assert_allclose(ours[:valid], theirs[:valid], rtol=1e-5, atol=1e-6)
    if valid:
        assert not np.isnan(ours[:valid]).any()


def test_constant_column_scales_to_zero():
    points = np.stack([np.arange(8, dtype=np.float32), np.full(8, 3.0, np.float32)], 1)
    out = standard_scale(torch.from_numpy(points), torch.ones(8)).numpy()
    np.testing.assert_array_equal(out[:, 1], 0.0)


# ---- the app ---------------------------------------------------------------------

class Recorder:
    """A loopback Lightning server recording every POST (path, JSON body):
    session ``s1``, visualization ``v1``."""

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
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def wait_for(self, n, timeout=10.0):
        end = time.monotonic() + timeout
        while len(self.posts) < n and time.monotonic() < end:
            time.sleep(0.01)
        return list(self.posts)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


ARGV = ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
        "--twtweb", CLOSED, "--webTimeout", "0.2"]


def port_lines(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(["--backend", "cpu", *argv]))
    return totals, out.getvalue().splitlines()


def jax_lines(argv, capsys):
    from twtml_tpu.apps import kmeans as jax_app

    jax.devices()
    capsys.readouterr()
    totals = jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]))
    return totals, [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]


def test_app_on_the_fixture_prints_the_jax_apps_lines_and_charts(monkeypatch, capsys):
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    ours_rec, theirs_rec = Recorder(), Recorder()
    try:
        totals, lines = port_lines([*ARGV, "--lightning", ours_rec.url])
        jax_totals, want = jax_lines([*ARGV, "--lightning", theirs_rec.url], capsys)
        ours, theirs = ours_rec.wait_for(3), theirs_rec.wait_for(3)
    finally:
        ours_rec.close()
        theirs_rec.close()
    assert lines == want
    assert totals["count"] == jax_totals["count"] == 8
    assert lines[0].startswith("count: 8  batch: 8  centers: ")
    # the chart: session, scatter created empty, one append of the batch
    assert [p for p, _ in ours] == [p for p, _ in theirs] == [
        "/sessions/", "/sessions/s1/visualizations/", "/visualizations/v1/data/"]
    assert ours[0][1] == theirs[0][1] and ours[1][1] == theirs[1][1]
    (a, b) = ours[2][1]["data"], theirs[2][1]["data"]
    assert a["label"] == b["label"] and len(a["x"]) == 8
    np.testing.assert_allclose(a["x"], b["x"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a["y"], b["y"], rtol=1e-6, atol=1e-6)


def test_app_batches_back_to_back_as_the_jax_app(monkeypatch, capsys):
    """The fixture's 10 statuses in drains of 5: two batches, each line the
    JAX app's (the half-life decay carries across batches)."""
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    argv = [*ARGV, "--batchBucket", "5", "--lightning", CLOSED]
    _, lines = port_lines(argv)
    _, want = jax_lines(argv, capsys)
    assert lines == want and len(lines) == 2


def test_app_checkpoints_centers_and_weights_for_either_package(tmp_path, monkeypatch):
    from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer

    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    ck = tmp_path / "ck"
    port_lines([*ARGV, "--lightning", CLOSED, "--checkpointDir", str(ck),
                "--checkpointEvery", "1", "--history", "off"])
    state, meta = JaxCheckpointer(str(ck)).restore()
    assert set(state) == {"centers", "weights"} and meta["batches"] == 1
    assert state["centers"].shape == (3, 2) and state["weights"].dtype == np.float32
    # a second run resumes from it: its first line counts on from 8
    _, lines = port_lines([*ARGV, "--lightning", CLOSED, "--checkpointDir", str(ck),
                           "--history", "off"])
    assert lines[0].startswith("count: 16  batch: 8")


def test_app_runs_with_the_multi_host_values(tmp_path):
    """The multi-host values (a ``twtml://`` master, ``--numProcesses``,
    ``--processId``), which raised naming ROADMAP A10c until k-means across
    hosts was ported, now form a group: two CPU ranks over the fixture's 8
    retweets at 4 rows a rank print one process's line at ``--batchBucket
    8``, and the follower prints nothing."""
    from torch_group import run_torch_group, run_torch_single, stat_lines

    argv = ["--backend", "cpu", "--source", "replay", "--replayFile", FIXTURE, "--seconds",
            "0", "--lightning", CLOSED, "--twtweb", CLOSED]
    results = run_torch_group([*argv, "--batchBucket", "4"], app="kmeans")
    for rc, _out, err in results:
        assert rc == 0, err[-3000:]
    lead, follower = (stat_lines(out) for _rc, out, _err in results)
    assert follower == []
    assert lead == stat_lines(run_torch_single([*argv, "--batchBucket", "8"], app="kmeans"))


@pytest.mark.parametrize("group", [[], ["--master", "twtml://127.0.0.1:9", "--numProcesses",
                                         "2", "--processId", "1"]],
                         ids=["one host", "a group"])
def test_elastic_on_exits_as_the_jax_app(group):
    """``--elastic on`` stops both k-means apps on the same argv with the
    JAX app's exit (the elastic rebuild is wired for the SGD apps only),
    before anything is joined or built."""
    from twtml_tpu.apps import kmeans as jax_app

    argv = ["--backend", "cpu", "--elastic", "on", *group, "--lightning", CLOSED]
    with pytest.raises(SystemExit) as theirs:
        jax_app.run(JaxConf().parse([("tpu" if a == "cuda" else a) for a in argv]))
    with pytest.raises(SystemExit) as ours:
        app.run(ConfArguments().parse(argv))
    assert str(ours.value) == str(theirs.value)
    assert "k-means plane keeps the abort-on-peer-loss behavior" in str(ours.value)


def test_scatter_streaming_payloads():
    rec = Recorder()
    try:
        lgn = Lightning(host=rec.url)
        viz = lgn.scatter_streaming([], [])
        lgn.scatter_streaming(np.array([0.5, 1.0]), [2, 3], label=np.array([1, 0]), viz=viz)
    finally:
        rec.close()
    assert rec.posts == [
        ("/sessions/", {}),
        ("/sessions/s1/visualizations/",
         {"type": "scatter-streaming", "data": {"x": [], "y": []}}),
        ("/visualizations/v1/data/", {"data": {"x": [0.5, 1.0], "y": [2.0, 3.0],
                                               "label": [1, 0]}}),
    ]


def test_kmeans_state_converts_both_ways():
    rng = np.random.default_rng(0)
    c, w = rng.normal(size=(3, 2)).astype(np.float32), np.ones(3, np.float32)
    tc, tw = convert.kmeans_from_jax(c, w, device="cpu")
    back = convert.kmeans_to_numpy(tc, tw)
    np.testing.assert_array_equal(back[0], c)
    np.testing.assert_array_equal(back[1], w)
    with pytest.raises(ValueError):
        convert.kmeans_from_jax(c, np.ones(2, np.float32), device="cpu")
    with pytest.raises(TypeError):
        convert.kmeans_from_jax(c.astype(np.float64), w, device="cpu")
