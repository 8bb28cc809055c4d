"""The port's champion/challenger serving (``twtml_tpu_torch/serving/
abtest.py``, ``apps/serve.py --abtest on``) and the tenant-stack predict
engine on the CPU, where B1's plain twin stands in for the card, each case
of tests/test_abtest.py held against the JAX ``ChampionSelector`` and
``ChampionEngine`` on the same stamps and rows.

- The selector's verdicts and counters equal the JAX selector's: strictly
  better promotes once a stamped step, an alert-stamped best challenger is
  refused through the one gate and counted, warn serves, missing stamps
  never promote.
- A champion's answers are bitwise the port's train-step pre-update
  predictions of that tenant's weights; against the JAX engine rounded
  predictions are equal and raw margins within 2e-3
  (tests/test_torch_serving.py's tolerance: bf16 X and another summation
  order). One fetch a served batch, the challengers' shadow scores
  included.
- Shadow divergence, the atomic champion swap under load, the serve app
  over HTTP and its refusal of a single-model checkpoint, the trainer's
  per-tenant quality stamps, the Fleet view's champion, and a tenant
  stack served without A/B (each row its own tenant's answer).

Every wait is bounded (futures, joins, HTTP timeouts), and each test runs
under a time limit of its own.
"""

import faulthandler
import threading
import time

import numpy as np
import pytest

from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.ops.quality import QUALITY_WIDTH as JAX_QUALITY_WIDTH
from twtml_tpu.serving.abtest import ChampionEngine as JaxChampion
from twtml_tpu.serving.abtest import ChampionSelector as JaxSelector
from twtml_tpu.serving.fleet import FleetRouter as JaxRouter
from twtml_tpu.serving.plane import ServingPlane as JaxPlane
from twtml_tpu.serving.snapshot import ServingSnapshot as JaxSnapshot
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry import modelwatch as jax_modelwatch

from twtml_tpu_torch.apps import linear_regression as train_app
from twtml_tpu_torch.apps import serve as serve_app
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.batch import tenant_rows
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD as Linear
from twtml_tpu_torch.ops.quality import QUALITY_WIDTH
from twtml_tpu_torch.parallel import tenants as port_tenants
from twtml_tpu_torch.serving import FleetRouter, ServingClient, ServingSnapshot
from twtml_tpu_torch.serving.abtest import ChampionEngine, ChampionSelector
from twtml_tpu_torch.serving.engine import PredictEngine
from twtml_tpu_torch.serving.plane import ServingPlane
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import lineage, modelwatch
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.telemetry import tenants as _tenants
from twtml_tpu_torch.telemetry.web_client import WebClient
from twtml_tpu_torch.web.cache import ApiCache
from twtml_tpu_torch.web.server import Server

NOW_MS = 1785320000000
CLOSED = "http://127.0.0.1:9"
RAW_ATOL = 2e-3
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
    def reset():
        for mod in (_metrics, jax_metrics, modelwatch, jax_modelwatch, _tenants, lineage):
            mod.reset_for_tests()

    reset()
    yield
    reset()


def counters(metrics):
    reg = metrics.get_registry()
    return (int(reg.counter("abtest.promotions").snapshot()),
            int(reg.counter("abtest.promotions_refused").snapshot()))


def stamps(entries):
    """Meta with per-tenant quality stamps; ``entries`` = [(level, loss)]."""
    return {"quality": {"level": "ok", "tenants": [
        {"tenant": i, "level": level, "loss": loss,
         "drift_score": 9.0 if level == "alert" else 0.5, "loss_trend": 0.0}
        for i, (level, loss) in enumerate(entries)]}}


def stack(m, seed=0, scale=1e-3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, 1004)) * scale).astype(np.float32)


def rows_of(n, seed=3):
    """The JSON request face of ``n`` synthetic originals, creation times
    pinned: one input for both packages."""
    return [{
        "text": s.retweeted_status.text,
        "followers_count": s.retweeted_status.followers_count,
        "favourites_count": s.retweeted_status.favourites_count,
        "friends_count": s.retweeted_status.friends_count,
        "created_at_ms": s.retweeted_status.created_at_ms,
    } for s in SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce()]


def plane(snapshot, engine=None, **kw):
    kw.setdefault("featurizer", Featurizer(now_ms=NOW_MS))
    kw.setdefault("batch_rows", 32)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("depth", 4)
    if engine is None:
        kw.setdefault("device", "cpu")
    return ServingPlane(snapshot, engine=engine, **kw)


def jax_plane(snapshot, engine=None, **kw):
    kw.setdefault("featurizer", JaxFeaturizer(now_ms=NOW_MS))
    kw.setdefault("batch_rows", 32)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("depth", 4)
    return JaxPlane(snapshot, engine=engine, **kw)


def champion_engine(m, model_cls=None, **kw):
    return ChampionEngine(num_text_features=1000, num_tenants=m, model_cls=model_cls,
                          device="cpu", **kw)


def refs_per_tenant(w, statuses, model_cls=Linear):
    """Tenant m's weights through the port's train step: the pre-update
    predictions of ``statuses`` (valid rows), bitwise what serving owes."""
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(statuses, row_bucket=32,
                                                             pre_filtered=True)
    mask = np.asarray(batch.mask) > 0
    refs = {}
    for m in range(w.shape[0]):
        model = model_cls(device="cpu").set_initial_weights(w[m])
        refs[m] = model.fetch_output(model.step(batch)).result().predictions[mask]
    return refs


# ---- the promotion rule ---------------------------------------------------------------

SELECTOR_SCRIPTS = {
    # name: (tenants, champion, [(meta, step)])
    "promotes_strictly_better_exactly_once": (3, 0, [
        (stamps([("ok", 10.0), ("ok", 5.0), ("ok", 7.0)]), 1),
        (stamps([("ok", 10.0), ("ok", 5.0), ("ok", 7.0)]), 1),
        (stamps([("ok", 10.0), ("ok", 5.0), ("ok", 7.0)]), 2)]),
    "refuses_alert_challenger_through_the_gate": (3, 0, [
        (stamps([("ok", 10.0), ("ok", 5.0), ("alert", 1.0)]), 4)]),
    "alert_only_challenger_holds_the_champion": (2, 0, [
        (stamps([("ok", 10.0), ("alert", 1.0)]), 1)]),
    "warn_serves": (2, 0, [(stamps([("ok", 10.0), ("warn", 2.0)]), 1)]),
    "missing_stamps_never_promote": (2, 0, [
        ({"quality": {"level": "ok"}}, 1), (None, 2),
        ({"quality": {"tenants": [{"tenant": 0, "level": "ok", "loss": 3.0},
                                  {"tenant": 1, "level": "ok"}]}}, 3)]),
    "out_of_range_and_bad_losses": (2, 1, [
        ({"quality": {"tenants": [{"tenant": 0, "level": "ok", "loss": "x"},
                                  {"tenant": 1, "level": "ok", "loss": 4.0},
                                  {"tenant": 7, "level": "ok", "loss": 0.1}]}}, 1)]),
}


@pytest.mark.parametrize("script", list(SELECTOR_SCRIPTS))
def test_selector_gives_the_jax_selectors_verdicts(script):
    m, champ, calls = SELECTOR_SCRIPTS[script]
    ours, theirs = ChampionSelector(m, champ), JaxSelector(m, champ)
    for meta, step in calls:
        assert ours.consider(meta, step) == theirs.consider(meta, step)
        assert ours.champion == theirs.champion
    assert counters(_metrics) == counters(jax_metrics)
    expected = {"promotes_strictly_better_exactly_once": (1, (1, 0)),
                "refuses_alert_challenger_through_the_gate": (1, (1, 1)),
                "alert_only_challenger_holds_the_champion": (0, (0, 1)),
                "warn_serves": (1, (1, 0)),
                "missing_stamps_never_promote": (0, (0, 0)),
                "out_of_range_and_bad_losses": (1, (0, 0))}[script]
    assert (ours.champion, counters(_metrics)) == expected
    with pytest.raises(ValueError, match="out of range"):
        ChampionSelector(m, m)


# ---- the champion's answers ------------------------------------------------------------

class _RawLinear(Linear):
    round_predictions = False


class _RawJaxLinear(JaxLinear):
    round_predictions = False


def test_champion_answers_bitwise_the_tenant_train_step_with_one_fetch_a_batch(monkeypatch):
    w = stack(3, seed=7, scale=0.5)
    meta = stamps([("ok", 1.0), ("ok", 5.0), ("ok", 9.0)])
    rows = rows_of(24, seed=5)
    fetches = []
    real = port_tenants.fetch_output
    monkeypatch.setattr(port_tenants, "fetch_output", lambda out: fetches.append(1) or real(out))
    engine = champion_engine(3)
    p = plane(ServingSnapshot(step=1, weights=w, meta=meta), engine).start()
    try:
        statuses = p.statuses_from_rows(rows)
        res = p.submit(statuses).result(timeout=60)
        view = p.stats()
    finally:
        p.stop()
    refs = refs_per_tenant(w, statuses)
    got = np.asarray(res["predictions"], np.float32)
    assert engine.champion == 0 and np.array_equal(refs[0], got)
    assert len(set(got.tolist())) > 1
    assert len(fetches) == 1  # the challengers rode the champion's fetch
    assert view["champion"] == 0
    shadows = {s["tenant"]: s for s in view["shadows"]}
    assert shadows[0]["live"] and shadows[0]["liveRows"] == 24
    assert shadows[1]["shadowRows"] == shadows[2]["shadowRows"] == 24
    assert {t["tenant"]: t["rows"] for t in view["tenants"]} == {0: 24, 1: 0, 2: 0}
    # the JAX engine on the same stack and rows
    jp = jax_plane(JaxSnapshot(step=1, weights=w, meta=meta),
                   JaxChampion(num_text_features=1000, num_tenants=3)).start()
    try:
        jres = jp.submit(jp.statuses_from_rows(rows)).result(timeout=120)
        jview = jp.stats()
    finally:
        jp.stop()
    assert np.array_equal(got, np.asarray(jres["predictions"], np.float32))
    for key in ("champion", "tenants", "promotions", "refusedPromotions"):
        assert view[key] == jview[key], key
    assert [(s["tenant"], s["live"], s["liveRows"], s["shadowRows"]) for s in view["shadows"]] \
        == [(s["tenant"], s["live"], s["liveRows"], s["shadowRows"]) for s in jview["shadows"]]


def test_champion_raw_margins_are_within_2e_3_of_the_jax_engines():
    w = stack(3, seed=8, scale=0.5)
    meta = stamps([("ok", 9.0), ("ok", 1.0), ("ok", 5.0)])  # tenant 1 is promoted
    rows = rows_of(30, seed=9)
    p = plane(ServingSnapshot(step=1, weights=w, meta=meta),
              champion_engine(3, model_cls=_RawLinear)).start()
    try:
        got = np.asarray(p.submit(p.statuses_from_rows(rows)).result(timeout=60)["predictions"])
    finally:
        p.stop()
    jp = jax_plane(JaxSnapshot(step=1, weights=w, meta=meta),
                   JaxChampion(num_text_features=1000, num_tenants=3,
                               model_cls=_RawJaxLinear)).start()
    try:
        jgot = np.asarray(jp.submit(jp.statuses_from_rows(rows)).result(timeout=120)
                          ["predictions"])
    finally:
        jp.stop()
    np.testing.assert_allclose(got, jgot, rtol=0, atol=RAW_ATOL)
    assert np.array_equal(got, refs_per_tenant(w, p.statuses_from_rows(rows), _RawLinear)[1])


def test_shadow_divergence_tracks_a_disagreeing_challenger():
    w = stack(2, seed=3, scale=0.5)
    snap = ServingSnapshot(step=1, weights=w, meta=stamps([("ok", 1.0), ("ok", 2.0)]))
    engine = champion_engine(2)
    p = plane(snap, engine).start()
    try:
        statuses = p.statuses_from_rows(rows_of(24, seed=9))
        p.submit(statuses).result(timeout=60)
        view = p.stats()
    finally:
        p.stop()
    shadow = [s for s in view["shadows"] if s["tenant"] == 1][0]
    refs = refs_per_tenant(w, statuses)
    assert shadow["shadowRows"] == 24
    assert shadow["divergence"] == round(float(np.abs(refs[1] - refs[0]).mean()), 4) > 0


def test_champion_swap_is_atomic_and_fires_once_under_load():
    """A new snapshot whose stamps favour a challenger flips the champion
    once; under load every answer is bitwise ONE tenant's, the one of the
    step it names, and the alert challenger is refused at both steps."""
    w = stack(3, seed=11, scale=0.05)
    rows = rows_of(8, seed=21)
    engine = champion_engine(3)
    p = plane(ServingSnapshot(step=1, weights=w,
                              meta=stamps([("ok", 1.0), ("ok", 5.0), ("alert", 0.1)])),
              engine, max_wait_ms=0.5).start()
    statuses = p.statuses_from_rows(rows)
    refs = refs_per_tenant(w, statuses)
    assert engine.champion == 0
    results, errors = [], []

    def loader():
        try:
            for _ in range(10):
                results.append(p.submit(list(statuses)).result(timeout=60))
        except Exception as exc:  # the failure evidence, asserted below
            errors.append(exc)

    threads = [threading.Thread(target=loader) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        p.hot_swap(ServingSnapshot(step=2, weights=w,
                                   meta=stamps([("ok", 1.0), ("ok", 0.5), ("alert", 0.1)])))
        for t in threads:
            t.join(timeout=120)
        # traffic after the swap, so the promoted champion surely serves
        results.append(p.submit(list(statuses)).result(timeout=60))
    finally:
        p.stop()
    assert not errors and len(results) == 31
    assert engine.champion == 1
    assert counters(_metrics) == (1, 2)
    champion_by_step = {1: 0, 2: 1}
    for res in results:
        champ = champion_by_step[res["snapshot_step"]]
        assert np.array_equal(refs[champ], np.asarray(res["predictions"], np.float32))
    assert {r["snapshot_step"] for r in results} >= {2}


def test_a_batch_in_flight_answers_with_its_dispatch_time_champion():
    """The champion rides beside the output: a swap between dispatch and
    delivery does not change whose row answers."""
    w = stack(2, seed=4, scale=0.5)
    engine = champion_engine(2)
    engine.set_snapshot(ServingSnapshot(step=1, weights=w,
                                        meta=stamps([("ok", 1.0), ("ok", 5.0)])))
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        ServingPlane.statuses_from_rows(rows_of(8)), row_bucket=32, pre_filtered=True)
    pending = engine.fetch_output(engine.step(engine.pack_for_wire(batch)))
    engine.set_snapshot(ServingSnapshot(step=2, weights=w,
                                        meta=stamps([("ok", 1.0), ("ok", 0.5)])))
    assert engine.champion == 1
    host = pending.result()
    assert host[1] == 0
    refs = refs_per_tenant(w, ServingPlane.statuses_from_rows(rows_of(8)))
    assert np.array_equal(engine.predictions_for(host, batch), refs[0])


# ---- a tenant stack served without A/B --------------------------------------------------

def test_a_tenant_stack_serves_each_row_its_own_tenant_like_the_jax_plane():
    w = stack(3, seed=5, scale=0.5)
    rows = rows_of(24, seed=6)
    p = plane(ServingSnapshot(step=1, weights=w))
    assert isinstance(p._engine, PredictEngine) and p.num_tenants == 3
    p.start()
    try:
        statuses = p.statuses_from_rows(rows)
        got = np.asarray(p.submit(statuses).result(timeout=60)["predictions"], np.float32)
        view = p.stats()
    finally:
        p.stop()
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(statuses, row_bucket=32,
                                                             pre_filtered=True)
    ids = p._engine.model.route_ids(batch)
    refs = refs_per_tenant(w, statuses)
    valid = np.nonzero(np.asarray(batch.mask) > 0)[0]
    for m, rows_m in enumerate(tenant_rows(batch, ids, 3)):
        pos = np.searchsorted(valid, rows_m)
        assert np.array_equal(got[pos], refs[m][pos])
    jp = jax_plane(JaxSnapshot(step=1, weights=w)).start()
    try:
        jgot = np.asarray(jp.submit(jp.statuses_from_rows(rows)).result(timeout=120)
                          ["predictions"], np.float32)
        jview = jp.stats()
    finally:
        jp.stop()
    assert np.array_equal(got, jgot)
    assert view["tenants"] == jview["tenants"] and sum(t["rows"] for t in view["tenants"]) == 24
    with pytest.raises(ValueError, match="ndim"):
        p._engine.set_snapshot(ServingSnapshot(step=2, weights=w[0]))


# ---- the entry point ------------------------------------------------------------------

def save_stack(directory, step, w, entries):
    meta = {"count": step * 10, "batches": step, "quality": stamps(entries)["quality"]}
    return Checkpointer(str(directory)).save(step, np.asarray(w, np.float32), meta)


def test_serve_app_abtest_end_to_end(tmp_path, monkeypatch):
    """``apps.serve --abtest on`` over a stamped tenant-stack checkpoint:
    the champion answers over HTTP bitwise its train step, the Serving view
    carries the champion and shadow tiles, and a router's Fleet view shows
    the champion it reads from the replica."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    w = stack(2, seed=2, scale=0.5)
    ck = tmp_path / "ck"
    save_stack(ck, 3, w, [("ok", 9.0), ("ok", 5.0)])  # tenant 1 is the champion
    ready, stop, got = threading.Event(), threading.Event(), {}

    def started(server, plane_, promoter):
        got["url"] = f"http://127.0.0.1:{server.port}"
        ready.set()

    conf = ConfArguments().parse([
        "--backend", "cpu", "--checkpointDir", str(ck), "--servePort", "0",
        "--serveBatchRows", "32", "--serveMaxWaitMs", "2", "--servePromoteEvery", "600",
        "--abtest", "on", "--twtweb", CLOSED, "--webTimeout", "0.2"])

    def run():
        try:
            got["stats"] = serve_app.run(conf, started=started, stop_event=stop)
        except BaseException as exc:  # asserted below
            got["error"] = exc
            ready.set()

    thread = threading.Thread(target=run)
    thread.start()
    try:
        assert ready.wait(60) and "error" not in got, got.get("error")
        rows = rows_of(6, seed=2)
        res = ServingClient(got["url"]).predict(rows)
        router = FleetRouter([got["url"]])
        try:
            # the app publishes its Serving view every PUBLISH_EVERY_S
            deadline = time.monotonic() + 5 * serve_app.PUBLISH_EVERY_S
            while time.monotonic() < deadline:
                router.health_check_once()
                fleet = router.stats()
                if fleet["champion"] >= 0:
                    break
                time.sleep(0.1)
        finally:
            router.stop()
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and "error" not in got
    assert res["snapshotStep"] == 3 and res["servedRows"] == 6
    refs = refs_per_tenant(w, ServingPlane.statuses_from_rows(rows))
    assert np.array_equal(refs[1], np.asarray(res["predictions"], np.float32))
    assert got["stats"]["champion"] == 1 and fleet["champion"] == 1
    assert [s["tenant"] for s in got["stats"]["shadows"]] == [0, 1]
    assert got["stats"]["promotions"] == 1


def test_serve_app_abtest_refuses_a_single_model_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    Checkpointer(str(ck)).save(1, np.zeros(1004, np.float32), {"count": 1, "batches": 1})
    conf = ConfArguments().parse(["--backend", "cpu", "--checkpointDir", str(ck),
                                  "--abtest", "on"])
    with pytest.raises(SystemExit, match="tenant-stack"):
        serve_app.run(conf)
    with pytest.raises(ValueError, match="tenant stack"):
        champion_engine(1)


def test_the_fleet_view_carries_the_champion_like_the_jax_routers(tmp_path):
    view = {"snapshotStep": 4, "champion": 2, "p99Ms": 1.0}
    ours, theirs = FleetRouter(["http://127.0.0.1:9"]), JaxRouter(["http://127.0.0.1:9"])
    try:
        for r in (ours, theirs):
            r.replicas[0].last_view = dict(view)
        assert ours.stats()["champion"] == theirs.stats()["champion"] == 2
        for r in (ours, theirs):
            r.replicas[0].last_view = {"snapshotStep": 4}
        assert ours.stats()["champion"] == theirs.stats()["champion"] == -1
    finally:
        ours.stop()
        theirs.stop()
    # a live replica: the port's A/B plane behind the port's server
    p = plane(ServingSnapshot(step=1, weights=stack(3),
                              meta=stamps([("ok", 5.0), ("ok", 7.0), ("ok", 1.0)])),
              champion_engine(3)).start()
    server = Server(port=0, host="127.0.0.1", cache=ApiCache(str(tmp_path / "c.json")))
    server.attach_serving(p).start_background()
    url = f"http://127.0.0.1:{server.port}"
    router = FleetRouter([url])
    try:
        WebClient(url).serving(p.stats())  # what apps/serve.py publishes
        router.health_check_once()
        assert router.stats()["champion"] == 2
    finally:
        router.stop()
        server.stop()
        p.stop()


# ---- the trainer's half ------------------------------------------------------------------

def test_per_tenant_quality_stamps_ride_the_checkpoint_meta():
    assert QUALITY_WIDTH == JAX_QUALITY_WIDTH
    q = np.zeros((2, QUALITY_WIDTH), np.float64)
    for watch in (modelwatch, jax_modelwatch):
        watch.record_tick(q, np.array([8.0, 8.0]), np.array([4.0, 2.0]))
    stamp = modelwatch.snapshot_for_checkpoint()
    assert stamp == jax_modelwatch.snapshot_for_checkpoint()
    t1 = stamp["tenants"][1]
    assert (t1["tenant"], t1["level"], t1["loss"]) == (1, "ok", pytest.approx(2.0))
    sel, jsel = ChampionSelector(2), JaxSelector(2)
    assert sel.consider({"quality": stamp}, step=1) == jsel.consider({"quality": stamp}, 1) == 1
    # one track: no tenants key, as in the JAX package
    for watch in (modelwatch, jax_modelwatch):
        watch.reset_for_tests()
        watch.record_tick(q[0], np.array(8.0), np.array(4.0))
    assert "tenants" not in modelwatch.snapshot_for_checkpoint()
    assert modelwatch.snapshot_for_checkpoint() == jax_modelwatch.snapshot_for_checkpoint()


def test_a_tenants_run_stamps_every_tenant_into_its_checkpoint(tmp_path, monkeypatch):
    """``--tenants 3 --modelWatch on --checkpointDir``: the verified
    checkpoint holds the [3, F+4] stack and a quality stamp a tenant, which
    ``apps.serve --abtest on`` ranks."""
    import json

    from tools.bench_suite import _status_json

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    path = tmp_path / "tweets.jsonl"
    with open(path, "w") as fh:
        for s in SyntheticSource(total=64, seed=51, base_ms=NOW_MS).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")
    conf = ConfArguments().parse([
        "--backend", "cpu", "--source", "replay", "--replayFile", str(path), "--seconds", "0",
        "--batchBucket", "16", "--tenants", "3", "--checkpointDir", str(tmp_path / "ck"),
        "--checkpointEvery", "2", "--lightning", CLOSED, "--twtweb", CLOSED,
        "--webTimeout", "0.2"])
    totals = train_app.run(conf)
    w, meta = Checkpointer(str(tmp_path / "ck")).restore()
    assert totals["tenants"] == 3 and w.shape == (3, 1004)
    tenants = meta["quality"]["tenants"]
    assert [t["tenant"] for t in tenants] == [0, 1, 2]
    assert all(t["loss"] >= 0 and t["level"] in ("ok", "warn", "alert") for t in tenants)
