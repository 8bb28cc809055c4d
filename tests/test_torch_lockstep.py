"""The lockstep scheduler of the port's multi-host runtime on the CPU (two
gloo processes, each under its own timeout): a batch failure on one rank
aborts both at the same tick; a killed or stalled peer makes the survivor
exit non-zero within the watchdog's bound instead of hanging; a tick makes
exactly one cadence all-gather and no other host collective, counted; and
the straggler attribution and the ``/api/hosts`` payload are the JAX
package's for the same inputs."""

from __future__ import annotations

import json
import time

import numpy as np
from torch_group import common_args, last_json, run_torch_group, run_worker_group, write_replay

from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry import sideband as jax_sideband
from twtml_tpu.telemetry.api_types import Hosts as JaxHosts
from twtml_tpu.telemetry.api_types import encode as jax_encode
from twtml_tpu.web.cache import ApiCache as JaxCache
from twtml_tpu_torch.telemetry import metrics, sideband
from twtml_tpu_torch.telemetry.api_types import Hosts, encode
from twtml_tpu_torch.web.cache import ApiCache

WATCHDOG_S = 5


def test_a_batch_failure_aborts_both_ranks_at_the_same_tick():
    results = run_worker_group("abort", [], timeout=120)
    recs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        recs.append(last_json(out))
    assert all(r["terminated"] and r["failed"] for r in recs), recs
    assert recs[1]["batches_seen"] == 3  # raised on its third batch
    assert recs[0]["ticks"] == recs[1]["ticks"]


def test_a_killed_peer_aborts_the_survivor_within_the_watchdog_bound(tmp_path):
    """``--chaos peer.kill:uid=1:tick=3``: rank 1 hard-exits (77) at the top
    of tick 3; rank 0's cadence all-gather fails (the transport error or
    the watchdog) and its run exits non-zero, not hanging."""
    path = write_replay(tmp_path / "tweets.jsonl", 160, 5)
    t0 = time.monotonic()
    (rc0, out0, err0), (rc1, out1, err1) = run_torch_group(
        common_args(path, "--batchBucket", "16", "--chaos", "peer.kill:uid=1:tick=3"),
        env={"TWTML_LOCKSTEP_TIMEOUT_S": str(WATCHDOG_S)}, timeout=120)
    assert rc1 == 77 and out1.strip() == "", err1[-3000:]
    assert rc0 != 0 and "lockstep" in err0, err0[-3000:]
    assert time.monotonic() - t0 < 90


def test_a_stalled_peer_trips_the_watchdog(tmp_path):
    """``--chaos peer.pause:uid=1:ticks=20@3`` stalls rank 1 for 10 s at tick
    3; rank 0's cadence all-gather makes no progress for the watchdog's
    bound, and its watchdog aborts it (``lockstep.watchdog_aborts``)."""
    path = write_replay(tmp_path / "tweets.jsonl", 160, 5)
    results = run_worker_group(
        "app", common_args(path, "--batchBucket", "16", "--chaos",
                           "peer.pause:uid=1:ticks=20@3"),
        env={"TWTML_LOCKSTEP_TIMEOUT_S": "3"}, timeout=120)
    rc0, out0, err0 = results[0]
    rec = last_json(out0)
    assert rec["failed"], err0[-3000:]
    assert rec["counters"].get("lockstep.watchdog_aborts") == 1
    assert "lockstep peer watchdog" in err0
    assert last_json(results[1][1])["failed"]


def test_a_tick_makes_one_cadence_allgather_and_no_other_host_collective(tmp_path):
    """Counted on both ranks of a clean run: one cadence all-gather a tick
    (the sideband rides it), one alignment all-gather a dispatched batch of
    the ragged wire (the warm-up's too), no broadcast without a checkpoint;
    in the step, the stats' and the quality vector's all-reduces and one
    a B1 iteration (the split's), nothing else."""
    path = write_replay(tmp_path / "tweets.jsonl", 128, 7)
    results = run_worker_group("app", common_args(path, "--batchBucket", "16"), timeout=180)
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        rec = last_json(out)
        c, counters = rec["collectives"], rec["counters"]
        steps = rec["batches"] + 1  # and the warm-up
        assert rec["batches"] == 4 and not rec["failed"]
        assert c["cadence_allgathers"] == counters["lockstep.ticks"]
        assert c["align_allgathers"] == steps
        assert c["broadcasts"] == 0 and c["row_allgathers"] == 0
        assert c["allreduces"] == steps * (50 + 2)


def _matrices(seed: int, ticks: int = 12, hosts: int = 3):
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        m = rng.gamma(2.0, 5.0, size=(hosts, sideband.WIDTH))
        m[1, 0] += 40.0 * (t % 3)  # host 1 gates now and then
        m[1, sideband.FIELDS.index("dispatch_ms")] += 30.0 * (t % 3)
        yield m


def test_straggler_verdicts_and_the_hosts_view_equal_the_jax_package():
    """The same gathered sideband matrices through each package's
    ``LockstepTelemetry``: the same verdicts, published views and gauges;
    the view as a ``Hosts`` message answers ``GET /api/hosts`` with the
    JAX server's bytes."""
    assert sideband.FIELDS == jax_sideband.FIELDS
    metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    ours, theirs = sideband.LockstepTelemetry(0, 3), jax_sideband.LockstepTelemetry(0, 3)
    for m in _matrices(4):
        ours.ingest(m.copy())
        theirs.ingest(m.copy())
        view, jview = sideband.last_hosts(), jax_sideband.last_hosts()
        assert view == jview
        assert ours._attributor.summary() == theirs._attributor.summary()
    g, jg = metrics.get_registry().snapshot(), jax_metrics.get_registry().snapshot()
    for name in ("lockstep.straggler_host", "lockstep.tick_skew_ms"):
        assert g["gauges"][name] == jg["gauges"][name]
    for name, value in jg["counters"].items():
        if name.startswith(("straggler.", "lockstep.ticks")):
            assert g["counters"][name] == value, name
    msg = Hosts(hosts=view["hosts"], straggler=view["straggler"], stage=view["stage"],
                skewMs=view["skew_ms"])
    jmsg = JaxHosts(hosts=jview["hosts"], straggler=jview["straggler"], stage=jview["stage"],
                    skewMs=jview["skew_ms"])
    assert json.loads(encode(msg)) == json.loads(jax_encode(jmsg))
    cache, jcache = ApiCache(backup_file=""), JaxCache(backup_file="")
    cache.cache(encode(msg))
    jcache.cache(jax_encode(jmsg))
    assert cache.hosts() == jcache.hosts()
