"""Elastic membership of the port's lockstep runtime (``--elastic on``) on the
CPU: two gloo processes of the port's linear app, each under its own
timeout, with the acceptance properties of the JAX package's
tests/test_elastic_multiprocess.py (whose two-process runs cannot run on
this image; its oracle, an in-process run of the JAX package from the
restored archive, does, and holds each survivor here too):

- a healthy elastic tick adds no collective and no fetch over
  ``--elastic off``: as many cadence all-gathers as ticks, the same
  all-reduces, alignment all-gathers, broadcasts and fetches;
- a follower killed at a tick boundary shrinks the group to the survivor,
  whose continuation is BITWISE an in-process world-1 run of the port from
  the restored archive over its remaining rows, and within the JAX
  multi-host tests' tolerance of the JAX package's one-host run from it;
- the rows a rescue rolls back replay from the journal, each trained once;
- a killed lead is replaced by the lowest live uid, which promotes its own
  standby archives and continues bitwise as a clean run from them;
- a restarted host parks, is admitted at an epoch boundary, and its first
  tick's state CRC is the lead's;
- a host the straggler attribution names gating for ``--elasticEvictTicks``
  ticks in a row is evicted by a clean commit.

Kills land at tick boundaries (``--chaos peer.kill``), as in the JAX tests."""

from __future__ import annotations

import json
import re
import shutil
import threading
import time

import jax
import numpy as np
from torch_group import (
    _collect,
    common_args,
    last_json,
    spawn_worker,
    write_replay,
)

from twtml_tpu_torch.apps.common import state_checksum
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.parallel.distributed import Collectives, MultiHostSGDModel
from twtml_tpu_torch.parallel.elastic import free_base_port
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.sharding import ParallelSGDModel
from twtml_tpu_torch.streaming.sources import ReplayFileSource

NOW_MS = 1785320000000
TIMEOUT_S = 120
ENV = {"TWTML_NOW_MS": str(NOW_MS), "TWTML_LOCKSTEP_TIMEOUT_S": "5",
       "TWTML_ELASTIC_RESCUE_GRACE_S": "2", "TWTML_ELASTIC_SERVICE_LINGER_S": "3"}
# the JAX multi-host tests' tolerance for the weights across packages
JAX_RTOL, JAX_ATOL = 1e-4, 1e-7
RESYNC = (r"elastic resync: state from the lead's verified checkpoint \(count=(\d+), "
          r"batches=(\d+), state crc ([0-9a-f]+)\)")


def _stat_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("count:")]


def _args(path, ck=None, *extra) -> list:
    args = common_args(path, "--batchBucket", "16", "--elastic", "on", *extra)
    return args + (["--checkpointDir", str(ck)] if ck is not None else [])


def _group(args0: list, args1: list, env=None) -> list:
    base = free_base_port()
    procs = [spawn_worker("app", 0, 2, base, args0, dict(ENV, **(env or {}))),
             spawn_worker("app", 1, 2, base, args1, dict(ENV, **(env or {})))]
    return _collect(procs, TIMEOUT_S)


class _Keeper:
    """Copies every archive ``directory`` writes into ``keep`` as it lands
    (the checkpointer keeps the last 3), so a test can restore the one a
    rescue restored."""

    def __init__(self, directory, keep):
        self.directory, self.keep = directory, keep
        keep.mkdir()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        seen = set()
        while not self._stop.is_set():
            for f in (self.directory.glob("ckpt-*.npz") if self.directory.exists() else []):
                if f.name not in seen:
                    try:
                        shutil.copy2(f, self.keep / f.name)
                        seen.add(f.name)
                    except OSError:
                        pass  # racing the writer's rename: the next pass
            self._stop.wait(0.02)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _statuses(path) -> list:
    return list(ReplayFileSource(str(path)).produce())


def _clean_run(state, rows: list):
    """The port's world-1 run in this process: the survivor's model
    (``MultiHostSGDModel`` over a ``ParallelSGDModel`` on a group of one)
    from ``state`` over ``rows`` in 16-row batches on the shard-segment
    wire. Returns its weights."""
    conf = ConfArguments().parse(["--backend", "cpu"])
    mesh = make_mesh(num_processes=1)
    model = MultiHostSGDModel(ParallelSGDModel.from_conf(conf, mesh, Collectives()), mesh)
    model.set_initial_weights(state)
    feat = Featurizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), 16):
        batch = feat.featurize_batch_ragged(rows[lo:lo + 16], row_bucket=16, unit_bucket=64)
        model.step(model.pack_for_wire(batch))
    return model.latest_weights


def _jax_clean_run(state, rows: list):
    """The JAX package's oracle of tests/test_elastic_multiprocess.py: its
    ``ParallelSGDModel`` on one host's 2-device mesh, from ``state`` over
    ``rows`` in 16-row batches. Returns its weights."""
    from twtml_tpu.config import ConfArguments as JaxConf
    from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
    from twtml_tpu.parallel import ParallelSGDModel as JaxParallel
    from twtml_tpu.parallel import make_mesh as jax_make_mesh

    conf = JaxConf().parse(["--backend", "cpu"])
    mesh = jax_make_mesh(num_data=2, devices=jax.devices()[:2])
    model = JaxParallel.from_conf(conf, mesh).set_initial_weights(state)
    feat = JaxFeaturizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), 16):
        batch = feat.featurize_batch_ragged(rows[lo:lo + 16], row_bucket=16, unit_bucket=64,
                                            row_multiple=2)
        model.step(model.pack_for_wire(batch))
    return np.asarray(model.latest_weights)


def _hold_survivor(final, state, rows) -> None:
    """The survivor's final weights: bitwise the port's clean world-1 run
    from ``state`` over ``rows``, and the JAX package's within tolerance."""
    final = np.asarray(final)
    np.testing.assert_array_equal(final, _clean_run(state, rows))
    np.testing.assert_allclose(final, _jax_clean_run(state, rows), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_a_healthy_elastic_tick_adds_no_collective_and_no_fetch(tmp_path):
    """(a) Counted on both ranks: with the membership plane active, the
    cadence all-gathers are the ticks, and every other host collective and
    the fetches are ``--elastic off``'s; the group stays epoch 0."""
    path = write_replay(tmp_path / "tweets.jsonl", 128, 7)
    on = _group(_args(path), _args(path))
    off_args = common_args(path, "--batchBucket", "16")
    off = _group(off_args, off_args)
    for (rc, out, err), (rc_off, out_off, err_off) in zip(on, off):
        assert rc == 0 and rc_off == 0, (err[-3000:], err_off[-3000:])
        rec, ref = last_json(out), last_json(out_off)
        assert not rec["failed"] and rec["batches"] == ref["batches"] == 4
        assert rec["collectives"]["cadence_allgathers"] == rec["counters"]["lockstep.ticks"]
        assert rec["collectives"] == ref["collectives"]
        assert rec["counters"]["fetch.count"] == ref["counters"]["fetch.count"]
        assert rec["gauges"]["elastic.epoch"] == 0 and rec["gauges"]["elastic.live_hosts"] == 2
        assert rec["counters"]["elastic.reforms"] == 0
        assert "elastic run complete (epoch 0, 0 re-formation(s)); hard exit 0" in err


def test_a_killed_follower_shrinks_the_group_and_the_survivor_is_a_clean_run(tmp_path):
    """(b) ``peer.kill`` on uid 1 at tick 4: uid 0 shrinks to epoch 1 alone,
    restores the step-3 archive (count 96) and trains its remaining 52 rows
    (148): its final weights are bitwise the port's world-1 run from that
    archive over host 0's rows 48 on, and the JAX package's run from it
    within tolerance."""
    path = write_replay(tmp_path / "tweets.jsonl", 200, 5)
    ck = tmp_path / "ck"
    keeper = _Keeper(ck, tmp_path / "archives")
    args = _args(path, ck, "--checkpointEvery", "1")
    try:
        (rc0, out0, err0), (rc1, out1, err1) = _group(
            args, args + ["--chaos", "peer.kill:uid=1:tick=4"])
    finally:
        keeper.stop()
    assert rc1 == 77 and out1.strip() == "", err1[-2000:]
    assert rc0 == 0, err0[-4000:]
    assert "elastic epoch 1 formed: 1 host(s) [0]" in err0
    assert "intake shard rebalanced: now serving residues [0, 1] of 2" in err0
    assert "rows_lost_estimate" in err0
    lines = _stat_lines(out0)
    assert lines[2].startswith("count: 96  batch: 32")
    assert int(re.findall(r"count: (\d+)", lines[-1])[0]) == 148
    resync = re.search(RESYNC, err0)
    assert resync and (int(resync.group(1)), int(resync.group(2))) == (96, 3), err0[-3000:]
    state3, _meta = Checkpointer(str(tmp_path / "archives")).restore(step=3)
    assert resync.group(3) == state_checksum(state3)
    final, meta = Checkpointer(str(ck)).restore()
    assert meta["count"] == 148
    _hold_survivor(final, state3, _statuses(path)[0::2][48:])
    rec = last_json(out0)
    assert rec["counters"]["elastic.hosts_departed"] == 1
    assert rec["gauges"]["elastic.epoch"] == 1 and rec["gauges"]["elastic.live_hosts"] == 1


def test_a_rescue_replays_its_rolled_back_rows_from_the_journal(tmp_path):
    """(c) At ``--checkpointEvery 2`` the newest archive at the kill is step
    2, so the rescue throws batch 3 away (discarded in flight, or rolled
    back); the survivor's journal replays exactly its 16 rows, and the
    continuation is bitwise the world-1 run from step 2 over host 0's rows
    32 on (and the JAX package's within tolerance): 132 rows, each trained once."""
    path = write_replay(tmp_path / "tweets.jsonl", 200, 5)
    ck = tmp_path / "ck"
    keeper = _Keeper(ck, tmp_path / "archives")
    args = _args(path, ck, "--checkpointEvery", "2")
    try:
        (rc0, out0, err0), (rc1, _out1, err1) = _group(
            args, args + ["--chaos", "peer.kill:uid=1:tick=4"])
    finally:
        keeper.stop()
    assert rc1 == 77, err1[-2000:]
    assert rc0 == 0, err0[-4000:]
    resync = re.search(RESYNC + r"(?: — (\d+) row\(s\) of post-checkpoint progress rolled "
                       r"back)?", err0)
    assert resync and (int(resync.group(1)), int(resync.group(2))) == (64, 2), err0[-3000:]
    rolled_share = int(resync.group(4) or 0) // 2  # global rows, 2 hosts
    discarded = sum(int(r) for r in re.findall(
        r"elastic rescue: discarded \d+ in-flight.*?\(~(\d+) row\(s\)\)", err0))
    assert rolled_share + discarded == 16
    replay = re.search(r"journal: replayed (\d+) row\(s\) from cursor (\d+) after elastic "
                       r"rescue; counters reset to \(count=64, batches=2\)", err0)
    assert replay and int(replay.group(1)) == 16 and int(replay.group(2)) == 2, err0[-3000:]
    state2, meta2 = Checkpointer(str(tmp_path / "archives")).restore(step=2)
    assert resync.group(3) == state_checksum(state2)
    assert meta2["journal"] == {"cursor": 2, "rows": 32}
    final, meta = Checkpointer(str(ck)).restore()
    assert meta["count"] == 132
    assert int(re.findall(r"count: (\d+)", _stat_lines(out0)[-1])[0]) == 132
    _hold_survivor(final, state2, _statuses(path)[0::2][32:])


def test_a_killed_lead_is_replaced_by_the_lowest_live_uid(tmp_path):
    """(d) ``peer.kill:uid=0`` (the same spec on both ranks): uid 1's wedge
    report finds the beacon gone, it wins the election, promotes its
    standby lineage, restores its own step-3 archive and trains on; its
    final archive (in ``standby-u1``, the lineage now) is bitwise the
    world-1 run from that archive over host 1's rows 48 on, and the JAX
    package's run from it within tolerance."""
    path = write_replay(tmp_path / "tweets.jsonl", 200, 5)
    ck = tmp_path / "ck"
    standby = ck / "standby-u1"
    keeper = _Keeper(standby, tmp_path / "archives")
    args = _args(path, ck, "--checkpointEvery", "1", "--chaos", "peer.kill:uid=0:tick=4")
    try:
        (rc0, _out0, err0), (rc1, out1, err1) = _group(args, args)
    finally:
        keeper.stop()
    assert rc0 == 77, err0[-2000:]
    assert rc1 == 0, err1[-4000:]
    assert "the lead (uid 0) is gone; electing a successor" in err1
    assert "uid 1 WON the election (beacon :" in err1
    assert "checkpoint authority PROMOTED after lead election" in err1
    assert "elastic epoch 1 formed: 1 host(s) [1]" in err1
    assert "intake shard rebalanced: now serving residues [0, 1] of 2" in err1
    assert _stat_lines(out1) == []  # the launch lead printed; it is gone
    resync = re.search(RESYNC, err1)
    assert resync and (int(resync.group(1)), int(resync.group(2))) == (96, 3), err1[-3000:]
    state3, _meta = Checkpointer(str(tmp_path / "archives")).restore(step=3)
    assert resync.group(3) == state_checksum(state3)
    final, meta = Checkpointer(str(standby)).restore()
    assert meta["count"] == 148
    _hold_survivor(final, state3, _statuses(path)[1::2][48:])
    rec = last_json(out1)
    assert rec["counters"]["elastic.elections"] == 1
    assert rec["gauges"]["elastic.lead_uid"] == 1


def test_a_restarted_host_is_readmitted_with_the_leads_state(tmp_path):
    """(e) uid 1 killed at tick 4, then started again with the same command
    line: it parks, the lead (alone since its rescue) proposes epoch 2 with
    it (a join), and its first tick's state CRC (the lead's broadcast at
    its start) is the lead's resync CRC at the admission boundary, a
    trained state (``--checkpointEvery 1``). A 0.5 s pause of the lead every
    tick from the fifth (``peer.pause:uid=0``) keeps the run going past the
    admission."""
    path = write_replay(tmp_path / "tweets.jsonl", 480, 5)
    ck = tmp_path / "ck"
    chaos = "peer.pause:uid=0:ticks=1@from5"
    args = _args(path, ck, "--checkpointEvery", "1", "--chaos", chaos)
    base = free_base_port()
    lead = spawn_worker("app", 0, 2, base, args, ENV)
    peer = spawn_worker("app", 1, 2, base, _args(
        path, ck, "--checkpointEvery", "1", "--chaos", chaos + ",peer.kill:uid=1:tick=4"), ENV)
    rejoiner = None
    try:
        (rc1, _out1, err1), = _collect([peer], TIMEOUT_S)
        assert rc1 == 77, err1[-2000:]
        # parks at once: the lead admits it at its first tick after the rescue
        rejoiner = spawn_worker("app", 1, 2, base, args,
                                dict(ENV, TWTML_ELASTIC_PARK_TIMEOUT_S="40"))
        (rc0, out0, err0), (rcr, outr, errr) = _collect([lead, rejoiner], TIMEOUT_S)
    finally:
        for p in (lead, peer, rejoiner):
            if p is not None:
                p.kill()
    assert rc0 == 0, err0[-4000:]
    assert rcr == 0, errr[-4000:]
    assert "parking this host (uid 1) for admission" in errr
    assert "proposing epoch 2 with members [0, 1] (join)" in err0
    assert "elastic epoch 2 formed: 2 host(s) [0, 1]" in err0
    assert "joined a live replay-sharded run as a hot standby" in errr
    lead_crcs = re.findall(r"elastic resync: .* state crc ([0-9a-f]+)", err0)
    join_crcs = re.findall(r"multi-host state synchronized from the lead \(count=\d+, state "
                           r"crc ([0-9a-f]+)\)", errr)
    assert lead_crcs and join_crcs and join_crcs[-1] == lead_crcs[-1], (lead_crcs, join_crcs)
    assert join_crcs[-1] != state_checksum(np.zeros(1004, np.float32))
    assert _stat_lines(outr) == [] and _stat_lines(out0)
    rec = last_json(out0)
    assert rec["counters"]["elastic.hosts_rejoined"] == 1
    assert rec["gauges"]["elastic.epoch"] == 2 and rec["gauges"]["elastic.live_hosts"] == 2
    assert json.loads(outr.strip().splitlines()[-1])["gauges"]["elastic.epoch"] == 2


def test_a_gating_host_is_evicted_after_the_configured_ticks(tmp_path):
    """(f) ``--elasticEvictTicks 2 --elasticEvictSkewMs 100``: uid 1 stalls
    0.5 s every tick from the second (``peer.pause``), the sideband's
    straggler attribution names it gating, and after two such ticks in a
    row the lead proposes epoch 1 without it; the commit is clean (no
    rescue), uid 0 trains on alone, and uid 1, with ``--elasticRejoin
    off``, parks and leaves with a failed run."""
    path = write_replay(tmp_path / "tweets.jsonl", 480, 5)
    args = _args(path, tmp_path / "ck", "--checkpointEvery", "1", "--elasticEvictTicks", "2",
                 "--elasticEvictSkewMs", "100", "--elasticRejoin", "off", "--chaos",
                 "peer.pause:uid=1:ticks=1@from2")
    (rc0, out0, err0), (rc1, out1, err1) = _group(args, args)
    assert rc0 == 0, err0[-4000:]
    assert rc1 == 1 and "parked with --elasticRejoin off" in err1, err1[-3000:]
    assert "proposing epoch 1 with members [0] (evict, evicting uid 1)" in err0
    assert "elastic epoch 1 formed: 1 host(s) [0]" in err0
    assert "lockstep collective failed" not in err0  # a clean commit, no rescue
    rec = last_json(out0)
    assert rec["counters"]["elastic.hosts_departed"] == 1
    assert rec["gauges"]["elastic.epoch"] == 1
    assert last_json(out1)["failed"]
