"""Shared app runtime (counterpart of ``twtml_tpu/apps/common.py``): group
formation (``init_distributed``, elastic or not), source and model
construction, the
``--trace``/``--chaos``/``--blackbox``/``--journal``/``--history``
installers, the backend checks (``select_backend``), the
checkpoint (``AppCheckpoint``) and journal recovery, the runtime guards
(``DivergenceSentinel``, ``ModelWatchGuard``, ``FreshnessGuard``,
``ProcessRecycler``), the fetch watchdog, the depth-D fetch pipeline of
back-to-back streams, the superbatch (``SuperBatcher``: K batches a
``step_many`` dispatch), the synchronous per-batch path of wall-clock
streams, and the pre-stream warm-up.

A batch's life on ``cuda``: the stream featurizes it on the host (the
unpacked batch, whose arrays the handler reads); the pipeline packs it into
a page-locked arena buffer (the ragged wire), ``model.step`` queues the
non-blocking H2D copy and the step's kernels on the model's stream, and
``model.fetch_output`` queues ONE device-to-host copy of the predictions,
stats and quality vector into pinned memory with one event behind it. No
call in that dispatch waits for the card. The handler runs once the event
has fired, on the host copies, in dispatch order; then the batch's leases
retire (the H2D copy ran before the step on the same stream, so it is done).

The guards read only what the host already holds: the sentinel the 3
fetched stat scalars, the model watch the quality slice of the same D2H
vector, freshness the host's clock stamps. Each delivery passes through
wrappers in the JAX package's order, outermost first: the journal's token
pop, freshness, model watch, the tenant plane's view and aggregation
(``--tenants``), the sentinel, then the journal commit and the app's
handler. A checkpoint reads the weights (a blocking copy) only at a
drained boundary, outside the sync-debug window of a dispatch.

Across hosts (``--coordinator``/``twtml://``, a lockstep group): every rank
reads its own intake shard (``build_source``), trains a
``MultiHostSGDModel`` (``build_model``) whose stats are global, delivers at
deterministic points only (no early emit, so a delivery's side effects land
on the same tick on every rank), skips a globally empty batch after its
step, restores and rolls back from the lead's checkpoint, broadcast
(``AppCheckpoint``), journals under ``journal-p<rank>`` and leaves printing
and publishing to the lead.

Elastic (``--elastic on``, ``attach_elastic``): the group is a sequence of
epochs (parallel/elastic.py) driven by the membership plane
(streaming/membership.py). A re-formation drains the fetch pipeline (a
rescue discards what is in flight: a dead peer failed its collectives),
saves at the boundary on a clean commit, abandons the epoch, forms the
next, rebuilds the model for its mesh, resynchronizes state and counters
from the lead's verified checkpoint (every host shadow-saves under
``standby-u<uid>``, so an elected lead restores from its own), replays the
journal's rolled-back rows, and hands a departed host's intake residues to
the survivors. Journals and historians are keyed by the elastic uid
(``-u<uid>``), and an elastic process leaves through a hard exit
(``elastic_exit``).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import sys
import tempfile
import time
import zlib

import numpy as np

from ..checkpoint import Checkpointer
from ..features import assemble, featurize_native, native
from ..features.arena import chain_leases, get_arena
from ..features.batch import (
    NUM_NUMBER_FEATURES, FeatureBatch, PackedBatch, RaggedUnitBatch, UnitBatch,
    pack_batch, pack_ragged_group, stack_batches, wire_composition, wire_nbytes,
)
from ..models.base import StepOutput
from ..models.linear import StreamingLinearRegressionWithSGD
from ..models.sgd import DTYPES, wire_signature
from ..streaming import faults as _faults
from ..streaming import journal as _journal
from ..streaming.sources import (
    BlockReplayFileSource, ReplayFileSource, SkipRowsSource, Source, SyntheticSource,
)
from ..telemetry import blackbox as _blackbox
from ..telemetry import freshness as _freshness
from ..telemetry import historian as _historian
from ..telemetry import lineage as _lineage
from ..telemetry import metrics as _metrics
from ..telemetry import modelwatch as _modelwatch
from ..telemetry import sideband as _sideband
from ..telemetry import trace as _trace
from ..utils import get_logger
from ..utils.rss import RssWatchdog, rss_mb
from ..utils.runid import config_fingerprint, next_run_id
from ..utils.tracing import annotate

log = get_logger("apps.common")

# fetch-watchdog policy (see FetchWatchdog): the deadline derives from the
# health monitor's rolling fetch wait, clamped; generous, because a retry
# only helps a lost copy, not a busy card
FETCH_DEADLINE_MULT = 25.0
FETCH_DEADLINE_MIN_S = 30.0
FETCH_DEADLINE_MAX_S = 180.0
FETCH_RETRIES = 3

# batches in flight in a back-to-back stream (FetchPipeline)
FETCH_DEPTH = 8

# torch.cuda.set_sync_debug_mode around every dispatch when set ("warn" or
# "error"): a hidden host sync in the dispatch path then warns or raises
SYNC_DEBUG_ENV = "TWTML_SYNC_DEBUG"


class FetchAbort(RuntimeError):
    """The fetch watchdog exhausted its retries: the run is aborting."""


def build_source(conf, allow_block: bool = False,
                 block_interval: "tuple[int, int] | None" = None) -> Source:
    """The configured source. ``--replaySpeed`` paces a replay (x realtime)
    or a synthetic stream (tweets/s). ``TWTML_NOW_MS`` (env), which pins the
    featurizer's clock, also pins the synthetic tweets' creation times, so
    a pinned synthetic run gives the same batches every time. ``--source
    twitter`` opens the live stream with the ``twitter4j.oauth.*``
    credentials (flags or ``application.conf``). ``--wire ragged`` with
    ``--hashOn host`` exits, as in the JAX package: the ragged wire ships
    code units for the device to hash.

    ``--ingest block`` (the JAX package's rules and exits): an entry point
    whose pipeline takes ParsedBlocks passes ``allow_block`` (linear and
    logistic; k-means also ``block_interval``, the retweet-count interval
    the parser filters by, since it keeps every retweet); the replay file
    (as fast as it parses: ``--replaySpeed`` exits) or the live stream goes
    through the block parser, the wire emitter under ``--blockWire``'s
    rule. In a multi-host group each rank reads its own shard: a block
    replay its line-aligned byte range of the file, a live stream the
    statuses whose id is its rank mod the ranks (``IdShardedSource``),
    anything else every N-th item (``ShardedSource``); ``--source twitter
    --ingest block`` exits there (a parsed block carries no per-row shard
    key), as in the JAX package."""
    from ..parallel import distributed as _dist

    group = _dist.mesh()
    multihost = group.num_processes > 1
    if conf.effective_wire() == "ragged" and conf.hashOn != "device":
        raise SystemExit("--wire ragged is a device-hash wire format; "
                         "it requires --hashOn device")
    block = conf.ingest == "block"
    if block and not allow_block:
        raise SystemExit("--ingest block is not wired for this entry point; "
                         "use --ingest object")
    if block and conf.source not in ("replay", "twitter"):
        raise SystemExit("--ingest block requires --source replay or twitter")
    if block and conf.hashOn != "device":
        raise SystemExit("--ingest block ships raw code units (device hashing); "
                         "--hashOn host requires --ingest object")
    if multihost and block and conf.source == "twitter":
        raise SystemExit("--ingest block with --source twitter cannot shard across hosts "
                         "(a parsed block has no per-row id to shard on); use --ingest "
                         "object for a multi-host live stream")
    begin, end = (block_interval if block_interval is not None
                  else (conf.numRetweetBegin, conf.numRetweetEnd))
    if conf.source == "twitter":
        from ..streaming.twitter import BlockTwitterSource, TwitterSource

        source: Source = (
            BlockTwitterSource.from_properties(
                num_retweet_begin=begin, num_retweet_end=end,
                wire=conf.effective_block_wire())
            if block else TwitterSource.from_properties())
    elif conf.source == "replay":
        if not conf.replayFile:
            raise SystemExit("--source replay requires --replayFile <path.jsonl>")
        if block and conf.replaySpeed:
            raise SystemExit("--ingest block replays as fast as possible; "
                             "drop --replaySpeed or use --ingest object")
        source = (
            BlockReplayFileSource(conf.replayFile, num_retweet_begin=begin,
                                  num_retweet_end=end, wire=conf.effective_block_wire(),
                                  shard_index=group.process_index,
                                  shard_count=group.num_processes)
            if block else ReplayFileSource(conf.replayFile, speed=conf.replaySpeed))
    else:
        now_env = os.environ.get("TWTML_NOW_MS", "")
        source = SyntheticSource(
            rate=conf.replaySpeed or 0.0, base_ms=int(now_env) if now_env else None
        )
    if conf.faultEvery > 0:
        # a crash cap keeps a finite replay from re-reading itself forever
        source = _faults.FaultInjectingSource(
            source, crash_every=conf.faultEvery,
            max_crashes=3 if conf.source == "replay" else 0,
        )
    if multihost and not block:
        from ..streaming.sources import IdShardedSource, ShardedSource

        shard = IdShardedSource if conf.source == "twitter" else ShardedSource
        source = shard(source, group.process_index, group.num_processes)
    return source


# routes --tenants 1 through the tenant plane when "1" (the app-level M = 1
# parity hook); the default M = 1 path is the plain learner, which a
# one-tenant stream must not pay the routing split for
FORCE_TENANT_PLANE_ENV = "TWTML_FORCE_TENANT_PLANE"


def build_model(conf, model_cls=StreamingLinearRegressionWithSGD):
    """The single-device learner on ``--backend``, with the process-wide
    native seams (``--featurizeNative``, ``--wireAssemble``) set and the
    wire arena serving page-locked buffers to a ``cuda`` model.

    ``--tenants M > 1`` (or ``TWTML_FORCE_TENANT_PLANE=1`` at M = 1) builds
    the tenant plane instead (parallel/tenants.py): M learners of
    ``model_cls``'s gradient family on one wire, one fetch a tick.
    ``--tenantKey lang`` needs ``--hashOn device``.

    In a multi-host group (``init_distributed`` formed it) the learner is a
    ``MultiHostSGDModel`` over a ``ParallelSGDModel`` of ``model_cls``'s
    gradient family on this rank's device, with the digram codec's agreed
    bucket under ``--wireCodec dict``, and the closure that rebuilds it for
    an elastic epoch's mesh; with the tenant plane it is the tenant fleet,
    a ``MultiHostTenantModel`` over a ``TenantStackModel`` on the group's
    data axis, with its own rebuilder."""
    from ..parallel import distributed as _dist

    featurize_native.configure(conf.featurizeNative)
    assemble.configure(conf.wireAssemble)
    tenants = int(conf.tenants or 1)
    plane = tenants > 1 or os.environ.get(FORCE_TENANT_PLANE_ENV) == "1"
    if plane and conf.tenantKey == "lang" and conf.hashOn != "device":
        raise SystemExit("--tenantKey lang routes on raw code units; it requires "
                         "--hashOn device")
    if _dist.is_multihost() and plane:
        from ..parallel.tenants import MultiHostTenantModel, TenantStackModel

        def rank_stack(mesh):
            return TenantStackModel.from_conf(
                conf, mesh, _dist.Collectives.from_group(),
                residual_fn=model_cls.residual_fn, prediction_fn=model_cls.prediction_fn,
                round_predictions=model_cls.round_predictions, device=_dist.device())

        model = MultiHostTenantModel(rank_stack(_dist.mesh()), _dist.mesh(),
                                     rebuilder=rank_stack)
        get_arena().use_device(model.device)
        log.info("multi-tenant model fleet: %d tenants across %d hosts, key %s, stacked "
                 "wire, %s step route", tenants, _dist.mesh().num_processes,
                 model.tenant_key, model.route)
        return model
    if _dist.is_multihost():
        from ..parallel.sharding import ParallelSGDModel

        codec = conf.effective_wire_codec() if conf.effective_wire() == "ragged" else "off"

        def rank_model(mesh):
            return ParallelSGDModel.from_conf(
                conf, mesh, _dist.Collectives.from_group(),
                residual_fn=model_cls.residual_fn, prediction_fn=model_cls.prediction_fn,
                round_predictions=model_cls.round_predictions, device=_dist.device())

        model = _dist.MultiHostSGDModel(rank_model(_dist.mesh()), _dist.mesh(),
                                        wire_codec="dict" if codec == "dict" else "",
                                        rebuilder=rank_model)
        get_arena().use_device(model.device)
        log.info("multi-host training (%s): rank %d of %d, %s step route",
                 model_cls.__name__, _dist.mesh().process_index,
                 _dist.mesh().num_processes, model.route)
        return model
    if plane:
        from ..parallel.tenants import TenantStackModel

        model = TenantStackModel.from_conf(
            conf, residual_fn=model_cls.residual_fn, prediction_fn=model_cls.prediction_fn,
            round_predictions=model_cls.round_predictions,
        )
    else:
        model = model_cls.from_conf(conf)
    get_arena().use_device(model.device)
    return model


# ---- installers of the process-wide planes ---------------------------------

def _rank_suffix() -> str:
    """``-p<rank>`` in a multi-host group (each rank's own trace, journal),
    "" on one host."""
    from ..parallel import distributed as _dist

    group = _dist.mesh()
    return f"-p{group.process_index}" if group.num_processes > 1 else ""


def _host_suffix() -> "str | None":
    """``-u<uid>`` under ``--elastic on``: the elastic uid (the launch id)
    keys a host's journal and historian across epochs and restarts, so a
    restarted host finds its own; None otherwise."""
    from ..parallel.elastic import get_runtime

    runtime = get_runtime()
    return None if runtime is None else f"-u{runtime.uid}"


def install_trace(conf) -> None:
    """``--trace PATH`` (rotated at ``--traceMaxMb``): the pipeline tracer
    (telemetry/trace.py); a multi-host rank traces to ``PATH.p<rank>``."""
    if conf.trace:
        suffix = _rank_suffix()
        _trace.install(conf.trace + (f".{suffix[1:]}" if suffix else ""),
                       max_bytes=int(conf.traceMaxMb or 0) * 1024 * 1024)


def install_chaos(conf) -> None:
    """``--chaos SPEC``: the seeded fault injector (streaming/faults.py). A
    run without the flag uninstalls an injector an earlier run in the same
    process left."""
    if not conf.chaos:
        _faults.uninstall_chaos()
        return
    try:
        _faults.install_chaos(conf.chaos)
    except ValueError as exc:
        raise SystemExit(f"bad --chaos spec: {exc}")


def install_blackbox(conf) -> None:
    """``--blackbox`` (on by default): the crash flight recorder
    (telemetry/blackbox.py). The bundle lands next to the checkpoint
    directory, or in the temporary directory without one; a SIGTERM dumps
    too, where the handler can be installed (the main thread)."""
    if conf.blackbox != "on":
        _blackbox.uninstall()
        return
    ckpt_dir = conf.checkpointDir
    out_dir = (os.path.dirname(os.path.abspath(ckpt_dir)) if ckpt_dir
               else tempfile.gettempdir())
    cfg = {k: v for k, v in vars(conf).items() if isinstance(v, (str, int, float, bool))}
    from ..parallel import distributed as _dist

    _blackbox.install(config=cfg, out_dir=out_dir,
                      process_index=_dist.mesh().process_index)
    _blackbox.install_signal_handler()


def install_journal(conf) -> None:
    """``--journal`` (auto: on with ``--checkpointDir``): open the intake
    journal under ``<checkpointDir>/journal`` (``journal-p<rank>`` for a
    multi-host rank: each journals its own shard; ``journal-u<uid>`` under
    ``--elastic on``), so the seam in
    streaming/context.py appends. Off uninstalls a journal an earlier run
    in the same process left."""
    if not conf.effective_journal():
        _journal.uninstall()
        return
    if not conf.checkpointDir:
        raise SystemExit("--journal on requires --checkpointDir: the replay cursor "
                         "lives in verified checkpoint meta (use --journal auto to "
                         "follow the checkpoint flag)")
    suffix = _host_suffix()
    _journal.install(os.path.join(conf.checkpointDir,
                                  "journal" + (_rank_suffix() if suffix is None else suffix)),
                     max_mb=int(conf.journalMaxMb or 512))


def install_historian(conf) -> None:
    """``--history`` (auto: on with ``--checkpointDir``): open the telemetry
    historian under ``<checkpointDir>/history`` (``history-u<uid>`` under
    ``--elastic on``: a restarted host appends after its own tail), so
    SessionStats' publish
    seam samples into it, with a run id from the counter the JAX package
    shares and the config's fingerprint. Off uninstalls a historian an
    earlier run in the same process left."""
    if not conf.effective_history():
        _historian.uninstall()
        return
    if not conf.checkpointDir:
        raise SystemExit("--history on requires --checkpointDir: the historian "
                         "segments and the --perfGuard baseline live under it (use "
                         "--history auto to follow the checkpoint flag)")
    _historian.configure(
        os.path.join(conf.checkpointDir, "history" + (_host_suffix() or "")),
        max_mb=int(conf.historyMaxMb or 256),
        perf_guard=conf.perfGuard == "warn",
        guard_ratio=float(conf.perfGuardRatio or 1.5),
        run_id=next_run_id(),
        fingerprint=config_fingerprint(conf),
    )


def init_distributed(conf) -> bool:
    """The cluster face of every entry point (the reference's ``--master``):
    validate ``--master``, and when ``--coordinator`` or a ``twtml://``
    master asks for a multi-host group, join it (parallel/distributed.py
    ``initialize``, on ``--backend``'s device kind; ``_init_elastic`` under
    ``--elastic on``). Returns whether this process prints and publishes:
    the lead (rank 0), or any single-host run."""
    from ..parallel import distributed as _dist

    conf.validate_master()
    group = conf.multihost()
    if group is None:
        return True
    coordinator, num_processes, process_id = group
    if conf.elastic == "on":
        return _init_elastic(conf, coordinator, num_processes, process_id)
    return _dist.initialize(coordinator, num_processes, process_id, conf.backend)


def _init_elastic(conf, coordinator: str, num_processes: int, process_id: int) -> bool:
    """Elastic group formation. A cold start forms epoch 0 with the whole
    launch membership; a restarted host (the run is live and this uid is
    not a member) parks at the beacon and joins at the epoch boundary the
    lead commits for it. The device is chosen first, once, from the launch
    id."""
    from ..parallel import distributed as _dist
    from ..parallel import elastic as _elastic
    from ..streaming.membership import PARK_TIMEOUT_DEFAULT_S, PARK_TIMEOUT_ENV

    host, _, port = coordinator.rpartition(":")
    _dist.setup(process_id, conf.backend)
    runtime = _elastic.install_runtime(host or "127.0.0.1", int(port), process_id)
    launch_members = list(range(num_processes))
    if not conf.checkpointDir:
        log.warning("--elastic on without --checkpointDir: membership changes "
                    "re-synchronize from the lead's LIVE state instead of a verified "
                    "on-disk checkpoint (reduced rollback guarantee)")
    if process_id == 0 and runtime.beacon is not None:
        # a cold start: uid 0 owns the beacon and leads the launch
        runtime.beacon.publish("forming", 0, launch_members)
        runtime.form(0, launch_members)
        return _dist.mesh().process_index == 0
    # uid 0 without the beacon is a RESTARTED ex-lead: an elected successor
    # owns the port, so it rejoins through the followers' path
    client = runtime.beacon_client()
    deadline = time.monotonic() + _elastic._init_timeout_s()
    hello = None
    while time.monotonic() < deadline:
        hello = client.request("hello", process_id)
        if hello is not None:
            break
        time.sleep(0.5)
    if hello is None:
        raise SystemExit(f"--elastic on: the lead's membership beacon at "
                         f"{host}:{runtime.beacon_port} never answered (is the lead up?)")
    # the beacon names the CURRENT lead (an elected one after an election)
    runtime.set_lead(int(hello.get("lead_uid", 0)))
    if hello["state"] == "forming":
        runtime.form(0, launch_members)
        return _dist.mesh().process_index == 0
    log.warning("elastic: run already live at epoch %d (members %s); parking this host "
                "(uid %d) for admission at the next epoch boundary", hello["epoch"],
                hello["members"], process_id)
    park_deadline = time.monotonic() + float(
        os.environ.get(PARK_TIMEOUT_ENV, "") or PARK_TIMEOUT_DEFAULT_S)
    while time.monotonic() < park_deadline:
        client.request("join", process_id)
        state = client.request("hello", process_id) or {}
        plan = (client.request("plan", process_id) or {}).get("plan")
        if plan and process_id in plan.get("members", []) and (
                plan["epoch"] > state.get("epoch", -1)):
            # the admission plan names the lead that committed it
            runtime.set_lead(int(plan.get("lead_uid", runtime.lead_uid)))
            runtime.joined_late = True
            runtime.form(plan["epoch"], plan["members"])
            return _dist.mesh().process_index == 0
        time.sleep(0.5)
    raise SystemExit("elastic: admission never committed within the park window (is "
                     "--elasticRejoin off on the lead, or the group idle?)")


def select_backend(conf) -> None:
    """The JAX package's ``select_backend`` checks for the port, before
    anything is built: ``--master`` (``validate_master``), ``--dtype`` (float64 on
    ``--backend cpu`` only: the JAX package runs it on its CPU backend
    alone) and ``local[N]``, which the JAX package resolves to
    ``min(N, devices)`` data shards: one process drives one device (the
    CPU, or one card), so every ``local[N]`` runs unsharded, and a
    multi-host group ignores the hint (logged)."""
    from ..parallel import distributed as _dist

    conf.validate_master()
    if conf.dtype not in DTYPES:
        raise SystemExit(f"--dtype {conf.dtype!r}: the port trains {'|'.join(DTYPES)}")
    if conf.dtype == "float64" and conf.backend != "cpu":
        raise SystemExit("--dtype float64 runs on the CPU backend only (as in the "
                         "JAX package); add --backend cpu")
    shards = conf.local_shards()
    if shards and shards > 1:
        if _dist.is_multihost():
            log.warning("--master local[N] hint ignored in a multi-host run")
        else:
            log.info("--master %s: min(%d, 1 device) = 1 data shard, unsharded",
                     conf.master, shards)


# ---- checkpoint and journal recovery ---------------------------------------

def state_checksum(state) -> str:
    """CRC of a checkpointable state (one array or a flat dict), logged at a
    recycle's save and at restore, so the two log lines prove the restart's
    weights bit-identical to the save."""
    arrs = state if isinstance(state, dict) else {"state": state}
    crc = 0
    for key in sorted(arrs):
        a = np.ascontiguousarray(np.asarray(arrs[key]))
        crc = zlib.crc32(a.tobytes(), zlib.crc32(f"{key}:{a.dtype}:{a.shape}".encode(), crc))
    return f"{crc:08x}"


class AppCheckpoint:
    """``--checkpointDir``/``--checkpointEvery``, single host: restores the
    state and the counters at start, saves on a cadence at drained
    boundaries (``at_boundary``: the weights are current and nothing is in
    flight, so reading them costs no hidden sync), and saves the final
    state at shutdown. ``get_state()`` returns the checkpointable arrays,
    ``set_state(state)`` restores them into the model.

    Each save stamps into the verified archive's meta the model-watch and
    freshness pictures and the journal's committed cursor, then retires the
    journal segments every retained archive covers.

    In a multi-host group the lead is authoritative: every rank restores
    what it finds, then the lead's restored state and counters are
    broadcast to all (a follower on other storage, or a stale one,
    converges on the lead's), only the lead writes archives, and a rollback
    restores on the lead and broadcasts (``rollback_to_verified``: every
    rank calls it at the same delivery).

    Elastic (``--elastic on``): the lead is the runtime's (``lead_uid``),
    and every other host shadow-saves the same verified archives into its
    own ``standby-u<uid>/`` under the directory, on the same cadence: the
    steps are all-reduce-identical, so its archives are the lead's bits.
    That is what an election relies on: ``promote`` hands the won
    authority to this host's archives, and ``resync_from_verified``
    re-synchronizes an epoch from the lead's own verified archive. The
    broadcasts send from the lead's rank, whatever its place in the epoch."""

    def __init__(self, conf, get_state, set_state, totals: dict, lead: bool = True):
        from ..parallel.elastic import get_runtime

        runtime = get_runtime()
        self._lead = runtime.is_lead if runtime is not None else lead
        self._shadow = runtime is not None and not self._lead
        self._ckpt: "Checkpointer | None" = None
        self._get_state = get_state
        self._set_state = set_state
        self.every = int(conf.checkpointEvery or 0)
        self.restored_meta = None
        self._last = 0
        if not conf.checkpointDir:
            return
        ckpt_dir = conf.checkpointDir
        if self._shadow:
            ckpt_dir = os.path.join(conf.checkpointDir, f"standby-u{runtime.uid}")
            log.info("elastic standby checkpoints: this host shadow-saves verified "
                     "archives into %s (any host can restore)", ckpt_dir)
        self._ckpt = Checkpointer(ckpt_dir)
        restored = self._ckpt.restore()
        self.restored_meta = restored[1] if restored is not None else None
        if restored is not None:
            state, meta = restored
            set_state(state)
            totals["count"] = int(meta.get("count", 0))
            totals["batches"] = int(meta.get("batches", 0))
            log.info("resumed from checkpoint step %s (count=%s, state crc %s)",
                     meta.get("step"), totals["count"], state_checksum(state))
        if self._multihost:
            self._sync_from_lead(totals, restored is not None)
        self._last = totals["batches"]

    @property
    def _multihost(self) -> bool:
        """Whether the current group has more than one rank (an elastic group
        shrunk to one host restores and rolls back locally)."""
        from ..parallel import distributed as _dist

        return _dist.is_multihost()

    def _sync_from_lead(self, totals: dict, restored: bool) -> None:
        """Every rank takes the lead's state and counters (one broadcast)."""
        from ..parallel import distributed as _dist

        got = _dist.broadcast_object(
            (restored, totals["count"], totals["batches"], self._get_state()),
            is_source=self._lead)
        lead_restored, count, batches, state = got
        self._set_state(state)
        totals["count"], totals["batches"] = int(count), int(batches)
        if lead_restored and not restored:
            log.info("resumed from the lead's broadcast checkpoint (count=%s)", count)
        log.info("multi-host state synchronized from the lead (count=%s, state crc %s)",
                 totals["count"], state_checksum(state))

    @property
    def directory(self) -> str:
        return self._ckpt.directory if self._ckpt is not None else ""

    def _save(self, totals: dict) -> None:
        if not self._lead and not self._shadow:
            self._last = totals["batches"]  # the lead writes; keep the cadence aligned
            return
        j = _journal.get()
        if j is not None and not j.save_allowed:
            # a replay is still draining: the weights hold rows past the
            # rollback cursor the journal cannot commit yet, so a save now
            # would double-train them on restore. _last stays: the cadence
            # retries at the next boundary
            log.info("checkpoint save deferred at batch %s: journal replay still "
                     "draining (retries next boundary)", totals["batches"])
            return
        meta = {"count": totals["count"], "batches": totals["batches"]}
        quality = _modelwatch.snapshot_for_checkpoint()
        if quality is not None:
            meta["quality"] = quality
        fresh = _freshness.snapshot_for_checkpoint()
        if fresh is not None:
            meta["freshness"] = fresh
        jstamp = _journal.snapshot_for_checkpoint()
        if jstamp is not None:
            meta["journal"] = jstamp
        self._ckpt.save(totals["batches"], self._get_state(), meta)
        self._last = totals["batches"]
        if jstamp is not None:
            # segments retire once EVERY retained archive covers them (a
            # fallback restore may land on the oldest)
            covered = ((self._ckpt.oldest_meta() or {}).get("journal") or {}).get("cursor")
            if covered is not None:
                j.retire_covered(int(covered))
        _blackbox.note("last_checkpoint",
                       {"step": totals["batches"], "count": totals["count"]})

    def maybe_save(self, totals: dict, at_boundary: bool = True) -> None:
        """The cadence save; the app's handler calls it every batch."""
        if (self._ckpt is not None and at_boundary and self.every > 0
                and totals["batches"] - self._last >= self.every):
            self._save(totals)

    def final_save(self, totals: dict) -> None:
        """The shutdown save, when anything advanced past the last one."""
        if self._ckpt is not None and totals["batches"] != self._last:
            self._save(totals)

    def save_now(self, totals: dict) -> bool:
        """An unconditional save (a recycle, a guard's forced save); False
        without a checkpoint directory."""
        if self._ckpt is None:
            return False
        self._save(totals)
        return True

    def own_journal_stamp(self, batches: int) -> "dict | None":
        """This rank's journal cursor for an agreed rollback point: the
        newest archive's stamp when its ``batches`` is that point (a stale or
        missing archive gives None, and the caller counts the rows lost)."""
        if self._ckpt is None:
            return None
        meta = self._ckpt.latest_meta()
        if meta is None or int(meta.get("batches", -1)) != int(batches):
            return None
        return meta.get("journal")

    def adopt_replay_totals(self, totals: dict, count, batches) -> None:
        """Reset the run's counters to the rollback point whose rows a
        journal replay re-ingests: they count again through the unchanged
        handler, so the final ledger equals an unfailed run's."""
        totals["count"] = int(count)
        totals["batches"] = int(batches)
        self._last = totals["batches"]

    def rollback_to_verified(self) -> "dict | None":
        """Restore the newest VERIFIED (checksummed, finite) archive into the
        model: the sentinel's recovery. Returns its meta, or None when there
        is none (no directory, or every archive corrupt or non-finite)."""
        restored = self._ckpt.restore() if self._ckpt is not None else None
        if restored is not None:
            _blackbox.note("last_verified_rollback", {"step": restored[1].get("step")})
        if not self._multihost:
            if restored is None:
                return None
            state, meta = restored
            self._set_state(state)
            return meta
        from ..parallel import distributed as _dist

        # every rank calls this at the same delivery; the lead's disk wins,
        # and the agreed (count, batches) ride the same broadcast so a
        # follower finds its own journal cursor
        mine = None
        if self._lead and restored is not None:
            mine = (restored[0], int(restored[1].get("count", 0)),
                    int(restored[1].get("batches", 0)))
        got = _dist.broadcast_object(mine, is_source=self._lead)
        if got is None:
            return None
        state, count, batches = got
        self._set_state(state)
        if self._lead:
            return restored[1]
        return {"broadcast": True, "count": count, "batches": batches}

    def promote(self) -> None:
        """The elastic lead's hand-off: this host won an election. Its standby
        archives become the group's lineage (later saves go on into the same
        directory), and the next ``resync_from_verified`` restores from them
        and broadcasts from this host. Idempotent."""
        if self._lead:
            return
        self._lead = True
        self._shadow = False
        if self._ckpt is not None:
            log.warning("checkpoint authority PROMOTED after lead election: this host's "
                        "verified archives in %s are the group's lineage now",
                        self._ckpt.directory)
        _blackbox.record("checkpoint_promoted", directory=self.directory)

    def resync_from_verified(self, totals: dict) -> bool:
        """Re-synchronize a just-formed elastic epoch: every member takes the
        LEAD's state and counters, its newest verified archive when one
        exists (a clean commit saved at the boundary first, so it loses
        nothing; a rescue rolls back at most ``--checkpointEvery`` batches),
        else its live weights. Rolled-back rows are counted
        (``elastic.rows_rolled_back``). The broadcast is the one a starting
        rank's restore makes (``_sync_from_lead``), so a rejoiner's start
        pairs with it. An epoch of one host restores locally, with no
        collective. Returns False only when there is neither an archive nor
        a broadcast to take (one host, no archive: the state goes on)."""
        from ..parallel import distributed as _dist

        restored = self._ckpt.restore() if self._ckpt is not None and self._lead else None
        old_count = int(totals.get("count", 0))

        def adopt(state, count, batches) -> None:
            self._set_state(state)
            totals["count"] = int(count)
            totals["batches"] = int(batches)
            self._last = totals["batches"]
            rolled = max(0, old_count - totals["count"])
            if rolled:
                _metrics.get_registry().counter("elastic.rows_rolled_back").inc(rolled)
            source = ("verified checkpoint" if restored is not None or not self._lead
                      else "live weights")
            log.warning("elastic resync: state from the lead's %s (count=%d, batches=%d, "
                        "state crc %s)%s", source, totals["count"], totals["batches"],
                        state_checksum(state),
                        f" — {rolled} row(s) of post-checkpoint progress rolled back "
                        "(counted)" if rolled else "")

        if not _dist.is_multihost():
            if restored is None:
                return False
            state, meta = restored
            adopt(state, meta.get("count", 0), meta.get("batches", 0))
            return True
        state = self._get_state()
        count, batches = totals.get("count", 0), totals.get("batches", 0)
        if restored is not None:
            state, meta = restored
            count, batches = meta.get("count", 0), meta.get("batches", 0)
        _found, count, batches, state = _dist.broadcast_object(
            (restored is not None, int(count), int(batches), state), is_source=self._lead)
        adopt(state, count, batches)
        return True


def journal_replay_rollback(ssc, ckpt: AppCheckpoint, totals: dict, meta,
                            where: str) -> "int | None":
    """Re-ingest every journaled row after the rollback point ``meta``
    names (None: no verified archive, the model went back to zeros, and the
    whole journal replays from cursor 0): the rows go back to the queue
    FRONT and the counters to the rollback point. Returns the rows
    replayed, or None when replay is impossible (no journal, or an archive
    without a cursor); the caller then counts the rows lost. Host only:
    disk reads and queue putbacks."""
    j = _journal.get()
    if j is None:
        return None
    if meta is None:
        count = batches = 0
        stamp = {"cursor": 0, "rows": 0}
    else:
        count = int(meta.get("count", 0))
        batches = int(meta.get("batches", 0))
        stamp = meta.get("journal")
        if stamp is None and meta.get("broadcast"):
            # a follower: the lead's agreed rollback point, this rank's cursor
            stamp = ckpt.own_journal_stamp(batches)
    if stamp is None:
        log.warning("journal: the rollback point (batches=%d) carries no journal "
                    "cursor after %s; rows stay counted as lost, not replayed",
                    batches, where)
        return None
    cursor = int(stamp["cursor"])
    # an earlier replay still draining is superseded: its rows, parked at
    # the queue front, are re-covered by this one and must not train twice
    stale = j.cancel_pending_replay()
    if stale:
        queued = ssc._drain(0)
        qrows = _journal.rows_of(queued)
        ssc._putback(_journal.drop_rows(queued, stale) if qrows > stale else [])
        log.warning("journal: superseded an in-progress replay: dropped %d stale "
                    "queued row(s) the new replay from cursor %d re-covers",
                    min(stale, qrows), cursor)
    items, rows = j.replay_from(cursor)
    ssc._putback(items)
    ckpt.adopt_replay_totals(totals, count, batches)
    _blackbox.record("journal_replay", where=where, rows=rows, cursor=cursor,
                     count=count, batches=batches)
    log.warning("journal: replayed %d row(s) from cursor %d after %s; counters "
                "reset to (count=%d, batches=%d); recovery is replay-exact, zero "
                "rows lost", rows, cursor, where, count, batches)
    return rows


def journal_boot_replay(conf, ssc, ckpt: AppCheckpoint, totals: dict) -> int:
    """The boot half of journal recovery (a restart after a kill, an abort or
    a recycle): every row the journal holds is either inside the restored
    checkpoint (id < cursor) or put back here from the journal, and the
    source fast-forwards past ALL of them (``SkipRowsSource``). Call after
    ``AppCheckpoint`` restored and before the stream starts."""
    j = _journal.get()
    if j is None:
        return 0
    from ..parallel.elastic import get_runtime

    runtime = get_runtime()
    if runtime is not None and runtime.joined_late:
        # this host's pre-departure rows went to their adopters when the
        # group re-formed without it: replaying (or skipping past) its old
        # journal would train adopted rows twice
        j.reset()
        log.warning("journal: reset on late join: this host's pre-departure rows "
                    "belong to their adopters now; boot replay skipped")
        return 0
    meta = ckpt.restored_meta
    stamp = (meta or {}).get("journal")
    if meta is not None and stamp is None:
        log.warning("journal: the restored checkpoint carries no journal cursor; "
                    "boot replay skipped, the source re-produces from its top")
        return 0
    if meta is not None and int(meta.get("batches", -1)) != int(totals.get("batches", 0)):
        # the lead's broadcast moved the counters away from this host's own
        # archive: its cursor no longer names the adopted state
        log.warning("journal: local archive (batches=%s) disagrees with the adopted "
                    "counters (batches=%s); boot replay skipped", meta.get("batches"),
                    totals.get("batches"))
        return 0
    cursor = int(stamp["cursor"]) if stamp is not None else 0
    skip_rows = j.rows_total
    items, rows = j.replay_from(cursor)
    ssc._putback(items)
    if skip_rows:
        ssc._source = SkipRowsSource(ssc._source, skip_rows)
    _blackbox.record("journal_replay", where="boot", rows=rows, cursor=cursor,
                     count=int(totals.get("count", 0)),
                     batches=int(totals.get("batches", 0)))
    if skip_rows or rows:
        log.warning("journal: boot resume — %d journaled row(s), %d fast-forwarded "
                    "at the source (%d inside the restored checkpoint, %d replayed "
                    "from cursor %d); zero rows lost, zero rows double-trained",
                    skip_rows, skip_rows, skip_rows - rows, rows, cursor)
    return rows


# ---- the runtime guards ----------------------------------------------------

class DivergenceSentinel:
    """Non-finite-state guard at the model boundary (``--sentinel``, on by
    default). A poisoned batch (a NaN label in a valid row) drives the
    weights non-finite in one step; the sentinel sees it in the fetched
    mse and stdevs (NaN labels reach mse and real_stdev, NaN weights the
    predictions), three ``math.isfinite`` calls on host scalars a batch.

    A non-finite delivery is skipped (its cap slot refunded), the model rolls
    back to the last verified checkpoint (zeros without one; on the tenant
    plane the whole [M, F+4] stack, whose aggregate stats any poisoned
    tenant makes non-finite), and the
    journal re-ingests the rows after it; ``model.rollbacks`` counts it.
    Batches dispatched against the poisoned weights before the rollback drain
    as tainted skips of the SAME episode; the first finite delivery closes
    it. ``--sentinelRollbacks`` rollbacks within ``--sentinelWindow``
    batches abort the run through ``ssc.request_abort``."""

    def __init__(self, conf, model, ckpt: AppCheckpoint, ssc, totals: "dict | None" = None):
        self.enabled = conf.sentinel == "on"
        self.max_rollbacks = int(conf.sentinelRollbacks or 0)
        self.window = max(1, int(conf.sentinelWindow or 1))
        self._model = model
        self._ckpt = ckpt
        self._ssc = ssc
        # the run's counters, which a replayed rollback resets; None keeps
        # the counted-loss path
        self._totals = totals
        self._replaying = False
        self._num_features = int(conf.numTextFeatures)
        self._tainted = False
        self._delivered = 0
        self._rollback_points: "list[int]" = []
        self._pipeline = None
        reg = _metrics.get_registry()
        self._nonfinite_count = reg.counter("model.nonfinite_batches")
        self._rollback_count = reg.counter("model.rollbacks")
        self._rows_lost = reg.counter("model.rows_lost")
        if self.enabled:
            ssc.rollback_count_fn = lambda: len(self._rollback_points)

    def bind(self, pipeline) -> None:
        """The fetch pipeline whose ``refund_dispatch`` keeps a max-batches
        cap exact when a batch is skipped."""
        self._pipeline = pipeline

    @property
    def rollbacks(self) -> int:
        return len(self._rollback_points)

    @staticmethod
    def _finite(out) -> bool:
        return (math.isfinite(float(out.mse)) and math.isfinite(float(out.real_stdev))
                and math.isfinite(float(out.pred_stdev)))

    def admit(self, out, batch) -> bool:
        """True: hand the batch to the app's handler; False: skipped (the
        rollback or abort is handled here)."""
        self._delivered += 1
        if self._finite(out):
            if self._tainted:
                log.warning("divergence sentinel: finite stats resumed at delivered "
                            "batch %d; the rollback recovered the model", self._delivered)
                self._tainted = False
            return True
        self._nonfinite_count.inc()
        rows = int(out.count)
        if self._pipeline is not None:
            self._pipeline.refund_dispatch()
        if self._tainted:
            if not self._replaying:
                self._rows_lost.inc(rows)
            log.warning("divergence sentinel: skipping tainted in-flight batch "
                        "(delivered %d, %d rows)%s", self._delivered, rows,
                        " — rows re-ingest via journal replay" if self._replaying else "")
            return False
        self._tainted = True
        self._rollback()
        if not self._replaying:
            self._rows_lost.inc(rows)
        return False

    def _rollback(self) -> None:
        self._rollback_count.inc()
        self._rollback_points.append(self._delivered)
        episode = len(self._rollback_points)
        _trace.get().instant("sentinel_rollback", delivered=self._delivered, episode=episode)
        _blackbox.record("sentinel_rollback", delivered=self._delivered, episode=episode)
        meta = self._ckpt.rollback_to_verified()
        replayed = None
        trained = self._totals["batches"] if self._totals is not None else 0
        if self._totals is not None:
            replayed = journal_replay_rollback(self._ssc, self._ckpt, self._totals, meta,
                                               where="sentinel rollback")
        self._replaying = replayed is not None
        if self._replaying and self._pipeline is not None:
            # a batch already featurized but not yet dispatched is replayed,
            # and so are the batches trained since the rollback point
            self._pipeline.note_replay(trained - self._totals["batches"])
        if meta is not None:
            log.error("divergence sentinel: NON-FINITE model state at delivered batch "
                      "%d — rolled back to verified checkpoint step %s and skipping "
                      "the poisoning batch (rollback #%d)", self._delivered,
                      meta.get("step", "?"), episode)
        else:
            # nothing to roll back to: the reference's initial zeros; progress
            # is lost, the stream keeps training
            self._model.set_initial_weights(
                np.zeros((self._num_features + NUM_NUMBER_FEATURES,), np.float32))
            log.error("divergence sentinel: NON-FINITE model state at delivered batch "
                      "%d and no verified checkpoint — model RESET to initial zeros "
                      "(rollback #%d); add --checkpointDir to preserve progress across "
                      "rollbacks", self._delivered, episode)
        in_window = [p for p in self._rollback_points if self._delivered - p < self.window]
        if self.max_rollbacks and len(in_window) >= self.max_rollbacks:
            _metrics.get_registry().counter("model.sentinel_aborts").inc()
            _blackbox.record("sentinel_abort", rollbacks=len(in_window), window=self.window)
            log.critical("divergence sentinel: %d rollbacks within %d batches — the "
                         "stream keeps poisoning the model; aborting the run cleanly "
                         "(the shutdown saves a final checkpoint and the run fails)",
                         len(in_window), self.window)
            self._ssc.request_abort("divergence sentinel rollback budget")


class ModelWatchGuard:
    """``--modelWatch`` delivery adapter: feeds the model watcher
    (telemetry/modelwatch.py) from the quality vector the fetch already
    brought, and, when the watcher holds ``alert`` for
    ``--modelWatchWindow`` delivered batches, records a flight-recorder
    event and forces ONE verified checkpoint an episode (warn-only)."""

    def __init__(self, conf, ckpt: "AppCheckpoint | None", totals: dict):
        self.enabled = conf.modelWatch == "on"
        self.window = max(1, int(conf.modelWatchWindow or 1))
        self._ckpt = ckpt
        self._totals = totals
        self._saved_episode = False
        self._alert_saves = _metrics.get_registry().counter("model.alert_checkpoints")

    def observe(self, out, at_boundary: bool = True) -> None:
        if not self.enabled or getattr(out, "quality", None) is None:
            return
        counts = np.atleast_1d(np.asarray(out.count, np.float64))
        if float(counts.sum()) <= 0:
            return  # an all-padding batch carries no data
        verdict = _modelwatch.record_tick(np.asarray(out.quality, np.float64), counts,
                                          np.asarray(out.mse, np.float64))
        if verdict["level"] != "alert":
            self._saved_episode = False
            return
        if verdict["alert_run"] >= self.window and not self._saved_episode and at_boundary:
            self._saved_episode = True
            self._alert_saves.inc()
            _blackbox.record("modelwatch_alert_checkpoint",
                             batches=self._totals.get("batches", 0),
                             drift=round(verdict["drift_score"], 3),
                             trend=round(verdict["loss_trend"], 4))
            saved = self._ckpt.save_now(self._totals) if self._ckpt is not None else False
            log.warning("model watch: ALERT held for %d batches (drift z=%.2f, loss trend "
                        "%+.1f%%) — %s (early warning only; training continues, the "
                        "sentinel still owns rollback)", verdict["alert_run"],
                        verdict["drift_score"], verdict["loss_trend"] * 100.0,
                        "forced a verified-checkpoint save" if saved else
                        "no checkpoint dir configured, evidence recorded to the flight "
                        "recorder only")


class FreshnessGuard:
    """``--freshness`` delivery adapter: pops the batch's lineage record
    (telemetry/freshness.py) and, on a sustained ``--freshnessSloMs``
    breach, forces ONE verified checkpoint an episode (warn-only). Wired
    outside the sentinel, so every delivery (a skipped one too) pops its
    record and the dispatch-ordered FIFO stays aligned."""

    def __init__(self, conf, ckpt: "AppCheckpoint | None" = None,
                 totals: "dict | None" = None):
        self.enabled = conf.freshness == "on"
        self._ckpt = ckpt
        self._totals = totals if totals is not None else {}
        self._saved_episode = False
        self._slo_saves = _metrics.get_registry().counter("freshness.slo_checkpoints")

    def observe(self, out, at_boundary: bool = True) -> None:
        if not self.enabled:
            return
        verdict = _freshness.record_delivery()
        if verdict is None:
            return
        if not verdict["breach"]:
            self._saved_episode = False
            return
        if verdict["in_episode"] and not self._saved_episode and at_boundary:
            self._saved_episode = True
            self._slo_saves.inc()
            saved = self._ckpt.save_now(self._totals) if self._ckpt is not None else False
            log.warning("freshness guard: event lag %.0f ms over SLO for %d batches "
                        "(critical edge: %s) — %s (warn-only; training continues, the "
                        "sentinel still owns rollback)", verdict["event_lag_ms"],
                        verdict["breach_run"], verdict["critical"] or "?",
                        "forced a verified-checkpoint save" if saved else
                        "no checkpoint dir configured, evidence recorded to the flight "
                        "recorder only")


class ProcessRecycler:
    """``--recycleAfterMb``: bounded process lifetime. Once RSS crosses the
    ceiling, the next drained boundary checkpoints and re-execs the process
    in place (``os.execv``: same interpreter, argv and environment); the
    restart restores the archive and the journal's boot replay resumes the
    stream exactly. Needs ``--checkpointDir``. ``TWTML_RECYCLE_MAX`` caps
    the recycles of a process lineage (counted in ``TWTML_RECYCLES`` across
    execs); ``TWTML_RECYCLE_SAMPLE_EVERY`` samples every Nth boundary."""

    def __init__(self, conf, ckpt: AppCheckpoint, totals: dict, sample_every: int = 1):
        self.threshold = float(conf.recycleAfterMb or 0)
        self._ticks = 0
        self._sample_every = max(1, int(os.environ.get("TWTML_RECYCLE_SAMPLE_EVERY",
                                                       sample_every)))
        if self.threshold <= 0:
            return
        from ..parallel import distributed as _dist

        if _dist.is_multihost():
            raise SystemExit("--recycleAfterMb is single-host: a multi-host lockstep group "
                             "cannot lose a member mid-collective; recycle the whole group "
                             "externally on the RSS watchdog's warning")
        if not conf.checkpointDir:
            raise SystemExit("--recycleAfterMb needs --checkpointDir (a recycle is "
                             "checkpoint + re-exec; without a checkpoint the restart "
                             "would train from zeros)")
        self._ckpt = ckpt
        self._totals = totals
        self._lineage = int(os.environ.get("TWTML_RECYCLES", "0") or 0)
        self._max = int(os.environ.get("TWTML_RECYCLE_MAX", "0") or 0)
        self._capped_warned = False

    def check(self, at_boundary: bool = True) -> None:
        """Every batch, after the cadence save; only a drained boundary may
        recycle (the snapshot must hold this batch)."""
        if self.threshold <= 0 or not at_boundary:
            return
        self._ticks += 1
        if self._ticks % self._sample_every:
            return
        cur = rss_mb()
        if cur < self.threshold:
            return
        if self._max and self._lineage >= self._max:
            if not self._capped_warned:
                self._capped_warned = True
                log.warning("RSS %.0f MB over the --recycleAfterMb ceiling but "
                            "TWTML_RECYCLE_MAX=%d reached; running on", cur, self._max)
            return
        self._recycle(cur)

    def _recycle(self, cur_mb: float) -> None:
        self._ckpt.save_now(self._totals)
        main = sys.modules.get("__main__")
        spec = getattr(main, "__spec__", None)
        if spec is not None and spec.name:
            argv = [sys.executable, "-m", spec.name] + sys.argv[1:]
        else:
            argv = [sys.executable] + sys.argv
        log.warning("process RSS %.0f MB crossed --recycleAfterMb %.0f: checkpointed at "
                    "batch %d (count=%d, state crc %s) and re-exec'ing (recycle #%d of "
                    "this lineage). Resume is exact.", cur_mb, self.threshold,
                    self._totals["batches"], self._totals["count"],
                    state_checksum(self._ckpt._get_state()), self._lineage + 1)
        os.environ["TWTML_RECYCLES"] = str(self._lineage + 1)
        for handler in logging.getLogger().handlers:
            handler.flush()
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, argv)


class FetchWatchdog:
    """Deadline + bounded-retry + clean-abort guard over the host fetches.

    A fetch is a pending device-to-host copy (``models/sgd.HostOutput``)
    whose event is polled (``done()``) against the deadline: an event wait
    cannot time out. A fetch that missed its deadline or raised is
    RE-ISSUED as a fresh copy of the same device output, which stays
    resident. The deadline derives from the health monitor's rolling fetch
    wait (``FETCH_DEADLINE_MULT`` x median, clamped to
    [``FETCH_DEADLINE_MIN_S``, ``FETCH_DEADLINE_MAX_S``]; the maximum
    before the first sample). After ``retries`` re-issues the run aborts:
    the abort hook marks it failed and stops the stream, and ``FetchAbort``
    is raised.

    Env overrides: ``TWTML_FETCH_DEADLINE_S`` pins a fixed deadline,
    ``TWTML_FETCH_RETRIES`` the retry budget. Constructor arguments win."""

    # the polling interval grows from the first to the last value
    POLL_FIRST_S = 20e-6
    POLL_MAX_S = 500e-6

    def __init__(self, health, abort=None, deadline_s: float = 0.0,
                 retries: "int | None" = None):
        self._health = health
        self._abort = abort
        self.deadline_s = deadline_s or float(
            os.environ.get("TWTML_FETCH_DEADLINE_S", "0") or 0
        )
        self.retries = (
            retries if retries is not None
            else int(os.environ.get("TWTML_FETCH_RETRIES", FETCH_RETRIES))
        )
        reg = _metrics.get_registry()
        self._retry_count = reg.counter("fetch.retries")
        self._abort_count = reg.counter("fetch.aborts")
        self.aborted = False

    def deadline(self) -> float:
        if self.deadline_s > 0:
            return self.deadline_s
        med_s = self._health.median_ms() / 1e3
        if med_s <= 0:
            return FETCH_DEADLINE_MAX_S
        return min(max(FETCH_DEADLINE_MULT * med_s, FETCH_DEADLINE_MIN_S),
                   FETCH_DEADLINE_MAX_S)

    def _ready_within(self, pending, seconds: float) -> bool:
        end = time.monotonic() + seconds
        nap = self.POLL_FIRST_S
        while not pending.done():
            if time.monotonic() >= end:
                return False
            time.sleep(nap)
            nap = min(2 * nap, self.POLL_MAX_S)
        return True

    def await_result(self, pending, reissue):
        """The host result of ``pending`` within the deadline; ``reissue()``
        starts a fresh fetch of the same device output and returns it."""
        attempts = 0
        while True:
            deadline = self.deadline()
            try:
                _faults.perturb("fetch")  # --chaos: inside the watched wait
                if self._ready_within(pending, deadline):
                    return pending.result()
                why = f"made no progress within its {deadline:.3g}s deadline"
            except Exception as exc:  # lawcheck: disable=TW005 -- not a swallow: the failure is captured into `why` and drives the watchdog's retry/abort machine below
                why = f"failed ({exc!r})"
            attempts += 1
            if attempts > self.retries:
                self.aborted = True
                self._abort_count.inc()
                _trace.get().instant("fetch_abort", attempts=attempts)
                _blackbox.record("fetch_abort", attempts=attempts, why=why)
                log.critical(
                    "stats fetch %s after %d attempt(s); aborting the run "
                    "(FetchWatchdog)", why, attempts,
                )
                if self._abort is not None:
                    self._abort()
                raise FetchAbort(f"fetch {why} after {attempts} attempts")
            self._retry_count.inc()
            _blackbox.record("fetch_retry", attempt=attempts, why=why)
            log.warning(
                "stats fetch %s; re-issuing (retry %d/%d: the device output "
                "is still resident, a fresh copy reads the same bytes)",
                why, attempts, self.retries,
            )
            pending = reissue()


class _Ready:
    """A fetch that is complete at once: a model without ``fetch_output``
    returns host values from ``step``."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def done(self) -> bool:
        return True

    def wait(self) -> None:
        pass

    def result(self):
        return self._value


def _fetcher(model):
    fetch = getattr(model, "fetch_output", None)
    return fetch if fetch is not None else _Ready


@contextlib.contextmanager
def _sync_debug(model, mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` around a dispatch on a cuda
    model (no-op when ``mode`` is empty or the model is not on cuda)."""
    device = getattr(model, "device", None)
    if not mode or device is None or device.type != "cuda":
        yield
        return
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_WIRE_TYPES = (PackedBatch, RaggedUnitBatch, UnitBatch, FeatureBatch)


def _packer(model, codec: str = ""):
    """The model's own wire pack (``pack_for_wire``: the tenant plane's
    routed wire, which carries the model's own ``wire_codec``; the serve
    engines'), else ``pack_batch`` with ``codec`` ("" or "dict")."""
    own = getattr(model, "pack_for_wire", None)
    if own is not None:
        return own
    return functools.partial(pack_batch, codec=codec or None)


def _codec_requested(model, codec: str) -> str:
    """The codec a dispatch's wire is meant to carry: the model's own under
    its ``pack_for_wire``, else the pipeline's."""
    if getattr(model, "pack_for_wire", None) is not None:
        return getattr(model, "wire_codec", "") or ""
    return codec


_codec_fallback_warned = False


def _record_wire_codec(wire, requested: str) -> "dict | None":
    """A packed wire's codec telemetry (the JAX package's): the
    ``wire.units_compressed_bytes`` and ``wire.codec_ratio`` gauges from
    ``wire_composition`` (layout arithmetic, no array read). A wire that
    asked for the codec and shipped raw (uint16 units, or an incompressible
    batch) counts in ``wire.codec_fallbacks``, with one warning a process.
    Returns the composition, or None when no codec was asked for."""
    global _codec_fallback_warned
    if not requested or requested == "off":
        return None
    comp = wire_composition(wire)
    reg = _metrics.get_registry()
    phys = comp.get("units_compressed")
    if phys is None:
        reg.counter("wire.codec_fallbacks").inc()
        reg.gauge("wire.codec_ratio").set(1.0)
        reg.gauge("wire.units_compressed_bytes").set(comp.get("units", 0))
        if not _codec_fallback_warned:
            _codec_fallback_warned = True
            log.warning("wire codec requested but this batch shipped RAW (non-ASCII-"
                        "widened units or incompressible): counted in "
                        "wire.codec_fallbacks; further fallbacks are silent")
        return comp
    reg.gauge("wire.units_compressed_bytes").set(phys)
    if phys:
        reg.gauge("wire.codec_ratio").set(round(comp["units"] / phys, 3))
    return comp


def _dispatch(model, batch, pack: bool, fetch, sync_debug: str, stamp: dict,
              codec: str = ""):
    """Pack (the ragged wire, by ``_packer``, digram-coded under ``codec``),
    step and start the fetch of one host batch, timing each part into
    ``stamp``, the stage clock (``wire_pack``, ``dispatch``) and the trace;
    the batch's lineage record goes in flight. Returns (pending fetch,
    device output, the batch's leases). On cuda the step's device time is
    bracketed by two events, read at delivery (``_finish_stamp``); a coded
    wire's units bytes raw and coded go into ``stamp`` (``units_bytes``,
    ``units_coded_bytes``: None when it shipped raw)."""
    device = getattr(model, "device", None)
    events = None
    tr = _trace.get()
    with _sync_debug(model, sync_debug), annotate("twtml.dispatch"):
        packs = native.COUNTERS["packs_native"]
        t0 = time.perf_counter()
        if pack:
            with tr.span("wire_pack", mode="single") as sp:
                wire = _packer(model, codec)(batch)
                if tr.enabled:
                    sp.add(wire_bytes=wire_nbytes(wire))
        else:
            wire = batch
        t1 = time.perf_counter()
        _faults.perturb("step")  # --chaos: inside the dispatch window
        if device is not None and device.type == "cuda":
            import torch

            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
        out = model.step(wire)
        if events is not None:
            events[1].record()
        t2 = time.perf_counter()
        pending = fetch(out)
        t3 = time.perf_counter()
    if pack:
        _sideband.record_stage("wire_pack", t1 - t0)
        comp = _record_wire_codec(wire, _codec_requested(model, codec))
        if comp is not None:
            stamp.update(units_bytes=comp["units"],
                         units_coded_bytes=comp.get("units_compressed"))
    _sideband.record_stage("dispatch", t3 - t1)
    _lineage.mark_dispatch()
    if tr.enabled:
        tr.complete("dispatch", t1, t3 - t1, depth=stamp.get("depth", 0))
    stamp.update(
        pack_ms=(t1 - t0) * 1e3, step_host_ms=(t2 - t1) * 1e3,
        dispatch_ms=(t3 - t1) * 1e3, step_events=events,
        wire_bytes=wire_nbytes(wire) if isinstance(wire, _WIRE_TYPES) else None,
        native_pack=native.COUNTERS["packs_native"] > packs,
    )
    return pending, out, chain_leases(getattr(wire, "lease", None),
                                       getattr(batch, "lease", None))


def _drop_undispatched(batch, why: str) -> None:
    """A batch that crossed the intake seam will not dispatch: its lineage
    record and journal token (the newest of each: the scheduler is one
    thread) go with it, so later deliveries pair with their own, and its
    leases are closed."""
    log.info("batch of %d rows not dispatched: %s", batch.num_valid, why)
    _lineage.drop_newest()
    j = _journal.get()
    if j is not None:
        j.drop_newest()
    lease = getattr(batch, "lease", None)
    if lease is not None:
        lease.discard()


def _guarded_dispatch(model, batch, pack, fetch, sync_debug, stamp, codec: str = ""):
    """``_dispatch``; a dispatch that raises (the context logs and skips
    the batch) first drops the batch's lineage record and journal token."""
    try:
        return _dispatch(model, batch, pack, fetch, sync_debug, stamp, codec)
    except Exception:
        _drop_undispatched(batch, "its dispatch raised")
        raise


def _finish_stamp(stamp: dict, t0: float, fetch_wait_s: float, depth: int) -> None:
    """Delivery-time fields: the fetch wait (also the ``fetch`` stage of
    the stage clock and the trace) and the step's time (CUDA events on
    cuda, both complete once the fetch is; the host clock of the
    synchronous step on the CPU)."""
    _sideband.record_stage("fetch", fetch_wait_s)
    tr = _trace.get()
    if tr.enabled:
        tr.complete("fetch", t0, fetch_wait_s, depth=depth)
    stamp["fetch_wait_ms"] = fetch_wait_s * 1e3
    events = stamp.pop("step_events", None)
    stamp["step_ms"] = (
        events[0].elapsed_time(events[1]) if events is not None
        else stamp["step_host_ms"]
    )


class FetchPipeline:
    """Depth-D in-order fetch for back-to-back streams: the scheduler thread
    packs and dispatches each batch (``model.step`` and the start of its
    host fetch, nothing waited for), keeps up to ``depth`` fetches in
    flight, and delivers the results IN ORDER to ``handle(host, batch, t,
    at_boundary, stamp)``: blocking on the oldest when ``depth`` are in
    flight, and early for every finished head. ``stamp`` holds the
    batch's timings (``stamp()`` at dispatch, then pack, dispatch, step,
    fetch wait, the in-flight depth at dispatch).

    Semantics of the synchronous path: per-batch stats identical and in
    order; ``at_boundary`` only when nothing newer is in flight (a drain);
    ``max_dispatch`` caps the batches that may train EXACTLY (enforced
    before dispatch, and a batch past the cap still delivers the pending
    ones, where the app's stop fires); ``boundary_every`` drains on a
    monotonic cadence counter; ``flush()`` drains the tail. A batch's
    leases retire after its handler (the handler reads the unpacked
    arrays), and are discarded on a fetch abort, never recycled.
    ``deterministic`` (a multi-host rank) drops the early emit of a
    finished head, whose timing differs between ranks: deliveries (and the
    handler's saves, rollbacks and stops) then land at the same dispatch
    on every rank."""

    def __init__(self, model, handle, depth: int = FETCH_DEPTH, stop_requested=None,
                 boundary_every: int = 0, max_dispatch: int = 0, pack: bool = False,
                 abort=None, fetch_deadline_s: float = 0.0,
                 fetch_retries: "int | None" = None, stamp=None,
                 sync_debug: str = "", wire_codec: str = "", deterministic: bool = False):
        self.model = model
        self.deterministic = deterministic
        self.handle = handle
        self.depth = max(1, depth)
        self.pack = pack
        self.wire_codec = wire_codec
        self._stop_requested = stop_requested
        self.boundary_every = boundary_every
        self.max_dispatch = max_dispatch
        self._stamp = stamp
        self.sync_debug = sync_debug
        self._fetch = _fetcher(model)
        self._registry = _metrics.get_registry()
        self._health = _metrics.get_health_monitor()
        self._fetch_count = self._registry.counter("fetch.count")
        self._fetch_hist = self._registry.histogram("fetch.latency_s")
        self._depth_gauge = self._registry.gauge("fetch.queue_depth")
        self._refund_count = self._registry.counter("fetch.refunds")
        self._watchdog = FetchWatchdog(
            self._health, abort=abort, deadline_s=fetch_deadline_s,
            retries=fetch_retries,
        )
        self._pending: list = []  # [(fetch, out, batch, t, lease, stamp)], oldest first
        self._dispatched = 0
        # the cadence runs on its own monotonic counter: a refund must not
        # make it pass a point twice or skip one
        self._cadence = 0
        self._last_boundary = 0
        # journal replays a delivery started (note_replay)
        self._replays = 0
        # (head fetch, when poll() first saw it unfinished)
        self._head_since = None

    def _emit_one(self) -> None:
        pending, out, batch, t, lease, stamp = self._pending.pop(0)
        t0 = time.perf_counter()
        try:
            host = self._watchdog.await_result(pending, lambda: self._fetch(out))
        except FetchAbort:
            # the dispatch may still run on a wedged card: never hand its
            # buffers out again
            if lease is not None:
                lease.discard()
            raise
        dt = time.perf_counter() - t0
        self._fetch_count.inc()
        self._fetch_hist.observe(dt)
        self._health.observe(dt)
        _finish_stamp(stamp, t0, dt, self.depth)
        self.handle(host, batch, t, at_boundary=not self._pending, stamp=stamp)
        if lease is not None:
            lease.retire()

    def drain(self) -> None:
        """Deliver every pending output now, dispatching nothing more (a
        cap, a cadence point, a flush, an elastic clean commit before the
        group re-forms: nothing stays in flight across a rebuild)."""
        while self._pending:
            self._emit_one()

    def drain_discard(self, why: str) -> int:
        """An elastic rescue's drain: a peer died, so an output in flight
        may hold collectives that failed, and awaiting it would only burn
        the fetch watchdog's retries. The resync restores the lead's
        verified checkpoint anyway, so the outputs in flight are DISCARDED:
        their cap slots refunded, their leases discarded (never reused), the
        rows counted in ``elastic.rows_discarded_inflight``. Returns the
        rows discarded."""
        if not self._pending:
            return 0
        n, rows = len(self._pending), 0
        for _pending, _out, batch, _t, lease, _stamp in self._pending:
            rows += int(getattr(batch, "num_valid", 0) or 0)
            self.refund_dispatch()
            if lease is not None:
                lease.discard()
        self._pending.clear()
        self._depth_gauge.set(0)
        self._registry.counter("elastic.rows_discarded_inflight").inc(rows)
        log.warning("elastic rescue: discarded %d in-flight batch output(s) (~%d row(s)): "
                    "%s; the resync restores the verified checkpoint, so these rolled-back "
                    "rows are counted in elastic.rows_discarded_inflight, never awaited",
                    n, rows, why)
        return rows

    def on_batch(self, batch, t) -> None:
        if self._watchdog.aborted:
            return  # a fetch abort is in flight: nothing more may train
        stop = self._stop_requested
        if stop is not None and stop():
            return
        if self.max_dispatch and self._dispatched >= self.max_dispatch:
            # cap reached: this batch must not train, but what did train is
            # delivered now, or the handler-side stop never fires
            self.drain()
            return
        replays = self._replays
        while len(self._pending) >= self.depth or (
            not self.deterministic and self._pending and self._pending[0][0].done()
        ):
            self._emit_one()
            if stop is not None and stop():
                return  # the cap landed on an emitted batch: no dispatch
        if self._replays != replays:
            # the batch crossed the journal's seam before a rollback one of
            # these emits made: its rows are among the replayed ones
            _drop_undispatched(batch, "it re-ingests with the journal's replay")
            return
        stamp = dict(self._stamp()) if self._stamp is not None else {}
        stamp["depth"] = len(self._pending)
        pending, out, lease = _guarded_dispatch(
            self.model, batch, self.pack, self._fetch, self.sync_debug, stamp,
            self.wire_codec,
        )
        self._pending.append((pending, out, batch, t, lease, stamp))
        self._depth_gauge.set(len(self._pending))
        self._dispatched += 1
        self._cadence += 1
        if self.boundary_every and (
            self._cadence - self._last_boundary >= self.boundary_every
        ):
            self.drain()
            self._last_boundary = self._cadence

    def note_replay(self, rolled_back: int = 0) -> None:
        """A delivery rolled the model back and the journal put every row
        from the rollback point back at the queue front (the sentinel calls
        this). The ``rolled_back`` batches that had trained since the
        rollback point train again from the replay: their ``max_dispatch``
        slots are given back, so a capped run still trains its cap."""
        self._replays += 1
        self._dispatched -= rolled_back

    def refund_dispatch(self) -> None:
        """Give back one ``max_dispatch`` slot (a handler that skips a
        delivered batch)."""
        self._dispatched -= 1
        self._refund_count.inc()

    @property
    def pending_fetches(self) -> int:
        """Fetches in flight (the serving plane's idle tick reads it)."""
        return len(self._pending)

    def poll(self) -> None:
        """Deliver the finished in-order results WITHOUT dispatching (the
        serving plane's idle tick, so results deliver when no new request
        comes to trigger ``on_batch``'s early emit). The watchdog's
        deadline holds here too: a head fetch that outlives it with no
        traffic behind it goes through the blocking path, whose watchdog
        re-issues and at last aborts, so a stalled fetch on an idle plane
        does not hang its clients until the next request."""
        while self._pending and self._pending[0][0].done():
            self._emit_one()
        if not self._pending:
            self._head_since = None
            return
        head = self._pending[0][0]
        now = time.monotonic()
        if self._head_since is None or self._head_since[0] is not head:
            self._head_since = (head, now)
            return
        if now - self._head_since[1] > self._watchdog.deadline():
            self._head_since = None
            self._emit_one()  # blocking: the watchdog owns it from here

    def flush(self) -> None:
        try:
            self.drain()
        except FetchAbort:
            # logged and the abort hook fired; never raise into shutdown
            if self._pending:
                log.warning("dropping %d undelivered batch output(s) after the "
                            "fetch abort", len(self._pending))
                for entry in self._pending:
                    if entry[4] is not None:
                        entry[4].discard()
                self._pending.clear()


class SuperBatcher:
    """K featurized batches as ONE ``model.step_many`` dispatch, each
    batch's outputs delivered to ``handle(host, batch, t, at_boundary,
    stamp)`` in order (the JAX package's ``SuperBatcher``).

    Only contiguous batches of one wire signature group: a batch of another
    shape closes the pending group first, and a partial group (a shape
    change, the stream's tail) runs as plain steps, fetched synchronously.
    A full group is packed (``group_wire``: ``pack_ragged_group``, one
    buffer, under ``wire_pack="group"`` on the ragged wire; else
    ``stack_batches``), dispatched with its host fetch started (one D2H copy
    of the K outputs), and up to ``fetch_depth`` groups stay in flight; the
    oldest is delivered when that many are, and early when it is done.
    ``at_boundary`` is True only for a group's last batch with nothing newer
    in flight (the weights are current); ``boundary_every`` drains at the
    first group boundary past each cadence point; ``max_dispatch`` caps the
    batches that may train at group granularity (a group may overshoot it
    by up to K - 1, as in the JAX package). A group's lease retires after
    its last handler. The dispatch runs under ``sync_debug`` as the fetch
    pipeline's does.

    Each batch's ``stamp`` holds its featurize stamp and its share (1/K) of
    the group's pack, dispatch, step (CUDA events on cuda) and fetch wait,
    with ``group`` = K and ``depth`` = groups in flight at the dispatch."""

    def __init__(self, model, k: int, handle, fetch_depth: int = 4,
                 boundary_every: int = 0, max_dispatch: int = 0, abort=None,
                 wire_pack: str = "stacked", stamp=None, sync_debug: str = "",
                 wire_codec: str = "", deterministic: bool = False):
        if wire_pack not in ("stacked", "group"):
            raise ValueError(f"wire_pack must be 'stacked' or 'group', got {wire_pack!r}")
        self.model = model
        self.deterministic = deterministic
        self.wire_codec = wire_codec
        self.k = k
        self.handle = handle
        self.fetch_depth = max(1, fetch_depth)
        self.boundary_every = boundary_every
        self.max_dispatch = max_dispatch
        self.wire_pack = wire_pack
        self.sync_debug = sync_debug
        self._stamp = stamp
        self._fetch = _fetcher(model)
        self._registry = _metrics.get_registry()
        self._health = _metrics.get_health_monitor()
        self._fetch_count = self._registry.counter("fetch.count")
        self._fetch_hist = self._registry.histogram("fetch.latency_s")
        self._depth_gauge = self._registry.gauge("fetch.queue_depth")
        self._refund_count = self._registry.counter("fetch.refunds")
        self._watchdog = FetchWatchdog(self._health, abort=abort)
        self._buf: list = []  # [(batch, t, stamp)] of the pending group
        self._sig = None
        self._inflight: list = []  # [(fetch, outs, group, lease, stamp)], oldest first
        self._dispatched = 0
        # the cadence runs on its own monotonic counter (a refund must not
        # move it)
        self._cadence = 0
        self._last_boundary = 0
        # journal replays a delivery started (note_replay)
        self._replays = 0

    def on_batch(self, batch, t) -> None:
        if self._watchdog.aborted:
            return  # a fetch abort is in flight: nothing more may train
        if self.max_dispatch and self._dispatched >= self.max_dispatch:
            # cap reached: deliver what trained, so the handler's stop fires
            self.drain()
            return
        sig = wire_signature(batch)
        if self._buf and sig != self._sig:
            self._close_group()  # another shape: close the group, never drop
        self._sig = sig
        stamp = dict(self._stamp()) if self._stamp is not None else {}
        self._buf.append((batch, t, stamp))
        if len(self._buf) >= self.k:
            self._close_group()

    def _coalesce(self, batch) -> bool:
        """Whether this batch rides the one-buffer group wire."""
        return self.wire_pack == "group" and isinstance(batch, RaggedUnitBatch)

    def group_wire(self, batches):
        """The ``step_many`` wire of a full group: one packed buffer in
        group mode on the ragged wire, the stacked arrays otherwise."""
        if self._coalesce(batches[0]):
            own = getattr(self.model, "pack_group_for_wire", None)
            with _trace.get().span("wire_pack", mode="group", batches=len(batches)):
                if own is not None:  # a multi-host rank's segment, agreed buckets
                    return own(batches)
                return pack_ragged_group(batches, codec=self.wire_codec or None)
        return stack_batches(batches)

    def _emit_group(self) -> None:
        pending, outs, group, lease, gstamp = self._inflight.pop(0)
        t0 = time.perf_counter()
        try:
            host = self._watchdog.await_result(pending, lambda: self._fetch(outs))
        except FetchAbort:
            # the group trained but its outputs are lost: refund its cap
            # slots; the dispatch may still run, so its buffers never return
            if lease is not None:
                lease.discard()
            for _ in group:
                self.refund_dispatch()
            raise
        dt = time.perf_counter() - t0
        self._fetch_count.inc()
        self._fetch_hist.observe(dt)
        self._health.observe(dt)
        _sideband.record_stage("fetch", dt)
        tr = _trace.get()
        if tr.enabled:
            tr.complete("fetch", t0, dt, depth=self.fetch_depth, group=len(group))
        events = gstamp.pop("step_events", None)
        k = len(group)
        share = dict(gstamp, fetch_wait_ms=dt * 1e3 / k, step_ms=(
            events[0].elapsed_time(events[1]) / k if events is not None
            else gstamp["step_host_ms"]))
        last = k - 1
        boundary_ok = not self._inflight
        for i, (batch, bt, stamp) in enumerate(group):
            out = StepOutput(*(None if f is None else f[i] for f in host))
            self.handle(out, batch, bt, at_boundary=(i == last and boundary_ok),
                        stamp=dict(stamp, **share))
        if lease is not None:
            lease.retire()  # after the handlers, which read the host arrays

    def drain(self) -> None:
        """Deliver every in-flight group now, dispatching nothing more (a
        cap, a cadence point, an elastic clean commit); buffered batches not
        yet dispatched are host-side and stay."""
        while self._inflight:
            self._emit_group()

    def drain_discard(self, why: str) -> int:
        """An elastic rescue's drain (``FetchPipeline.drain_discard``): the
        groups in flight are discarded, their cap slots refunded, leases
        discarded, rows counted in ``elastic.rows_discarded_inflight``;
        buffered batches not yet dispatched never touched a collective and
        train against the restored state after the re-formation. Returns
        the rows discarded."""
        if not self._inflight:
            return 0
        groups, rows = len(self._inflight), 0
        for _pending, _outs, group, lease, _stamp in self._inflight:
            for batch, _t, _st in group:
                rows += int(getattr(batch, "num_valid", 0) or 0)
                self.refund_dispatch()
            if lease is not None:
                lease.discard()
        self._inflight.clear()
        self._depth_gauge.set(0)
        self._registry.counter("elastic.rows_discarded_inflight").inc(rows)
        log.warning("elastic rescue: discarded %d in-flight group(s) (~%d row(s)): %s; the "
                    "resync restores the verified checkpoint, so these rolled-back rows are "
                    "counted in elastic.rows_discarded_inflight, never awaited", groups, rows,
                    why)
        return rows

    def refund_dispatch(self) -> None:
        """Give back one ``max_dispatch`` slot (a handler that skips a
        delivered batch)."""
        self._dispatched -= 1
        self._refund_count.inc()

    def note_replay(self, rolled_back: int = 0) -> None:
        """A rollback's journal replay re-ingests the ``rolled_back`` batches
        trained since the rollback point: their cap slots are given back,
        and batches featurized before it but not yet dispatched are dropped
        (their rows come back with the replay)."""
        self._replays += 1
        self._dispatched -= rolled_back

    def _plain_steps(self, group) -> None:
        """A partial group: one synchronous step a batch (the one-buffer
        wire in group mode), after every earlier group was delivered."""
        replays = self._replays
        self.drain()
        for batch, t, stamp in group:
            if self._replays != replays:
                _drop_undispatched(batch, "it re-ingests with the journal's replay")
                continue
            if self.max_dispatch and self._dispatched >= self.max_dispatch:
                _drop_undispatched(batch, "the max-batches cap was reached")
                continue
            stamp["depth"] = 0
            pending, out, lease = _guarded_dispatch(
                self.model, batch, self._coalesce(batch), self._fetch, self.sync_debug, stamp,
                self.wire_codec)
            self._dispatched += 1
            self._cadence += 1
            t0 = time.perf_counter()
            try:
                host = self._watchdog.await_result(pending, lambda: self._fetch(out))
            except FetchAbort:
                if lease is not None:
                    lease.discard()
                self.refund_dispatch()
                raise
            dt = time.perf_counter() - t0
            self._fetch_count.inc()
            self._fetch_hist.observe(dt)
            self._health.observe(dt)
            _finish_stamp(stamp, t0, dt, 1)
            self.handle(host, batch, t, at_boundary=True, stamp=stamp)
            if lease is not None:
                lease.retire()

    def _close_group(self) -> None:
        if not self._buf:
            return
        group, self._buf = self._buf, []
        if len(group) < self.k:
            self._plain_steps(group)
            return
        replays = self._replays
        while len(self._inflight) >= self.fetch_depth or (
            not self.deterministic and self._inflight and self._inflight[0][0].done()
        ):
            self._emit_group()
        if self._replays != replays:
            # a delivery rolled back: these batches' rows re-ingest with
            # the journal's replay
            for batch, _t, _stamp in group:
                _drop_undispatched(batch, "it re-ingests with the journal's replay")
            return
        batches = [b for b, _, _ in group]
        device = getattr(self.model, "device", None)
        events = None
        tr = _trace.get()
        with _sync_debug(self.model, self.sync_debug), annotate("twtml.dispatch"):
            t0 = time.perf_counter()
            wire = self.group_wire(batches)
            t1 = time.perf_counter()
            _faults.perturb("step")  # --chaos: inside the dispatch window
            if device is not None and device.type == "cuda":
                import torch

                events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                events[0].record()
            outs = self.model.step_many(wire)
            if events is not None:
                events[1].record()
            t2 = time.perf_counter()
            pending = self._fetch(outs)
            t3 = time.perf_counter()
        k = len(group)
        _sideband.record_stage("wire_pack", t1 - t0)
        _sideband.record_stage("dispatch", t3 - t1)
        comp = _record_wire_codec(wire, self.wire_codec) if self._coalesce(batches[0]) else None
        _lineage.mark_dispatch(k)
        if tr.enabled:
            tr.complete("dispatch", t1, t3 - t1, group=k, depth=len(self._inflight))
        gstamp = dict(
            pack_ms=(t1 - t0) * 1e3 / k, step_host_ms=(t2 - t1) * 1e3 / k,
            dispatch_ms=(t3 - t1) * 1e3 / k, step_events=events, group=k,
            depth=len(self._inflight), wire_bytes=wire_nbytes(wire) // k,
        )
        if comp is not None:
            coded = comp.get("units_compressed")
            gstamp.update(units_bytes=comp["units"] // k,
                          units_coded_bytes=None if coded is None else coded // k)
        lease = chain_leases(getattr(wire, "lease", None),
                             *(getattr(b, "lease", None) for b in batches))
        self._inflight.append((pending, outs, group, lease, gstamp))
        self._depth_gauge.set(len(self._inflight))
        self._dispatched += k
        self._cadence += k
        if self.boundary_every and (
            self._cadence - self._last_boundary >= self.boundary_every
        ):
            self.drain()  # a cadence point: the weights current for a save
            self._last_boundary = self._cadence

    def flush(self) -> None:
        """Run the pending tail as plain steps and deliver every group in
        flight; after a fetch abort, drop what is left (its leases
        discarded, its cap slots refunded), never raising into shutdown."""
        try:
            self._close_group()
            self.drain()
        except FetchAbort:
            for _pending, _outs, group, lease, _stamp in self._inflight:
                if lease is not None:
                    lease.discard()
                for _ in group:
                    self.refund_dispatch()
            if self._inflight or self._buf:
                log.warning("dropping %d in-flight group(s) and %d buffered batch(es) "
                            "after the fetch abort", len(self._inflight), len(self._buf))
            for batch, _t, _stamp in self._buf:
                _drop_undispatched(batch, "the fetch watchdog aborted the run")
            self._inflight.clear()
            self._buf.clear()


def super_batch_k(conf, stream, num_tenants: int = 0) -> int:
    """``--superBatch`` as the JAX package applies it: ignored (1, with a
    warning) on the tenant plane (``num_tenants`` >= 1), whose one stacked
    fetch a tick already serves its M models, and under a wall clock, where
    it would delay live stats by K intervals; K > 1 needs pinned
    ``--batchBucket`` and ``--tokenBucket`` (every grouped batch one
    shape), else ``ValueError``."""
    k = int(conf.superBatch or 1)
    if k > 1 and num_tenants >= 1:
        log.warning("--superBatch %d ignored with --tenants %d: the tenant stack already "
                    "amortizes the per-tick stats fetch across its %d models (scanning K "
                    "groups of M tenants is future work)", k, num_tenants, num_tenants)
        return 1
    if k > 1 and conf.seconds > 0:
        log.warning("--superBatch %d ignored: wall-clock streaming (--seconds %s) "
                    "would delay live stats by %d intervals", k, conf.seconds, k)
        return 1
    if k > 1 and (stream.row_bucket <= 0 or stream.token_bucket <= 0):
        raise ValueError("--superBatch needs pinned shapes: set --batchBucket and "
                         "--tokenBucket so every grouped batch has one shape")
    return max(1, k)


def attach_super_batcher(conf, stream, model, handle, stop_requested=None,
                         max_dispatch: int = 0, abort=None,
                         fetch_depth: int = FETCH_DEPTH, stamp=None, sentinel=None,
                         modelwatch=None, freshness=None, elastic=None):
    """Wire the app's ``handle(host, batch, t, at_boundary, stamp)`` to the
    stream and return the ``flush`` the app calls after the stream
    terminated; ``flush.group_k`` is the superbatch's K (1 without one) and
    ``flush.group_wire`` its group packer (None), for ``warmup_compile``.

    Each delivery passes the JAX package's wrappers, outermost first: the
    journal's dispatch-token pop (every delivery pops, a skipped one too),
    ``freshness`` (every delivery pops its lineage record), ``modelwatch``
    (on the tenant plane the raw [M, Q] quality: a track a tenant), the
    tenant plane's (a model with ``num_tenants``: ``telemetry/tenants.
    record_tick`` of the [M] counts and mses, then
    ``aggregate_tenant_output`` into one batch-level output in the
    original row order), the ``sentinel``'s gate (a non-finite batch stops
    here), then the RSS watchdog's tick and the journal's commit of the
    popped token (only admitted batches), then ``handle``.

    Back to back (``--seconds 0``): a ``FetchPipeline`` of ``fetch_depth``,
    which drains every ``--checkpointEvery`` dispatches when a checkpoint
    directory is set (a save reads current weights), or every 64 under
    ``--recycleAfterMb`` alone. Under a wall clock: one synchronous fetch a
    batch, so each interval's stats reach the dashboard in that interval.
    Either way the ragged wire is packed at dispatch, and a batch with no
    valid row is skipped before the step (its host mask is read, never a
    device tensor), its lineage record and journal token dropped with it.
    ``--superBatch K > 1`` (``super_batch_k``) groups K batches a dispatch
    through a ``SuperBatcher`` on ``--wirePack``'s wire (group: one buffer,
    ragged wire only), with the same wrappers, drains and cap.

    ``elastic`` (``attach_elastic``'s plane) gets the pipeline or
    superbatch, whose drains a re-formation calls, and the returned
    ``flush``, whose warm-up arguments a re-formation warms with."""
    from ..parallel import distributed as _dist

    bind = {} if elastic is None else elastic._bind_box

    pack = bool(getattr(stream, "ragged", False))
    sync_debug = os.environ.get(SYNC_DEBUG_ENV, "")
    watchdog = RssWatchdog()
    app_handle = handle
    multihost = _dist.is_multihost()
    if multihost and (stream.row_bucket <= 0 or stream.token_bucket <= 0):
        raise SystemExit("multi-host runs need pinned shapes: set --batchBucket and "
                         "--tokenBucket (every rank dispatches the same collectives every "
                         "tick, all-padding batches included)")

    def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
        watchdog.tick()
        j = _journal.get()
        if j is not None:
            # innermost: only admitted batches commit their token, before
            # the app's handler, whose save must stamp a cursor covering
            # this batch
            j.note_delivered()
        app_handle(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    if sentinel is not None and sentinel.enabled:
        sentinel_inner = handle

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            if sentinel.admit(host, batch):
                sentinel_inner(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    # a tenant-plane model (any M, the forced M = 1 included) carries
    # num_tenants; plain learners do not
    num_tenants = int(getattr(model, "num_tenants", 0) or 0)
    if num_tenants >= 1:
        from ..parallel.tenants import aggregate_tenant_output
        from ..telemetry import tenants as _tenants

        tenant_inner = handle

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            _tenants.record_tick(np.asarray(host.count, np.int64),
                                 np.asarray(host.mse, np.float64))
            tenant_inner(aggregate_tenant_output(host, batch, model), batch, t,
                         at_boundary=at_boundary, stamp=stamp)

    if multihost:
        # the local batch cannot gate the step (its collectives), but a batch
        # GLOBALLY empty (every rank's rows filtered) must not reach the app,
        # nor take a max-batches slot
        empty_inner = handle
        pipeline_ref: list = []

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            if int(np.asarray(host.count).sum()) == 0:
                log.debug("batch: 0 (global)")
                if pipeline_ref:
                    pipeline_ref[0].refund_dispatch()
                return
            empty_inner(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    if modelwatch is not None and modelwatch.enabled:
        watch_inner = handle

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            modelwatch.observe(host, at_boundary=at_boundary)
            watch_inner(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    if freshness is not None and freshness.enabled:
        fresh_inner = handle

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            freshness.observe(host, at_boundary=at_boundary)
            fresh_inner(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    if _journal.get() is not None:
        pop_inner = handle

        def handle(host, batch, t, at_boundary=True, stamp=None):  # noqa: F811
            j = _journal.get()
            if j is not None:
                j.pop_dispatch()
            pop_inner(host, batch, t, at_boundary=at_boundary, stamp=stamp)

    def skip_empty(fn):
        if multihost:
            return fn  # an empty rank still dispatches: its peers' collectives wait

        def cb(batch, t):
            if batch.num_valid == 0:
                log.debug("batch: 0")
                _lineage.drop_newest()  # the shed batch never dispatches
                j = _journal.get()
                if j is not None:
                    j.drop_newest()
                return
            fn(batch, t)

        return cb

    # drains exist for checkpoint saves (and the recycler's check) only
    boundary_every = int(conf.checkpointEvery or 0) if conf.checkpointDir else 0
    if int(conf.recycleAfterMb or 0) > 0 and not boundary_every:
        boundary_every = 64

    # --wireCodec dict rides the packed wire forms only, as in the JAX
    # package: resolved (and its ValueError raised) only where the stream
    # packs; a tenant plane's pack carries the model's own codec
    wire_codec = ""
    if pack and conf.effective_wire_codec() == "dict":
        wire_codec = "dict"

    k = super_batch_k(conf, stream, num_tenants)
    if k > 1:
        batcher = SuperBatcher(
            model, k, handle, boundary_every=boundary_every, max_dispatch=max_dispatch,
            abort=abort, stamp=stamp, sync_debug=sync_debug,
            wire_pack="group" if pack and conf.effective_wire_pack() == "group" else "stacked",
            wire_codec=wire_codec, deterministic=multihost,
        )
        if sentinel is not None:
            sentinel.bind(batcher)  # a skipped batch refunds its cap slot
        if multihost:
            pipeline_ref.append(batcher)
        # a multi-host rank agrees each batch's buckets before grouping, so
        # every rank's group signatures match
        prepare = getattr(model, "prepare", None)
        on_batch = (batcher.on_batch if prepare is None
                    else lambda batch, t: batcher.on_batch(prepare(batch), t))
        stream.foreach_batch(skip_empty(on_batch))
        bind["pipeline"] = batcher
        bind["flush"] = _with_group(batcher.flush, k, batcher.group_wire, wire_codec)
        return bind["flush"]

    if conf.seconds <= 0:
        pipe = FetchPipeline(
            model, handle, depth=fetch_depth, stop_requested=stop_requested,
            boundary_every=boundary_every, max_dispatch=max_dispatch, pack=pack,
            abort=abort, stamp=stamp, sync_debug=sync_debug, wire_codec=wire_codec,
            deterministic=multihost,
        )
        if sentinel is not None:
            sentinel.bind(pipe)  # a skipped batch refunds its cap slot
        if multihost:
            pipeline_ref.append(pipe)
        stream.foreach_batch(skip_empty(pipe.on_batch))
        bind["pipeline"] = pipe
        bind["flush"] = _with_group(pipe.flush, wire_codec=wire_codec)
        return bind["flush"]

    fetch = _fetcher(model)
    reg = _metrics.get_registry()

    def per_batch(batch, t):
        # wall clock: ONE synchronous host fetch of the whole StepOutput
        st = dict(stamp()) if stamp is not None else {}
        st["depth"] = 0
        pending, _out, lease = _guarded_dispatch(model, batch, pack, fetch, sync_debug, st,
                                                 wire_codec)
        t0 = time.perf_counter()
        _faults.perturb("fetch")
        pending.wait()
        host = pending.result()
        dt = time.perf_counter() - t0
        reg.counter("fetch.count").inc()
        reg.histogram("fetch.latency_s").observe(dt)
        _metrics.get_health_monitor().observe(dt)
        _finish_stamp(st, t0, dt, 1)
        handle(host, batch, t, at_boundary=True, stamp=st)
        if lease is not None:
            lease.retire()  # after the handler, which reads the host arrays

    stream.foreach_batch(skip_empty(per_batch))
    bind["flush"] = _with_group(lambda: None, wire_codec=wire_codec)
    return bind["flush"]


# ---- elastic membership (--elastic on) --------------------------------------

def _sharded_source(source):
    """The residue-sharded source under ``source``'s wrappers, or None (a
    source kind with no residue surface, such as block byte ranges)."""
    while source is not None and not hasattr(source, "adopt_residues"):
        source = getattr(source, "inner", None)
    return source


def _hot_standby(sharded, how: str) -> None:
    """A rejoiner of a replay-sharded run: index shards are position-bound,
    so its residues stay with their adopters and it feeds all-padding
    batches (re-reading its file shard from the top would train rows
    twice). A live id-sharded stream keeps its residues: the incumbents
    hand them back (``_rebalance_intake``)."""
    from ..streaming.sources import IdShardedSource

    if sharded is not None and not isinstance(sharded, IdShardedSource):
        sharded.residues.clear()
        log.warning("elastic: %s replay-sharded run as a hot standby (residues stay with "
                    "their adopters)", how)


def _rebalance_intake(source, old_members, new_members, my_uid: int, reason: str) -> None:
    """The intake across a membership change: a departed host's residues
    are adopted round-robin by the survivors (exact coverage going forward,
    streaming/sources.py). A REJOINED host: a live id-sharded stream hands
    its residues back (ids are position-free); replay index shards stay
    with the adopters, and the rejoiner is a hot standby (re-reading its
    file shard from the top would train rows twice). A source with no
    residue surface (block byte ranges) loses the departed range, counted
    in ``elastic.shards_lost``."""
    from ..streaming.sources import IdShardedSource

    sharded = _sharded_source(source)
    departed = sorted(u for u in old_members if u not in new_members)
    rejoined = sorted(u for u in new_members if u not in old_members)
    if sharded is None:
        if departed:
            _metrics.get_registry().counter("elastic.shards_lost").inc(len(departed))
            log.warning("elastic: this source kind cannot adopt departed shard(s) %s: their "
                        "remaining rows are lost (counted in elastic.shards_lost)", departed)
        return
    survivors = sorted(u for u in new_members if u in old_members)
    for i, uid in enumerate(departed):
        owner = survivors[i % len(survivors)] if survivors else -1
        if owner == my_uid:
            sharded.adopt_residues([uid])
    if rejoined and isinstance(sharded, IdShardedSource):
        sharded.release_residues(rejoined)
    if my_uid in rejoined:
        _hot_standby(sharded, "rejoined a")


def attach_elastic(conf, ssc, model, stream, ckpt: AppCheckpoint, totals: dict):
    """``--elastic on``: build the membership plane over the runtime
    ``init_distributed`` formed and install it on the streaming context.
    Its two transitions re-provision the app stack:

    detach: drain the fetch pipeline (a RESCUE discards what is in flight:
    a dead peer failed its collectives, ``drain_discard``), on a CLEAN
    commit save at the boundary (loss-free), then abandon the epoch's
    groups;

    attach: form the new epoch, promote the checkpoint if this host won an
    election, rebuild the model for the epoch's mesh, re-synchronize state
    and counters from the lead (``resync_from_verified``), replay this
    host's journaled rows past the agreed rollback point (a rejoiner resets
    its journal instead), rebalance the intake shards, and warm the step
    for the new group.

    Returns the plane (None when the run is not elastic); pass it to
    ``attach_super_batcher`` so the drains bind."""
    from ..parallel import distributed as _dist
    from ..parallel import elastic as _elastic
    from ..streaming.membership import MembershipPlane

    runtime = _elastic.get_runtime()
    if runtime is None or not _dist.is_multihost():
        return None
    source = ssc._source
    if runtime.joined_late:
        # a restarted host admitted into a LIVE run: its replay residues
        # were adopted when it departed
        _hot_standby(_sharded_source(source), "joined a live")
    st: dict = {"pipeline": None, "flush": None, "old_members": list(runtime.members)}

    def detach(clean: bool) -> None:
        st["old_members"] = list(runtime.members)
        pipe = st["pipeline"]
        if pipe is not None:
            if clean:
                pipe.drain()
            else:
                pipe.drain_discard("a peer died mid-step")
        if clean:
            # every member is alive and in step at a clean commit: the lead
            # saves here, so the resync restores exactly this state
            ckpt.save_now(totals)
        runtime.abandon()

    def attach(plan: dict, reason: str) -> None:
        runtime.form(plan["epoch"], plan["members"])
        if runtime.is_lead:
            # a won election: authority moves to this host's archives
            # before the resync broadcasts from them
            ckpt.promote()
        model.rebuild(_dist.mesh())
        if reason == "rejoin":
            # a rejoiner's queued rows predate its absence; the adopters
            # own them now
            dropped = sum(getattr(s, "rows", 1) for s in ssc._drain(0))
            if dropped:
                _metrics.get_registry().counter("elastic.rows_dropped_rejoin").inc(dropped)
                log.warning("elastic: dropped %d stale queued row(s) on rejoin (counted in "
                            "elastic.rows_dropped_rejoin)", dropped)
        pre_resync = (int(totals["count"]), int(totals["batches"]))
        ckpt.resync_from_verified(totals)
        j = _journal.get()
        if j is not None:
            # the discarded deliveries' tokens would strand every later
            # pairing; the replay below re-covers their rows
            j.clear_inflight()
            if runtime.uid in set(plan["members"]) - set(st["old_members"]):
                j.reset()
                log.warning("journal: reset on rejoin: this host's pre-departure rows "
                            "belong to their adopters now")
            else:
                stub = {"count": totals["count"], "batches": totals["batches"]}
                if (totals["count"], totals["batches"]) == pre_resync:
                    # nothing rolled back: the adopted state covers exactly
                    # the delivered batches, whose committed cursor this is
                    stub["journal"] = j.snapshot_for_checkpoint()
                else:
                    stub["broadcast"] = True
                journal_replay_rollback(ssc, ckpt, totals, stub, where=f"elastic {reason}")
        _rebalance_intake(source, st["old_members"], plan["members"], runtime.uid, reason)
        flush = st["flush"]
        warmup_compile(stream, model, super_batch=flush.group_k, group_wire=flush.group_wire,
                       wire_codec=flush.wire_codec)

    plane = MembershipPlane(
        runtime, detach, attach,
        evict_ticks=int(conf.elasticEvictTicks or 0),
        evict_skew_ms=float(conf.elasticEvictSkewMs),
        rejoin=conf.elasticRejoin == "on",
    )
    plane._bind_box = st  # attach_super_batcher fills the pipeline and flush
    ssc.membership = plane
    log.info("elastic membership plane ACTIVE: epoch %d, members %s, evict after %s gating "
             "tick(s), rejoin %s", runtime.epoch, runtime.members, plane.evict_ticks or "∞",
             "on" if plane.rejoin else "off")
    return plane


def elastic_exit(failed: bool = False) -> None:
    """An elastic run leaves through a hard exit (parallel/elastic.py
    ``finalize_exit``: an abandoned epoch may hold a thread blocked in a
    collective); a no-op without an elastic runtime. The LAST call of an
    app's run, after its checkpoint and telemetry flushed."""
    from ..parallel import elastic as _elastic

    runtime = _elastic.get_runtime()
    if runtime is None:
        return
    log.info("elastic run complete (epoch %d, %d re-formation(s)); hard exit %d",
             runtime.epoch, len(runtime._graveyard), 1 if failed else 0)
    runtime.finalize_exit(1 if failed else 0)


def _with_group(flush, k: int = 1, group_wire=None, wire_codec: str = ""):
    """``flush`` as a function carrying ``group_k``, ``group_wire`` and
    ``wire_codec`` (the stream's packed-wire codec, "" or "dict")."""
    def call() -> None:
        flush()

    call.group_k, call.group_wire, call.wire_codec = k, group_wire, wire_codec
    return call


def warmup_compile(stream, model, super_batch: int = 1, group_wire=None,
                   wire_codec: str = "") -> None:
    """Build and warm the step BEFORE the stream starts, so the first
    wall-clock interval does not swallow the first-use builds (nvcc of the
    fused kernel, g++ of the native host library: seconds each) while a
    live source keeps producing. The warm batch is the stream's own
    all-padding batch (``featurize_empty``), packed as the stream's batches
    are, stepped and fetched: zero valid rows, so the weights stay as they
    are (a zero-count iteration is a no-op).

    The JAX package's warm-up returns early on the ragged wire, whose XLA
    program depends on the data-dependent units bucket. The port compiles
    no program per shape (the kernel builds once; its launch plan is
    computed each call), so it warms on every wire and every bucket. The
    tenant plane's warm batch is its own wire (``pack_for_wire``): M
    all-padding parts, M steps, one fetch.

    With ``super_batch`` K > 1 it also steps K all-padding batches through
    ``step_many``, on the superbatch's ``group_wire``: on the card that
    captures the group's CUDA graph for the all-padding batch's signature
    (a ragged stream's real batches may have other units buckets, each of
    which captures at its first group)."""
    t0 = time.perf_counter()
    empty = stream.featurize_empty()
    wire = _packer(model, wire_codec)(empty) if getattr(stream, "ragged", False) else empty
    pending = _fetcher(model)(model.step(wire))
    pending.wait()
    counts = np.atleast_1d(pending.result().count).tolist()
    leases = [getattr(wire, "lease", None)]
    if super_batch > 1:
        group = (group_wire or stack_batches)([empty] * super_batch)
        pending = _fetcher(model)(model.step_many(group))
        pending.wait()
        counts.extend(pending.result().count.tolist())
        leases.append(getattr(group, "lease", None))
    lease = chain_leases(*leases, getattr(empty, "lease", None))
    if lease is not None:
        lease.retire()
    if any(counts):
        raise RuntimeError(f"warm-up batches trained {sum(counts)} rows; they must train none")
    log.info("warmed the train step (builds and one all-padding step) in %.1fs",
             time.perf_counter() - t0)
