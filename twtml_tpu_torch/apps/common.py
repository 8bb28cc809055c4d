"""Shared app runtime, single host (counterpart of the single-host parts of
``twtml_tpu/apps/common.py``): source and model construction, the
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
pop, freshness, model watch, the sentinel, then the journal commit and the
app's handler. A checkpoint reads the weights (a blocking copy) only at a
drained boundary, outside the sync-debug window of a dispatch. The
multi-host parts of the JAX package's runtime are not ported (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
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
    pack_batch, pack_ragged_group, stack_batches, wire_nbytes,
)
from ..models.base import StepOutput
from ..models.linear import StreamingLinearRegressionWithSGD
from ..models.sgd import DTYPES, wire_signature
from ..streaming import faults as _faults
from ..streaming import journal as _journal
from ..streaming.sources import ReplayFileSource, SkipRowsSource, Source, SyntheticSource
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


def build_source(conf) -> Source:
    """The configured source. ``--replaySpeed`` paces a replay (x realtime)
    or a synthetic stream (tweets/s). ``TWTML_NOW_MS`` (env), which pins the
    featurizer's clock, also pins the synthetic tweets' creation times, so
    a pinned synthetic run gives the same batches every time. ``--source
    twitter`` opens the live stream with the ``twitter4j.oauth.*``
    credentials (flags or ``application.conf``). ``--wire ragged`` with
    ``--hashOn host`` exits, as in the JAX package: the ragged wire ships
    code units for the device to hash."""
    if conf.effective_wire() == "ragged" and conf.hashOn != "device":
        raise SystemExit("--wire ragged is a device-hash wire format; "
                         "it requires --hashOn device")
    if conf.source == "twitter":
        from ..streaming.twitter import TwitterSource

        source: Source = TwitterSource.from_properties()
    elif conf.source == "replay":
        if not conf.replayFile:
            raise SystemExit("--source replay requires --replayFile <path.jsonl>")
        source = ReplayFileSource(conf.replayFile, speed=conf.replaySpeed)
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
    return source


def build_model(conf, model_cls=StreamingLinearRegressionWithSGD):
    """The single-device learner on ``--backend``, with the process-wide
    native seams (``--featurizeNative``, ``--wireAssemble``) set and the
    wire arena serving page-locked buffers to a ``cuda`` model."""
    featurize_native.configure(conf.featurizeNative)
    assemble.configure(conf.wireAssemble)
    model = model_cls.from_conf(conf)
    get_arena().use_device(model.device)
    return model


# ---- installers of the process-wide planes ---------------------------------

def install_trace(conf) -> None:
    """``--trace PATH`` (rotated at ``--traceMaxMb``): the pipeline tracer
    (telemetry/trace.py)."""
    if conf.trace:
        _trace.install(conf.trace, max_bytes=int(conf.traceMaxMb or 0) * 1024 * 1024)


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
    _blackbox.install(config=cfg, out_dir=out_dir, process_index=0)
    _blackbox.install_signal_handler()


def install_journal(conf) -> None:
    """``--journal`` (auto: on with ``--checkpointDir``): open the intake
    journal under ``<checkpointDir>/journal``, so the seam in
    streaming/context.py appends. Off uninstalls a journal an earlier run
    in the same process left."""
    if not conf.effective_journal():
        _journal.uninstall()
        return
    if not conf.checkpointDir:
        raise SystemExit("--journal on requires --checkpointDir: the replay cursor "
                         "lives in verified checkpoint meta (use --journal auto to "
                         "follow the checkpoint flag)")
    _journal.install(os.path.join(conf.checkpointDir, "journal"),
                     max_mb=int(conf.journalMaxMb or 512))


def install_historian(conf) -> None:
    """``--history`` (auto: on with ``--checkpointDir``): open the telemetry
    historian under ``<checkpointDir>/history``, so SessionStats' publish
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
        os.path.join(conf.checkpointDir, "history"),
        max_mb=int(conf.historyMaxMb or 256),
        perf_guard=conf.perfGuard == "warn",
        guard_ratio=float(conf.perfGuardRatio or 1.5),
        run_id=next_run_id(),
        fingerprint=config_fingerprint(conf),
    )


def select_backend(conf) -> None:
    """The JAX package's ``select_backend`` checks for the port, before
    anything is built: ``--master`` (``validate_master``), the values that
    need an unported feature (``check_ported``), ``--dtype`` (float64 on
    ``--backend cpu`` only: the JAX package runs it on its CPU backend
    alone) and ``local[N]``, which sets the CPU's data-parallel shards in
    the JAX package: a no-op on the card, and N > 1 on the CPU needs the
    data-parallel runtime (ROADMAP A10)."""
    conf.validate_master()
    conf.check_ported()
    if conf.dtype not in DTYPES:
        raise SystemExit(f"--dtype {conf.dtype!r}: the port trains {'|'.join(DTYPES)}")
    if conf.dtype == "float64" and conf.backend != "cpu":
        raise SystemExit("--dtype float64 runs on the CPU backend only (as in the "
                         "JAX package); add --backend cpu")
    shards = conf.local_shards()
    if conf.backend == "cpu" and shards and shards > 1:
        raise NotImplementedError(
            f"--master {conf.master} shards the batch over {shards} CPU devices, "
            "which needs the data-parallel runtime the port has not ported "
            "(ROADMAP A10); use local[1] or local[*]")


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


def _multi_host(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} belongs to the multi-host and elastic runtime, which is not "
        "ported (ROADMAP A10)"
    )


class AppCheckpoint:
    """``--checkpointDir``/``--checkpointEvery``, single host: restores the
    state and the counters at start, saves on a cadence at drained
    boundaries (``at_boundary``: the weights are current and nothing is in
    flight, so reading them costs no hidden sync), and saves the final
    state at shutdown. ``get_state()`` returns the checkpointable arrays,
    ``set_state(state)`` restores them into the model.

    Each save stamps into the verified archive's meta the model-watch and
    freshness pictures and the journal's committed cursor, then retires the
    journal segments every retained archive covers. The lead-authoritative
    broadcast, the elastic standby archives and ``promote``/
    ``resync_from_verified`` are multi-host (ROADMAP A10): a follower
    (``lead=False``) and those two calls raise."""

    def __init__(self, conf, get_state, set_state, totals: dict, lead: bool = True):
        if not lead:
            raise _multi_host("a follower host's checkpoint (lead=False)")
        self._ckpt: "Checkpointer | None" = None
        self._get_state = get_state
        self._set_state = set_state
        self.every = int(conf.checkpointEvery or 0)
        self.restored_meta = None
        self._last = 0
        if not conf.checkpointDir:
            return
        self._ckpt = Checkpointer(conf.checkpointDir)
        restored = self._ckpt.restore()
        self.restored_meta = restored[1] if restored is not None else None
        if restored is not None:
            state, meta = restored
            set_state(state)
            totals["count"] = int(meta.get("count", 0))
            totals["batches"] = int(meta.get("batches", 0))
            log.info("resumed from checkpoint step %s (count=%s, state crc %s)",
                     meta.get("step"), totals["count"], state_checksum(state))
        self._last = totals["batches"]

    @property
    def directory(self) -> str:
        return self._ckpt.directory if self._ckpt is not None else ""

    def _save(self, totals: dict) -> None:
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
        if restored is None:
            return None
        state, meta = restored
        _blackbox.note("last_verified_rollback", {"step": meta.get("step")})
        self._set_state(state)
        return meta

    def promote(self) -> None:
        raise _multi_host("AppCheckpoint.promote (elastic lead election)")

    def resync_from_verified(self, totals: dict) -> bool:
        raise _multi_host("AppCheckpoint.resync_from_verified (elastic epochs)")


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
        ssc._putback(queued[stale:])
        log.warning("journal: superseded an in-progress replay: dropped %d stale "
                    "queued row(s) the new replay from cursor %d re-covers",
                    min(stale, len(queued)), cursor)
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
    meta = ckpt.restored_meta
    stamp = (meta or {}).get("journal")
    if meta is not None and stamp is None:
        log.warning("journal: the restored checkpoint carries no journal cursor; "
                    "boot replay skipped, the source re-produces from its top")
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
    back to the last verified checkpoint (zeros without one), and the
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


def _dispatch(model, batch, pack: bool, fetch, sync_debug: str, stamp: dict):
    """Pack (the ragged wire), step and start the fetch of one host batch,
    timing each part into ``stamp``, the stage clock (``wire_pack``,
    ``dispatch``) and the trace; the batch's lineage record goes in flight.
    Returns (pending fetch, device output, the batch's leases). On cuda the
    step's device time is bracketed by two events, read at delivery
    (``_finish_stamp``)."""
    device = getattr(model, "device", None)
    events = None
    tr = _trace.get()
    with _sync_debug(model, sync_debug), annotate("twtml.dispatch"):
        packs = native.COUNTERS["packs_native"]
        t0 = time.perf_counter()
        if pack:
            with tr.span("wire_pack", mode="single") as sp:
                wire = pack_batch(batch)
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


def _guarded_dispatch(model, batch, pack, fetch, sync_debug, stamp):
    """``_dispatch``; a dispatch that raises (the context logs and skips
    the batch) first drops the batch's lineage record and journal token."""
    try:
        return _dispatch(model, batch, pack, fetch, sync_debug, stamp)
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
    arrays), and are discarded on a fetch abort, never recycled."""

    def __init__(self, model, handle, depth: int = FETCH_DEPTH, stop_requested=None,
                 boundary_every: int = 0, max_dispatch: int = 0, pack: bool = False,
                 abort=None, fetch_deadline_s: float = 0.0,
                 fetch_retries: "int | None" = None, stamp=None,
                 sync_debug: str = ""):
        self.model = model
        self.handle = handle
        self.depth = max(1, depth)
        self.pack = pack
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

    def _drain(self) -> None:
        while self._pending:
            self._emit_one()

    def on_batch(self, batch, t) -> None:
        if self._watchdog.aborted:
            return  # a fetch abort is in flight: nothing more may train
        stop = self._stop_requested
        if stop is not None and stop():
            return
        if self.max_dispatch and self._dispatched >= self.max_dispatch:
            # cap reached: this batch must not train, but what did train is
            # delivered now, or the handler-side stop never fires
            self._drain()
            return
        replays = self._replays
        while len(self._pending) >= self.depth or (
            self._pending and self._pending[0][0].done()
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
            self.model, batch, self.pack, self._fetch, self.sync_debug, stamp
        )
        self._pending.append((pending, out, batch, t, lease, stamp))
        self._depth_gauge.set(len(self._pending))
        self._dispatched += 1
        self._cadence += 1
        if self.boundary_every and (
            self._cadence - self._last_boundary >= self.boundary_every
        ):
            self._drain()
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
            self._drain()
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
                 wire_pack: str = "stacked", stamp=None, sync_debug: str = ""):
        if wire_pack not in ("stacked", "group"):
            raise ValueError(f"wire_pack must be 'stacked' or 'group', got {wire_pack!r}")
        self.model = model
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
            self._drain()
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
            with _trace.get().span("wire_pack", mode="group", batches=len(batches)):
                return pack_ragged_group(batches)
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

    def _drain(self) -> None:
        while self._inflight:
            self._emit_group()

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
        self._drain()
        for batch, t, stamp in group:
            if self._replays != replays:
                _drop_undispatched(batch, "it re-ingests with the journal's replay")
                continue
            if self.max_dispatch and self._dispatched >= self.max_dispatch:
                _drop_undispatched(batch, "the max-batches cap was reached")
                continue
            stamp["depth"] = 0
            pending, out, lease = _guarded_dispatch(
                self.model, batch, self._coalesce(batch), self._fetch, self.sync_debug, stamp)
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
            self._inflight and self._inflight[0][0].done()
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
        _lineage.mark_dispatch(k)
        if tr.enabled:
            tr.complete("dispatch", t1, t3 - t1, group=k, depth=len(self._inflight))
        gstamp = dict(
            pack_ms=(t1 - t0) * 1e3 / k, step_host_ms=(t2 - t1) * 1e3 / k,
            dispatch_ms=(t3 - t1) * 1e3 / k, step_events=events, group=k,
            depth=len(self._inflight), wire_bytes=wire_nbytes(wire) // k,
        )
        lease = chain_leases(getattr(wire, "lease", None),
                             *(getattr(b, "lease", None) for b in batches))
        self._inflight.append((pending, outs, group, lease, gstamp))
        self._depth_gauge.set(len(self._inflight))
        self._dispatched += k
        self._cadence += k
        if self.boundary_every and (
            self._cadence - self._last_boundary >= self.boundary_every
        ):
            self._drain()  # a cadence point: the weights current for a save
            self._last_boundary = self._cadence

    def flush(self) -> None:
        """Run the pending tail as plain steps and deliver every group in
        flight; after a fetch abort, drop what is left (its leases
        discarded, its cap slots refunded), never raising into shutdown."""
        try:
            self._close_group()
            self._drain()
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


def super_batch_k(conf, stream) -> int:
    """``--superBatch`` as the JAX package applies it: ignored (1, with a
    warning) under a wall clock, where it would delay live stats by K
    intervals; K > 1 needs pinned ``--batchBucket`` and ``--tokenBucket``
    (every grouped batch one shape), else ``ValueError``."""
    k = int(conf.superBatch or 1)
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
                         modelwatch=None, freshness=None):
    """Wire the app's ``handle(host, batch, t, at_boundary, stamp)`` to the
    stream and return the ``flush`` the app calls after the stream
    terminated; ``flush.group_k`` is the superbatch's K (1 without one) and
    ``flush.group_wire`` its group packer (None), for ``warmup_compile``.

    Each delivery passes the JAX package's wrappers, outermost first: the
    journal's dispatch-token pop (every delivery pops, a skipped one too),
    ``freshness`` (every delivery pops its lineage record), ``modelwatch``,
    the ``sentinel``'s gate (a non-finite batch stops here), then the RSS
    watchdog's tick and the journal's commit of the popped token (only
    admitted batches), then ``handle``.

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
    ragged wire only), with the same wrappers, drains and cap."""
    pack = bool(getattr(stream, "ragged", False))
    sync_debug = os.environ.get(SYNC_DEBUG_ENV, "")
    watchdog = RssWatchdog()
    app_handle = handle

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

    k = super_batch_k(conf, stream)
    if k > 1:
        batcher = SuperBatcher(
            model, k, handle, boundary_every=boundary_every, max_dispatch=max_dispatch,
            abort=abort, stamp=stamp, sync_debug=sync_debug,
            wire_pack="group" if pack and conf.effective_wire_pack() == "group" else "stacked",
        )
        if sentinel is not None:
            sentinel.bind(batcher)  # a skipped batch refunds its cap slot
        stream.foreach_batch(skip_empty(batcher.on_batch))
        return _with_group(batcher.flush, k, batcher.group_wire)

    if conf.seconds <= 0:
        pipe = FetchPipeline(
            model, handle, depth=fetch_depth, stop_requested=stop_requested,
            boundary_every=boundary_every, max_dispatch=max_dispatch, pack=pack,
            abort=abort, stamp=stamp, sync_debug=sync_debug,
        )
        if sentinel is not None:
            sentinel.bind(pipe)  # a skipped batch refunds its cap slot
        stream.foreach_batch(skip_empty(pipe.on_batch))
        return _with_group(pipe.flush)

    fetch = _fetcher(model)
    reg = _metrics.get_registry()

    def per_batch(batch, t):
        # wall clock: ONE synchronous host fetch of the whole StepOutput
        st = dict(stamp()) if stamp is not None else {}
        st["depth"] = 0
        pending, _out, lease = _guarded_dispatch(model, batch, pack, fetch, sync_debug, st)
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
    return _with_group(lambda: None)


def _with_group(flush, k: int = 1, group_wire=None):
    """``flush`` as a function carrying ``group_k`` and ``group_wire``."""
    def call() -> None:
        flush()

    call.group_k, call.group_wire = k, group_wire
    return call


def warmup_compile(stream, model, super_batch: int = 1, group_wire=None) -> None:
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
    computed each call), so it warms on every wire and every bucket.

    With ``super_batch`` K > 1 it also steps K all-padding batches through
    ``step_many``, on the superbatch's ``group_wire``: on the card that
    captures the group's CUDA graph for the all-padding batch's signature
    (a ragged stream's real batches may have other units buckets, each of
    which captures at its first group)."""
    t0 = time.perf_counter()
    empty = stream.featurize_empty()
    wire = pack_batch(empty) if getattr(stream, "ragged", False) else empty
    pending = _fetcher(model)(model.step(wire))
    pending.wait()
    counts = [float(pending.result().count)]
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
