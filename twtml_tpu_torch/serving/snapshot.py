"""Serving snapshots: verified checkpoints and the one promotion predicate
(counterpart of ``twtml_tpu/serving/snapshot.py``).

A snapshot is the weight state of a VERIFIED checkpoint (CRC'd and finite:
``checkpoint/checkpointer.py`` refuses corrupt and non-finite archives at
restore), gated on the quality stamp a trainer writes into each checkpoint's
meta (``meta["quality"]``): ``ok`` and ``warn`` serve, ``alert`` refuses.
``is_promotable`` is that predicate; the promoter and any ops script that
asks "is this checkpoint servable?" share it, so they cannot disagree.

The archives are the JAX package's format byte for byte, so this package
serves a JAX-written checkpoint directory and the JAX serve app serves one
this package's trainer wrote.

The promoter polls the checkpoint directory (the trainer writes, the server
reads: the handoff is the filesystem, so serving adds no fetch to a
co-located trainer's device path) and hands a new promotable step to
``ServingPlane.hot_swap``, which installs it between dispatches.

No torch here: answering "is this servable?" starts no device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..utils import get_logger

log = get_logger("serving.snapshot")

# quality levels that may serve; anything else (today "alert") refuses.
# An unstamped checkpoint (saved with --modelWatch off) carries no evidence
# of trouble and serves: the stamp gates on KNOWN bad health
SERVABLE_LEVELS = ("ok", "warn")


def is_promotable(meta: "dict | None") -> "tuple[bool, str]":
    """The promotion predicate over a verified checkpoint's meta:
    (servable?, reason). The ``finite`` flag is checked again here, so a
    caller holding only the meta reaches the restore's verdict."""
    if not isinstance(meta, dict):
        return False, "no checkpoint meta"
    if not meta.get("finite", True):
        return False, "non-finite weights (quarantined save)"
    quality = meta.get("quality")
    if quality is None:
        return True, "servable (unstamped — no quality evidence against it)"
    level = str(quality.get("level", "ok"))
    if level not in SERVABLE_LEVELS:
        return False, (
            f"quality level {level!r} (drift z "
            f"{float(quality.get('drift_score', 0.0)):.2f}, loss trend "
            f"{float(quality.get('loss_trend', 0.0)) * 100:+.1f}%)"
        )
    return True, f"servable (quality level {level!r})"


@dataclass
class ServingSnapshot:
    """One promotable weight state: ``weights`` is the checkpoint's host
    array, ``[F+4]`` for one model or ``[M, F+4]`` for a tenant stack
    (``num_tenants`` reads the stack's height)."""

    step: int
    weights: np.ndarray
    meta: dict = field(default_factory=dict)

    @property
    def num_tenants(self) -> int:
        return int(self.weights.shape[0]) if self.weights.ndim == 2 else 1

    @property
    def quality_level(self) -> str:
        quality = self.meta.get("quality") or {}
        return str(quality.get("level", ""))


def load_servable(directory: str) -> "tuple[ServingSnapshot | None, str]":
    """(the newest VERIFIED checkpoint as a snapshot, reason), or (None,
    why). ``Checkpointer.restore`` verifies (CRC, finiteness, falling back
    past bad archives); ``is_promotable`` judges the newest verified one's
    meta. A newest verified checkpoint that fails the quality gate gives
    (None, reason): the server holds its current snapshot rather than go
    back to an older healthy one."""
    from ..checkpoint import Checkpointer

    restored = Checkpointer(directory).restore()
    if restored is None:
        return None, f"no verified checkpoint in {directory!r}"
    state, meta = restored
    if isinstance(state, dict):
        # a dict state (k-means centers and weights) has no predict program
        return None, (
            "checkpoint state is a pytree, not an SGD weight vector — "
            "not servable by the SGD predict program"
        )
    ok, reason = is_promotable(meta)
    if not ok:
        return None, f"step {meta.get('step', '?')} refused: {reason}"
    return (
        ServingSnapshot(step=int(meta.get("step", 0)), weights=np.asarray(state),
                        meta=dict(meta)),
        reason,
    )


class SnapshotPromoter:
    """Polls the checkpoint directory every ``poll_s`` and hands a NEW
    promotable step to ``plane.hot_swap``. A refused newest step (alert or
    non-finite) is counted and logged once; the plane keeps serving.
    ``poll_once`` is one check, callable on its own (tests drive it without
    the thread)."""

    def __init__(self, directory: str, plane, poll_s: float = 5.0):
        from ..telemetry import metrics as _metrics

        self.directory = directory
        self.plane = plane
        self.poll_s = max(0.05, float(poll_s))
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._refused_step: "int | None" = None
        reg = _metrics.get_registry()
        self._promotions = reg.counter("serve.promotions")
        self._refused = reg.counter("serve.promotions_refused")

    def poll_once(self) -> bool:
        """One promotion check; True when a swap was staged."""
        from ..checkpoint import Checkpointer

        latest = Checkpointer(self.directory).latest_step()
        current = self.plane.snapshot_step
        if latest is None or latest <= current:
            return False
        snap, reason = load_servable(self.directory)
        if snap is None:
            if self._refused_step != latest:
                self._refused_step = latest
                self._refused.inc()
                log.warning("snapshot promotion REFUSED (serving stays on step %d): %s",
                            current, reason)
            return False
        if snap.step <= current:
            return False
        self.plane.hot_swap(snap)
        self._promotions.inc()
        self._refused_step = None
        log.info("promoted snapshot step %d -> %d (%s)", current, snap.step, reason)
        return True

    def start(self) -> "SnapshotPromoter":
        self._thread = threading.Thread(target=self._loop, name="twtml-serve-promoter",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                log.exception("snapshot promotion poll failed; retrying")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
