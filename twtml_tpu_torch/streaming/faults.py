"""Fault injection, single host (counterpart of the single-host part of
``twtml_tpu/streaming/faults.py``).

``FaultInjectingSource`` (``--faultEvery``) wraps a Source and raises a
simulated receiver crash every ``crash_every`` tweets (a block source's
``ParsedBlock`` counts its rows), exercising the source supervision.

``ChaosInjector`` (``--chaos SPEC``) injects seeded faults at the runtime's
injection points:

- ``fetch``: each attempt of a batch's host fetch (apps/common.py),
- ``step``:  each dispatch (``model.step``),
- ``web``:   each dashboard request (telemetry/web_client.py),
- ``source.burst``: re-emit the current tweet N more times (a rate spike
  the bounded intake queue must absorb or shed),
- ``source.nan``: poison every valid label of the current featurized batch
  with NaN, which drives the weights non-finite in one step (the divergence
  sentinel's case),
- ``source.garbage``: truncate and garble a block source's raw bytes before
  the block parser (``--ingest block``; streaming/sources.py), whose
  skip-and-count contract absorbs them.

Grammar, comma-separated clauses, the JAX package's:

    TARGET[:ACTION][@TRIGGER]   or   seed=N

    ACTION   delay=SECONDS (``stall=`` is an alias) | error, for fetch/step/
             web; source targets take none, except source.burst:rows=N
             (extra re-emits a firing; default 4).
    TRIGGER  N       every Nth call of that target
             pP      probability P a call (seeded)
             fromN   every call from the Nth on
             default: every call

The ``peer.*`` targets drive the multi-host lockstep scheduler, once a tick:
``peer.kill[:uid=U][:tick=N]`` hard-exits process U (every process without
a uid) at lockstep tick N (default 1) with ``PEER_KILL_EXIT_CODE`` and no
goodbye; ``peer.pause[:uid=U][:ticks=K][@TRIGGER]`` stalls it for K ticks'
wall time (K x max(interval, 0.5 s)). The uid is the process id
(``--processId``); under ``--elastic on`` it is the elastic uid, the launch
process id, which stays a host's across epochs (streaming/context.py passes
the membership plane's), so one fleet-wide spec aims at one host, the lead
included.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Iterator

from ..utils import get_logger
from .sources import Source

log = get_logger("streaming.faults")

TRANSPORT_TARGETS = ("fetch", "step", "web")
SOURCE_TARGETS = ("source.garbage", "source.burst", "source.nan")
PEER_TARGETS = ("peer.kill", "peer.pause")
CHAOS_TARGETS = TRANSPORT_TARGETS + SOURCE_TARGETS + PEER_TARGETS

# extra re-emits a source.burst firing makes when the rule gives no rows=N
BURST_DEFAULT_EXTRA = 4
# a peer.pause stall's length when the rule gives no ticks=K
PAUSE_DEFAULT_TICKS = 4
# the exit code of a peer.kill hard death (the JAX package's)
PEER_KILL_EXIT_CODE = 77


class InjectedFault(ConnectionError):
    pass


class _ChaosRule:
    """One parsed ``TARGET[:ACTION][@TRIGGER]`` clause."""

    __slots__ = ("target", "kind", "value", "mode", "param", "uid")

    def __init__(self, target: str, kind: str, value: float, mode: str, param: float,
                 uid: int = -1):
        self.target = target
        self.kind = kind  # "delay" | "error" | "inject" | "kill" | "pause"
        # seconds (delay), extra rows (source.burst), the tick (kill) or the
        # ticks stalled (pause)
        self.value = value
        self.mode = mode  # "every" | "prob" | "from"
        self.param = param
        self.uid = int(uid)  # peer.*: the one process it fires on (-1: every one)

    def fires(self, call_index: int, rng: random.Random) -> bool:
        if self.mode == "every":
            return call_index % int(self.param) == 0
        if self.mode == "from":
            return call_index >= int(self.param)
        return rng.random() < self.param

    def on_host(self, uid: int) -> bool:
        return self.uid < 0 or self.uid == int(uid)

    def __repr__(self) -> str:
        sel = f" uid={self.uid}" if self.uid >= 0 else ""
        if self.kind == "kill":
            return f"{self.target}{sel} (at lockstep tick {int(self.value)})"
        act = ("error" if self.kind == "error" else "inject" if self.kind == "inject"
               else f"pause={int(self.value)} ticks" if self.kind == "pause"
               else f"delay={self.value:g}s")
        trig = {"every": "every %d", "from": "from call %d on",
                "prob": "p=%g"}[self.mode] % self.param
        return f"{self.target}{sel}:{act} ({trig})"


def _parse_trigger(text: str) -> "tuple[str, float]":
    if text.startswith("p"):
        p = float(text[1:])
        if not 0.0 < p <= 1.0:
            raise ValueError(f"probability trigger out of (0, 1]: {text!r}")
        return "prob", p
    if text.startswith("from"):
        n = int(text[len("from"):])
        if n < 1:
            raise ValueError(f"'from' trigger must be >= 1: {text!r}")
        return "from", n
    n = int(text)
    if n < 1:
        raise ValueError(f"every-Nth trigger must be >= 1: {text!r}")
    return "every", n


def _parse_clause(clause: str) -> _ChaosRule:
    body, _, trigger = clause.partition("@")
    target, _, action = body.partition(":")
    if target not in CHAOS_TARGETS:
        raise ValueError(f"bad chaos clause {clause!r}: want TARGET[:ACTION] with "
                         f"TARGET in {CHAOS_TARGETS}")
    mode, param = _parse_trigger(trigger) if trigger else ("every", 1)
    if target in PEER_TARGETS:
        # parts are colon-separated and order-free: uid=U and tick=N (kill)
        # or ticks=K (pause)
        count_key = "tick" if target == "peer.kill" else "ticks"
        uid, value = -1, None
        for part in filter(None, action.split(":")):
            key, eq, num = part.partition("=")
            if not eq or key not in ("uid", count_key):
                raise ValueError(f"bad chaos action {part!r} in {clause!r}: "
                                 f"{target} takes {count_key}=N and uid=U")
            if key == "uid":
                uid = int(num)
                if uid < 0:
                    raise ValueError(f"negative uid in {clause!r}")
            else:
                value = int(num)
                if value < 1:
                    raise ValueError(f"non-positive {count_key} in {clause!r}")
        if target == "peer.kill":
            value = 1 if value is None else value
            return _ChaosRule(target, "kill", value, "every", value, uid=uid)
        return _ChaosRule(target, "pause", PAUSE_DEFAULT_TICKS if value is None else value,
                          mode, param, uid=uid)
    if target in SOURCE_TARGETS:
        value = BURST_DEFAULT_EXTRA
        if action.startswith("rows="):
            if target != "source.burst":
                raise ValueError(f"rows= only applies to source.burst, not {clause!r}")
            value = int(action.partition("=")[2])
            if value < 1:
                raise ValueError(f"non-positive rows in {clause!r}")
        elif action:
            raise ValueError(f"bad chaos action {action!r} in {clause!r}: source "
                             "targets take no action (source.burst accepts rows=N)")
        return _ChaosRule(target, "inject", value, mode, param)
    if action == "error":
        return _ChaosRule(target, "error", 0.0, mode, param)
    if action.startswith(("delay=", "stall=")):
        value = float(action.partition("=")[2])
        if value <= 0:
            raise ValueError(f"non-positive delay in {clause!r}")
        return _ChaosRule(target, "delay", value, mode, param)
    raise ValueError(f"bad chaos action {action!r} in {clause!r}: want "
                     "delay=SECONDS, stall=SECONDS, or error")


class ChaosInjector:
    """Seeded fault injector. ``perturb(target)`` may sleep and/or raise
    ``InjectedFault``; ``should(target)`` decides a source injection the
    caller makes. Thread-safe; deterministic for a seed and each target's
    call sequence."""

    def __init__(self, spec: str):
        self.spec = spec
        seed = 0
        self._rules: dict[str, list[_ChaosRule]] = {}
        for raw in spec.split(","):
            clause = raw.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[len("seed="):])
                continue
            rule = _parse_clause(clause)
            self._rules.setdefault(rule.target, []).append(rule)
        if not self._rules:
            raise ValueError(f"chaos spec {spec!r} names no injection rules")
        self._rng = random.Random(seed)
        self._calls = {t: 0 for t in CHAOS_TARGETS}
        self._lock = threading.Lock()

    def _fired(self, target: str) -> "tuple[int, list]":
        rules = self._rules.get(target)
        if not rules:
            return 0, []
        with self._lock:
            self._calls[target] += 1
            n = self._calls[target]
            return n, [r for r in rules if r.fires(n, self._rng)]

    def perturb(self, target: str) -> None:
        """Apply this call's injections for ``target``: sleep for every
        firing delay rule, then raise if an error rule fired."""
        n, fired = self._fired(target)
        if not fired:
            return
        from ..telemetry import blackbox as _blackbox
        from ..telemetry import metrics as _metrics

        reg = _metrics.get_registry()
        raise_after = False
        for r in fired:
            reg.counter("chaos.injected").inc()
            _blackbox.record("chaos", target=target, action=r.kind, call=n)
            if r.kind == "delay":
                reg.counter(f"chaos.{target}.delays").inc()
                log.warning("chaos: injecting %.2fs %s into %s call #%d", r.value,
                            "stall" if r.value >= 1 else "delay", target, n)
                time.sleep(r.value)
            else:
                reg.counter(f"chaos.{target}.errors").inc()
                raise_after = True
        if raise_after:
            raise InjectedFault(f"injected {target} fault (call #{n})")

    def peer_chaos(self, tick: int, interval: float, uid: int = -1) -> None:
        """``peer.kill``/``peer.pause`` at lockstep tick ``tick`` (the call
        index: the same on every process) of process ``uid``. A kill is a
        hard exit (``os._exit``): no abort broadcast, the failure the
        lockstep watchdog exists for. A pause sleeps K ticks' wall time.
        Every process draws the same rng sequence (rules evaluate before the
        uid filter), so selected rules never desynchronize the others."""
        from ..telemetry import blackbox as _blackbox
        from ..telemetry import metrics as _metrics

        for r in self._rules.get("peer.kill", ()):
            if tick == int(r.value) and r.on_host(uid):
                log.critical("chaos: peer.kill firing at lockstep tick %d: hard exit %d "
                             "(no abort broadcast)", tick, PEER_KILL_EXIT_CODE)
                _metrics.get_registry().counter("chaos.injected").inc()
                _blackbox.record("chaos", target="peer.kill", tick=tick, uid=uid)
                import os
                import sys

                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(PEER_KILL_EXIT_CODE)
        rules = self._rules.get("peer.pause", ())
        if not rules:
            return
        with self._lock:
            fired = [r for r in rules if r.fires(tick, self._rng)]
        for r in (r for r in fired if r.on_host(uid)):
            dur = int(r.value) * max(float(interval), 0.5)
            reg = _metrics.get_registry()
            reg.counter("chaos.injected").inc()
            reg.counter("chaos.peer.pauses").inc()
            _blackbox.record("chaos", target="peer.pause", tick=tick, secs=round(dur, 2))
            log.warning("chaos: peer.pause stalling this process %.1fs (~%d ticks) at "
                        "lockstep tick %d", dur, int(r.value), tick)
            time.sleep(dur)

    def should(self, target: str) -> "float | None":
        """Count one call of a source target and return the firing rule's
        magnitude (source.burst rows; 1 otherwise), or None."""
        n, fired = self._fired(target)
        if not fired:
            return None
        from ..telemetry import blackbox as _blackbox
        from ..telemetry import metrics as _metrics

        reg = _metrics.get_registry()
        for _ in fired:
            reg.counter("chaos.injected").inc()
            reg.counter(f"chaos.{target}.injected").inc()
            _blackbox.record("chaos", target=target, action="inject", call=n)
        return max(r.value for r in fired)


# one injector a process: the injection points sit in several layers and
# all belong to the run's one --chaos configuration
_CHAOS: "ChaosInjector | None" = None


def install_chaos(spec: str) -> ChaosInjector:
    """Parse and activate a spec process-wide (ValueError when malformed)."""
    global _CHAOS
    _CHAOS = ChaosInjector(spec)
    log.warning("chaos ACTIVE: %s",
                "; ".join(repr(r) for rs in _CHAOS._rules.values() for r in rs))
    return _CHAOS


def uninstall_chaos() -> None:
    global _CHAOS
    _CHAOS = None


def get_chaos() -> "ChaosInjector | None":
    return _CHAOS


def perturb(target: str) -> None:
    """Injection point: no-op unless a spec is installed."""
    if _CHAOS is not None:
        _CHAOS.perturb(target)


def lockstep_chaos(tick: int, interval: float, uid: int = -1) -> None:
    """The ``peer.*`` injection point, at the top of every lockstep tick
    (streaming/context.py), with this process's id."""
    if _CHAOS is not None:
        _CHAOS.peer_chaos(tick, interval, uid=uid)


def burst_extra() -> int:
    """``source.burst`` injection point (the source's emit loop): extra
    re-emits of the current tweet (0 = none)."""
    if _CHAOS is None:
        return 0
    v = _CHAOS.should("source.burst")
    return int(v) if v else 0


def maybe_corrupt_block(data: bytes) -> bytes:
    """``source.garbage`` injection point (a block source's bytes, before
    the parser): cut the buffer to two thirds, mid-line, and garble 32
    bytes, a torn wire chunk; the cut tail rides the carry into the next
    chunk as real damage would. A buffer under 256 bytes passes untouched
    and counts no call: the parser's tail loops re-parse their own
    shrinking carry, which must not be corrupted again and again."""
    if _CHAOS is None or len(data) < 256:
        return data
    if _CHAOS.should("source.garbage") is None:
        return data
    cut = max(1, len(data) * 2 // 3)
    corrupted = bytearray(data[:cut])
    lo = max(0, cut // 2 - 16)
    for i in range(lo, min(len(corrupted), lo + 32)):
        corrupted[i] ^= 0xFF
    log.warning("chaos: corrupted a %d-byte block buffer (truncated to %d, "
                "garbled 32 bytes)", len(data), cut)
    return bytes(corrupted)


def maybe_poison_labels(batch):
    """``source.nan`` injection point (the featurize stage): ``batch`` with
    every VALID row's label set to NaN (padding rows keep their zeros). A
    padded ``UnitBatch`` is replaced; a ``RaggedUnitBatch`` gets a poisoned
    copy of its labels in place, keeping its arena lease with it."""
    if _CHAOS is None or _CHAOS.should("source.nan") is None:
        return batch
    import numpy as np

    from ..features.batch import RaggedUnitBatch

    label = np.array(batch.label, copy=True)
    valid = np.asarray(batch.mask) > 0
    if not valid.any():
        return batch
    label[valid] = np.nan
    log.warning("chaos: poisoned %d label(s) with NaN in a %d-row batch",
                int(valid.sum()), label.shape[0])
    if hasattr(batch, "_replace"):  # FeatureBatch / UnitBatch
        return batch._replace(label=label)
    if isinstance(batch, RaggedUnitBatch):
        batch.label = label
        return batch
    raise TypeError(f"source.nan cannot poison a {type(batch).__name__}")


class FaultInjectingSource(Source):
    """``--faultEvery``: a source that crashes every ``crash_every`` tweets,
    a ParsedBlock counting its rows (``max_crashes`` caps it, so a finite
    replay still ends; 0 = no cap)."""

    name = "fault-injecting"

    def __init__(self, inner: Source, crash_every: int, max_crashes: int = 3, **kw):
        kw.setdefault("max_restarts", 1_000_000)
        kw.setdefault("restart_backoff", 0.01)
        super().__init__(**kw)
        self.inner = inner
        self.crash_every = crash_every
        self.max_crashes = max_crashes
        self._emitted = 0
        self._next_crash = crash_every
        self.crashes = 0

    def _may_crash(self) -> bool:
        return self.max_crashes <= 0 or self.crashes < self.max_crashes

    def produce(self) -> Iterator:
        for item in self.inner.produce():
            # count TWEETS (a block counts its rows), then crash before the
            # yield: the item that crosses the threshold is lost in flight,
            # like a dropped connection
            self._emitted += getattr(item, "rows", 1)
            if self._emitted >= self._next_crash and self._may_crash():
                self.crashes += 1
                self._next_crash = self._emitted + self.crash_every
                raise InjectedFault(f"injected receiver crash #{self.crashes} "
                                    f"after {self._emitted} tweets")
            yield item

    def stop(self) -> None:
        # release the inner source first: the producer may wait in its pacing
        self.inner.stop()
        super().stop()
