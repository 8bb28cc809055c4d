"""Read-fleet router: N serve replicas behind one front door (counterpart of
``twtml_tpu/serving/fleet.py``).

Each replica is an ``apps/serve.py`` process polling the same verified
checkpoint directory through its own ``SnapshotPromoter``; they promote on
their own but converge on one stamped step through ``is_promotable``. The
router:

- **balances** ``POST /api/predict`` over the healthy replicas. ``p99``
  picks the lowest expected cost, rolling forward p99 x (in-flight forwards
  + 1), the router's own view of each replica's line (raw least-p99 herds an
  open-loop burst onto one replica); ``hash`` places the request key on a
  ring of 64 md5 vnodes a replica, so a key sticks to one replica and only
  1/N of keys move when a replica joins or dies;
- **health-checks** replicas through ``GET /api/serving`` on a cadence;
- **ejects** a failing replica: a refused, timed-out or 5xx forward retries
  on ANOTHER replica (``router.retries``) while the failing one sits out a
  jittered exponential backoff (``fleet.replica_ejections``); a probe or a
  forward that succeeds restores it (``fleet.replica_restores``).

Standard library only, no torch: the router holds no model, boots in
milliseconds and leaves the host's cores to the replicas.
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from ..telemetry import metrics as _metrics
from ..utils import get_logger

log = get_logger("serving.fleet")

# rolling forward latencies a replica (the p99 policy and the Fleet view)
LATENCY_WINDOW = 512
QPS_WINDOW_S = 30.0

# the ejection ladder: exponential, jittered into [0.5x, 1x], capped, the
# exponent capped so a flapping replica cannot overflow 2**n
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 15.0

# vnodes a replica on the consistent-hash ring
VNODES = 64

HEALTH_EVERY_S = 1.0
HEALTH_TIMEOUT_S = 2.0

# forwards are blocking urllib calls waiting on replica sockets; the fleet's
# in-flight ceiling is N replicas x serve depth, so the router's own pool
# must hold more than any one replica (asyncio's default executor, cpu + 4
# threads, would cap the fleet near one replica's budget)
FORWARD_WORKERS = 64


def _jittered_backoff(ejections: int) -> float:
    """Seconds an ejected replica sits out before its next probe."""
    base = min(BACKOFF_BASE_S * (2 ** min(max(ejections, 1) - 1, 12)), BACKOFF_CAP_S)
    return base * (0.5 + 0.5 * random.random())


class Replica:
    """The router's state of one replica; mutated under the router's lock."""

    def __init__(self, index: int, url: str):
        self.index = index
        self.url = url.rstrip("/")
        self.healthy = True  # optimistic: the first forward or probe decides
        self.ejections = 0
        self.ejected_until = 0.0
        self.requests = 0
        self.errors = 0
        self.inflight = 0
        self.latencies: "collections.deque[float]" = collections.deque(maxlen=LATENCY_WINDOW)
        self.completions: "collections.deque[float]" = collections.deque(maxlen=LATENCY_WINDOW)
        self.last_view: dict = {}

    def p99_s(self) -> float:
        if not self.latencies:
            return 0.0
        vs = sorted(self.latencies)
        return vs[min(len(vs) - 1, int(0.99 * len(vs)))]

    def qps(self, now: float) -> float:
        lo = now - QPS_WINDOW_S
        return sum(1 for t in self.completions if t >= lo) / QPS_WINDOW_S


class FleetRouter:
    """The front door's routing core. ``predict`` is thread-safe (the web
    server calls it from ``executor``'s threads); the health loop runs on a
    daemon thread of its own."""

    POLICIES = ("p99", "hash")

    def __init__(self, urls, policy: str = "p99", timeout: float = 30.0,
                 health_every_s: float = HEALTH_EVERY_S):
        urls = [u for u in urls if u]
        if not urls:
            raise ValueError("a fleet router needs at least one replica URL")
        if policy not in self.POLICIES:
            raise ValueError(f"routePolicy must be one of {self.POLICIES}, got {policy!r}")
        self.policy = policy
        self.timeout = float(timeout)
        self.health_every_s = max(0.05, float(health_every_s))
        self.replicas = [Replica(i, u) for i, u in enumerate(urls)]
        self._lock = threading.Lock()
        self._rr = 0  # the round-robin tiebreak cursor
        self._ring: "list[tuple[int, int]]" = sorted(
            (int.from_bytes(hashlib.md5(f"{rep.url}#{v}".encode("utf-8")).digest()[:8], "big"),
             rep.index)
            for rep in self.replicas for v in range(VNODES)
        )
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # the front door's forward pool (web/server.py runs forwards here)
        self.executor = ThreadPoolExecutor(max_workers=FORWARD_WORKERS,
                                           thread_name_prefix="twtml-fleet-fwd")
        reg = _metrics.get_registry()
        self._req_count = reg.counter("router.requests")
        self._retry_count = reg.counter("router.retries")
        self._err_count = reg.counter("router.errors")
        self._eject_count = reg.counter("fleet.replica_ejections")
        self._restore_count = reg.counter("fleet.replica_restores")

    # -- replica selection ---------------------------------------------------
    def _available(self, now: float, exclude: set) -> "list[Replica]":
        """Healthy replicas; with none, the ejected ones whose backoff ran
        out (a probe by forward beats a certain 503)."""
        healthy = [r for r in self.replicas if r.index not in exclude and r.healthy]
        if healthy:
            return healthy
        return [r for r in self.replicas if r.index not in exclude and now >= r.ejected_until]

    def _pick(self, key: bytes, exclude: set) -> "Replica | None":
        now = time.monotonic()
        with self._lock:
            candidates = self._available(now, exclude)
            if not candidates:
                return None
            if self.policy == "hash":
                point = int.from_bytes(hashlib.md5(key).digest()[:8], "big")
                ok = {r.index for r in candidates}
                lo, hi = 0, len(self._ring)
                while lo < hi:  # the first vnode at or after the key's point
                    mid = (lo + hi) // 2
                    if self._ring[mid][0] < point:
                        lo = mid + 1
                    else:
                        hi = mid
                rep = candidates[0]
                for off in range(len(self._ring)):
                    idx = self._ring[(lo + off) % len(self._ring)][1]
                    if idx in ok:
                        rep = self.replicas[idx]
                        break
            else:
                # queue-aware least-p99: p99 x (in flight + 1), the expected
                # cost of joining that replica's line; round-robin on ties
                self._rr += 1
                rep = min(candidates, key=lambda r: (
                    max(r.p99_s(), 1e-3) * (r.inflight + 1),
                    (r.index - self._rr) % max(len(self.replicas), 1),
                ))
            rep.inflight += 1
            rep.requests += 1
            return rep

    # -- forwarding ----------------------------------------------------------
    def predict(self, body: bytes, key: "bytes | None" = None):
        """Forward one ``POST /api/predict`` body; (http status, response
        bytes). A replica failure (refused, timed out, 5xx) ejects it and
        retries the next replica, so the client sees an error only when
        every replica is down at once; a 4xx passes through (the request's
        fault, which every replica would agree on)."""
        self._req_count.inc()
        key = body if key is None else key
        tried: set = set()
        first_failure = ""
        while True:
            rep = self._pick(key, tried)
            if rep is None:
                self._err_count.inc()
                detail = first_failure or "no replica available"
                return 503, json.dumps({
                    "error": f"fleet has no live replica ({detail}); "
                             "replicas re-probe on a jittered backoff",
                }).encode("utf-8")
            tried.add(rep.index)
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    rep.url + "/api/predict", data=body,
                    headers={"content-type": "application/json",
                             "accept": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    payload = resp.read()
                self._record_success(rep, time.perf_counter() - t0)
                return 200, payload
            except urllib.error.HTTPError as exc:
                detail = exc.read()
                if exc.code < 500:
                    self._record_success(rep, time.perf_counter() - t0)
                    return exc.code, detail
                why = f"HTTP {exc.code} from {rep.url}"
            except (OSError, http.client.HTTPException) as exc:
                # refused, reset, timed out, or cut mid-response
                why = f"{rep.url} unreachable ({getattr(exc, 'reason', exc)})"
            first_failure = first_failure or why
            self._record_failure(rep, why)
            if len(tried) < len(self.replicas):
                self._retry_count.inc()
                log.warning("predict forward failed (%s); retrying on another replica "
                            "(%d/%d tried)", why, len(tried), len(self.replicas))

    def _record_success(self, rep: Replica, dt: float) -> None:
        now = time.monotonic()
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            rep.latencies.append(dt)
            rep.completions.append(now)
            if not rep.healthy:
                rep.healthy = True
                rep.ejected_until = 0.0
                self._restore_count.inc()
                log.info("replica %s recovered (forward succeeded)", rep.url)

    def _eject(self, rep: Replica, why) -> None:
        """Under the lock: eject ``rep`` unless it sits out a backoff
        already."""
        if rep.healthy or rep.ejected_until <= time.monotonic():
            rep.healthy = False
            rep.ejections += 1
            backoff = _jittered_backoff(rep.ejections)
            rep.ejected_until = time.monotonic() + backoff
            self._eject_count.inc()
            log.warning("ejecting replica %s for %.1fs (ejection #%d): %s",
                        rep.url, backoff, rep.ejections, why)

    def _record_failure(self, rep: Replica, why: str) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            rep.errors += 1
            self._eject(rep, why)

    # -- health checks -------------------------------------------------------
    def health_check_once(self) -> None:
        """Probe each replica not sitting out a backoff through ``GET
        /api/serving``: a live view restores or confirms it, a failure
        ejects it."""
        now = time.monotonic()
        for rep in self.replicas:
            if not rep.healthy and now < rep.ejected_until:
                continue
            try:
                req = urllib.request.Request(rep.url + "/api/serving",
                                             headers={"accept": "application/json"})
                with urllib.request.urlopen(req, timeout=HEALTH_TIMEOUT_S) as resp:
                    view = json.loads(resp.read().decode("utf-8"))
            except (OSError, http.client.HTTPException, ValueError) as exc:
                with self._lock:
                    self._eject(rep, f"health probe failed: {exc}")
                continue
            with self._lock:
                rep.last_view = view if isinstance(view, dict) else {}
                if not rep.healthy:
                    rep.healthy = True
                    rep.ejected_until = 0.0
                    self._restore_count.inc()
                    log.info("replica %s recovered (health probe)", rep.url)

    def start(self) -> "FleetRouter":
        self._thread = threading.Thread(target=self._health_loop, name="twtml-fleet-health",
                                        daemon=True)
        self._thread.start()
        return self

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_every_s):
            try:
                self.health_check_once()
            except Exception:
                log.exception("fleet health sweep failed; retrying")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.executor.shutdown(wait=False)

    # -- the Fleet view ------------------------------------------------------
    def stats(self) -> dict:
        """The ``Fleet`` view (``/api/fleet``, the dashboard's fleet tiles):
        each replica's health, latency and traffic, and the router's
        retries and ejections."""
        now = time.monotonic()
        with self._lock:
            replicas = []
            champion = -1
            for r in self.replicas:
                view = r.last_view or {}
                champ = int(view.get("champion", -1))
                if champ >= 0:
                    champion = champ
                replicas.append({
                    "replica": r.index,
                    "url": r.url,
                    "healthy": bool(r.healthy),
                    "p99Ms": round(r.p99_s() * 1e3, 2),
                    "qps": round(r.qps(now), 2),
                    "requests": int(r.requests),
                    "errors": int(r.errors),
                    "ejections": int(r.ejections),
                    "snapshotStep": int(view.get("snapshotStep", -1)),
                })
        return {
            "policy": self.policy,
            "replicas": replicas,
            "requests": int(self._req_count.snapshot()),
            "retries": int(self._retry_count.snapshot()),
            "ejections": int(self._eject_count.snapshot()),
            "champion": champion,
        }
