"""The elastic process-group runtime (``--elastic on``; counterpart of
``twtml_tpu/parallel/elastic.py``): a lockstep group that forms, shrinks
and grows again inside the running processes.

A ``torch.distributed`` group is its launch topology forever, as a
``jax.distributed`` group is, so the group becomes a sequence of EPOCHS.
Epoch e is a new ``TCPStore`` on ``port_for(e)`` (``base + 2 + e``; base is
the ``--master twtml://host:port`` port) and process groups formed over it
for the epoch's members only (parallel/distributed.py ``form``: explicit
group objects, never the default group). The discipline is the JAX
package's:

- **the app's lockstep watchdog is the one death detector**
  (``TWTML_LOCKSTEP_TIMEOUT_S``, streaming/context.py), with the
  collective's own error the other way a dead peer shows;
- **no shutdown, ever, mid-run**: a gloo group with a dead peer, or with a
  thread still inside one of its collectives (the watched cadence
  all-gather of the tick that wedged), can block a shutdown. ``abandon``
  moves the epoch's objects to a graveyard for the process's life (a few
  threads and sockets an epoch, bounded by the churn);
- **a hard exit once the run is over** (``finalize_exit``): a thread left
  blocked in an abandoned epoch's all-gather ends only with the process,
  so an elastic process leaves through ``os._exit`` after flushing;
- **the store never shares a process with a member**: a member-hosted
  store dies with its host, so each epoch's pid-0 member spawns the store
  as a detached process of its own (parallel/service_host.py) that
  outlives every member and reaps itself once the membership beacon has
  been gone for ``TWTML_ELASTIC_SERVICE_LINGER_S``. The pid-0 member
  starts the NEXT epoch's store together with its own, so a rescue (whose
  new epoch's pid 0 may be another host) finds its store listening instead
  of waiting seconds for a process to start; a store started twice for one
  port exits at its failed bind.

Every member derives the epoch's port locally, so a re-formation needs no
negotiation beyond the agreed epoch number and member set.

The **beacon** is the lead's out-of-band membership channel, on ``base +
1``: JSON over TCP, one request a connection, never a collective, and
never touched on a healthy tick. It carries wedge reports after a peer's
death (a dead peer cannot ack in-band), join requests from parked or
restarted hosts, and plan polling while a host is outside the group.

**Lead election**: binding the beacon port is the election lock, which the
OS arbitrates. A dead lead's socket closes with it, so survivors whose
wedge reports are refused know the beacon is orphaned (a paused lead's
beacon thread still answers) and run the successor rule
(streaming/membership.py ``_elect``): the lowest live uid of the committed
view binds first and wins. It adopts ``lead_uid``, publishes the rescue
plan and restores the group from its own verified checkpoint (every
elastic host shadow-saves: apps/common.py ``AppCheckpoint``). Leadership is
sticky: a rejoining ex-lead is admitted as a follower.

Reachability: an election assumes the beacon's and the stores' host:port
stay bindable wherever a lead lands, true on one machine (the tests, the
chip phase) or behind a shared address.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time

from ..utils import get_logger

log = get_logger("parallel.elastic")

# beacon request cap: one JSON line a connection, bounded
_BEACON_MAX_BYTES = 65536

BEACON_OFFSET = 1      # beacon port = base + 1
EPOCH_PORT_OFFSET = 2  # epoch e's store port = base + 2 + e

INIT_TIMEOUT_ENV = "TWTML_ELASTIC_INIT_TIMEOUT_S"
INIT_TIMEOUT_DEFAULT_S = 60.0


def _init_timeout_s() -> int:
    """The bound on forming one epoch (the store's connect and every
    member's rendezvous), in place of a lockstep group's 120 s."""
    return int(float(os.environ.get(INIT_TIMEOUT_ENV, "") or INIT_TIMEOUT_DEFAULT_S))


def uids_from_mask(mask: int) -> "list[int]":
    """Member uids encoded in a view bitmask, ascending (uid = bit index).
    Uids are the LAUNCH process ids, stable across epochs."""
    out = []
    bit = 0
    m = int(mask)
    while m:
        if m & 1:
            out.append(bit)
        m >>= 1
        bit += 1
    return out


def mask_from_uids(uids) -> int:
    mask = 0
    for u in uids:
        if not 0 <= int(u) < 52:
            # the mask rides a float64 column; integers are exact to 2^53
            raise ValueError(f"elastic member uid {u} out of range [0, 52)")
        mask |= 1 << int(u)
    return mask


class BeaconServer:
    """The lead's membership side channel: JSON over TCP, one request a
    connection, answered from a lock-protected state the membership plane
    updates, on a daemon thread."""

    def __init__(self, port: int, lead_uid: int = 0):
        self.port = port
        self._lock = threading.Lock()
        self._state: dict = {
            "state": "forming", "epoch": 0, "members": [], "plan": None,
            "lead_uid": int(lead_uid),
        }
        self._joins: "dict[int, float]" = {}     # uid -> monotonic seen
        self._wedged: "dict[int, int]" = {}      # uid -> epoch reported
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(16)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="twtml-elastic-beacon",
                                        daemon=True)
        self._thread.start()
        log.info("elastic membership beacon listening on :%d", port)

    # -- state the membership plane publishes --------------------------------

    def publish(self, state: str, epoch: int, members: "list[int]") -> None:
        with self._lock:
            self._state["state"] = state
            self._state["epoch"] = int(epoch)
            self._state["members"] = [int(u) for u in members]

    def publish_plan(self, plan: "dict | None") -> None:
        """The committed next-epoch plan ({epoch, members}) parked or wedged
        hosts poll for; None clears it. A plan carries the owner's
        ``lead_uid``, so a host that reads it through a handed-off beacon
        adopts the elected lead in the same poll."""
        with self._lock:
            if plan is not None:
                plan = dict(plan)
                plan.setdefault("lead_uid", self._state["lead_uid"])
            self._state["plan"] = plan

    def fresh_joins(self, max_age_s: float) -> "list[int]":
        """Uids with a join request newer than ``max_age_s``: a joiner
        re-sends on every poll, and a no-show admitted into an epoch would
        hold its formation."""
        now = time.monotonic()
        with self._lock:
            return sorted(u for u, t in self._joins.items() if now - t <= max_age_s)

    def wedge_reports(self, epoch: int) -> "list[int]":
        """Uids that reported a wedged collective at ``epoch``."""
        with self._lock:
            return sorted(u for u, e in self._wedged.items() if e == int(epoch))

    def clear_wedges(self) -> None:
        with self._lock:
            self._wedged.clear()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- wire ----------------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # closed
            try:
                conn.settimeout(2.0)
                data = b""
                while b"\n" not in data and len(data) < _BEACON_MAX_BYTES:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                req = json.loads(data.decode("utf-8").strip() or "{}")
                conn.sendall((json.dumps(self._handle(req)) + "\n").encode("utf-8"))
            except Exception:  # lawcheck: disable=TW005 -- one bad request must not stop the beacon; logged
                log.debug("beacon request failed", exc_info=True)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, req: dict) -> dict:
        op = req.get("op", "")
        uid = int(req.get("uid", -1))
        with self._lock:
            st = dict(self._state)
            if op == "hello":
                return {"state": st["state"], "epoch": st["epoch"], "members": st["members"],
                        "member": uid in st["members"], "plan": st["plan"],
                        "lead_uid": st["lead_uid"]}
            if op == "join":
                self._joins[uid] = time.monotonic()
                return {"queued": True, "epoch": st["epoch"], "lead_uid": st["lead_uid"]}
            if op == "wedged":
                self._wedged[uid] = int(req.get("epoch", -1))
                return {"ok": True, "plan": st["plan"], "lead_uid": st["lead_uid"]}
            if op == "plan":
                return {"plan": st["plan"], "epoch": st["epoch"], "lead_uid": st["lead_uid"]}
        return {"error": f"unknown op {op!r}"}


class BeaconClient:
    """The follower's and joiner's side of the beacon: short connections,
    every failure returned as None (the caller owns retry and abort)."""

    def __init__(self, host: str, port: int, timeout_s: float = 3.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s

    def request(self, op: str, uid: int, **kw) -> "dict | None":
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=self.timeout_s) as conn:
                conn.sendall((json.dumps(dict(op=op, uid=uid, **kw)) + "\n").encode("utf-8"))
                conn.settimeout(self.timeout_s)
                data = b""
                while b"\n" not in data and len(data) < _BEACON_MAX_BYTES:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                return json.loads(data.decode("utf-8").strip() or "null")
        except (OSError, ValueError) as exc:
            log.debug("beacon %s failed: %s", op, exc)
            return None


def probe_port(host: str, port: int, timeout_s: float = 0.5) -> bool:
    """Plain TCP reachability probe (a live beacon answers a connect)."""
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True
    except OSError:
        return False


def free_base_port(host: str = "127.0.0.1", span: int = 12) -> int:
    """A base port for a group launched on one machine: ``base + 1`` (the
    beacon) up to ``base + span - 1`` (epoch ``span - 3``'s store) are free
    when this returns."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind((host, 0))
            base = s.getsockname()[1]
        socks = []
        try:
            for off in range(BEACON_OFFSET, span):
                s = socket.socket()
                socks.append(s)
                s.bind((host, base + off))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {span} free ports in a row on {host}")


class ElasticRuntime:
    """One process's epochs. ``uid`` is its LAUNCH process id, stable
    across epochs; ``lead_uid`` the current lead's (0 at launch, sticky
    until an election moves it). A restarted ex-lead finds the beacon port
    taken by its successor, keeps ``beacon=None`` and rejoins as a
    follower: demotion is losing the bind."""

    def __init__(self, host: str, base_port: int, uid: int):
        self.host = host
        self.base_port = int(base_port)
        self.uid = int(uid)
        self.epoch = -1
        self.members: "list[int]" = []
        self.reformed_ever = False
        # True when this process joined a LIVE run (a restarted host
        # admitted mid-flight): its replay-index shard stays with the
        # adopters from the first batch on (apps/common.py)
        self.joined_late = False
        # abandoned epochs' groups and stores: never shut down (module
        # docstring); they live as long as the process
        self._graveyard: list = []
        # the store processes this host spawned (parallel/service_host.py),
        # by port: they reap themselves off the beacon's liveness
        self._service_hosts: dict = {}
        self.lead_uid = 0
        self.beacon: "BeaconServer | None" = None
        if self.uid == 0:
            # a TRY: a restarted ex-lead races the elected successor for
            # the port and must lose gracefully
            try:
                self.beacon = BeaconServer(self.beacon_port, lead_uid=0)
            except OSError:
                log.warning("beacon port :%d already owned: uid 0 restarting into a group "
                            "led by an elected successor; joining as a follower",
                            self.beacon_port)

    @property
    def is_lead(self) -> bool:
        return self.uid == self.lead_uid

    def set_lead(self, uid: int) -> None:
        """Adopt ``uid`` as the current lead (from a beacon hello or plan,
        or this host after winning an election)."""
        self.lead_uid = int(uid)

    def take_over_beacon(self) -> bool:
        """The election's bind race: bind the beacon port and become the
        lead. Exactly one caller wins (the OS arbitrates the bind); a loser
        returns False and re-resolves through the winner's beacon."""
        if self.beacon is not None:
            return True
        try:
            self.beacon = BeaconServer(self.beacon_port, lead_uid=self.uid)
        except OSError as exc:
            log.info("beacon takeover lost (:%d already bound: %s): another survivor won "
                     "the election", self.beacon_port, exc)
            return False
        self.lead_uid = self.uid
        return True

    # -- address arithmetic --------------------------------------------------

    @property
    def beacon_port(self) -> int:
        return self.base_port + BEACON_OFFSET

    def port_for(self, epoch: int) -> int:
        return self.base_port + EPOCH_PORT_OFFSET + int(epoch)

    def beacon_client(self) -> BeaconClient:
        return BeaconClient(self.host, self.beacon_port)

    # -- epoch lifecycle -----------------------------------------------------

    def _spawn_service_host(self, port: int, nprocs: int) -> None:
        """Start epoch ``port``'s store in a process of its own
        (parallel/service_host.py), detached: a new session, every stdio on
        /dev/null (it must not hold a pipe a harness waits on). It outlives
        every member and reaps itself once the beacon has been gone for
        the linger window."""
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH", "")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", "twtml_tpu_torch.parallel.service_host", str(port),
             str(nprocs), self.host, str(self.beacon_port)],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True, env=env,
        )
        self._service_hosts[port] = proc
        log.info("elastic store for :%d hosted in its own process (pid %d, %d member(s))",
                 port, proc.pid, nprocs)

    def form(self, epoch: int, members: "list[int]") -> None:
        """Join epoch ``epoch`` with the given member uids (this host among
        them): the pid-0 member starts the epoch's store process and the
        next epoch's, each unless it started it already or one listens (a
        previous epoch's pid 0 started it); every member connects to the
        epoch's store within the formation bound
        (``TWTML_ELASTIC_INIT_TIMEOUT_S``) and forms the epoch's groups
        (distributed.py ``form``, the backend chosen anew)."""
        import torch.distributed as dist

        from . import distributed as _dist

        members = sorted(int(u) for u in members)
        if self.uid not in members:
            raise ValueError(f"host uid {self.uid} is not in epoch {epoch}'s member set "
                             f"{members}")
        pid = members.index(self.uid)
        nprocs = len(members)
        port = self.port_for(epoch)
        if pid == 0:
            # this epoch's store, and the next's, listening before a rescue
            # needs it
            for p in (port, self.port_for(epoch + 1)):
                if p not in self._service_hosts and not probe_port(self.host, p):
                    self._spawn_service_host(p, nprocs)
        bound = datetime.timedelta(seconds=_init_timeout_s())
        store = dist.TCPStore(self.host, port, nprocs, is_master=False, timeout=bound)
        lead_rank = members.index(self.lead_uid) if self.lead_uid in members else 0
        _dist.form(store, pid, nprocs, _dist.collective_timeout(), lead_rank=lead_rank)
        self.epoch = int(epoch)
        self.members = members
        if self.beacon is not None:
            self.beacon.publish("live", self.epoch, members)
        log.info("elastic epoch %d formed: %d host(s) %s, this host uid=%d pid=%d, "
                 "store %s:%d", epoch, nprocs, members, self.uid, pid, self.host, port)

    def abandon(self) -> None:
        """Leave the current epoch WITHOUT shutting its groups down (module
        docstring): they go to the graveyard for the process's life."""
        from . import distributed as _dist

        self._graveyard.append(_dist.abandon())
        self.reformed_ever = True
        log.info("elastic epoch %d abandoned (graveyard now %d epoch(s))", self.epoch,
                 len(self._graveyard))

    def finalize_exit(self, code: int) -> None:
        """Leave the process through ``os._exit`` after flushing the
        standard streams: an abandoned epoch may hold a thread blocked in a
        collective that only the process's end releases. Every elastic run
        leaves here, so the exit does not depend on the churn."""
        import sys

        for stream in (sys.stdout, sys.stderr):
            try:
                stream.flush()
            except Exception:  # lawcheck: disable=TW005 -- best effort before the hard exit; logged
                log.debug("stream flush failed at elastic exit")
        os._exit(int(code))


# the process-wide runtime: formation happens before the app builds
# anything, and the lockstep loop and the app's exit need the same one
_RUNTIME: "ElasticRuntime | None" = None


def install_runtime(host: str, base_port: int, uid: int) -> ElasticRuntime:
    global _RUNTIME
    if _RUNTIME is not None:
        raise RuntimeError("elastic runtime already installed")
    _RUNTIME = ElasticRuntime(host, base_port, uid)
    return _RUNTIME


def get_runtime() -> "ElasticRuntime | None":
    return _RUNTIME


def reset_for_tests() -> None:
    global _RUNTIME
    if _RUNTIME is not None and _RUNTIME.beacon is not None:
        _RUNTIME.beacon.close()
    _RUNTIME = None
