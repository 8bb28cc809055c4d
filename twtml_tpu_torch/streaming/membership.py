"""Lead-coordinated membership epochs for the lockstep group (``--elastic
on``; counterpart of ``twtml_tpu/streaming/membership.py``): the control
plane that lets the group SHRINK when a host dies or keeps gating,
REBALANCE intake across the survivors, and ADMIT a recovered host back,
without a restart.

The in-band protocol rides the tick's ONE cadence all-gather
(streaming/context.py ``_lockstep_loop``): its row widens by the ``WIDTH``
columns below, and a healthy tick adds no collective and no fetch. A
membership change is a two-tick exchange over those columns:

    tick T:   the lead's row carries (proposed epoch P, proposed member
              mask); every member sees it in the same gather;
    tick T+1: every member's row acks P; the commit condition (the lead's
              proposal P AND every row's ack of P) is evaluated on the SAME
              gathered matrix by every host, so the commit is simultaneous.
              Members of the new view re-form at epoch P's port; a host
              outside it parks.

A HARD-dead peer can never ack in-band: the gather itself fails or makes no
progress. That path goes out of band through the lead's beacon
(parallel/elastic.py): each survivor's watchdog fires, each reports
"wedged" to the beacon, the lead takes (reporters ∪ itself) ∩ members as
the survivors, publishes the rescue plan, and everyone re-forms. When the
dead peer is the lead itself, the wedge reports are refused (the beacon
died with its owner) and the survivors run ``_elect``: rank-staggered
candidates race ``take_over_beacon()`` (the bind on the beacon port is the
election lock), the lowest live uid wins, adopts ``lead_uid`` and runs the
same rescue; the losers report to the winner's beacon. Leadership is
sticky from then on.

Columns (float64-exact integers, between the 4 lockstep flags and the
telemetry sideband):

    0 epoch       this host's current epoch
    1 uid         this host's LAUNCH process id (stable across epochs)
    2 view        bitmask of member uids in this host's current epoch
    3 prop_epoch  lead: proposed next epoch (0 = no proposal)
    4 prop_view   lead: proposed member mask (may include a joiner's uid)
    5 ack         newest proposed epoch this host agrees to (0 = none)
    6 reason      proposal reason (1 evict, 2 join, 3 rescue-rejoin)
    7 spare       reserved

Host-side only: no torch here; ``time.monotonic`` for every interval.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..utils import get_logger

log = get_logger("streaming.membership")

FIELDS = (
    "epoch", "uid", "view", "prop_epoch", "prop_view", "ack", "reason",
    "spare",
)
WIDTH = len(FIELDS)

REASON_EVICT = 1
REASON_JOIN = 2
REASON_RESCUE = 3
REASON_NAMES = {REASON_EVICT: "evict", REASON_JOIN: "join",
                REASON_RESCUE: "rescue"}

# rescue: how long the lead collects wedge reports after its own watchdog
# fires before declaring the silent members dead (alive survivors' watchdogs
# fire within ~one timeout of each other, so a small multiple suffices)
RESCUE_GRACE_ENV = "TWTML_ELASTIC_RESCUE_GRACE_S"
RESCUE_GRACE_DEFAULT_S = 5.0

# park: how long an evicted/wedged-out host polls for (re)admission before
# giving up and aborting
PARK_TIMEOUT_ENV = "TWTML_ELASTIC_PARK_TIMEOUT_S"
PARK_TIMEOUT_DEFAULT_S = 120.0

# a join request is only proposable while fresh: the joiner re-sends it on
# every poll, so a stale one means the joiner is gone — admitting it would
# wedge the new epoch's formation on a no-show
JOIN_FRESH_S = 5.0

# election: successor candidates rank by uid and each waits rank × stagger
# (probing the orphaned beacon port throughout) before attempting the bind,
# so the lowest LIVE uid wins the race deterministically; the OS bind is
# the lock, the stagger only prevents needless bind contention
ELECT_STAGGER_ENV = "TWTML_ELASTIC_ELECT_STAGGER_S"
ELECT_STAGGER_DEFAULT_S = 0.3

# bounded election rounds: each retry means the beacon owner died again
# mid-election; three corpses in one rescue window is a lost fleet
ELECT_MAX_ROUNDS = 3


def election_candidates(members, lead_uid) -> "list[int]":
    """Successor order for a dead lead: every OTHER member of the committed
    view, ascending uid — rank in this list is the election stagger slot.
    Pure (unit-tested directly); dead candidates simply never bind."""
    return sorted(int(u) for u in members if int(u) != int(lead_uid))


class MembershipPlane:
    """One per lockstep run on every host. The scheduler drives it:
    ``pre_tick`` → columns for the flag row; ``ingest`` on the gathered
    block → an action string; ``execute_reform``/``park``/``rescue`` for
    the transitions. The heavy lifting (pipeline drain, group teardown and
    re-formation, model rebuild, checkpoint broadcast, intake rebalance)
    lives in two injected callbacks:

    - ``detach_cb()``             — drain in-flight work, abandon the epoch
    - ``attach_cb(plan, reason)`` — form the new epoch and rebuild on it

    so this module stays a pure protocol machine (testable without torch or
    sockets: tests/test_torch_membership.py drives ingest matrices through
    it and the JAX package's plane)."""

    def __init__(self, runtime, detach_cb, attach_cb,
                 evict_ticks: int = 0, evict_skew_ms: float = 250.0,
                 rejoin: bool = True):
        self.runtime = runtime
        self._detach = detach_cb
        self._attach = attach_cb
        self.evict_ticks = int(evict_ticks)
        self.evict_skew_ms = float(evict_skew_ms)
        self.rejoin = bool(rejoin)
        self.uid = runtime.uid
        # active proposal state (lead publishes; everyone tracks)
        self._prop_epoch = 0
        self._prop_view = 0
        self._prop_reason = 0
        self._ack = 0
        # straggler eviction scoring (lead)
        self._gating_uid = -1
        self._gating_ticks = 0
        self._plan: "dict | None" = None
        from ..telemetry import metrics as _metrics

        reg = _metrics.get_registry()
        self._epoch_gauge = reg.gauge("elastic.epoch")
        self._hosts_gauge = reg.gauge("elastic.live_hosts")
        self._lead_gauge = reg.gauge("elastic.lead_uid")
        self._reforms = reg.counter("elastic.reforms")
        self._departed = reg.counter("elastic.hosts_departed")
        self._rejoined = reg.counter("elastic.hosts_rejoined")
        self._rows_lost = reg.counter("elastic.rows_lost_estimate")
        self._elections = reg.counter("elastic.elections")
        self._handoffs = reg.counter("elastic.lead_handoffs")
        self._epoch_gauge.set(runtime.epoch)
        self._hosts_gauge.set(len(runtime.members))
        self._lead_gauge.set(self.lead_uid)

    # -- helpers -------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.runtime.epoch

    @property
    def members(self) -> "list[int]":
        return self.runtime.members

    @property
    def lead_uid(self) -> int:
        return int(getattr(self.runtime, "lead_uid", 0))

    @property
    def lead(self) -> bool:
        """Whether THIS host is the current lead. Dynamic — leadership is
        sticky on ``runtime.lead_uid`` and only moves at an election (a
        rejoining ex-lead stays a follower even though its uid is again
        the minimum)."""
        return self.uid == self.lead_uid

    def _adopt_lead(self, resp: "dict | None", how: str) -> None:
        """Adopt the lead uid a beacon response advertises. Any response
        from a HANDED-OFF beacon carries the winner's uid; counting the
        change here gives every survivor/rejoiner its own handoff record
        (``elastic.lead_handoffs``)."""
        if not resp or "lead_uid" not in resp:
            return
        new = int(resp["lead_uid"])
        if new == self.lead_uid:
            return
        old = self.lead_uid
        self.runtime.set_lead(new)
        self._lead_gauge.set(new)
        self._handoffs.inc()
        log.warning(
            "elastic: lead handoff observed (%s): uid %d -> uid %d",
            how, old, new,
        )

    @staticmethod
    def _grace_s() -> float:
        return float(
            os.environ.get(RESCUE_GRACE_ENV, "") or RESCUE_GRACE_DEFAULT_S
        )

    @staticmethod
    def _park_timeout_s() -> float:
        return float(
            os.environ.get(PARK_TIMEOUT_ENV, "") or PARK_TIMEOUT_DEFAULT_S
        )

    # -- per-tick protocol ---------------------------------------------------

    def pre_tick(self) -> np.ndarray:
        """Build this host's membership columns; on the lead, first fold in
        out-of-band join requests and the straggler-eviction score to maybe
        open a proposal. Pure host-side work."""
        from ..parallel.elastic import mask_from_uids

        if self.lead and self._prop_epoch == 0:
            self._maybe_propose()
        return np.array([
            self.epoch, self.uid, mask_from_uids(self.members),
            self._prop_epoch, self._prop_view, self._ack,
            self._prop_reason, 0,
        ], dtype=np.float64)

    def _maybe_propose(self) -> None:
        from ..parallel.elastic import mask_from_uids

        beacon = self.runtime.beacon
        joiners = []
        if beacon is not None and self.rejoin:
            joiners = [
                u for u in beacon.fresh_joins(JOIN_FRESH_S)
                if u not in self.members
            ]
        evictee = self._straggler_evictee()
        if not joiners and evictee < 0:
            return
        view = set(self.members) | set(joiners)
        reason = REASON_JOIN if joiners else REASON_EVICT
        if evictee >= 0:
            view.discard(evictee)
        self._prop_epoch = self.epoch + 1
        self._prop_view = mask_from_uids(sorted(view))
        self._prop_reason = reason
        self._ack = self._prop_epoch  # the lead trivially acks its own
        from ..telemetry import blackbox as _blackbox

        _blackbox.record(
            "membership_propose", epoch=self._prop_epoch,
            members=sorted(view), reason=REASON_NAMES.get(reason, "?"),
        )
        log.warning(
            "elastic: proposing epoch %d with members %s (%s%s)",
            self._prop_epoch, sorted(view), REASON_NAMES.get(reason, "?"),
            f", evicting uid {evictee}" if evictee >= 0 else "",
        )

    def _straggler_evictee(self) -> int:
        """Uid to evict when the sideband's straggler attribution has named
        the same non-lead host for ``evict_ticks`` consecutive ticks with
        skew over the threshold; -1 otherwise. Off when evict_ticks == 0."""
        if not self.evict_ticks or len(self.members) <= 1:
            return -1
        from ..telemetry import sideband as _sideband

        view = _sideband.last_hosts()
        if not view:
            return -1
        pid = view.get("straggler", -1)
        skew = float(view.get("skew_ms", 0.0))
        uid = (
            self.members[pid]
            if 0 <= pid < len(self.members) else -1
        )
        if uid < 0 or uid == self.lead_uid or skew < self.evict_skew_ms:
            # the CURRENT lead is never evicted (it owns the beacon and
            # the checkpoint truth — losing it is an election, not an
            # eviction); reset the run
            self._gating_uid, self._gating_ticks = -1, 0
            return -1
        if uid == self._gating_uid:
            self._gating_ticks += 1
        else:
            self._gating_uid, self._gating_ticks = uid, 1
        if self._gating_ticks >= self.evict_ticks:
            return uid
        return -1

    def ingest(self, mem: np.ndarray) -> str:
        """Consume the gathered ``[hosts, WIDTH]`` membership block (row
        order = current epoch pid order). Returns one of:

        - ``""``       — steady state, run the tick normally
        - ``"reform"`` — a view change committed and this host is in the
                         new view: call ``execute_reform`` now
        - ``"parked"`` — a view change committed WITHOUT this host (it was
                         evicted): call ``park`` now
        """
        rows = np.asarray(mem, dtype=np.int64)
        # proposals are read from the LEAD's row. After an election the
        # lead is no longer pid 0 whenever a lower uid rejoined (the
        # ex-lead comes back as a follower but still sorts first), so the
        # row index follows lead_uid through the member list.
        lead_pid = (
            self.members.index(self.lead_uid)
            if self.lead_uid in self.members else 0
        )
        lead_prop = int(rows[lead_pid, FIELDS.index("prop_epoch")])
        lead_view = int(rows[lead_pid, FIELDS.index("prop_view")])
        lead_reason = int(rows[lead_pid, FIELDS.index("reason")])
        if lead_prop > self.epoch:
            # record/refresh the proposal; ack it from the NEXT tick on
            self._prop_epoch = lead_prop
            self._prop_view = lead_view
            self._prop_reason = lead_reason
            if self._ack != lead_prop:
                self._ack = lead_prop
                if not self.lead:
                    log.info(
                        "elastic: acking proposed epoch %d (members %s)",
                        lead_prop, self._decode_view(lead_view),
                    )
                return ""  # commit needs every row's ack in ONE gather
        if lead_prop <= self.epoch or lead_prop == 0:
            return ""
        acks = rows[:, FIELDS.index("ack")]
        if not bool((acks == lead_prop).all()):
            return ""
        members = self._decode_view(lead_view)
        self._plan = {
            "epoch": lead_prop, "members": members,
            "reason": REASON_NAMES.get(lead_reason, "?"),
        }
        if self.uid in members:
            return "reform"
        return "parked"

    @staticmethod
    def _decode_view(mask: int) -> "list[int]":
        from ..parallel.elastic import uids_from_mask

        return uids_from_mask(mask)

    # -- transitions ---------------------------------------------------------

    def _clear_proposal(self) -> None:
        self._prop_epoch = 0
        self._prop_view = 0
        self._prop_reason = 0
        self._ack = 0

    def _count_departed(self, old_members, new_members) -> None:
        """Departed hosts' last-known queue depths (from the sideband's
        final healthy gather) become the counted row-loss estimate — the
        honest form of 'drained': their queued rows died with them, and
        their source shards' future rows are adopted by survivors."""
        departed = [u for u in old_members if u not in new_members]
        if not departed:
            return
        self._departed.inc(len(departed))
        from ..telemetry import sideband as _sideband

        view = _sideband.last_hosts()
        est = 0
        if view:
            by_pid = {h["host"]: h for h in view.get("hosts", [])}
            for u in departed:
                if u in old_members:
                    pid = old_members.index(u)
                    est += int(by_pid.get(pid, {}).get("queue_rows", 0))
        if est:
            self._rows_lost.inc(est)
        log.warning(
            "elastic: host(s) %s departed; ~%d queued row(s) lost with "
            "them (counted in elastic.rows_lost_estimate)", departed, est,
        )

    def _finish_transition(self, old_members, reason: str) -> None:
        self._reforms.inc()
        self._epoch_gauge.set(self.epoch)
        self._hosts_gauge.set(len(self.members))
        rejoined = [u for u in self.members if u not in old_members]
        if rejoined:
            self._rejoined.inc(len(rejoined))
        from ..telemetry import blackbox as _blackbox

        _blackbox.record(
            "membership_commit", epoch=self.epoch, members=self.members,
            reason=reason, departed=[
                u for u in old_members if u not in self.members
            ], rejoined=rejoined,
        )
        if self.runtime.beacon is not None:
            # the plan stays briefly for late pollers; the live state is
            # authoritative for hello
            self.runtime.beacon.publish("live", self.epoch, self.members)
            self.runtime.beacon.clear_wedges()
        self._clear_proposal()

    def execute_reform(self) -> None:
        """Run the committed plan on a member of the new view (clean
        commit path: every old member is alive and synchronized at this
        tick, so the lead may first snapshot a loss-free checkpoint inside
        ``detach_cb``)."""
        plan = self._plan
        assert plan is not None
        old = list(self.members)
        self._count_departed(old, plan["members"])
        if self.lead and self.runtime.beacon is not None:
            # publish BEFORE forming: a parked/fresh joiner polls this to
            # learn its admission, and formation blocks until it connects
            self.runtime.beacon.publish_plan(
                {"epoch": plan["epoch"], "members": plan["members"]}
            )
        self._detach(clean=True)
        self._attach(plan, plan.get("reason", "?"))
        self._finish_transition(old, plan.get("reason", "?"))
        self._plan = None

    def park(self) -> bool:
        """This host was evicted (clean commit without it) or woke up past
        a rescue it missed: leave the group, then poll the beacon for
        (re)admission until the park timeout. True → rejoined (the run
        continues); False → give up (the caller aborts)."""
        old = list(self.members)
        self._detach(clean=False)
        self._clear_proposal()
        if not self.rejoin:
            log.warning("elastic: parked with --elasticRejoin off; exiting")
            return False
        client = self.runtime.beacon_client()
        deadline = time.monotonic() + self._park_timeout_s()
        log.warning(
            "elastic: parked (uid %d); polling the beacon for readmission",
            self.uid,
        )
        while time.monotonic() < deadline:
            resp = client.request("join", self.uid)
            if resp is None:
                time.sleep(1.0)
                continue
            # a parked ex-lead learns its successor here — admission into
            # a post-election fleet is the demotion path (the beacon that
            # answers is the winner's)
            self._adopt_lead(resp, "parked")
            plan = (client.request("plan", self.uid) or {}).get("plan")
            if plan and self.uid in plan.get("members", []) and (
                plan["epoch"] > self.epoch
            ):
                self._adopt_lead(plan, "admission plan")
                plan = dict(plan, reason="rejoin")
                self._attach(plan, "rejoin")
                self._finish_transition(old, "rejoin")
                return True
            time.sleep(0.5)
        log.critical(
            "elastic: park timed out after %.0fs without readmission",
            self._park_timeout_s(),
        )
        return False

    def rescue(self, why: str) -> bool:
        """Out-of-band recovery after a wedged/failed cadence collective
        (a hard-dead peer). Lead: collect wedge reports for the grace
        window, shrink to the reporters ∪ itself, publish the plan, and
        re-form. Follower: report the wedge, then follow the lead's plan
        (or park if the plan excludes this host). True → the run continues
        on the new epoch; False → unrecoverable (the caller aborts)."""
        from ..telemetry import blackbox as _blackbox

        _blackbox.record(
            "membership_rescue", epoch=self.epoch, uid=self.uid, why=why,
        )
        if self.lead:
            return self._rescue_lead(why)
        return self._rescue_follower(why)

    def _rescue_lead(self, why: str, extra_grace_s: float = 0.0) -> bool:
        beacon = self.runtime.beacon
        if beacon is None:
            return False
        grace = self._grace_s() + float(extra_grace_s)
        log.critical(
            "elastic: lockstep wedged (%s); collecting survivor reports "
            "for %.1fs before shrinking", why, grace,
        )
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            time.sleep(0.2)
        survivors = sorted(
            ({self.uid} | set(beacon.wedge_reports(self.epoch)))
            & set(self.members)
        )
        if survivors == self.members:
            # everyone reported alive: the wedge was a transient (or the
            # watchdog was too tight) — re-form with the same view, which
            # also re-synchronizes state off the lead's checkpoint
            log.warning(
                "elastic: every member reported alive; re-forming the "
                "same view to clear the wedge"
            )
        old = list(self.members)
        plan = {
            "epoch": self.epoch + 1, "members": survivors,
            "reason": "rescue",
        }
        self._plan = plan
        self._count_departed(old, survivors)
        beacon.publish_plan(
            {"epoch": plan["epoch"], "members": plan["members"]}
        )
        self._detach(clean=False)
        self._attach(plan, "rescue")
        self._finish_transition(old, "rescue")
        self._plan = None
        return True

    def _rescue_follower(self, why: str, round_no: int = 0) -> bool:
        client = self.runtime.beacon_client()
        wedge_epoch = self.epoch
        resp = client.request("wedged", self.uid, epoch=wedge_epoch)
        if resp is None:
            # the beacon is ORPHANED: a merely-paused lead's beacon thread
            # still answers, so an unreachable beacon means the lead DIED
            # with it: the survivors elect a successor.
            log.critical(
                "elastic: lockstep wedged (%s) and the lead's beacon is "
                "unreachable — the lead (uid %d) is gone; electing a "
                "successor from the committed view", why, self.lead_uid,
            )
            return self._elect(why, round_no)
        self._adopt_lead(resp, "wedge report")
        # wait for the lead's plan: its grace window + margin
        deadline = time.monotonic() + self._grace_s() + max(
            10.0, self._grace_s()
        )
        while time.monotonic() < deadline:
            hello = client.request("hello", self.uid)
            if hello and hello.get("epoch", -1) > wedge_epoch and not (
                hello.get("member")
            ) and not (hello.get("plan") or {}).get("members"):
                # the group already re-formed without us long ago (a woken
                # paused host missed the whole rescue): park and rejoin
                return self.park()
            plan = (resp or {}).get("plan")
            if plan and plan["epoch"] > wedge_epoch:
                old = list(self.members)
                if self.uid not in plan.get("members", []):
                    # the group moved on without us (we were presumed
                    # dead — e.g. a long GC pause): park and rejoin
                    return self.park()
                self._adopt_lead(plan, "rescue plan")
                plan = dict(plan, reason="rescue")
                self._plan = plan
                self._detach(clean=False)
                self._attach(plan, "rescue")
                self._finish_transition(old, "rescue")
                self._plan = None
                return True
            time.sleep(0.3)
            resp = client.request("wedged", self.uid, epoch=wedge_epoch)
        from ..parallel.elastic import probe_port

        if not probe_port(self.runtime.host, self.runtime.beacon_port):
            # the lead died DURING the window (answered the first wedge
            # report, then went down): the beacon is orphaned now — elect
            log.critical(
                "elastic: the lead's beacon went dark mid-rescue (%s); "
                "electing a successor", why,
            )
            return self._elect(why, round_no)
        log.critical(
            "elastic: no rescue plan from the lead within the window (%s)",
            why,
        )
        return False

    def _elect(self, why: str, round_no: int = 0) -> bool:
        """Lead election over the orphaned beacon port (the lead died; its
        ``os._exit`` released the bind). Deterministic successor rule: the
        candidates are every OTHER member of the committed view ascending
        by uid; each waits rank × stagger while probing the port, then
        races ``take_over_beacon()`` — the OS bind arbitrates, so exactly
        one survivor wins (the lowest LIVE uid, because lower ranks bind
        first and dead candidates never do). The winner runs the normal
        lead rescue (losers' wedge reports land on ITS beacon within the
        grace window); losers re-enter the follower rescue against the
        winner's beacon."""
        if round_no >= ELECT_MAX_ROUNDS:
            log.critical(
                "elastic: %d election rounds exhausted (%s) — every "
                "successor died mid-election; aborting", round_no, why,
            )
            return False
        from ..parallel.elastic import probe_port
        from ..telemetry import blackbox as _blackbox

        candidates = election_candidates(self.members, self.lead_uid)
        if self.uid not in candidates:
            return False  # not in the committed view — nothing to lead
        rank = candidates.index(self.uid)
        stagger = float(
            os.environ.get(ELECT_STAGGER_ENV, "") or ELECT_STAGGER_DEFAULT_S
        )
        _blackbox.record(
            "lead_election", epoch=self.epoch, uid=self.uid, rank=rank,
            candidates=candidates, dead_lead=self.lead_uid, why=why,
        )
        log.warning(
            "elastic: election — uid %d is successor rank %d of %s "
            "(stagger %.1fs)", self.uid, rank, candidates, rank * stagger,
        )
        deadline = time.monotonic() + rank * stagger
        while time.monotonic() < deadline:
            if probe_port(self.runtime.host, self.runtime.beacon_port,
                          timeout_s=0.2):
                # a lower-ranked survivor already owns the beacon: follow
                return self._rescue_follower(why, round_no + 1)
            time.sleep(0.1)
        old_lead = self.lead_uid
        if not self.runtime.take_over_beacon():
            # lost the bind race — the winner's beacon is up; follow it
            return self._rescue_follower(why, round_no + 1)
        self._lead_gauge.set(self.uid)
        self._elections.inc()
        self._handoffs.inc()
        _blackbox.record(
            "lead_elected", epoch=self.epoch, uid=self.uid,
            dead_lead=old_lead, why=why,
        )
        _blackbox.record(
            "beacon_handoff", port=self.runtime.beacon_port,
            from_uid=old_lead, to_uid=self.uid,
        )
        log.critical(
            "elastic: uid %d WON the election (beacon :%d re-bound, "
            "ex-lead uid %d) — coordinating the rescue as the new lead",
            self.uid, self.runtime.beacon_port, old_lead,
        )
        # the losers' probes see the bind within one stagger step; the
        # grace window stretches by the full stagger span so even the
        # highest-ranked live candidate's re-report lands inside it
        self.runtime.beacon.publish("rescuing", self.epoch, self.members)
        return self._rescue_lead(why, extra_grace_s=stagger * len(candidates))
