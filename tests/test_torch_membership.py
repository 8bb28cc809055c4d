"""The port's elastic membership plane against the JAX package's, case by case
(the cases of tests/test_membership.py): each scenario runs once through
each package, on the same stub runtime and the same gathered float64
matrices, and records what the plane decided (actions, the columns it
publishes, proposals, views, election order, transitions, counters and
gauges) and what the helpers give (view masks, beacon port arithmetic, the
peer chaos grammar, the elastic flags). Plain integer decisions, so the two
records must be EQUAL."""

from __future__ import annotations

import types

import numpy as np
import pytest

import twtml_tpu.config as jax_config
import twtml_tpu.parallel.elastic as jax_elastic
import twtml_tpu.streaming.faults as jax_faults
import twtml_tpu.streaming.membership as jax_membership
import twtml_tpu.telemetry.metrics as jax_metrics
import twtml_tpu.telemetry.sideband as jax_sideband
import twtml_tpu_torch.config as torch_config
import twtml_tpu_torch.parallel.elastic as torch_elastic
import twtml_tpu_torch.streaming.faults as torch_faults
import twtml_tpu_torch.streaming.membership as torch_membership
import twtml_tpu_torch.telemetry.metrics as torch_metrics
import twtml_tpu_torch.telemetry.sideband as torch_sideband

JAX = types.SimpleNamespace(ms=jax_membership, el=jax_elastic, sb=jax_sideband,
                            metrics=jax_metrics, faults=jax_faults, config=jax_config)
PORT = types.SimpleNamespace(ms=torch_membership, el=torch_elastic, sb=torch_sideband,
                             metrics=torch_metrics, faults=torch_faults, config=torch_config)

ELASTIC_COUNTERS = ("elastic.reforms", "elastic.hosts_departed", "elastic.hosts_rejoined",
                    "elastic.rows_lost_estimate", "elastic.elections",
                    "elastic.lead_handoffs")
ELASTIC_GAUGES = ("elastic.epoch", "elastic.live_hosts", "elastic.lead_uid")


class _StubRuntime:
    """The duck-typed ElasticRuntime of tests/test_membership.py."""

    def __init__(self, uid: int, epoch: int = 0, members=(0, 1, 2)):
        self.uid = uid
        self.epoch = epoch
        self.members = list(members)
        self.beacon = None
        self.lead_uid = 0

    def set_lead(self, uid: int) -> None:
        self.lead_uid = int(uid)


def _plane(pk, uid, transitions, members=(0, 1, 2), **kw):
    rt = _StubRuntime(uid, members=members)

    def detach(clean):
        transitions.append((uid, "detach", clean))

    def attach(plan, reason):
        transitions.append((uid, "attach", plan["epoch"], reason))
        rt.epoch = plan["epoch"]
        rt.members = list(plan["members"])

    return pk.ms.MembershipPlane(rt, detach, attach, **kw)


def _registry(pk) -> dict:
    snap = pk.metrics.get_registry().snapshot()
    return {"counters": {k: snap["counters"].get(k) for k in ELASTIC_COUNTERS},
            "gauges": {k: snap["gauges"].get(k) for k in ELASTIC_GAUGES}}


def _gather(planes) -> np.ndarray:
    """The gathered membership block every host ingests: each plane's
    columns, as float64 (the all-gather's dtype), in pid order."""
    return np.stack([p.pre_tick() for p in planes]).astype(np.float64)


# ---- the scenarios: each returns what one package decided ---------------------

def view_masks(pk):
    out = [pk.el.uids_from_mask(pk.el.mask_from_uids([0, 1, 5])), pk.el.uids_from_mask(0),
           pk.el.mask_from_uids([]), pk.el.mask_from_uids(range(52))]
    with pytest.raises(ValueError):
        pk.el.mask_from_uids([52])
    return out


def steady_state(pk):
    transitions: list = []
    planes = [_plane(pk, u, transitions) for u in range(3)]
    rows = _gather(planes)
    actions = [p.ingest(rows.astype(np.int64)) for p in planes]
    return [rows.tolist(), actions, transitions, _gather(planes).tolist()]


def eviction_dance(pk):
    transitions: list = []
    planes = [_plane(pk, u, transitions, evict_ticks=2, evict_skew_ms=100.0) for u in range(3)]
    pk.sb.publish_hosts({"hosts": [], "straggler": 1, "stage": "upload", "skew_ms": 400.0})
    record = []
    for _tick in range(3):
        rows = _gather(planes)
        record.append((rows.tolist(), [p.ingest(rows.astype(np.int64)) for p in planes]))
    for p in (planes[0], planes[2]):
        p.execute_reform()
    record.append((transitions, [p.members for p in planes], [p.epoch for p in planes]))
    return record


def lead_not_self_evicted(pk):
    lead = _plane(pk, 0, [], evict_ticks=1, evict_skew_ms=100.0)
    pk.sb.publish_hosts({"hosts": [], "straggler": 0, "stage": "fetch", "skew_ms": 900.0})
    rows = lead.pre_tick()[None, :]
    return [rows.tolist(), lead.ingest(rows.astype(np.int64))]


def consecutive_ticks(pk):
    lead = _plane(pk, 0, [], evict_ticks=3, evict_skew_ms=100.0)
    out = []
    for straggler in (1, 2, 1, 1, 1):  # alternating hosts reset the run
        pk.sb.publish_hosts({"hosts": [], "straggler": straggler, "stage": "upload",
                             "skew_ms": 500.0})
        out.append(lead.pre_tick().tolist())
    return out


def low_skew(pk):
    lead = _plane(pk, 0, [], evict_ticks=1, evict_skew_ms=250.0)
    pk.sb.publish_hosts({"hosts": [], "straggler": 1, "stage": "upload", "skew_ms": 50.0})
    return lead.pre_tick().tolist()


def election_order(pk):
    return [pk.ms.election_candidates(m, lead) for m, lead in (
        ([0, 1, 2, 3], 0), ([4, 2, 7], 2), ([0, 1, 2], 0), ([3, 5], 0))]


def ex_lead_demoted(pk):
    rt = _StubRuntime(0)
    rt.lead_uid = 2
    plane = pk.ms.MembershipPlane(rt, lambda clean: None, lambda plan, reason: None)
    return [plane.lead_uid, plane.lead, plane.pre_tick().tolist()]


def adopt_lead(pk):
    plane = _plane(pk, 2, [])
    out = []
    for resp in ({"lead_uid": 1}, {"lead_uid": 2}, {}, {"lead_uid": 2}, None):
        plane._adopt_lead(resp, "wedge report")
        out.append((plane.runtime.lead_uid, plane.lead_uid, plane.lead))
    return [out, _registry(pk)]


def elected_lead_row(pk):
    transitions: list = []
    planes = [_plane(pk, u, transitions, evict_ticks=1, evict_skew_ms=100.0) for u in range(3)]
    for p in planes:
        p.runtime.set_lead(1)
    pk.sb.publish_hosts({"hosts": [], "straggler": 2, "stage": "upload", "skew_ms": 500.0})
    record = []
    for _tick in range(2):
        rows = _gather(planes)
        record.append((rows.tolist(), [p.ingest(rows.astype(np.int64)) for p in planes]))
    return record


def elected_lead_not_evicted(pk):
    plane = _plane(pk, 1, [], evict_ticks=1, evict_skew_ms=100.0)
    plane.runtime.set_lead(1)
    pk.sb.publish_hosts({"hosts": [], "straggler": 1, "stage": "fetch", "skew_ms": 900.0})
    return plane.pre_tick().tolist()


def beacon_ports(pk):
    rt = object.__new__(pk.el.ElasticRuntime)
    rt.base_port = 9000
    return [rt.beacon_port, [rt.port_for(e) for e in range(52)], pk.el.BEACON_OFFSET,
            pk.el.EPOCH_PORT_OFFSET]


def _rule(rule):
    return (rule.target, rule.kind, rule.mode, rule.param, rule.value, rule.uid, repr(rule))


def chaos_grammar(pk):
    return [[_rule(r) for rs in pk.faults.ChaosInjector(spec)._rules.values() for r in rs]
            for spec in ("peer.kill:tick=7", "peer.pause:ticks=3@5", "peer.kill",
                         "peer.kill:tick=2")]


def chaos_uid_selector(pk):
    out = []
    for spec in ("peer.kill:uid=0:tick=4", "peer.pause:ticks=2:uid=5@3", "peer.kill"):
        (rule,) = [r for rs in pk.faults.ChaosInjector(spec)._rules.values() for r in rs]
        out.append((_rule(rule), [rule.on_host(u) for u in (0, 3, 5, 7)]))
    return out


def kill_only_on_target(pk, monkeypatch):
    import os

    deaths: list = []
    inj = pk.faults.ChaosInjector("peer.kill:uid=1:tick=2")
    monkeypatch.setattr(os, "_exit", lambda c: deaths.append(c))
    for tick, uid in ((1, 1), (2, 0), (2, 1), (3, 1)):
        inj.peer_chaos(tick, 0.0, uid=uid)
        deaths.append(("after", tick, uid))
    return deaths


def pause_rng_identical(pk, monkeypatch):
    def draws(uid):
        inj = pk.faults.ChaosInjector(
            "peer.pause:uid=3:ticks=1@p0.5,peer.pause:ticks=1@p0.5,seed=9")
        naps: list = []
        monkeypatch.setattr(pk.faults.time, "sleep", naps.append)
        for tick in range(1, 40):
            inj.peer_chaos(tick, 0.0, uid=uid)
        return naps, inj._rng.random()

    return [draws(uid) for uid in (0, 3, 11)]


def malformed(pk, spec):
    with pytest.raises(ValueError) as info:
        pk.faults.ChaosInjector(spec)
    return str(info.value)


def pause_at_trigger(pk, monkeypatch):
    naps: list = []
    monkeypatch.setattr(pk.faults.time, "sleep", naps.append)
    inj = pk.faults.ChaosInjector("peer.pause:ticks=4@3")
    out = []
    for tick in range(1, 8):
        inj.peer_chaos(tick, 0.0)
        out.append(list(naps))
    return out


def kill_exit_code(pk):
    return pk.faults.PEER_KILL_EXIT_CODE


def elastic_flags(pk):
    conf = pk.config.ConfArguments().parse([
        "--elastic", "on", "--elasticEvictTicks", "4", "--elasticEvictSkewMs", "300",
        "--elasticRejoin", "off"])
    with pytest.raises(SystemExit):
        pk.config.ConfArguments().parse(["--elastic", "maybe"])
    return [conf.elastic, conf.elasticEvictTicks, conf.elasticEvictSkewMs, conf.elasticRejoin]


def knobs(pk):
    return [pk.ms.FIELDS, pk.ms.WIDTH, pk.ms.REASON_NAMES, pk.ms.RESCUE_GRACE_ENV,
            pk.ms.RESCUE_GRACE_DEFAULT_S, pk.ms.PARK_TIMEOUT_ENV, pk.ms.PARK_TIMEOUT_DEFAULT_S,
            pk.ms.JOIN_FRESH_S, pk.ms.ELECT_STAGGER_ENV, pk.ms.ELECT_STAGGER_DEFAULT_S,
            pk.ms.ELECT_MAX_ROUNDS]


SCENARIOS = {
    "view_mask_roundtrip_and_ceiling": view_masks,
    "steady_state_columns_are_inert": steady_state,
    "straggler_eviction_two_tick_dance_commits_simultaneously": eviction_dance,
    "lead_is_never_self_evicted": lead_not_self_evicted,
    "eviction_requires_consecutive_ticks": consecutive_ticks,
    "low_skew_never_proposes": low_skew,
    "election_candidates_successor_ordering": election_order,
    "ex_lead_rejoin_is_demoted_to_follower": ex_lead_demoted,
    "adopt_lead_handoff_updates_runtime_and_counts": adopt_lead,
    "ingest_reads_proposal_from_elected_lead_row": elected_lead_row,
    "elected_lead_is_never_self_evicted": elected_lead_not_evicted,
    "beacon_port_handoff_arithmetic": beacon_ports,
    "peer_chaos_grammar_parses": chaos_grammar,
    "peer_chaos_uid_selector_parses_and_filters": chaos_uid_selector,
    "peer_kill_exit_code_is_distinct": kill_exit_code,
    "config_elastic_flags_parse": elastic_flags,
    "membership_columns_and_knobs": knobs,
}
WITH_MONKEYPATCH = {
    "peer_kill_uid_selector_only_fires_on_target": kill_only_on_target,
    "peer_pause_uid_filter_keeps_rng_draws_fleet_identical": pause_rng_identical,
    "peer_pause_sleeps_at_its_trigger": pause_at_trigger,
}
MALFORMED = ["peer.kill:ticks=3", "peer.kill:tick=0", "peer.pause:tick=3",
             "peer.pause:ticks=0", "peer.kill:delay=2"]


@pytest.fixture(autouse=True)
def _fresh_state():
    for pk in (JAX, PORT):
        pk.sb.reset_for_tests()
        pk.metrics.reset_for_tests()
    yield
    for pk in (JAX, PORT):
        pk.sb.reset_for_tests()


def _both(fn, *args):
    """``fn`` through the JAX package, then the port, from the same fresh
    state."""
    out = []
    for pk in (JAX, PORT):
        pk.sb.reset_for_tests()
        pk.metrics.reset_for_tests()
        out.append(fn(pk, *args))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_decides_as_the_jax_package(name):
    theirs, ours = _both(SCENARIOS[name])
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(WITH_MONKEYPATCH))
def test_the_port_injects_peer_chaos_as_the_jax_package(name, monkeypatch):
    theirs, ours = _both(WITH_MONKEYPATCH[name], monkeypatch)
    assert ours == theirs


@pytest.mark.parametrize("spec", MALFORMED)
def test_the_port_refuses_malformed_peer_chaos_as_the_jax_package(spec):
    theirs, ours = _both(malformed, spec)
    assert ours == theirs


def test_a_committed_eviction_reaches_the_same_transitions_and_registry():
    """The eviction dance to its commit on each host of both packages: the
    same detach/attach calls, views, epochs and elastic counters and
    gauges (the plane's dashboard fields)."""
    def run(pk):
        transitions: list = []
        planes = [_plane(pk, u, transitions, evict_ticks=1, evict_skew_ms=100.0)
                  for u in range(3)]
        pk.sb.publish_hosts({"hosts": [{"host": 1, "queue_rows": 7}], "straggler": 1,
                             "stage": "upload", "skew_ms": 400.0})
        for _tick in range(2):
            rows = _gather(planes).astype(np.int64)
            actions = [p.ingest(rows) for p in planes]
        for p, a in zip(planes, actions):
            if a == "reform":
                p.execute_reform()
        return [actions, transitions, [p.members for p in planes], _registry(pk)]

    theirs, ours = _both(run)
    assert ours == theirs
    assert ours[0] == ["reform", "parked", "reform"]
