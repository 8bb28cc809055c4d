"""The port's freshness plane (``twtml_tpu_torch/telemetry/freshness.py``,
``lineage.py``, the stage clock of ``sideband.py``) against the JAX
package's: with the clock pinned (``TWTML_NOW_MS``) and the same stage
timings, both give the same verdicts, views and checkpoint stamps; the
lineage FIFOs pair records with deliveries in dispatch order; and the app
posts a Freshness view with the JAX app's keys."""

from types import SimpleNamespace

import pytest

from twtml_tpu.telemetry import freshness as jax_freshness
from twtml_tpu.telemetry import lineage as jax_lineage
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry import sideband as jax_sideband
from twtml_tpu_torch.telemetry import freshness, lineage, sideband
from twtml_tpu_torch.telemetry import metrics as _metrics

BASE_MS = 1_785_320_000_000


@pytest.fixture(autouse=True)
def fresh():
    for mod in (freshness, jax_freshness):
        mod.reset_for_tests()
    sideband.reset_for_tests()
    jax_sideband.reset_for_tests()
    _metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    yield
    for mod in (freshness, jax_freshness):
        mod.reset_for_tests()
    sideband.reset_for_tests()
    jax_sideband.reset_for_tests()


SIDES = ((freshness, lineage, sideband), (jax_freshness, jax_lineage, jax_sideband))


def _batch(i):
    """Statuses of batch ``i``: created 40-10 s before the base clock, one
    with an unknown time."""
    return [SimpleNamespace(created_at_ms=BASE_MS - 40_000 + 500 * i + d)
            for d in (0, 1_000, 30_000)] + [SimpleNamespace(created_at_ms=0)]


def _drive(monkeypatch, slo_ms=0.0, window=4, n=12, depth=3):
    """Both planes through the same seams: open, stage timings, dispatch up
    to ``depth`` in flight, deliver in order, publish every 4th delivery;
    returns each side's verdicts."""
    for fr, _, _ in SIDES:
        fr.configure(on=True, slo_ms=slo_ms, window=window)
    verdicts = ([], [])
    inflight = 0
    for i in range(n):
        monkeypatch.setenv("TWTML_NOW_MS", str(BASE_MS + 1_000 * i))
        for fr, lin, sb in SIDES:
            lin.open_batch(_batch(i))
            sb.record_stage("featurize", 0.002 * (1 + i % 3))
            sb.record_stage("wire_pack", 0.0005)
            sb.record_stage("dispatch", 0.001 * (i % 5))
            lin.mark_dispatch()
        inflight += 1
        while inflight >= depth or (i == n - 1 and inflight):
            monkeypatch.setenv("TWTML_NOW_MS", str(BASE_MS + 1_000 * i + 250 * inflight))
            for side, (fr, _, sb) in enumerate(SIDES):
                sb.record_stage("fetch", 0.003 * inflight)
                verdicts[side].append(fr.record_delivery())
                if len(verdicts[side]) % 4 == 0:
                    fr.record_publish()
            inflight -= 1
    return verdicts


@pytest.mark.parametrize("slo_ms", [0.0, 12_000.0, 60_000.0])
def test_verdicts_views_and_stamps_equal_the_jax_planes(monkeypatch, slo_ms):
    ours, theirs = _drive(monkeypatch, slo_ms=slo_ms)
    assert ours == theirs and len(ours) == 12 and all(v is not None for v in ours)
    assert freshness.last_freshness() == jax_freshness.last_freshness()
    assert freshness.snapshot_for_checkpoint() == jax_freshness.snapshot_for_checkpoint()
    assert freshness.last_event_lag_ms() == jax_freshness.last_event_lag_ms()
    ours_g = _metrics.get_registry().snapshot()["gauges"]
    theirs_g = jax_metrics.get_registry().snapshot()["gauges"]
    assert {k: v for k, v in ours_g.items() if k.startswith("freshness.")} == {
        k: v for k, v in theirs_g.items() if k.startswith("freshness.")}


def test_a_sustained_breach_is_one_episode(monkeypatch):
    ours, _ = _drive(monkeypatch, slo_ms=12_000.0, window=4)
    assert sum(v["sustained"] for v in ours) == 1
    assert _metrics.get_registry().counter("freshness.slo_breaches").snapshot() == 1
    assert freshness.last_freshness()["breaches"] == 1


def test_lineage_pairs_deliveries_in_dispatch_order(monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", str(BASE_MS))
    lineage.configure(True)
    for i in range(3):
        lineage.open_batch(_batch(i))
    lineage.drop_newest()  # the third batch was shed before dispatch
    lineage.mark_dispatch(2)
    lineage.mark_dispatch()  # a dispatch with nothing open: a blank
    assert lineage.depths() == (0, 3)
    first, second = lineage.pop_delivery(), lineage.pop_delivery()
    assert (first["event_min_ms"], second["event_min_ms"]) == (
        BASE_MS - 40_000, BASE_MS - 39_500)
    assert first["rows"] == 4 and lineage.pop_delivery() is None
    assert lineage.depths() == (0, 0)


def test_off_touches_nothing(monkeypatch):
    freshness.configure(on=False)
    lineage.open_batch(_batch(0))
    lineage.mark_dispatch()
    assert lineage.depths() == (0, 0)
    assert freshness.record_delivery() is None and freshness.last_freshness() is None


def test_configure_reads_the_flags():
    from twtml_tpu_torch.config import ConfArguments

    freshness.configure(ConfArguments().parse(["--freshnessSloMs", "250"]))
    assert freshness.enabled() and freshness.get_plane().slo_ms == 250.0
    freshness.configure(ConfArguments().parse(["--freshness", "off"]))
    assert not freshness.enabled() and not lineage.enabled()


def test_stage_clock_accumulates_and_turns_off():
    sideband.record_stage("fetch", 0.5)
    sideband.record_stage("fetch", 0.25)
    assert sideband.stage_seconds() == {"fetch": 0.75}
    sideband.set_stage_clock(False)
    sideband.record_stage("fetch", 1.0)
    assert sideband.stage_seconds() == {"fetch": 0.75}
