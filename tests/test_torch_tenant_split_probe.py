"""The timing probe of the split with a tenant grid (``csrc/fused_sgd.cu``
``tenant_iteration_kernel``'s kProbe instantiation) on the CPU: its phase
split on made-up stamps, and its refusals before any work."""

import numpy as np
import pytest
import torch

from twtml_tpu_torch.ops import fused_sgd


def _stamps(ns_a_cycle, cycles, launches=3, slots=5, stamped=(0, 2, 4)):
    """Made-up stamps of ``launches`` probe launches: the ``stamped`` slots'
    edges at ``cycles`` cycles apart (slot s's phases s + 1 times as long),
    each launch on its own clock64 origin, the globaltimer at ``ns_a_cycle``
    with a coarse 32 ns tick."""
    st = torch.zeros((launches, slots, fused_sgd.PROBE_SPLIT_EDGES, 2), dtype=torch.int64)
    for launch in range(launches):
        for s in stamped:
            c = torch.tensor(np.cumsum(cycles) * (s + 1) + 10**6 * (launch + 1),
                             dtype=torch.int64)
            st[launch, s, :, 1] = c
            st[launch, s, :, 0] = (c.double() * ns_a_cycle).long() // 32 * 32 + 10**12
    return st


@pytest.mark.parametrize("stamped", [(0,), (0, 2, 4), (0, 1, 2, 3, 4)],
                         ids=["cta0_only", "cta0_and_two_tenants", "every_slot"])
def test_the_split_probe_times_each_phase_at_one_pooled_clock_rate(stamped):
    """Each stamping CTA's cycles between its edges, at the rate of all the
    launches' globaltimer spans over their cycle spans, averaged over the
    launches and CTAs; a slot no CTA stamped, or a launch cut short, counts
    nothing."""
    cycles = [0, 300, 400, 500, 2000, 400, 600]  # entry, then each phase's cycles
    st = _stamps(0.5, cycles, stamped=stamped)
    phases, launches, span, by_slot = fused_sgd.tenant_split_probe_split(st)
    assert list(phases) == list(fused_sgd.PROBE_SPLIT_PHASES)
    assert launches == 3
    whole = st.reshape(-1, fused_sgd.PROBE_SPLIT_EDGES, 2).double()
    whole = whole[(whole[..., 0] != 0).all(dim=1)]
    g, c = whole[..., 0], whole[..., 1]
    rate = float((g[:, -1] - g[:, 0]).sum() / (c[:, -1] - c[:, 0]).sum())
    assert rate == pytest.approx(0.5, rel=1e-2)  # the 32 ns tick over spans of 2-11 µs
    scale = np.mean([s + 1 for s in stamped])  # slot s stamps s + 1 times the cycles
    for got, want in zip(phases.values(), cycles[1:]):
        assert got == pytest.approx(want * scale * rate / 1e3, rel=1e-9)
    assert span == pytest.approx(sum(cycles) * scale * rate / 1e3, rel=1e-9)
    assert sorted(by_slot) == list(stamped)  # CTA 0's, and tenants' last CTAs
    for slot, split in by_slot.items():
        for got, want in zip(split.values(), cycles[1:]):
            assert got == pytest.approx(want * (slot + 1) * rate / 1e3, rel=1e-9)
    # the last launch returned before its reduce: its stamps past the row pass are 0
    st[-1, :, 5:] = 0
    assert fused_sgd.tenant_split_probe_split(st)[1] == 2
    assert fused_sgd.tenant_split_probe_split(torch.zeros_like(st)) == ({}, 0, None, {})


@pytest.mark.parametrize("shape,match", [((33, 4, 8), "1..32 tenants in one launch"),
                                         ((0, 4, 8), "1..32 tenants in one launch"),
                                         ((4, 8), "1..32 tenants in one launch"),
                                         ((2, 4, 8), "on the card")],
                         ids=["33", "none", "2d", "cpu"])
def test_the_split_probe_takes_one_launch_of_tenants_on_the_card(shape, match):
    """The timing instantiation stamps one launch of 1..TENANTS_PER_LAUNCH
    tenants, on the card only: refused before any work."""
    x = torch.zeros(shape)
    m = shape[0] if len(shape) == 3 else 1
    with pytest.raises(ValueError, match=match):
        fused_sgd.tenant_split_probe(x, None, None, None, valid_rows=[1] * m,
                                     step_sizes=[0.1] * m, l2_regs=[0.0] * m)
