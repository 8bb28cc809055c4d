"""Half-up rounding, host and tensor versions (counterpart of
``twtml_tpu/utils/rounding.py``).

The reference rounds every reported metric and prediction with BigDecimal
HALF_UP: ties round away from zero (2.5 -> 3, -2.5 -> -3). ``torch.round``
rounds half to even, so the tensor version is written out as
``floor(x + 0.5)`` / ``ceil(x - 0.5)``.
"""

from __future__ import annotations

import decimal


def round_half_up(x: float) -> float:
    """Scalar host-side HALF_UP rounding (ties away from zero), exact on
    values next to a tie (0.49999999999999994 rounds to 0)."""
    return float(
        decimal.Decimal(x).quantize(decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP)
    )


def torch_round_half_up(x):
    """Tensor HALF_UP rounding in the tensor's own float type; like the JAX
    package's device version it can differ from ``round_half_up`` on values
    within float resolution of a tie."""
    import torch

    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
