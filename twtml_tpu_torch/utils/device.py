"""Device selection for the port's entry points: ``cuda`` unless the caller
asks for ``cpu``, and never a quiet fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``).

    Raises when CUDA is asked for and is not available. Also pins float32
    products to full float32: TF32 keeps about three decimal digits, and
    the JAX package's reference products are full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested (--backend cuda is the default) "
                "but torch.cuda.is_available() is False; use --backend cpu "
                "(device='cpu') to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
