"""Weights between the JAX package's models and the port's.

Both packages keep the linear learners' state as one float32 vector of
``numTextFeatures + 4`` weights (hashed text dims, then the 4 numeric dims),
so a JAX model's ``latest_weights`` can seed the port's model through
``set_initial_weights``, and the reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .features.batch import NUM_NUMBER_FEATURES
from .utils.device import resolve_device


def _check(shape, dtype_ok: bool, num_text_features: int) -> None:
    want = (num_text_features + NUM_NUMBER_FEATURES,)
    if tuple(shape) != want:
        raise ValueError(f"weights must have shape {want}, got {tuple(shape)}")
    if not dtype_ok:
        raise TypeError("weights must be float32")


def weights_from_jax(
    weights: np.ndarray, num_text_features: int = 1000, device="cuda"
) -> torch.Tensor:
    """A JAX model's ``latest_weights`` as a float32 tensor on ``device``."""
    arr = np.asarray(weights)
    _check(arr.shape, arr.dtype == np.float32, num_text_features)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def weights_to_numpy(weights: torch.Tensor, num_text_features: int = 1000) -> np.ndarray:
    """The port's weights as the float32 numpy vector the JAX package's
    ``set_initial_weights`` takes."""
    _check(weights.shape, weights.dtype == torch.float32, num_text_features)
    return weights.detach().cpu().numpy().copy()
