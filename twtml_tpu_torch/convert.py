"""Model state between the JAX package's models and the port's.

Both packages keep the SGD learners' state as one float32 vector of
``numTextFeatures + 4`` weights (hashed text dims, then the 4 numeric dims):
the linear and the logistic learner alike, since the logistic one differs
only in its gradient and its predictions, never in its state. A JAX model's
``latest_weights`` seeds the port's model through ``set_initial_weights``,
and the reverse. The tenant plane (``--tenants M``) stacks M such vectors
into one [M, F+4] array in both packages, which moves the same way.

Streaming k-means keeps centers [k, D] and cluster weights [k], float32, in
both packages (the JAX model's ``latest_centers`` and ``cluster_weights``);
``kmeans_from_jax`` and ``kmeans_to_numpy`` move them either way.
"""

from __future__ import annotations

import numpy as np
import torch

from .features.batch import NUM_NUMBER_FEATURES
from .utils.device import resolve_device


def _check(shape, dtype_ok: bool, num_text_features: int) -> None:
    width = num_text_features + NUM_NUMBER_FEATURES
    if tuple(shape[-1:]) != (width,) or len(shape) not in (1, 2):
        raise ValueError(f"weights must have shape ({width},) or a tenant stack's "
                         f"(M, {width}), got {tuple(shape)}")
    if not dtype_ok:
        raise TypeError("weights must be float32")


def weights_from_jax(
    weights: np.ndarray, num_text_features: int = 1000, device="cuda"
) -> torch.Tensor:
    """A JAX model's ``latest_weights`` ([F+4], or a tenant stack's [M, F+4])
    as a float32 tensor on ``device``."""
    arr = np.asarray(weights)
    _check(arr.shape, arr.dtype == np.float32, num_text_features)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def weights_to_numpy(weights: torch.Tensor, num_text_features: int = 1000) -> np.ndarray:
    """The port's weights ([F+4], or a tenant stack's [M, F+4]) as the
    float32 numpy array the JAX package's ``set_initial_weights`` takes."""
    _check(weights.shape, weights.dtype == torch.float32, num_text_features)
    return weights.detach().cpu().numpy().copy()


def kmeans_from_jax(centers: np.ndarray, weights: np.ndarray, device="cuda"):
    """A JAX k-means model's centers [k, D] and weights [k] (float32) as
    tensors on ``device``, for ``StreamingKMeans.set_initial_centers`` or
    direct use."""
    c, w = np.asarray(centers), np.asarray(weights)
    if c.ndim != 2 or w.shape != (c.shape[0],):
        raise ValueError(f"centers must be [k, D] and weights [k], got {c.shape} and {w.shape}")
    if c.dtype != np.float32 or w.dtype != np.float32:
        raise TypeError("k-means centers and weights must be float32")
    dev = resolve_device(device)
    return torch.from_numpy(c.copy()).to(dev), torch.from_numpy(w.copy()).to(dev)


def kmeans_to_numpy(centers: torch.Tensor, weights: torch.Tensor):
    """The port's k-means centers and weights as the float32 numpy arrays
    the JAX package's ``set_initial_centers`` takes."""
    if centers.dim() != 2 or tuple(weights.shape) != (centers.shape[0],):
        raise ValueError(f"centers must be [k, D] and weights [k], got "
                         f"{tuple(centers.shape)} and {tuple(weights.shape)}")
    if centers.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("k-means centers and weights must be float32")
    return centers.detach().cpu().numpy().copy(), weights.detach().cpu().numpy().copy()
