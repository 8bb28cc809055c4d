"""Streaming k-means with exponential forgetting, single device
(counterpart of ``twtml_tpu/models/kmeans.py``).

MLlib's ``StreamingKMeans``/``StreamingKMeansModel`` as the reference's
k-means entry configures it (setK(3).setHalfLife(5, "batches")
.setRandomCenters(2, 0.0), then a manual ``update(scaled, decayFactor,
timeUnit)`` a batch). The update, as torch ops on the model's device:
  discount = decayFactor               (timeUnit = batches)
           = decayFactor^numPoints     (timeUnit = points)
  n_j ← n_j·discount
  c_j ← (c_j·n_j + Σ_{x→j} x) / (n_j + count_j)
  n_j ← n_j + count_j
with the dying-cluster rule: when the smallest weight falls below 1e-8 of
the largest, the largest is split in two (±1e-14 perturbation) and the
smallest replaced. A batch with no valid row changes nothing (no decay, no
split). Assignment takes a [B, k] squared-distance matrix in its expanded
form (one [B, D]×[D, k] product) and the per-center sums a one-hot product.

The random centers are ``jax.random.normal(PRNGKey(seed), (k, dim))``,
drawn by ``ops/prng.normal`` bit for bit as jax draws them for the app's
(3, 2). The JAX package's data-parallel mesh (k-means across hosts) is ROADMAP
A10c.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import prng
from ..utils.device import resolve_device

BATCHES = "batches"
POINTS = "points"


def sq_dists(points, centers):
    """[B, k] squared distances, expanded: |p|² − 2·p·c + |c|²."""
    return (
        torch.sum(points * points, dim=1, keepdim=True)
        - 2.0 * points @ centers.T
        + torch.sum(centers * centers, dim=1)[None, :]
    )


def update_step(centers, weights, points, mask, decay_factor: float, time_unit: str):
    """One streaming k-means batch update: centers [k, D], weights [k],
    points [B, D], mask [B] -> (new centers, new weights, assignments [B]).
    No host sync."""
    k = centers.shape[0]
    assign = torch.argmin(sq_dists(points, centers), dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype) * mask[:, None]
    counts = torch.sum(onehot, dim=0)
    sums = onehot.T @ points
    num_points = torch.sum(mask)
    decay = torch.full((), decay_factor, dtype=points.dtype, device=points.device)
    discount = decay if time_unit == BATCHES else decay ** num_points
    # an all-padding batch is a state no-op: no decay, no split
    discount = torch.where(num_points > 0, discount, 1.0)

    n = weights * discount
    denom = torch.clamp(n + counts, min=1e-16)
    new_centers = (centers * n[:, None] + sums) / denom[:, None]
    # a center with no mass and no history keeps its position
    new_centers = torch.where((n + counts)[:, None] > 0, new_centers, centers)
    new_weights = n + counts

    # the dying-cluster rule (MLlib StreamingKMeansModel.update's tail)
    largest = torch.argmax(new_weights)
    smallest = torch.argmin(new_weights)
    max_w = new_weights[largest]
    min_w = new_weights[smallest]
    dying = (min_w < 1e-8 * max_w) & (num_points > 0)
    half = (max_w + min_w) / 2.0
    c_large = new_centers[largest]
    p = 1e-14 * torch.clamp(torch.abs(c_large), min=1.0)
    rows = torch.arange(k, device=centers.device)[:, None]
    split_centers = torch.where(rows == largest, c_large + p,
                                torch.where(rows == smallest, c_large - p, new_centers))
    split_weights = torch.where((rows[:, 0] == largest) | (rows[:, 0] == smallest),
                                half, new_weights)
    new_centers = torch.where(dying, split_centers, new_centers)
    new_weights = torch.where(dying, split_weights, new_weights)
    return new_centers, new_weights, assign


class StreamingKMeans:
    """The streaming k-means model on one device (``cuda`` unless the
    caller asks for the CPU): MLlib's builder surface, ``update``,
    ``predict`` and the centers and weights on the host."""

    def __init__(self, k: int = 2, decay_factor: float = 1.0, time_unit: str = BATCHES,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a data-parallel k-means mesh (k-means across hosts) is not ported "
                "(ROADMAP A10c)")
        self.k = k
        self.decay_factor = decay_factor
        self.time_unit = time_unit
        self.device = resolve_device(device)
        self.centers: torch.Tensor | None = None
        self.cluster_weights: torch.Tensor | None = None

    # -- MLlib builder surface -------------------------------------------------
    def set_k(self, k: int) -> "StreamingKMeans":
        self.k = k
        return self

    def set_decay_factor(self, a: float) -> "StreamingKMeans":
        self.decay_factor = a
        return self

    def set_half_life(self, half_life: float, time_unit: str) -> "StreamingKMeans":
        """decayFactor = exp(ln(0.5)/halfLife), as MLlib's setHalfLife."""
        self.decay_factor = math.exp(math.log(0.5) / half_life)
        self.time_unit = time_unit
        return self

    def set_random_centers(self, dim: int, weight: float, seed: int = 0) -> "StreamingKMeans":
        """k centers drawn as ``jax.random.normal(PRNGKey(seed), (k, dim))``,
        on the model's device, each of weight ``weight``."""
        self.centers = prng.normal(prng.prng_key(seed), (self.k, dim), self.device)
        self.cluster_weights = torch.full((self.k,), weight, dtype=torch.float32,
                                          device=self.device)
        return self

    def set_initial_centers(self, centers, weights) -> "StreamingKMeans":
        self.centers = torch.as_tensor(np.asarray(centers, np.float32)).to(self.device)
        self.cluster_weights = torch.as_tensor(np.asarray(weights, np.float32)).to(self.device)
        return self

    # -- streaming update --------------------------------------------------------
    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(np.asarray(points, np.float32)).to(self.device)

    def update_device(self, points, mask=None) -> torch.Tensor:
        """One batch update from host or device ``points`` [B, D] (``mask``
        [B], all valid when None); returns the assignments [B] on the
        device, nothing waited for."""
        if self.centers is None:
            raise ValueError("call set_random_centers or set_initial_centers first")
        points = points if isinstance(points, torch.Tensor) else self._points(points)
        if mask is None:
            mask = torch.ones((points.shape[0],), dtype=torch.float32, device=self.device)
        elif not isinstance(mask, torch.Tensor):
            mask = self._points(mask)
        self.centers, self.cluster_weights, assign = update_step(
            self.centers, self.cluster_weights, points, mask, self.decay_factor,
            self.time_unit)
        return assign

    def update(self, points, mask=None) -> np.ndarray:
        """One batch update; returns the per-point assignments on the host."""
        return self.update_device(points, mask).cpu().numpy()

    def predict(self, points) -> np.ndarray:
        """The nearest center of each point, on the host."""
        points = points if isinstance(points, torch.Tensor) else self._points(points)
        return torch.argmin(sq_dists(points, self.centers), dim=1).cpu().numpy()

    @property
    def latest_centers(self) -> np.ndarray:
        return self.centers.cpu().numpy()

    @property
    def latest_weights(self) -> np.ndarray:
        """The clusters' decayed weights on the host."""
        return self.cluster_weights.cpu().numpy()
