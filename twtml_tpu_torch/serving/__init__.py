"""Serving plane of the port (counterpart of ``twtml_tpu/serving``): batched,
pipelined inference from verified snapshots on the card.

- ``snapshot`` — verified-checkpoint snapshots, the one promotion predicate
                 (finite, quality level ``ok`` or ``warn``) and the promoter;
- ``engine``   — the predict-only program: the learner's train step built
                 with zero iterations, so served predictions are bitwise the
                 train step's pre-update predictions (on the dense route one
                 launch of the fused kernel in its predict-only mode);
- ``plane``    — the bounded-latency coalescer and the depth-K pipelined
                 fetches of ``apps/common.FetchPipeline``;
- ``client``   — the HTTP client of ``POST /api/predict``;
- ``fleet``    — the read-fleet router: least-p99 or consistent-hash routing
                 over N serve replicas, health checks, ejection.

``snapshot``, ``client`` and ``fleet`` import no torch (the router holds
no model); ``ServingPlane`` loads the model layer when first asked for.
The JAX package's champion/challenger A/B serving needs the tenant plane
(ROADMAP A9) and is not here.
"""

from __future__ import annotations

from .client import ServingClient
from .fleet import FleetRouter
from .snapshot import ServingSnapshot, SnapshotPromoter, is_promotable, load_servable

__all__ = [
    "FleetRouter",
    "ServingClient",
    "ServingPlane",
    "ServingSnapshot",
    "SnapshotPromoter",
    "is_promotable",
    "load_servable",
]

_LAZY = {"ServingPlane": ("plane", "ServingPlane")}  # loads the model layer


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is not None:
        import importlib

        module = importlib.import_module(f".{target[0]}", __name__)
        return getattr(module, target[1])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
