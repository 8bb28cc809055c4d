"""The tenant plane: M stacked learners on one wire with one fetch a tick
(counterpart of ``twtml_tpu/parallel/tenants.py``).

One global retweet model becomes M (per topic, per language, per A/B arm)
without M pipelines: the M models share the host batch, its wire, its H2D
copy and ONE device-to-host fetch a tick, so a tenant more costs device
work, not a round trip.

- **weights**: one [M, F+4] tensor on the model's device; each tenant's
  step size and L2 are its own (``step_sizes``, ``l2_regs``).
- **the step**: tenant m runs the learner's train step
  (``models/sgd.make_sgd_train_step``, built with that tenant's step size
  and L2) on its part of the wire, with its own row of the stack: the JAX
  package's ``lax.map`` with no carry. On the dense float32 route each
  tenant's step is one launch of B1 (``ops/fused_sgd.py``) at the batch's
  padded B, so a tick launches B1 M times. Tenant m's weights, predictions
  and stats are bitwise a standalone learner's stepped on m's rows.
- **the wire**: the rows route on the host by a deterministic key
  (``features/batch.tenant_route_keys``) into M batches of the batch's
  padded shape (a dry tenant gets all padding), carried as the superbatch
  wire with K = M: ``stack_batches`` (``--wirePack stacked``) or one
  ``pack_ragged_group`` buffer (``--wirePack group``, the ragged wire), one
  ``batch_to_device``.
- **the fetch**: the tick's outputs stack into ONE [M]-leading StepOutput,
  fetched with ``models/sgd.fetch_output`` as a superbatch group is: one
  D2H copy a tick. Delivery (apps/common.py) records the per-tenant view
  and aggregates the tick into one batch-level StepOutput
  (``aggregate_tenant_output``) for the chain that predates tenants.

Not here: a mesh and ``MultiHostTenantModel`` (the tenant plane across
devices and hosts, ROADMAP A10b), and ``mapping="vmap"``, whose Hopper form is B1 with a tenant
grid dimension (ROADMAP B10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.batch import (
    NUM_NUMBER_FEATURES,
    PackedBatch,
    RaggedUnitBatch,
    pack_ragged_group,
    split_batch_tenants,
    stack_batches,
    tenant_route_keys,
    tenant_rows,
    unpack_batch,
)
from ..models.base import StepOutput
from ..models.sgd import (
    _batch_at,
    _stack_outputs,
    batch_to_device,
    fetch_output,
    host_planes,
    make_sgd_train_step,
)
from ..utils import get_logger
from ..utils.device import resolve_device

log = get_logger("parallel.tenants")


def aggregate_tenant_output(out, batch, model) -> StepOutput:
    """A delivered [M]-leading host StepOutput as ONE batch-level StepOutput
    in the original batch's row order, for the handler, sentinel and
    session chain. Host numpy on the fetched arrays.

    M = 1 passes tenant 0's output through untouched. M > 1: ``count``
    sums; ``mse`` is the row-weighted mean of the tenants' mses; the
    stdevs are the row-weighted pooled within-tenant stdevs; the
    predictions go back to the original rows by the recomputed route; the
    quality is None (M models' norms do not pool; the model watch reads the
    [M, Q] leaf before this). A non-finite stat in any tenant reaches the
    aggregate, so the divergence sentinel sees every poisoning."""
    m = model.num_tenants
    if m == 1:
        return StepOutput(*(None if f is None else f[0] for f in out))
    counts = np.asarray(out.count, np.float64)
    total = float(counts.sum())
    denom = max(total, 1.0)
    mse = float((counts * np.asarray(out.mse, np.float64)).sum() / denom)
    real_sd = float(np.sqrt(
        (counts * np.square(np.asarray(out.real_stdev, np.float64))).sum() / denom))
    pred_sd = float(np.sqrt(
        (counts * np.square(np.asarray(out.pred_stdev, np.float64))).sum() / denom))
    preds = None
    if out.predictions is not None:
        tenant_preds = np.asarray(out.predictions)
        preds = np.zeros(tenant_preds.shape[1:], tenant_preds.dtype)
        for i, rows in enumerate(tenant_rows(batch, model.route_ids(batch), m)):
            preds[rows] = tenant_preds[i][: rows.shape[0]]
    return StepOutput(
        predictions=preds, count=np.float32(total), mse=np.float32(mse),
        real_stdev=np.float32(real_sd), pred_stdev=np.float32(pred_sd),
    )


def split_tenant_output(out: StepOutput, num_tenants: int) -> list:
    """The [M]-leading StepOutput as M per-tenant ones (views, no copy)."""
    return [StepOutput(*(None if f is None else f[m] for f in out))
            for m in range(num_tenants)]


def _refuse(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what}, which the port has not ported (ROADMAP {item})")


class TenantStackModel:
    """M stacked streaming-SGD learners with the single learner's surface
    (``step``, ``fetch_output``, ``latest_weights``,
    ``set_initial_weights``, ``bind_thread``, ``device``), so the fetch
    pipeline, checkpoints and the divergence sentinel take it unchanged.

    ``step(batch)`` takes an ordinary host batch (routed, split and wired
    here) or an M-tenant wire from ``prepare_wire``/``pack_for_wire``, and
    returns the device StepOutput with [M]-leading fields: [M, B]
    predictions in each tenant's row order (``route_ids`` gives the
    original order back on the host)."""

    accepts_packed = True

    def __init__(
        self,
        num_tenants: int,
        num_text_features: int = 1000,
        num_iterations: int = 50,
        step_size: float = 0.1,
        mini_batch_fraction: float = 1.0,
        l2_reg: float = 0.0,
        convergence_tol: float = 0.001,
        dtype=torch.float32,
        residual_fn=None,
        prediction_fn=None,
        round_predictions: bool = True,
        use_sparse: "bool | None" = None,
        use_gram: "bool | None" = None,
        gram_int8: "bool | None" = None,
        tenant_key: str = "hash",
        wire_pack: str = "stacked",
        wire_codec: str = "",
        mesh=None,
        step_sizes=None,
        l2_regs=None,
        mapping: str = "scan",
        quality: bool = False,
        device="cuda",
    ) -> None:
        if num_tenants < 1:
            raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
        if mapping not in ("scan", "vmap"):
            raise ValueError(f"mapping must be 'scan' or 'vmap', got {mapping!r}")
        if wire_pack not in ("stacked", "group"):
            raise ValueError(f"wire_pack must be 'stacked' or 'group', got {wire_pack!r}")
        if mapping == "vmap":
            raise _refuse("mapping='vmap' batches the tenants in one program: on the card "
                          "that is B1 with a tenant grid dimension", "B10")
        if mesh is not None:
            raise _refuse("a mesh shards the tenant plane over devices and hosts (the "
                          "tenant fleet of the multi-host runtime)", "A10b")
        self.num_tenants = num_tenants
        self.num_text_features = num_text_features
        self.dtype = dtype
        self.tenant_key = tenant_key
        self.wire_pack = wire_pack
        # --wireCodec dict: the group pack digram-codes each tenant segment
        # ("" or "off": raw); the stacked wire ships raw by design
        self.wire_codec = wire_codec
        self.device = resolve_device(device)

        def per_tenant(values, default, name):
            if values is None:
                return [float(default)] * num_tenants
            values = [float(v) for v in np.asarray(values, np.float64).reshape(-1)]
            if len(values) != num_tenants:
                raise ValueError(f"per-tenant {name} needs shape ({num_tenants},), "
                                 f"got ({len(values)},)")
            return values

        # the JAX package maps each tenant's (step size, L2) as float32
        # leaves; the train step rounds both to float32 as it computes
        self.step_sizes = per_tenant(step_sizes, step_size, "step_sizes")
        self.l2_regs = per_tenant(l2_regs, l2_reg, "l2_regs")
        built: dict = {}
        self._steps = []
        for hyper in zip(self.step_sizes, self.l2_regs):
            if hyper not in built:  # tenants with equal hyperparameters share one
                built[hyper] = make_sgd_train_step(
                    num_text_features=num_text_features, num_iterations=num_iterations,
                    step_size=hyper[0], mini_batch_fraction=mini_batch_fraction,
                    l2_reg=hyper[1], convergence_tol=convergence_tol,
                    residual_fn=residual_fn, prediction_fn=prediction_fn,
                    round_predictions=round_predictions, quality=quality, dtype=dtype,
                    use_sparse=use_sparse, use_gram=use_gram, gram_int8=gram_int8,
                )
            self._steps.append(built[hyper])
        self.route = self._steps[0].route
        log.info("tenant plane: %d tenants, key %s, %s wire, %s step route on %s",
                 num_tenants, tenant_key, wire_pack, self.route, self.device)
        self._weights = torch.zeros((num_tenants, num_text_features + NUM_NUMBER_FEATURES),
                                    dtype=dtype, device=self.device)
        self.non_blocking = True
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)

    @classmethod
    def from_conf(cls, conf, mesh=None, **overrides):
        from ..models.sgd import DTYPES

        kwargs = dict(
            num_tenants=int(conf.tenants or 1),
            num_text_features=conf.numTextFeatures,
            num_iterations=conf.numIterations,
            step_size=conf.stepSize,
            mini_batch_fraction=conf.miniBatchFraction,
            l2_reg=conf.l2Reg,
            convergence_tol=conf.convergenceTol,
            dtype=DTYPES[conf.dtype],
            tenant_key=conf.tenantKey,
            wire_pack=("group" if conf.effective_wire_pack() == "group"
                       and conf.effective_wire() == "ragged" else "stacked"),
            wire_codec=conf.effective_wire_codec(),
            mesh=mesh,
            quality=conf.modelWatch == "on",
            device=conf.backend,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    # -- routing and the wire ------------------------------------------------
    def route_ids(self, batch) -> np.ndarray:
        """Each row's tenant for a host batch; deterministic, so delivery
        recomputes it."""
        return tenant_route_keys(batch, self.num_tenants, self.tenant_key)

    def split(self, batch) -> list:
        """Route and split into the M same-signature tenant batches."""
        return split_batch_tenants(batch, self.route_ids(batch), self.num_tenants)

    @staticmethod
    def _is_tenant_wire(batch) -> bool:
        """A packed group or a stacked batch: the wire of ``pack_for_wire``."""
        if isinstance(batch, PackedBatch):
            return True
        mask = getattr(batch, "mask", None)
        return mask is not None and getattr(mask, "ndim", 1) == 2

    def prepare_wire(self, batch):
        """A host batch as the M-tenant wire: routed and split, then one
        ``pack_ragged_group`` buffer (``wire_pack="group"``, ragged) or the
        stacked arrays."""
        return self.prepare_wire_from_parts(self.split(batch))

    def prepare_wire_from_parts(self, parts):
        """M same-signature batches (routed by the caller, or one batch
        mirrored M times) as the M-tenant wire."""
        if self.wire_pack == "group" and isinstance(parts[0], RaggedUnitBatch):
            return pack_ragged_group(parts, codec=self.wire_codec or None)
        return stack_batches(parts)

    def pack_for_wire(self, batch):
        """The fetch pipeline's pack: the tenant wire, built once a batch."""
        return self.prepare_wire(batch)

    # -- the learner's surface -----------------------------------------------
    def planes(self, wire) -> tuple:
        """Each tenant part's Gram plane (``host_planes``), or () on a route
        that builds no G."""
        if self.route != "gram":
            return ()
        return host_planes(wire, self._steps[0].int8_plane)

    def step(self, batch) -> StepOutput:
        """One tick: the wire's H2D copy, then tenant m's train step on part
        m with row m of the stack, m = 0..M-1; returns the [M]-leading
        device StepOutput, nothing waited for on ``cuda``. The new stack is
        a fresh tensor (a step still queued keeps reading the old rows)."""
        wire = batch if self._is_tenant_wire(batch) else self.prepare_wire(batch)
        planes = self.planes(wire)
        dev = batch_to_device(wire, self.device, self.non_blocking)
        if isinstance(dev, PackedBatch):
            dev = unpack_batch(dev.buffer, dev.layout)
        rows, outs = [], []
        for m, train_step in enumerate(self._steps):
            w_m, out = train_step(self._weights[m], _batch_at(dev, m),
                                  plane=planes[m] if planes else None)
            rows.append(w_m)
            outs.append(out)
        self._weights = torch.stack(rows)
        return _stack_outputs(outs)

    @staticmethod
    def fetch_output(out: StepOutput):
        """Start the ONE host fetch of a tick's [M]-leading output
        (``models/sgd.fetch_output``)."""
        return fetch_output(out)

    def bind_thread(self) -> None:
        """Make the model's CUDA device and stream current on the calling
        thread; no-op on the CPU."""
        if self.stream is not None:
            torch.cuda.set_device(self.stream.device)
            torch.cuda.set_stream(self.stream)

    @property
    def latest_weights(self) -> np.ndarray:
        """[M, F+4] on the host: one checkpointable array for every tenant
        (a blocking copy; read it at a drained boundary)."""
        w = self._weights.detach()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.cpu().numpy().copy()

    def tenant_weights(self, m: int) -> np.ndarray:
        return self.latest_weights[m]

    def set_initial_weights(self, weights) -> "TenantStackModel":
        """The stacked [M, F+4] state (a checkpoint's) or one [F+4] vector
        for every tenant (the sentinel's zeros), as a FRESH tensor made on
        the model's stream, as ``StreamingSGDModel.set_initial_weights``."""
        w = torch.as_tensor(np.asarray(weights), dtype=self.dtype)
        if w.dim() == 1:
            w = w.expand((self.num_tenants,) + tuple(w.shape))
        if w.shape[0] != self.num_tenants:
            raise ValueError(f"stacked weights lead with {w.shape[0]} tenants; "
                             f"this plane has {self.num_tenants}")
        if tuple(w.shape) != tuple(self._weights.shape):
            raise ValueError(f"weights must have shape {tuple(self._weights.shape)}, "
                             f"got {tuple(w.shape)}")
        if self.stream is None:
            self._weights = w.to(self.device, copy=True).contiguous()
            return self
        with torch.cuda.stream(self.stream):
            self._weights = w.to(self.device, copy=True).contiguous()
        return self

    def reset(self) -> "TenantStackModel":
        return self.set_initial_weights(
            np.zeros((self.num_text_features + NUM_NUMBER_FEATURES,), np.float32))


class MultiHostTenantModel:
    """The tenant plane behind per-host sharded intake: the tenant fleet of
    the multi-host runtime (ROADMAP A10b)."""

    def __init__(self, *args, **kwargs):
        raise _refuse("MultiHostTenantModel runs the tenant plane across hosts (the "
                      "tenant fleet of the multi-host runtime)", "A10b")
