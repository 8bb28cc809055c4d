"""The tenant plane: M stacked learners on one wire with one fetch a tick
(counterpart of ``twtml_tpu/parallel/tenants.py``).

One global retweet model becomes M (per topic, per language, per A/B arm)
without M pipelines: the M models share the host batch, its wire, its H2D
copy and ONE device-to-host fetch a tick, so a tenant more costs device
work, not a round trip.

- **weights**: one [M, F+4] tensor on the model's device; each tenant's
  step size and L2 are its own (``step_sizes``, ``l2_regs``).
- **the step**: with ``mapping="scan"`` (the default) tenant m runs the
  learner's train step (``models/sgd.make_sgd_train_step``, built with that
  tenant's step size and L2) on its part of the wire, with its own row of
  the stack: the JAX package's ``lax.map`` with no carry. On the dense
  float32 route each tenant's step is one launch of B1
  (``ops/fused_sgd.py``) at the batch's padded B, so a tick launches B1 M
  times. Tenant m's weights, predictions and stats are bitwise a
  standalone learner's stepped on m's rows. ``mapping="vmap"`` (the JAX
  package's ``jax.vmap``, reached only through the library, as there) runs
  ONE batched step (``models/sgd.make_sgd_tenant_step``): the M·B rows
  decode at once; in the dense regime the float32 kernel route is one
  launch of B1's tenant grid (``fused_dense_sgd_tenants``: each tenant's
  CTAs read its valid rows only, which the host counts before the copy),
  the other dense routes one batched torch loop; on the 2^18 routes the
  Gram route on the card is the tenant forms of B4 and B8 (once a plane
  present) and B7 (once) around one G product a tenant over its valid
  rows, the scatter route one batched gather/scatter loop; rounding, stats
  and quality run over the leading M. Its sums run in another order, so it
  agrees with scan within float rounding, as the JAX vmap does. The
  construction log says which form runs.
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

Over a process group (``mesh``, with its ``group``'s Collectives):

- on a data axis (``DataMesh``) each tenant's step is the data-parallel
  step of this rank's part of the rows (``make_sgd_train_step(group=...)``:
  on the card B1's split, once a tenant: M x (N + 1) all-reduces a tick),
  every rank holding the whole stack, replicated. The vmap form batches
  the M tenants' data-parallel steps into one (``make_sgd_tenant_step(
  group=...)``, the JAX vmap inside ``shard_map``): on the card the dense
  float32 route is the split with a tenant grid
  (``fused_dense_sgd_tenants_split``), the torch-loop and scatter routes
  reduce every tenant's sums in one buffer, so a tick makes N + 1
  all-reduces (N + 2 with the quality vector) whatever M; the 2^18 Gram
  route gathers every tenant's rows in one all-gather and every tenant's
  G panels in another, runs the M dual loops replicated and all-reduces
  the write-backs once (``models/sgd.gram_tenants_parallel``): 2
  all-gathers and 2 all-reduces a tick (3 with the quality vector)
  whatever M;
- on a ``('data', 'model')`` mesh (``ModelMesh``) the TENANTS shard over
  ``model``: rank (d, m) holds and trains tenants [m·M/n, (m+1)·M/n) (n the
  model axis) on data shard d's rows, data-parallel over ``data`` (the vmap
  form batches the rank's own tenants the same way); the tenants are
  independent, so no collective crosses ``model`` inside a tick. Its step
  returns its own tenants' [M/n]-leading outputs, and ``latest_weights``
  all-gathers the stack over ``model``.

``MultiHostTenantModel`` is the tenant fleet of the multi-host runtime
(``--tenants M`` in a group): each host routes its own rows with the
deterministic key into the stacked wire, the tenant stack on the group's
data axis, one fetch a tick.
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
    tenant_valid_rows,
    unpack_batch,
)
from ..models.base import StepOutput
from ..models.sgd import (
    _batch_at,
    _stack_outputs,
    batch_to_device,
    fetch_output,
    host_planes,
    make_sgd_tenant_step,
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


class TenantStackModel:
    """M stacked streaming-SGD learners with the single learner's surface
    (``step``, ``fetch_output``, ``latest_weights``,
    ``set_initial_weights``, ``bind_thread``, ``device``), so the fetch
    pipeline, checkpoints and the divergence sentinel take it unchanged.

    ``step(batch)`` takes an ordinary host batch (routed, split and wired
    here) or an M-tenant wire from ``prepare_wire``/``pack_for_wire``, and
    returns the device StepOutput with [M]-leading fields: [M, B]
    predictions in each tenant's row order (``route_ids`` gives the
    original order back on the host). ``mapping`` is "scan" (M steps, each
    bitwise a standalone learner) or "vmap" (one batched step; module
    docstring)."""

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
        group=None,
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
        self.mapping = mapping
        self.mesh = mesh
        # this rank's tenants [tenant0, tenant0 + num_local) and the group
        # their steps reduce over (the data axis)
        self.num_local, self.tenant0, data_group = num_tenants, 0, None
        self._model_group = None
        if mesh is not None:
            if group is None:
                raise ValueError("a tenant plane over a mesh needs its group's Collectives")
            data_group = group
            if mesh.num_model > 1:
                if num_tenants % mesh.num_model:
                    raise ValueError(f"{num_tenants} tenants not divisible by the mesh's "
                                     f"model axis ({mesh.num_model})")
                self.num_local = num_tenants // mesh.num_model
                self.tenant0 = mesh.model_index * self.num_local
                data_group, self._model_group = group.data, group.model
                # the stacked wire: the group buffer has no tenant-axis layout
                wire_pack = "stacked"
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
        mine = slice(self.tenant0, self.tenant0 + self.num_local)
        for hyper in zip(self.step_sizes[mine], self.l2_regs[mine]):
            if hyper not in built:  # tenants with equal hyperparameters share one
                built[hyper] = make_sgd_train_step(
                    num_text_features=num_text_features, num_iterations=num_iterations,
                    step_size=hyper[0], mini_batch_fraction=mini_batch_fraction,
                    l2_reg=hyper[1], convergence_tol=convergence_tol,
                    residual_fn=residual_fn, prediction_fn=prediction_fn,
                    round_predictions=round_predictions, quality=quality, dtype=dtype,
                    use_sparse=use_sparse, use_gram=use_gram, gram_int8=gram_int8,
                    group=data_group,
                )
            self._steps.append(built[hyper])
        self.route = self._steps[0].route
        # the vmap form's one batched step over this rank's tenants, on
        # every route, on one process or over a data axis
        self._batched = None
        if mapping == "vmap":
            self._batched = make_sgd_tenant_step(
                num_tenants=self.num_local, step_sizes=self.step_sizes[mine],
                l2_regs=self.l2_regs[mine], num_text_features=num_text_features,
                num_iterations=num_iterations, mini_batch_fraction=mini_batch_fraction,
                convergence_tol=convergence_tol, residual_fn=residual_fn,
                prediction_fn=prediction_fn, round_predictions=round_predictions,
                quality=quality, dtype=dtype, use_sparse=use_sparse, use_gram=use_gram,
                gram_int8=gram_int8, group=data_group)
        form = "scan: a step a tenant" if mapping == "scan" else "vmap: one batched step"
        log.info("tenant plane: %d tenants (%d on this rank), key %s, %s wire, %s step route "
                 "on %s, mapping %s", num_tenants, self.num_local, tenant_key, wire_pack,
                 self.route, self.device, form)
        self._weights = torch.zeros((self.num_local, num_text_features + NUM_NUMBER_FEATURES),
                                    dtype=dtype, device=self.device)
        self.non_blocking = True
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)

    @classmethod
    def from_conf(cls, conf, mesh=None, group=None, **overrides):
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
            group=group,
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
        stacked arrays; on a model axis this rank's tenants' parts only."""
        parts = self.split(batch)
        return self.prepare_wire_from_parts(parts[self.tenant0:self.tenant0 + self.num_local])

    def prepare_wire_from_parts(self, parts):
        """M same-signature batches (routed by the caller, or one batch
        mirrored M times) as the M-tenant wire. The vmap form's wire carries
        each part's valid rows (``valid_rows``: ``tenant_valid_rows``), which
        its kernel reads X to; a stacked padded wire (a tuple) carries its
        host mask, which gives them."""
        if self.wire_pack == "group" and isinstance(parts[0], RaggedUnitBatch):
            wire = pack_ragged_group(parts, codec=self.wire_codec or None)
        else:
            wire = stack_batches(parts)
        if self._batched is not None and hasattr(wire, "__dict__"):
            wire.valid_rows = tenant_valid_rows([p.mask for p in parts])
        return wire

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

    @staticmethod
    def valid_rows(wire) -> list:
        """Each part's rows up to its last valid one, from a HOST tenant
        wire: what it carries, else its mask (unpacked from a group buffer
        that carries none)."""
        rows = getattr(wire, "valid_rows", None)
        if rows is None:
            mask = (unpack_batch(wire.buffer, wire.layout) if isinstance(wire, PackedBatch)
                    else wire).mask
            rows = tenant_valid_rows(mask)
        return rows

    def step(self, batch) -> StepOutput:
        """One tick: the wire's H2D copy, then tenant m's train step on part
        m with row m of the stack, m = 0..M-1 (the vmap form: one batched
        step over the M parts); returns the [M]-leading device StepOutput,
        nothing waited for on ``cuda``. The new stack is a fresh tensor (a
        step still queued keeps reading the old rows)."""
        wire = batch if self._is_tenant_wire(batch) else self.prepare_wire(batch)
        planes = self.planes(wire)
        valid = self.valid_rows(wire) if self._batched is not None else None
        dev = batch_to_device(wire, self.device, self.non_blocking)
        if isinstance(dev, PackedBatch):
            dev = unpack_batch(dev.buffer, dev.layout)
        if self._batched is not None:
            self._weights, out = self._batched(self._weights, dev, valid,
                                               planes if planes else None)
            return out
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
        (a blocking copy; read it at a drained boundary). On a model axis
        the ranks' tenants are all-gathered over ``model``: a collective,
        which every rank calls at the same point."""
        w = self._weights.detach()
        if self._model_group is not None:
            w = self._model_group.all_gather_rows(w)
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
        w = w[self.tenant0:self.tenant0 + self.num_local]
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
    """The tenant fleet of the multi-host runtime (the JAX package's
    ``MultiHostTenantModel``, ``--tenants M`` in a group): the tenant stack
    behind per-host sharded intake. ``inner`` is a ``TenantStackModel`` on
    the group's data axis (every rank holds the whole [M, F+4] stack,
    replicated like the single model's weights). Each host routes ITS OWN
    rows with the deterministic key into the M-tenant split, stacks them
    and steps its part of every tenant's data-parallel step; one fetch a
    tick of the [M]-leading output (global stats, this rank's rows'
    predictions). The stacked wire is the only one (``accepts_packed``
    False: the coalesced group buffer has no tenant axis across hosts),
    built as this rank's ``pack_for_wire``. Ragged parts agree one per-shard
    unit capacity across every part and every host with ONE all-gather of
    this host's largest need a batch (``_stack_ragged_parts``), their units
    widened to uint16. ``rebuild`` swaps in a stack for an elastic epoch's
    mesh, as ``MultiHostSGDModel.rebuild`` does."""

    accepts_packed = False
    wire_pack = "stacked"
    wire_codec = ""  # the stacked wire ships raw

    def __init__(self, inner: TenantStackModel, mesh, rebuilder=None):
        self.inner = inner
        self.mesh = mesh
        self.num_data = mesh.num_data
        self._lead = mesh.process_index == 0
        self._rebuilder = rebuilder

    def rebuild(self, mesh) -> "MultiHostTenantModel":
        """A fresh stack for a NEW epoch's ``mesh``, in place (the caller
        restores the weights from the lead's broadcast before the next
        tick)."""
        if self._rebuilder is None:
            raise RuntimeError("MultiHostTenantModel.rebuild needs the rebuilder closure "
                               "(set by apps/common.build_model)")
        self.inner = self._rebuilder(mesh)
        self.mesh = mesh
        self.num_data = mesh.num_data
        self._lead = mesh.process_index == 0
        return self

    # the tenant plane's surface, which the app runtime reads
    num_tenants = property(lambda self: self.inner.num_tenants)
    tenant_key = property(lambda self: self.inner.tenant_key)
    route = property(lambda self: self.inner.route)
    device = property(lambda self: self.inner.device)

    def route_ids(self, batch) -> np.ndarray:
        return self.inner.route_ids(batch)

    def bind_thread(self) -> None:
        self.inner.bind_thread()

    def _stack_ragged_parts(self, parts):
        """M ragged tenant parts as ONE stacked batch, each aligned as this
        rank's one shard segment at the capacity every part on every host
        needs: one all-gather (``host_allgather``, an ``align`` agreement)
        of this host's largest need."""
        from ..features.batch import align_ragged_shards, ragged_shard_bucket
        from .distributed import _as_units, host_allgather

        parts = [_as_units(p, np.uint16) for p in parts]
        need = max(ragged_shard_bucket(p, 1) for p in parts)
        agreed = int(host_allgather(np.array([need], np.float64), "align")[:, 0].max())
        return stack_batches([align_ragged_shards(p, 1, unit_bucket=agreed) for p in parts])

    def pack_for_wire(self, batch):
        """This host's rows as the stacked M-tenant wire."""
        parts = self.inner.split(batch)
        if isinstance(parts[0], RaggedUnitBatch):
            return self._stack_ragged_parts(parts)
        return stack_batches(parts)

    def step(self, batch) -> StepOutput:
        """One tick on this host's rows (a host batch, or its stacked wire
        from ``pack_for_wire``); the [M]-leading device StepOutput."""
        wire = batch if self.inner._is_tenant_wire(batch) else self.pack_for_wire(batch)
        return self.inner.step(wire)

    def fetch_output(self, out):
        """Start the ONE host fetch of a tick's output."""
        return self.inner.fetch_output(out)

    @property
    def latest_weights(self) -> np.ndarray:
        return self.inner.latest_weights

    def set_initial_weights(self, weights) -> "MultiHostTenantModel":
        self.inner.set_initial_weights(weights)
        return self
