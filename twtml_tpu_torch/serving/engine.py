"""The predict-only program over a device-resident snapshot (counterpart of
``twtml_tpu/serving/engine.py``).

Parity by construction: the predict program is the learner's train step
built with ``num_iterations=0`` (``models/sgd.py make_sgd_train_step``).
The train step reports predictions made with the PRE-update weights, by
the very prologue this program runs (wire unpack, re-pad and ASCII fold,
device bigram hash, raw margin, ``prediction_fn``, HALF_UP rounding), and
zero iterations leave the weights as they are. So a served prediction is
bitwise what the train step would report for the same snapshot and batch,
and a change to the prediction semantics lands on both paths at once.

On the dense float32 route every served batch is ONE launch of the fused
SGD kernel (``ops/fused_sgd.py``, ``csrc/fused_sgd.cu``) in its
predict-only mode: X is staged, preds = X·w0 is written, w0 is copied to
the output and no iteration runs. ``use_gram=False`` always: in the 2^18
regime the Gram build exists for iterations serving never runs, so the step
is the gather predict and the (zero-iteration) scatter loop launches
nothing. ``quality=False``: the model-watch vector is training telemetry.

An ``[M, F+4]`` tenant stack serves through the same trick: the tenant
plane (``parallel/tenants.TenantStackModel``) with zero-iteration steps,
the rows routed on the host by ``tenant_route_keys``, M launches of B1's
predict-only mode and one stacked fetch a batch; ``predictions_for`` puts
the [M, B] output back in the request rows' order by the recomputed route.
"""

from __future__ import annotations

import numpy as np

from ..utils import get_logger

log = get_logger("serving.engine")


class PredictEngine:
    """Snapshot-resident predict program with the model surface
    ``apps/common.FetchPipeline`` drives (``step``, ``fetch_output``,
    ``device``, ``pack_for_wire``, ``accepts_packed``), delegating to the
    zero-iteration learner, or with ``num_tenants`` > 1 to the
    zero-iteration tenant stack. ``model_cls`` gives the gradient family's
    knobs (the linear learner by default; the logistic learner serves the
    sentiment family). ``device`` is ``cuda`` unless the caller asks for
    ``cpu``."""

    def __init__(self, num_text_features: int = 1000, num_tenants: int = 1,
                 tenant_key: str = "hash", dtype=None, model_cls=None,
                 use_sparse: "bool | None" = None, device="cuda") -> None:
        import torch

        from ..features.arena import get_arena
        from ..models.linear import StreamingLinearRegressionWithSGD

        model_cls = model_cls or StreamingLinearRegressionWithSGD
        dtype = torch.float32 if dtype is None else dtype
        self.num_text_features = num_text_features
        self.num_tenants = int(num_tenants)
        if self.num_tenants > 1:
            from ..parallel.tenants import TenantStackModel

            self.model = TenantStackModel(
                self.num_tenants,
                num_text_features=num_text_features,
                num_iterations=0,  # predict only: no update runs
                dtype=dtype,
                residual_fn=model_cls.residual_fn,
                prediction_fn=model_cls.prediction_fn,
                round_predictions=model_cls.round_predictions,
                use_sparse=use_sparse,
                use_gram=False,  # G exists for iterations serving never runs
                tenant_key=tenant_key,
                quality=False,
                device=device,
            )
        else:
            self.model = model_cls(
                num_text_features=num_text_features,
                num_iterations=0,
                dtype=dtype,
                use_sparse=use_sparse,
                use_gram=False,
                quality=False,
                device=device,
            )
        # the wire's arena buffers are page-locked for a cuda model, so the
        # step's H2D copy is asynchronous
        get_arena().use_device(self.model.device)
        self.snapshot_step = -1

    @classmethod
    def from_conf(cls, conf, num_tenants: int = 1, model_cls=None):
        from ..models.sgd import DTYPES

        return cls(num_text_features=conf.numTextFeatures, num_tenants=num_tenants,
                   tenant_key=conf.tenantKey, dtype=DTYPES[conf.dtype],
                   model_cls=model_cls, device=conf.backend)

    # -- snapshot state ------------------------------------------------------
    def set_snapshot(self, snapshot) -> None:
        """Install a snapshot's weights on the device through the model's
        ``set_initial_weights``: a FRESH tensor made on the model's stream,
        so a batch dispatched before keeps the weights it read. Zero
        iterations never change them; callers swap only between dispatches
        (serving/plane.py), which makes the swap tear-free."""
        weights = np.asarray(snapshot.weights)
        want = 2 if self.num_tenants > 1 else 1
        if weights.ndim != want:
            raise ValueError(f"snapshot weights ndim {weights.ndim} does not fit a "
                             f"{self.num_tenants}-tenant predict program")
        self.model.set_initial_weights(weights)
        self.snapshot_step = int(snapshot.step)

    # -- FetchPipeline model surface ----------------------------------------
    @property
    def device(self):
        return self.model.device

    @property
    def accepts_packed(self) -> bool:
        """The learner takes the one-buffer packed wire."""
        return True

    def bind_thread(self) -> None:
        """Make the model's device and stream current on the calling thread
        (the serve loop's, before its first dispatch)."""
        self.model.bind_thread()

    def step(self, wire):
        return self.model.step(wire)

    def fetch_output(self, out):
        return self.model.fetch_output(out)

    def pack_for_wire(self, batch):
        """The one-buffer packed wire, or the tenant stack's routed wire."""
        if self.num_tenants > 1:
            return self.model.pack_for_wire(batch)
        from ..features.batch import pack_batch

        return pack_batch(batch)

    # -- result extraction ---------------------------------------------------
    def step_output(self, host_out):
        """The fetched StepOutput of a ``fetch_output`` result."""
        return host_out

    def predictions_for(self, host_out, batch) -> np.ndarray:
        """The fetched output's predictions of the batch's valid rows, in
        the batch's row order ([n]). The tenant stack's [M, B] output, in
        each tenant's row order, goes back to the batch's rows by the
        recomputed route (``aggregate_tenant_output``'s rule)."""
        mask = np.asarray(batch.mask) > 0
        if self.num_tenants == 1:
            return np.asarray(host_out.predictions)[mask]
        from ..features.batch import tenant_rows

        tenant_preds = np.asarray(host_out.predictions)
        preds = np.zeros(tenant_preds.shape[1:], tenant_preds.dtype)
        for m, rows in enumerate(tenant_rows(batch, self.model.route_ids(batch),
                                             self.num_tenants)):
            preds[rows] = tenant_preds[m][: rows.shape[0]]
        return preds[mask]

    def tenant_row_counts(self, batch) -> "np.ndarray | None":
        """[M] valid rows this batch routed to each tenant (None for one
        model), from the wire's own route."""
        if self.num_tenants == 1:
            return None
        ids = np.asarray(self.model.route_ids(batch))
        valid = np.asarray(batch.mask) > 0
        return np.bincount(ids[valid], minlength=self.num_tenants).astype(np.int64)
