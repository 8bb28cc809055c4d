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

The JAX package also serves an ``[M, F+4]`` tenant stack here; the port
serves one model, and a stack raises naming ROADMAP A9.
"""

from __future__ import annotations

import numpy as np

from ..utils import get_logger

log = get_logger("serving.engine")


class PredictEngine:
    """Snapshot-resident predict program with the model surface
    ``apps/common.FetchPipeline`` drives (``step``, ``fetch_output``,
    ``device``, ``pack_for_wire``, ``accepts_packed``), delegating to the
    zero-iteration learner. ``model_cls`` gives the gradient family's knobs
    (the linear learner by default; the logistic learner serves the
    sentiment family). ``device`` is ``cuda`` unless the caller asks for
    ``cpu``."""

    num_tenants = 1  # a tenant stack needs ROADMAP A9 (set_snapshot refuses one)

    def __init__(self, num_text_features: int = 1000, dtype=None, model_cls=None,
                 use_sparse: "bool | None" = None, device="cuda") -> None:
        import torch

        from ..features.arena import get_arena
        from ..models.linear import StreamingLinearRegressionWithSGD

        model_cls = model_cls or StreamingLinearRegressionWithSGD
        self.num_text_features = num_text_features
        self.model = model_cls(
            num_text_features=num_text_features,
            num_iterations=0,  # predict only: no update runs
            dtype=torch.float32 if dtype is None else dtype,
            use_sparse=use_sparse,
            use_gram=False,  # G exists for iterations serving never runs
            quality=False,
            device=device,
        )
        # the wire's arena buffers are page-locked for a cuda model, so the
        # step's H2D copy is asynchronous
        get_arena().use_device(self.model.device)
        self.snapshot_step = -1

    @classmethod
    def from_conf(cls, conf, model_cls=None):
        from ..models.sgd import DTYPES

        return cls(num_text_features=conf.numTextFeatures, dtype=DTYPES[conf.dtype],
                   model_cls=model_cls, device=conf.backend)

    # -- snapshot state ------------------------------------------------------
    def set_snapshot(self, snapshot) -> None:
        """Install a snapshot's weights on the device through the model's
        ``set_initial_weights``: a FRESH tensor made on the model's stream,
        so a batch dispatched before keeps the weights it read. Zero
        iterations never change them; callers swap only between dispatches
        (serving/plane.py), which makes the swap tear-free."""
        weights = np.asarray(snapshot.weights)
        if weights.ndim != 1:
            raise NotImplementedError(
                f"a snapshot of weights shaped {weights.shape} is a tenant stack, which "
                "needs the tenant plane the port has not ported (ROADMAP A9)")
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
        from ..features.batch import pack_batch

        return pack_batch(batch)

    # -- result extraction ---------------------------------------------------
    def predictions_for(self, host_out, batch) -> np.ndarray:
        """The fetched output's predictions of the batch's valid rows, in
        the batch's row order ([n])."""
        mask = np.asarray(batch.mask) > 0
        return np.asarray(host_out.predictions)[mask]
