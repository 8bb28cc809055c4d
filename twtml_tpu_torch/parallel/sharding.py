"""Data-parallel training over a process group (counterpart of the
data-parallel layout of ``twtml_tpu/parallel/sharding.py``).

In the JAX package one ``shard_map`` program spans the mesh: the batch's
rows are sharded over ``data``, the weights replicated, and the
single-device step runs with ``axis_name`` so its reductions become
``psum``s. In the port every rank of a ``torch.distributed`` group runs the
same step on its own rows with a ``Collectives`` object in place of the
axis name (models/sgd.py ``make_sgd_train_step(group=...)``):
``ParallelSGDModel`` is that rank-local learner. Its batch is this rank's
rows; its weights stay identical on every rank, since every rank applies
the same all-reduced update. The wire (this rank's segment of the
shard-segment wire, at buckets every rank agreed) is
``parallel/distributed.py`` ``MultiHostSGDModel``'s, which wraps this one.

``step_many`` runs a group's K steps eagerly, one after the other, with one
fetch for the group: a gloo collective is a host round trip, which a CUDA
graph cannot capture. The feature-sharded 2D layout
(``_make_feature_sharded_step``, with the feature-split form of B1 it
needs) is ROADMAP A10c. Under ``--elastic on`` the model is rebuilt for
each epoch's group (``MultiHostSGDModel.rebuild``); a group shrunk to one
rank runs the split at one rank, bitwise B1, with no all-reduce.
"""

from __future__ import annotations

from ..models.base import StepOutput
from ..models.sgd import DTYPES, StreamingSGDModel, batch_to_device
from .mesh import DataMesh


class ParallelSGDModel(StreamingSGDModel):
    """The rank-local learner of a data-parallel group over ``mesh``
    (``group``: the ``Collectives`` its step reduces over), with the step
    surface of the single-device learners. ``residual_fn``,
    ``prediction_fn`` and ``round_predictions`` (StreamingSGDModel's) are
    the learner's knobs, the JAX package's constructor arguments."""

    def __init__(self, mesh: DataMesh, group, **kwargs):
        self.mesh = mesh
        super().__init__(group=group, **kwargs)

    @classmethod
    def from_conf(cls, conf, mesh: DataMesh = None, group=None, **overrides):
        kwargs = dict(
            num_text_features=conf.numTextFeatures,
            num_iterations=conf.numIterations,
            step_size=conf.stepSize,
            mini_batch_fraction=conf.miniBatchFraction,
            l2_reg=conf.l2Reg,
            convergence_tol=conf.convergenceTol,
            quality=conf.modelWatch == "on",
            dtype=DTYPES[conf.dtype],
            device=conf.backend,
        )
        kwargs.update(overrides)
        return cls(mesh, group, **kwargs)

    def step_many(self, stacked) -> StepOutput:
        """K steps of a stacked batch or packed group, eagerly (a collective
        inside cannot be captured over gloo); the [K]-leading outputs come
        back as one StepOutput, for one fetch."""
        planes = self.planes(stacked)
        self._weights, out = self._train_many(
            self._weights, batch_to_device(stacked, self.device, self.non_blocking), planes)
        return out
