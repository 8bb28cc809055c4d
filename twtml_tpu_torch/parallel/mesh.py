"""The axes of a multi-process group (counterpart of
``twtml_tpu/parallel/mesh.py``): a plain description, since torch has no
device mesh object to build.

Each rank trains on one device. On a ``data`` axis alone (``DataMesh``)
the weights are replicated on every rank and the batch's rows are split
over the ranks. A ``('data', 'model')`` mesh (``ModelMesh``) lays the
ranks out as the JAX package's ``arr.reshape(num_data, num_model)`` lays
out its process-major devices: rank r is data index ``r // num_model`` and
model index ``r % num_model``. The ranks that share a data index form the
model axis (they hold the same rows, each a slice of the text features, or
a share of the tenants); the ranks that share a model index form the data
axis (they hold the same slice, each its own rows).
"""

from __future__ import annotations

from typing import NamedTuple


class DataMesh(NamedTuple):
    """``num_processes`` ranks of one device each on one ``data`` axis;
    this process is rank ``process_index``."""

    num_processes: int = 1
    process_index: int = 0
    axis_name: str = "data"

    @property
    def num_data(self) -> int:
        """Data shards: one a rank."""
        return self.num_processes

    @property
    def data_index(self) -> int:
        return self.process_index

    num_model = 1
    model_index = 0
    axis_names = ("data",)


class ModelMesh(NamedTuple):
    """``num_processes`` ranks of one device each on a ``('data', 'model')``
    mesh of ``num_model`` columns; this process is rank ``process_index``."""

    num_processes: int
    process_index: int
    num_model: int

    @property
    def num_data(self) -> int:
        return self.num_processes // self.num_model

    @property
    def data_index(self) -> int:
        """This rank's row of the mesh: its data shard."""
        return self.process_index // self.num_model

    @property
    def model_index(self) -> int:
        """This rank's column of the mesh: its feature slice (or tenants)."""
        return self.process_index % self.num_model

    axis_names = ("data", "model")

    def axis_ranks(self, axis: str) -> list:
        """The ranks of this rank's ``axis`` group, in axis order: the model
        axis holds the ranks of this data index, the data axis the ranks of
        this model index."""
        if axis == "model":
            base = self.data_index * self.num_model
            return list(range(base, base + self.num_model))
        if axis == "data":
            return list(range(self.model_index, self.num_processes, self.num_model))
        raise ValueError(f"a mesh has the axes 'data' and 'model', not {axis!r}")


def make_mesh(num_data: "int | None" = None, num_model: int = 1, *,
              num_processes: int = 1,
              process_index: int = 0) -> "DataMesh | ModelMesh":
    """The mesh of ``num_processes`` ranks of one device each (the JAX
    package's ``make_mesh`` over process-major devices): the data axis
    (``DataMesh``) when ``num_model`` is 1, else ``num_data`` x
    ``num_model`` (``ModelMesh``). ``num_data``, when given, times
    ``num_model`` must equal the ranks."""
    if num_model < 1:
        raise ValueError(f"num_model must be >= 1, got {num_model}")
    if num_processes % num_model:
        raise ValueError(f"{num_processes} processes not divisible by num_model={num_model}")
    if num_data is not None and num_data * num_model != num_processes:
        raise ValueError(f"a rank holds one device: a {num_data} x {num_model} mesh needs "
                         f"{num_data * num_model} processes, have {num_processes}")
    if not 0 <= process_index < num_processes:
        raise ValueError(f"process {process_index} out of range for {num_processes}")
    if num_model == 1:
        return DataMesh(num_processes=num_processes, process_index=process_index)
    return ModelMesh(num_processes, process_index, num_model)
