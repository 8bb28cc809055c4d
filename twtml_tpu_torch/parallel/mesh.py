"""The data axis of a multi-process group (counterpart of
``twtml_tpu/parallel/mesh.py``): a plain description, since torch has no
device mesh object to build.

Each rank trains on one device and holds one data shard, so the data axis
is the ranks; the weights are replicated on every rank and the batch's rows
are split over the ranks.
A model axis (the 2D feature-sharded layout) is ROADMAP A10c.
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


def make_mesh(num_data: "int | None" = None, num_model: int = 1, *,
              num_processes: int = 1, process_index: int = 0) -> DataMesh:
    """The data axis of ``num_processes`` ranks of one device each (the JAX
    package's ``make_mesh`` over process-major devices). ``num_data``, when
    given, must equal the ranks; ``num_model`` > 1 (the model axis) raises
    naming ROADMAP A10c."""
    if num_model != 1:
        raise NotImplementedError(
            f"a model axis of {num_model} (the 2D feature-sharded layout) belongs to "
            "the layouts over a model axis of the multi-host runtime, which are not "
            "ported (ROADMAP A10c)")
    if num_data is not None and num_data != num_processes:
        raise ValueError(f"a rank holds one device: num_data {num_data} must equal the "
                         f"{num_processes} processes")
    if not 0 <= process_index < num_processes:
        raise ValueError(f"process {process_index} out of range for {num_processes}")
    return DataMesh(num_processes=num_processes, process_index=process_index)
