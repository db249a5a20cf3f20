"""The (data, model) grid of ranks (PyTorch port of `jacobiforcing_tpu/parallel/mesh.py`).

The JAX package runs one controller over a `jax.sharding.Mesh` of devices
and leaves the collectives to XLA.  The port is SPMD over
`torch.distributed` ranks instead: every rank runs the same host engine on
the same requests, and the only communication is the collectives inside the
forward pass (`parallel/collectives.py`) plus a few host values that the
model group's first rank broadcasts.  The reference engine's SharedMemory
control plane, which single-controller JAX removed, does not come back.

`make_mesh` lays out the ranks exactly as the JAX version lays out devices
and gives each rank a `Mesh` that names its coordinates and one process
group per axis: the model group is this rank's row of the grid (tensor
parallelism), the data group its column.  An axis of size 1 has no group
(None), so a single process needs no `torch.distributed` world at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The serving mesh, registered by LLMEngine (or any caller running sharded
# decode) for code that wants to know the layout it runs under; the port's
# attention needs no dispatch of its own, since each rank's KV pool holds
# only that rank's heads.
_SERVING_MESH: Optional["Mesh"] = None


def set_serving_mesh(mesh: Optional["Mesh"]) -> None:
    """Register (or clear, with None) the mesh sharded decode runs under."""
    global _SERVING_MESH
    _SERVING_MESH = mesh


def get_serving_mesh() -> Optional["Mesh"]:
    return _SERVING_MESH


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) grid.

    `ranks` is the [dp, tp] grid of global ranks, `coords` this rank's
    (data, model) index in it (None for a rank left outside the grid), and
    `groups` one `ProcessGroup` per axis, None where the axis has size 1."""

    ranks: np.ndarray
    coords: Optional[Tuple[int, int]]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    @property
    def model_group(self) -> Optional[dist.ProcessGroup]:
        return self.groups[MODEL_AXIS]

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        return self.groups[DATA_AXIS]

    def destroy(self) -> None:
        """Destroy this mesh's process groups (collective over each group's
        ranks); the world stays."""
        for group in self.groups.values():
            if group is not None:
                dist.destroy_process_group(group)

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here: the data group, then
        the model group (rank (d, m) passes after (d, 0), which passed after
        every (., 0))."""
        for axis in self.axis_names:
            if self.groups[axis] is not None:
                dist.barrier(group=self.groups[axis])

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise ValueError("this rank lies outside the mesh")
        return self.coords[self.axis_names.index(axis)]


def make_mesh(
    tensor_parallel_size: int = 1,
    data_parallel_size: int = -1,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a (data, model) mesh over `ranks` (default: every rank of the
    `torch.distributed` world, or the one process when there is none).

    `tensor_parallel_size` is the reference's `Config.tensor_parallel_size`;
    data_parallel_size = -1 uses all remaining ranks.  The grid covers every
    rank of `ranks`: a (dp, tp) that leaves some out raises (pass the ranks
    the mesh is made of instead; those outside it get `coords` None).  Every
    rank of the world must call this with the same arguments: creating a
    process group is collective.
    """
    world = dist.is_initialized()
    ranks = list(ranks if ranks is not None else range(dist.get_world_size() if world else 1))
    n = len(ranks)
    tp = tensor_parallel_size
    if n % tp:
        raise ValueError(f"{n} ranks do not divide by tp={tp}")
    dp = data_parallel_size if data_parallel_size > 0 else n // tp
    if dp * tp != n:
        raise ValueError(f"a (data {dp}, model {tp}) mesh needs {dp * tp} ranks, and it is "
                         f"given {n}: pass `ranks` to build it over part of the world")
    grid = np.asarray(ranks[: dp * tp]).reshape(dp, tp)
    me = dist.get_rank() if world else 0
    hits = np.argwhere(grid == me)
    coords = tuple(int(c) for c in hits[0]) if len(hits) else None
    groups: Dict[str, Optional[dist.ProcessGroup]] = {DATA_AXIS: None, MODEL_AXIS: None}
    for axis, lines in ((MODEL_AXIS, grid), (DATA_AXIS, grid.T)):
        if lines.shape[1] > 1:
            if not world:
                raise ValueError(f"a {axis} axis of size {lines.shape[1]} needs a "
                                 "torch.distributed world (initialize_multihost)")
            mine, _ = dist.new_subgroups_by_enumeration([row.tolist() for row in lines])
            groups[axis] = mine
    return Mesh(grid, coords, groups)
