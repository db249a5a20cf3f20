"""Joining a `torch.distributed` world (PyTorch port of
`jacobiforcing_tpu/parallel/multihost.py`).

The JAX package joins hosts with `jax.distributed.initialize()`; the port
joins ranks with `torch.distributed.init_process_group`, from explicit
arguments or from the environment `torchrun` sets (`RANK`, `WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`).  The backend
is an explicit argument: "nccl" between cards, "gloo" on the CPU (gloo also
carries CUDA tensors, which lets two ranks share one card, where NCCL
refuses).  The model axis of a pod mesh stays within one node, so
tensor-parallel collectives ride NVLink; the data axis may span nodes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from jacobiforcing_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
    local_rank: Optional[int] = None,
) -> None:
    """Join the torch.distributed world (a no-op for one process, or when
    the world is joined already).

    `coordinator_address` is "host:port" (default `MASTER_ADDR:MASTER_PORT`),
    `num_processes` the world size (default `WORLD_SIZE`, else 1) and
    `process_id` this rank (default `RANK`).  Where a card is present, this
    process's device is set to card `local_rank % device_count` (default
    `LOCAL_RANK`, else 0), so "cuda" names it: ranks beyond the node's cards
    share them (over gloo; NCCL takes one rank per card).
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ['MASTER_PORT']}")
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_pod_mesh(tensor_parallel_size: int = 1) -> Mesh:
    """Mesh over the whole world: "model" (tp) packed densely over the ranks
    of one node, so its collectives stay on NVLink, "data" spanning nodes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    assert tensor_parallel_size <= local, (
        f"tp={tensor_parallel_size} must fit within one node ({local} ranks) "
        "so tensor-parallel collectives stay on NVLink"
    )
    return make_mesh(tensor_parallel_size=tensor_parallel_size)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
