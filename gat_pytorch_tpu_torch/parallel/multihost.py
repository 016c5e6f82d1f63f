"""Joining the default process group, and the mesh and batch of a pod.

Counterpart of gat_pytorch_tpu/parallel/multihost.py, which joins the
jax.distributed runtime and builds a global mesh whose data axis spans
hosts and whose edge axis spans each host's chips. Here the process group
is torch.distributed's, joined from the environment that `torchrun` sets
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE) or from explicit arguments. The backend follows the
device: NCCL on CUDA, gloo on the CPU. A failed NCCL initialisation is an
error; it never falls back to gloo.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..graph.graph import Graph
from ..utils.device import resolve_device
from .mesh import Mesh, make_mesh
from .sharding import shard_batch


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device="cuda") -> bool:
    """Join the default process group; returns whether it is (now)
    initialised. A no-op, returning False, where the world has one
    process and no group was asked for (no init_method, no MASTER_ADDR in
    the environment). On CUDA the rank first takes the card LOCAL_RANK of
    its host."""
    if dist.is_initialized():
        return True
    world = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and "MASTER_ADDR" not in os.environ \
            and world == 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world,
        rank=int(os.environ.get("RANK", "0")) if rank is None else rank)
    return True


def pod_mesh(edge_per_host: Optional[int] = None) -> Mesh:
    """A (data, edge) mesh whose edge axis spans each host's processes
    (LOCAL_WORLD_SIZE, or edge_per_host of them) and whose data axis spans
    the hosts: the per-graph sums stay inside a host, the gradient sum
    crosses hosts once a step."""
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 str(dist.get_world_size())))
    edge = edge_per_host or n_local
    if n_local % edge:
        raise ValueError(f"edge_per_host {edge} must divide the "
                         f"{n_local} processes of a host")
    return make_mesh(data=dist.get_world_size() // edge, edge=edge)


def shard_global_batch(batch: Sequence[Graph], mesh: Mesh,
                       device="cuda") -> List[Graph]:
    """This process's shard of a global batch that every process holds on
    its host, on its device (the counterpart of jax's
    make_array_from_process_local_data: the shards stay where they are
    computed, nothing is sent)."""
    dev = resolve_device(device)
    return [g.to(dev) for g in shard_batch(batch, mesh)]
