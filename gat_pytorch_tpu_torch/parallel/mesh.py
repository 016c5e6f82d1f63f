"""The (data, edge) mesh over the ranks of the default process group.

Counterpart of gat_pytorch_tpu/parallel/mesh.py. The JAX package names a
`jax.sharding.Mesh` of devices with two logical axes:

  * ``data`` whole graphs per batch (data parallel: PPI/PATTERN batches),
  * ``edge`` contiguous ranges of each graph's dst-sorted edge list (the
    cut-neighbourhood layout: partial softmax denominators and aggregates
    are summed over this axis, models/gat.py).

Here each rank of torch.distributed's default group is one mesh device.
Rank r sits at data index r // edge and edge index r % edge (the JAX
mesh's row-major reshape of its device list), and each axis gets its
process groups from torch.distributed.new_group: the ranks that share a
data index form an edge group, the ranks that share an edge index a data
group. A collective "over an axis" (ops/collectives.py, which also
defines Axis) runs in the rank's group of that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from ..ops.collectives import Axis

DATA_AXIS = "data"
EDGE_AXIS = "edge"


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: Axis
    edge: Axis

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, EDGE_AXIS: self.edge.size}


def make_mesh(data: Optional[int] = None,
              edge: Optional[int] = None) -> Mesh:
    """A (data, edge) mesh over every rank of the default process group,
    which must be initialised (parallel/multihost.initialize). Defaults
    as in the JAX package: every rank on the edge axis; pass `data` to
    carve off a data-parallel axis. Every rank must call this, in the
    same order as any other new_group, since it creates the groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (parallel.multihost.initialize)")
    n = dist.get_world_size()
    if data is None and edge is None:
        data, edge = 1, n
    elif data is None:
        data = n // edge
    elif edge is None:
        edge = n // data
    if data * edge != n:
        raise ValueError(f"mesh {data}x{edge} != {n} ranks")
    rank = dist.get_rank()
    di, ei = divmod(rank, edge)
    edge_group = data_group = None
    for i in range(data):       # every rank creates every group, in order
        g = dist.new_group([i * edge + j for j in range(edge)])
        if i == di:
            edge_group = g
    for j in range(edge):
        g = dist.new_group([i * edge + j for i in range(data)])
        if j == ei:
            data_group = g
    return Mesh(data=Axis(DATA_AXIS, data, di, data_group),
                edge=Axis(EDGE_AXIS, edge, ei, edge_group))
