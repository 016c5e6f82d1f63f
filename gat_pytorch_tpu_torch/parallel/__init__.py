"""Multi-device training on torch.distributed: the (data, edge) mesh, the
batches' shards and the sharded train and eval steps.

Counterpart of gat_pytorch_tpu/parallel/ for the cut-neighbourhood
layout: each graph's dst-sorted edge list cut into contiguous ranges
over the edge axis, cut neighbourhoods completed by sums over it
(models/gat.py `edge_axis`). The dst-owned layout (partition.py) and
GSPMD auto-sharding are not ported (ROADMAP: what is left of parallel/).
"""

from .mesh import DATA_AXIS, EDGE_AXIS, Axis, Mesh, make_mesh
from .sharding import edge_shard, replicated, shard_batch, stack_graphs
from .train import (DropoutGenerators, make_sharded_eval_step,
                    make_sharded_train_step)

__all__ = [
    "DATA_AXIS", "EDGE_AXIS", "Axis", "Mesh", "make_mesh",
    "edge_shard", "replicated", "shard_batch", "stack_graphs",
    "DropoutGenerators", "make_sharded_eval_step",
    "make_sharded_train_step",
]
