"""Multi-device training on torch.distributed: the (data, edge) mesh, the
batches' shards and the sharded train and eval steps.

Counterpart of gat_pytorch_tpu/parallel/ in its two layouts: the
cut-neighbourhood one, each graph's dst-sorted edge list cut into
contiguous ranges over the edge axis, cut neighbourhoods completed by sums
over it (models/gat.py `edge_axis`); and the dst-owned one
(partition.py), each shard's edges the in-edges of its node rows, a layer
gathering its output rows (`dst_owned`). GSPMD auto-sharding has no
counterpart (parallel/sharding.py).
"""

from .mesh import DATA_AXIS, EDGE_AXIS, Axis, Mesh, make_mesh
from .partition import (partition_batches, partition_edges_by_dst,
                        repad_block_layout)
from .sharding import (dst_shard, edge_shard, replicated, shard_batch,
                       stack_graphs)
from .train import (DropoutGenerators, make_sharded_eval_step,
                    make_sharded_train_step)

__all__ = [
    "DATA_AXIS", "EDGE_AXIS", "Axis", "Mesh", "make_mesh",
    "dst_shard", "edge_shard", "replicated", "shard_batch", "stack_graphs",
    "partition_batches", "partition_edges_by_dst", "repad_block_layout",
    "DropoutGenerators", "make_sharded_eval_step",
    "make_sharded_train_step",
]
