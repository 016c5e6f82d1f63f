"""Batches of graphs for the data axis, and each rank's shard of them.

Counterpart of gat_pytorch_tpu/parallel/sharding.py. The JAX package
stacks same-bucket graphs along a leading batch axis and gives each field
a PartitionSpec:

  field                      spec
  x, node_mask, y, masks     P(data)         nodes replicated over edge
  senders/receivers/e_mask   P(data, edge)   contiguous dst-ranges/shard

Here a batch is a list of same-bucket Graphs (`stack_graphs`; the port's
loader already builds block-diagonal batches, so no new stacking format
is needed), and `shard_batch` hands a rank what those specs give its
device: its data rows (graphs [di*B/D, (di+1)*B/D)) and, of each, its
contiguous E/K slice of the dst-sorted edge arrays. Receivers are sorted,
so each shard holds a contiguous destination range and its per-shard
sums stay sorted and atomics-free; only neighbourhoods cut at shard
boundaries need the sum over the edge axis (models/gat.py). A shard's
`num_real_edges` is its own, clamp(E_real - k E/K, 0, E/K) (the real
edges are the prefix), and its `src_order` is its own edges' stable
sender order with the padding edges last, which the sharded layer's
gathers read for their sorted gradients: its first num_real_edges
entries sort the real edges alone (the graph-wide order means nothing on
a shard; the JAX package passes none there).

GSPMD auto-sharding (the JAX package's put_batch plus a plain jit, with
XLA inserting the collectives) has no PyTorch counterpart: the port has
only the explicit, hand-scheduled form (parallel/train.py).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..graph.graph import Graph, edge_offsets
from ..ops.segment import real_first_order
from .mesh import Mesh


def stack_graphs(graphs: Sequence[Graph]) -> List[Graph]:
    """A batch for the data axis: the graphs, which must share one bucket
    (the same padded node and edge counts)."""
    graphs = list(graphs)
    if not graphs:
        raise ValueError("an empty batch")
    g0 = graphs[0]
    for g in graphs[1:]:
        if (g.num_nodes, g.num_edges) != (g0.num_nodes, g0.num_edges):
            raise ValueError("all graphs in a batch must share one bucket")
    return graphs


def edge_shard(graph: Graph, k: int, num_shards: int) -> Graph:
    """Edge shard k of num_shards of `graph`: its contiguous slice of the
    dst-sorted edges, with the shard's real-edge count, its own stable
    sender order (padding edges last) and the CSR offsets of both; the
    node fields are the graph's (replicated). Raises when the edge count
    does not divide."""
    e = graph.num_edges
    if e % num_shards:
        raise ValueError(f"{e} edges do not divide over {num_shards} edge "
                         f"shards")
    s = e // num_shards
    sl = slice(k * s, (k + 1) * s)
    senders = graph.senders[sl].contiguous()
    receivers = graph.receivers[sl].contiguous()
    edge_mask = graph.edge_mask[sl].contiguous()
    order = real_first_order(senders, edge_mask, graph.num_nodes)
    e_real = min(max(graph.num_real_edges - k * s, 0), s)
    src_ptr, dst_ptr = edge_offsets(senders, receivers, order, e_real,
                                    graph.num_nodes)
    return graph.replace(
        senders=senders, receivers=receivers, edge_mask=edge_mask,
        src_order=order, num_edges=s, num_real_edges=e_real,
        tile_lo=None, src_band=0, block_layout=None, src_ptr=src_ptr,
        dst_ptr=dst_ptr)


def shard_batch(batch: Sequence[Graph], mesh: Mesh) -> List[Graph]:
    """This rank's shard of a batch (stack_graphs): its data rows, each
    cut to its edge shard (edge_shard). The batch size must divide over
    the data axis."""
    batch = stack_graphs(batch)
    b, dp = len(batch), mesh.data.size
    if b % dp:
        raise ValueError(f"batch of {b} graphs does not divide over "
                         f"{dp} data shards")
    per = b // dp
    rows = batch[mesh.data.index * per:(mesh.data.index + 1) * per]
    return [edge_shard(g, mesh.edge.index, mesh.edge.size) for g in rows]


def replicated(tensors: Sequence[torch.Tensor]) -> None:
    """Check that every rank of the default group holds the same bits in
    each tensor (parameters every rank initialised from one seed), and
    raise ValueError if not. JAX's replicated puts a tree on every
    device; here each rank builds its own copy, and a copy that differed
    would silently fork the model, so it is checked, never broadcast."""
    for i, t in enumerate(tensors):
        bits = t.detach().reshape(-1).contiguous()
        bits = bits.view(torch.int32) if bits.element_size() == 4 else bits
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise ValueError(f"tensor {i} differs between ranks: it is not "
                             f"replicated")
