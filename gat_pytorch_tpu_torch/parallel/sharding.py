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

In the dst-owned layout (parallel/partition.py: a graph partitioned by
destination, each shard's slice holding the in-edges of its node rows)
`dst_shard` hands a rank its slice instead: its edges, with receivers
still global, its real-edge count, its local sender order, the CSR
offsets of its rows and of the N senders, and its own block layout cut
from the stacked one (shard_batch(..., dst_owned=True)).

GSPMD auto-sharding (the JAX package's put_batch plus a plain jit, with
XLA inserting the collectives) has no PyTorch counterpart: the port has
only the explicit, hand-scheduled form (parallel/train.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..graph.graph import BlockLayout, Graph, edge_offsets
from ..ops.cuda.build import csr_offsets
from ..ops.segment import real_first_order
from .mesh import Mesh
from .partition import stacked_dims


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


def _layout_shard(bl: BlockLayout, k: int, num_shards: int
                  ) -> BlockLayout:
    """Shard k's own layout, cut from a layout stacked over num_shards
    (parallel/partition.py): its slots and blocks, its rows' and the N
    senders' offsets, its real slots by sender, and its remainder with
    rem_e its own count."""
    rows, n = stacked_dims(bl, num_shards)

    def part(t: Optional[torch.Tensor], width: Optional[int] = None):
        if t is None:
            return None
        w = t.shape[0] // num_shards if width is None else width
        return t[k * w:(k + 1) * w].contiguous()

    src_ptr = part(bl.src_ptr, n + 1)
    num_real = int(src_ptr[-1])
    rem = {}
    if bl.rem_send is not None:
        rem = dict(rem_send=part(bl.rem_send), rem_recv=part(bl.rem_recv),
                   rem_order=part(bl.rem_order),
                   rem_dst_ptr=part(bl.rem_dst_ptr, rows + 1),
                   rem_src_ptr=part(bl.rem_src_ptr, n + 1),
                   rem_e=int(bl.rem_count[k]))
    return BlockLayout(
        send=part(bl.send), recv=part(bl.recv), base=part(bl.base),
        tile_ptr=part(bl.tile_ptr), tile_base=part(bl.tile_base),
        dst_perm=part(bl.dst_perm), dst_ptr=part(bl.dst_ptr, rows + 1),
        src_perm=part(bl.src_perm)[:num_real].contiguous(), src_ptr=src_ptr,
        wb=bl.wb, window=bl.window, nb=bl.nb, eb=bl.eb, dmax=bl.dmax,
        num_real=num_real, **rem)


def dst_shard(graph: Graph, k: int, num_shards: int) -> Graph:
    """Shard k of num_shards of a graph partitioned by destination
    (parallel/partition.partition_edges_by_dst): its slice [k*eps,
    (k+1)*eps) of the edges, receivers global, with its real-edge count
    (its real edges come first), its local sender order (padding last),
    dst_ptr over its N/num_shards rows (of the local receivers) and
    src_ptr over the N senders, and its own block layout where the graph
    carries a stacked one (_layout_shard). The node fields are the
    graph's (replicated)."""
    n, e = graph.num_nodes, graph.num_edges
    if e % num_shards or n % num_shards:
        raise ValueError(f"{n} nodes and {e} edges do not divide over "
                         f"{num_shards} edge shards")
    eps, rows = e // num_shards, n // num_shards
    sl = slice(k * eps, (k + 1) * eps)
    senders = graph.senders[sl].contiguous()
    receivers = graph.receivers[sl].contiguous()
    edge_mask = graph.edge_mask[sl].contiguous()
    order = graph.src_order[sl].contiguous()
    e_real = int(edge_mask.sum())
    src_ptr = csr_offsets(
        senders.index_select(0, order[:e_real].long()), n)
    dst_ptr = csr_offsets(receivers - k * rows, rows)
    bl = graph.block_layout
    return graph.replace(
        senders=senders, receivers=receivers, edge_mask=edge_mask,
        src_order=order, num_edges=eps, num_real_edges=e_real,
        tile_lo=None, src_band=0, src_ptr=src_ptr, dst_ptr=dst_ptr,
        block_layout=None if bl is None
        else _layout_shard(bl, k, num_shards))


def shard_batch(batch: Sequence[Graph], mesh: Mesh, *,
                dst_owned: bool = False) -> List[Graph]:
    """This rank's shard of a batch (stack_graphs): its data rows, each
    cut to its edge shard (edge_shard; dst_shard where dst_owned, the
    graphs partitioned by destination). The batch size must divide over
    the data axis."""
    batch = stack_graphs(batch)
    b, dp = len(batch), mesh.data.size
    if b % dp:
        raise ValueError(f"batch of {b} graphs does not divide over "
                         f"{dp} data shards")
    per = b // dp
    rows = batch[mesh.data.index * per:(mesh.data.index + 1) * per]
    cut = dst_shard if dst_owned else edge_shard
    return [cut(g, mesh.edge.index, mesh.edge.size) for g in rows]


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
