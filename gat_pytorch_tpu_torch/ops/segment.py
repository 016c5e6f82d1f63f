"""Segment reductions over destination-sorted edge lists, in plain torch.

Counterpart of gat_pytorch_tpu/ops/segment.py. These are the reference
ops of the port and the `backend="segment"` layer path (the mirror of the
JAX package's `backend="xla"` path); they run on any device and launch no
kernel of this repository, with three exceptions built on the sorted
segment sum of ops/cuda/segment_sum.py (the kernel on CUDA tensors):
`gather_rows_sorted_grad` (its backward), `segment_sum_sorted_grad` (its
forward) and `segment_softmax_sorted` (both). The kernel path's logits
prelude and its attention coefficients use them so that a training step
gives the same bits on every run; `gather_rows` and `segment_sum`, whose
backward and forward scatter-add with atomics on the card, stay the
segment path's.

Segment ids >= num_segments (padding) are dropped, as XLA drops
out-of-bounds scatter updates: they are routed to one spill row that is
sliced off, so no host synchronisation is needed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import collectives as C


def _spill_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.where(ids < num_segments, ids,
                       torch.full_like(ids, num_segments))


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(E, ...) rows summed into (num_segments, ...) buckets."""
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    out = out.index_add(0, _spill_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, edge_axis=None) -> torch.Tensor:
    """Per-segment max; empty segments get -inf. edge_axis (a mesh Axis,
    parallel/mesh.py) when the edges are sharded over it: the shards'
    maxima are completed by pmax, and the result carries no gradient."""
    ids = _spill_ids(segment_ids, num_segments)
    idx = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = values.new_full((num_segments + 1,) + tuple(values.shape[1:]),
                          float("-inf"))
    out = out.scatter_reduce(0, idx, values, reduce="amax",
                             include_self=True)[:num_segments]
    if edge_axis is not None:
        out = C.pmax(out, edge_axis)
    return out


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather `table[indices]`."""
    return table.index_select(0, indices.long())


class _GatherRowsSortedGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, indices, order, ptr, num_real, num_segments):
        ctx.save_for_backward(indices, order, ptr)
        ctx.num_segments, ctx.num_real = num_segments, num_real
        return table.index_select(0, indices.long())

    @staticmethod
    def backward(ctx, g):
        indices, order, ptr = ctx.saved_tensors
        return (sorted_gather_grad(g, indices, ctx.num_segments, order, ptr,
                                   ctx.num_real),
                None, None, None, None, None)


def sorted_gather_grad(g: torch.Tensor, indices: torch.Tensor,
                       num_segments: int,
                       order: Optional[torch.Tensor] = None,
                       ptr: Optional[torch.Tensor] = None,
                       num_real: Optional[int] = None) -> torch.Tensor:
    """The backward of gather_rows_sorted_grad(table, indices,
    num_segments, order, ptr=ptr, num_real=num_real): the cotangent rows g
    (E, ...) summed into the (num_segments, ...) table by the sorted
    segment sum, one launch on CUDA tensors."""
    # imported here: ops/cuda/segment_sum.py imports this module
    from .cuda.segment_sum import segment_sum_sorted
    rows = g.reshape(g.shape[0], math.prod(g.shape[1:])).contiguous()
    if rows.shape[0] == 0:    # e.g. an edge shard without real edges
        d_table = rows.new_zeros((num_segments, rows.shape[1]))
    else:
        d_table = segment_sum_sorted(
            rows, None if ptr is not None else indices, num_segments,
            order=order, ptr=ptr, row_limit=num_real)
    return d_table.reshape((num_segments,) + tuple(g.shape[1:]))


def gather_rows_sorted_grad(table: torch.Tensor, indices: torch.Tensor,
                            num_segments: int,
                            order: Optional[torch.Tensor] = None, *,
                            ptr: Optional[torch.Tensor] = None,
                            num_real: Optional[int] = None
                            ) -> torch.Tensor:
    """`table[indices]` whose backward is a sorted segment sum in a fixed
    order (ops/cuda/segment_sum.segment_sum_sorted, one kernel launch)
    instead of index_select's scatter-add, which uses atomics on the card
    and so differs from run to run.

    table: (num_segments, ...) float32; indices: (E,) int32. order: a
    permutation that sorts `indices` ascending (Graph.src_order for the
    senders); None where they are sorted already (the receivers). The
    backward reads the cotangent rows through `order` itself.
    ptr: the (num_segments + 1,) int32 CSR offsets of the sorted indices
    (Graph.src_ptr with src_order, over its real edges; Graph.dst_ptr for
    the receivers), where the caller holds them: the backward then
    derives no segment bounds. num_real: the caller's promise that the
    cotangent rows from position num_real on (in the order `order` reads
    them) are zero, as the padding edges' are where a layer replaces
    their logits; they are not read. The result is the same function
    with or without either."""
    if table.shape[0] != num_segments:
        raise ValueError(f"table has {table.shape[0]} rows, "
                         f"num_segments={num_segments}")
    return _GatherRowsSortedGrad.apply(table, indices, order, ptr, num_real,
                                       num_segments)


def real_first_order(senders: torch.Tensor, edge_mask: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    """The stable permutation that sorts the edges by sender with the
    padding edges last (int32), the `order` of gather_rows_sorted_grad
    on an edge shard: a padding edge's sender is the sink, the largest
    node id, so this still sorts the senders, and its first E_real
    entries sort the real edges alone."""
    key = torch.where(edge_mask, senders, torch.full_like(senders,
                                                          num_nodes))
    return torch.argsort(key, stable=True).to(torch.int32)


class _SegmentSumSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, values, ids, ptr, num_real, num_segments):
        from .cuda.segment_sum import segment_sum_sorted
        ctx.save_for_backward(ids)
        ctx.num_segments, ctx.num_real = num_segments, num_real
        rows = values.reshape(values.shape[0], -1).contiguous()
        if rows.shape[0] == 0:    # e.g. an edge shard without real edges
            out = rows.new_zeros((num_segments, rows.shape[1]))
        else:
            out = segment_sum_sorted(rows, None if ptr is not None else ids,
                                     num_segments, ptr=ptr,
                                     row_limit=num_real)
        return out.reshape((num_segments,) + tuple(values.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        # each position reads its segment's cotangent; a position outside
        # the segments (a dropped id, or from num_real on) gets zero
        (ids,) = ctx.saved_tensors
        n = ctx.num_segments
        keep = (ids >= 0) & (ids < n)
        if ctx.num_real is not None:
            keep &= torch.arange(ids.shape[0], device=ids.device) \
                < ctx.num_real
        rows = g.index_select(0, ids.long().clamp(0, max(n - 1, 0)))
        keep = keep.view((-1,) + (1,) * (g.dim() - 1))
        return torch.where(keep, rows, 0.0), None, None, None, None


def segment_sum_sorted_grad(values: torch.Tensor, segment_ids: torch.Tensor,
                            num_segments: int, *,
                            ptr: Optional[torch.Tensor] = None,
                            num_real: Optional[int] = None
                            ) -> torch.Tensor:
    """segment_sum over rows whose ids ascend, differentiable, summed by
    the sorted segment sum (ops/cuda/segment_sum.segment_sum_sorted, one
    kernel launch on CUDA tensors) in a fixed order instead of index_add's
    atomics; the backward gathers each row's segment cotangent.

    values: (E, ...) float32; segment_ids: (E,) int32, ascending (the
    receivers); ids outside [0, num_segments) are dropped. ptr: their
    (num_segments + 1,) int32 CSR offsets (Graph.dst_ptr), where the
    caller holds them: the kernel then reads no ids. num_real: the
    caller's promise that the rows from num_real on are zero (the padding
    edges'); they are not read. The result is the same function with or
    without either."""
    return _SegmentSumSorted.apply(values, segment_ids, ptr, num_real,
                                   num_segments)


def segment_softmax_sorted(logits: torch.Tensor,
                           segment_ids: torch.Tensor,
                           num_segments: int,
                           *,
                           edge_mask: torch.Tensor,
                           ptr: Optional[torch.Tensor] = None,
                           num_real: Optional[int] = None,
                           eps: float = 1e-8,
                           subtract_segment_max: bool = False,
                           edge_axis=None) -> torch.Tensor:
    """segment_softmax's function over dst-sorted edges, for the kernel
    path: the denominator is segment_sum_sorted_grad of the masked
    numerator and goes back to the edges through gather_rows_sorted_grad,
    so that every sum of the forward and of the backward is the sorted
    segment sum, in a fixed order. The per-segment max (detached) and the
    edge axis's psum and vary are segment_softmax's. ptr and num_real (the
    CSR offsets of the ids and the real edge count, the padding edges
    last) go to both sums."""
    if subtract_segment_max:
        seg_max = segment_max(logits, segment_ids, num_segments,
                              edge_axis=edge_axis).detach()
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros_like(seg_max))
        logits = logits - gather_rows(seg_max, segment_ids)
    ex = torch.where(edge_mask[:, None], torch.exp(logits), 0.0)
    denom = segment_sum_sorted_grad(ex, segment_ids, num_segments, ptr=ptr,
                                    num_real=num_real)
    if edge_axis is not None:
        denom = C.vary(C.psum(denom, edge_axis), edge_axis)
    out = ex / (gather_rows_sorted_grad(denom, segment_ids, num_segments,
                                        ptr=ptr, num_real=num_real) + eps)
    return torch.where(edge_mask[:, None], out, 0.0)


def segment_softmax(logits: torch.Tensor,
                    segment_ids: torch.Tensor,
                    num_segments: int,
                    *,
                    edge_mask: Optional[torch.Tensor] = None,
                    eps: float = 1e-8,
                    subtract_segment_max: bool = False,
                    edge_axis=None) -> torch.Tensor:
    """exp(logit) / (segment_sum(exp) + eps) over in-neighbourhoods, by
    default without a per-segment max shift (the reference applies one
    global cap earlier instead). logits (E, H) -> (E, H), padding -> 0.

    edge_axis: the mesh Axis (ops/collectives.py) over which the edge
    arrays are sharded: the distributed softmax of neighbourhoods cut
    across shards, the segment max completed by pmax and the denominator
    by psum (the replicated denominator then enters the shard's edges
    through collectives.vary)."""
    if subtract_segment_max:
        # detached: softmax is invariant to per-segment shifts
        seg_max = segment_max(logits, segment_ids, num_segments,
                              edge_axis=edge_axis).detach()
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros_like(seg_max))
        logits = logits - gather_rows(seg_max, segment_ids)
    ex = torch.exp(logits)
    if edge_mask is not None:
        ex = torch.where(edge_mask[:, None], ex, torch.zeros_like(ex))
    denom = segment_sum(ex, segment_ids, num_segments)
    if edge_axis is not None:
        denom = C.vary(C.psum(denom, edge_axis), edge_axis)
    out = ex / (gather_rows(denom, segment_ids) + eps)
    if edge_mask is not None:
        out = torch.where(edge_mask[:, None], out, torch.zeros_like(out))
    return out


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean; empty segments give 0."""
    sums = segment_sum(values, segment_ids, num_segments)
    counts = segment_sum(values.new_ones(values.shape[:1]), segment_ids,
                         num_segments)
    return sums / counts.clamp(min=1.0).reshape(
        (num_segments,) + (1,) * (values.dim() - 1))


def in_degree(segment_ids: torch.Tensor, num_segments: int, *,
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-degree per destination node, counting only real edges."""
    ones = (torch.ones(segment_ids.shape, dtype=torch.float32,
                       device=segment_ids.device)
            if edge_mask is None else edge_mask.float())
    return segment_sum(ones, segment_ids, num_segments)
