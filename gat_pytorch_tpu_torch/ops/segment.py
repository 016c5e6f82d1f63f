"""Segment reductions over destination-sorted edge lists, in plain torch.

Counterpart of gat_pytorch_tpu/ops/segment.py. These are the reference
ops of the port and the `backend="segment"` layer path (the mirror of the
JAX package's `backend="xla"` path); they run on any device and launch no
kernel of this repository.

Segment ids >= num_segments (padding) are dropped, as XLA drops
out-of-bounds scatter updates: they are routed to one spill row that is
sliced off, so no host synchronisation is needed.
"""

from __future__ import annotations

from typing import Optional

import torch


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
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments get -inf."""
    ids = _spill_ids(segment_ids, num_segments)
    idx = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = values.new_full((num_segments + 1,) + tuple(values.shape[1:]),
                          float("-inf"))
    out = out.scatter_reduce(0, idx, values, reduce="amax",
                             include_self=True)
    return out[:num_segments]


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather `table[indices]`."""
    return table.index_select(0, indices.long())


def segment_softmax(logits: torch.Tensor,
                    segment_ids: torch.Tensor,
                    num_segments: int,
                    *,
                    edge_mask: Optional[torch.Tensor] = None,
                    eps: float = 1e-8,
                    subtract_segment_max: bool = False) -> torch.Tensor:
    """exp(logit) / (segment_sum(exp) + eps) over in-neighbourhoods, by
    default without a per-segment max shift (the reference applies one
    global cap earlier instead). logits (E, H) -> (E, H), padding -> 0."""
    if subtract_segment_max:
        # detached: softmax is invariant to per-segment shifts
        seg_max = segment_max(logits, segment_ids, num_segments).detach()
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros_like(seg_max))
        logits = logits - gather_rows(seg_max, segment_ids)
    ex = torch.exp(logits)
    if edge_mask is not None:
        ex = torch.where(edge_mask[:, None], ex, torch.zeros_like(ex))
    denom = segment_sum(ex, segment_ids, num_segments)
    out = ex / (gather_rows(denom, segment_ids) + eps)
    if edge_mask is not None:
        out = torch.where(edge_mask[:, None], out, torch.zeros_like(out))
    return out


def in_degree(segment_ids: torch.Tensor, num_segments: int, *,
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-degree per destination node, counting only real edges."""
    ones = (torch.ones(segment_ids.shape, dtype=torch.float32,
                       device=segment_ids.device)
            if edge_mask is None else edge_mask.float())
    return segment_sum(ones, segment_ids, num_segments)
