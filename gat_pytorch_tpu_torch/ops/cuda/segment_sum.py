"""Sorted row segment sums: the attention backward's d(h) reduction and
the plain sorted segment sum.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_sum.py:
segment_sum_pallas_rows (:176, the `_kernel_rows_nt` form) with the
`_dh_reduce` glue in segment_attention.py:912-938, and segment_sum_pallas
(:260, `_kernel`), the reduction behind the sorted-gradient gathers
(ops/segment.py:gather_rows_sorted_grad). The CUDA kernels are in
csrc/segment_sum.cu (its headers say what bounds them and why they are
shaped so); `segment_rows_plain` and `segment_sum_sorted_plain` are their
plain torch versions.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version. Every sum has a fixed order: two calls give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import segment as seg
from . import build

_KERNEL = "segment_sum"
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.load(_KERNEL)
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum_rows.argtypes = [p, p, p, i, i, i, p, i, p]
        lib.segment_sum_rows.restype = ctypes.c_int
        lib.segment_sum_sorted.argtypes = [p, p, i, i, i, p, p, p]
        lib.segment_sum_sorted.restype = ctypes.c_int
        _configured = True
    return lib


def segment_rows_plain(values: torch.Tensor, order: Optional[torch.Tensor],
                        sorted_ids: torch.Tensor, num_segments: int
                        ) -> torch.Tensor:
    e = sorted_ids.shape[0]
    rows = values[:e] if order is None else values.index_select(
        0, order.long())
    return seg.segment_sum(rows, sorted_ids, num_segments)


def _segment_rows_cuda(values: torch.Tensor, order: Optional[torch.Tensor],
                       seg_ptr: torch.Tensor,
                       row_limit: Optional[int] = None) -> torch.Tensor:
    """out[s] = sum of values[order[i]] over i in [seg_ptr[s], seg_ptr[s+1])
    (order None: the identity), by the kernel; rows from `row_limit` on
    are skipped (the caller knows them to be zero)."""
    dev = values.device
    build.require(values, "values", dev, torch.float32, (None, None))
    d = values.shape[1]
    if not 1 <= d <= 1024:
        raise ValueError(f"row width {d} outside [1, 1024]")
    build.require(seg_ptr, "seg_ptr", dev, torch.int32, (None,))
    num_segments = seg_ptr.shape[0] - 1
    if order is not None:
        build.require(order, "order", dev, torch.int32, (None,))
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.segment_sum_rows(
            build.ptr(values), build.ptr(order), build.ptr(seg_ptr),
            num_segments,
            values.shape[0] if row_limit is None else row_limit, d,
            build.ptr(out), build.grid_blocks(num_segments),
            build.stream(dev))
    build.check(err, "segment_sum_rows")
    build.LAUNCHES["segment_sum_rows"] += 1
    return out


def _segment_rows(values, order, sorted_ids, num_segments, row_limit=None):
    e = sorted_ids.shape[0]
    if values.shape[0] < e or (order is not None and order.shape[0] != e):
        raise ValueError(f"{values.shape[0]} rows and order "
                         f"{None if order is None else tuple(order.shape)} "
                         f"do not fit {e} ids")
    if values.is_cuda:
        build.require(sorted_ids, "sorted_ids", values.device, torch.int32,
                      (e,))
        return _segment_rows_cuda(
            values, order, build.csr_offsets(sorted_ids, num_segments),
            row_limit)
    if values.device.type == "cpu":
        return segment_rows_plain(values, order, sorted_ids, num_segments)
    raise ValueError(f"no kernel for device {values.device}")


def segment_sum_rows(values: torch.Tensor, sorted_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[e] over e with sorted_ids[e] == s.

    values: (E_rows >= E, D) float32; rows past E are ignored.
    sorted_ids: (E,) int32, ascending; ids >= num_segments are dropped.
    Returns (num_segments, D)."""
    return _segment_rows(values, None, sorted_ids, num_segments)


def dh_reduce(d_h_rows: torch.Tensor, src_order: torch.Tensor,
              senders: torch.Tensor, num_nodes: int,
              num_real_edges: Optional[int] = None) -> torch.Tensor:
    """Sum the attention backward's per-edge d(h) rows (dst order) into
    the (num_nodes, D) table by sender: rows are read through
    `src_order`, the stable sender-sorting permutation.

    With `num_real_edges`, the rows from there on belong to padding
    edges and are zero, as the attention backward writes them; the
    kernel steps over them without reading (a batch padded to its bucket
    hangs thousands of them on the sink node, which one warp sums)."""
    ids_sorted = senders.index_select(0, src_order.long())
    return _segment_rows(d_h_rows, src_order, ids_sorted, num_nodes,
                         num_real_edges)


def dh_reduce_ptr(d_h_rows: torch.Tensor, src_perm: torch.Tensor,
                  src_ptr: torch.Tensor) -> torch.Tensor:
    """The same reduction for a caller that holds the sender runs as
    offsets (the block layout does): sender s's rows are
    d_h_rows[src_perm[src_ptr[s]:src_ptr[s+1]]]; rows that src_perm does
    not name are not read. Returns (len(src_ptr) - 1, D)."""
    if d_h_rows.is_cuda:
        return _segment_rows_cuda(d_h_rows, src_perm, src_ptr)
    if d_h_rows.device.type == "cpu":
        n = src_ptr.shape[0] - 1
        ids = torch.repeat_interleave(torch.arange(n), src_ptr.long().diff())
        return segment_rows_plain(d_h_rows, src_perm, ids, n)
    raise ValueError(f"no kernel for device {d_h_rows.device}")


def segment_sum_sorted_plain(values: torch.Tensor, sorted_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    return seg.segment_sum(values, sorted_ids, num_segments)


def _segment_sum_sorted_cuda(values, sorted_ids, num_segments: int):
    dev = values.device
    build.require(values, "values", dev, torch.float32, (None, None))
    e, d = values.shape
    if not 1 <= d <= 1024:
        raise ValueError(f"row width {d} outside [1, 1024]")
    build.require(sorted_ids, "sorted_ids", dev, torch.int32, (e,))
    if num_segments < 1:
        raise ValueError(f"num_segments {num_segments} < 1")
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    ptr = torch.empty((num_segments + 1,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.segment_sum_sorted(
            build.ptr(values), build.ptr(sorted_ids), e, num_segments, d,
            build.ptr(ptr), build.ptr(out), build.stream(dev))
    build.check(err, "segment_sum_sorted")
    build.LAUNCHES["segment_sum_sorted"] += 1
    return out


def segment_sum_sorted(values: torch.Tensor, sorted_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[e] over e with sorted_ids[e] == s, for rows
    that are already in the order of their ids.

    values: (E, D) float32, 1 <= D <= 1024; sorted_ids: (E,) int32,
    ascending, ids >= num_segments are dropped. Returns (num_segments, D).
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if values.is_cuda:
        return _segment_sum_sorted_cuda(values, sorted_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_sorted_plain(values, sorted_ids, num_segments)
    raise ValueError(f"no kernel for device {values.device}")
