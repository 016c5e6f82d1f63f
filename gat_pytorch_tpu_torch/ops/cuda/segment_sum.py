"""Sorted row segment sums: the attention backward's d(h) reduction, in
its row-major and its feature-major form, and the plain sorted segment
sum.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_sum.py:
segment_sum_pallas_rows (:176) in its two forms, `_kernel_rows_nt`
(no_transpose=True, the JAX package's default) and `_kernel_rows`
(no_transpose=False: accumulated feature-major, (D, N), and transposed
back), with the `_dh_reduce` glue in segment_attention.py:912-938, which
picks the form by GAT_TPU_DH_REDUCE_NT (`dh_transposed`); and
segment_sum_pallas (:260, `_kernel`), the reduction behind the
sorted-gradient gathers (ops/segment.py:gather_rows_sorted_grad). The
CUDA kernels are in csrc/segment_sum.cu (its headers say what bounds
them and why they are shaped so); `segment_rows_plain`,
`segment_rows_t_plain` and `segment_sum_sorted_plain` are their plain
torch versions.

The d(h) kernels take the segments as offsets: segment s's rows are
values[order[ptr[s]:ptr[s+1]]]. A caller that holds them (Graph.src_ptr,
a block layout's src_ptr) passes them, and the reduction is then one
kernel launch; `dh_reduce` without them derives them from the senders
per call (a gather and a searchsorted before the kernel).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version. Every sum has a fixed order: each d(h) segment's rows are
added in ascending position, one at a time, starting from 0, in both
forms. So two calls give the same bits, the two forms give the same bits
as each other on the card, and the reduction with offsets gives the
bits of the one without.
"""

from __future__ import annotations

import ctypes
import os
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
        lib.segment_sum_rows.argtypes = [p, p, p, i, i, i, p, p]
        lib.segment_sum_rows.restype = ctypes.c_int
        lib.segment_sum_rows_t.argtypes = [p, p, p, i, i, i, p, p]
        lib.segment_sum_rows_t.restype = ctypes.c_int
        lib.segment_sum_sorted.argtypes = [p, p, i, i, i, p, p, p]
        lib.segment_sum_sorted.restype = ctypes.c_int
        _configured = True
    return lib


def dh_transposed() -> bool:
    """GAT_TPU_DH_REDUCE_NT as segment_attention._dh_reduce reads it: the
    feature-major form (segment_sum_pallas_rows(no_transpose=False))
    where it is "0", else the row-major one."""
    return os.environ.get("GAT_TPU_DH_REDUCE_NT", "1") == "0"


def segment_rows_plain(values: torch.Tensor, order: Optional[torch.Tensor],
                       sorted_ids: torch.Tensor, num_segments: int
                       ) -> torch.Tensor:
    e = sorted_ids.shape[0]
    rows = values[:e] if order is None else values.index_select(
        0, order.long())
    return seg.segment_sum(rows, sorted_ids, num_segments)


def segment_rows_t_plain(values: torch.Tensor, order: Optional[torch.Tensor],
                         sorted_ids: torch.Tensor, num_segments: int
                         ) -> torch.Tensor:
    """The feature-major form: the rows' transpose summed into a
    (D, num_segments) buffer by id (ids >= num_segments dropped), then
    returned row-major."""
    e, d = sorted_ids.shape[0], values.shape[1]
    rows = values[:e] if order is None else values.index_select(
        0, order.long())
    ids = sorted_ids.long()
    ids = torch.where(ids < num_segments, ids,
                      torch.full_like(ids, num_segments))
    out_t = rows.new_zeros((d, num_segments + 1)).index_add(1, ids, rows.t())
    return out_t[:, :num_segments].t().contiguous()


def _segment_rows_cuda(values: torch.Tensor, order: Optional[torch.Tensor],
                       seg_ptr: torch.Tensor,
                       row_limit: Optional[int] = None,
                       transposed: bool = False) -> torch.Tensor:
    """out[s] = sum of values[order[i]] over i in [seg_ptr[s], seg_ptr[s+1])
    (order None: the identity), by the kernel, one launch; rows from
    `row_limit` on are skipped (the caller knows them to be zero).
    transposed: the feature-major kernel. Both return (S, D)."""
    dev = values.device
    build.require(values, "values", dev, torch.float32, (None, None))
    d = values.shape[1]
    if not 1 <= d <= 1024:
        raise ValueError(f"row width {d} outside [1, 1024]")
    build.require(seg_ptr, "seg_ptr", dev, torch.int32, (None,))
    num_segments = seg_ptr.shape[0] - 1
    if order is not None:
        build.require(order, "order", dev, torch.int32, (None,))
    limit = values.shape[0] if row_limit is None else row_limit
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out
    name = "segment_sum_rows_t" if transposed else "segment_sum_rows"
    with torch.cuda.device(dev):
        err = getattr(_lib(), name)(
            build.ptr(values), build.ptr(order), build.ptr(seg_ptr),
            num_segments, limit, d, build.ptr(out), build.stream(dev))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def _segment_rows(values, order, sorted_ids, num_segments, row_limit=None,
                  transposed: bool = False):
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
            row_limit, transposed)
    if values.device.type == "cpu":
        plain = segment_rows_t_plain if transposed else segment_rows_plain
        return plain(values, order, sorted_ids, num_segments)
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
              num_real_edges: Optional[int] = None,
              transposed: bool = False,
              src_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum the attention backward's per-edge d(h) rows (dst order) into
    the (num_nodes, D) table by sender: rows are read through
    `src_order`, the stable sender-sorting permutation.

    src_ptr: the (num_nodes + 1,) int32 offsets of each sender's run of
    real edges in src_order (Graph.src_ptr), where the caller holds them:
    the call is then dh_reduce_ptr's, one kernel launch. Without them they
    are derived here from `senders` per call; with `num_real_edges`, the
    rows from there on belong to padding edges and are zero, as the
    attention backward writes them, and the kernel steps over them
    without reading them (a batch padded to its bucket hangs thousands of
    them on the sink node). Either way each sender's rows are added in
    the order of src_order, so the two give the same bits.
    transposed: the feature-major form (the caller's dh_transposed())."""
    if src_ptr is not None:
        if src_ptr.shape != (num_nodes + 1,):
            raise ValueError(f"src_ptr of shape {tuple(src_ptr.shape)} for "
                             f"{num_nodes} nodes")
        return dh_reduce_ptr(d_h_rows, src_order, src_ptr, transposed)
    ids_sorted = senders.index_select(0, src_order.long())
    return _segment_rows(d_h_rows, src_order, ids_sorted, num_nodes,
                         num_real_edges, transposed)


def dh_reduce_ptr(d_h_rows: torch.Tensor, src_perm: torch.Tensor,
                  src_ptr: torch.Tensor, transposed: bool = False
                  ) -> torch.Tensor:
    """The same reduction for a caller that holds the sender runs as
    offsets (the block layout, Graph.src_ptr): sender s's rows are
    d_h_rows[src_perm[src_ptr[s]:src_ptr[s+1]]]; entries of src_perm from
    src_ptr[-1] on, and rows that src_perm does not name, are not read.
    Returns (len(src_ptr) - 1, D)."""
    if d_h_rows.is_cuda:
        return _segment_rows_cuda(d_h_rows, src_perm, src_ptr,
                                  transposed=transposed)
    if d_h_rows.device.type == "cpu":
        n = src_ptr.shape[0] - 1
        ptr = src_ptr.long()
        ids = torch.repeat_interleave(torch.arange(n), ptr.diff())
        plain = segment_rows_t_plain if transposed else segment_rows_plain
        return plain(d_h_rows, src_perm[:int(ptr[-1])], ids, n)
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
