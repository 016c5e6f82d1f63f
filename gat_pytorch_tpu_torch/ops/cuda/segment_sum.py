"""Sorted row segment sums: the d(h) reduction of the JAX package's
attention backwards, in its row-major and its feature-major form, and the
plain sorted segment sum.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_sum.py:
segment_sum_pallas_rows (:176) in its two forms, `_kernel_rows_nt`
(no_transpose=True, the JAX package's default) and `_kernel_rows`
(no_transpose=False: accumulated feature-major, (D, N), and transposed
back), with the `_dh_reduce` glue in segment_attention.py:912-938, which
picks the form by GAT_TPU_DH_REDUCE_NT (`dh_transposed`); and
segment_sum_pallas (:260, `_kernel`), the reduction behind the
sorted-gradient gathers (ops/segment.py:gather_rows_sorted_grad), whose
permutation of the cotangent is read through `order` here. The
CUDA kernels are in csrc/segment_sum.cu (its headers say what bounds
them and why they are shaped so); `segment_rows_plain`,
`segment_rows_t_plain` and `segment_sum_sorted_plain` are their plain
torch versions.

The d(h) kernels take the segments as offsets: segment s's rows are
values[order[ptr[s]:ptr[s+1]]]. A caller that holds them (Graph.src_ptr,
a block layout's src_ptr) passes them, and the reduction is then one
kernel launch; `dh_reduce` without them derives them from the senders
per call (build.sender_runs: a stable sort of the real edges' senders, a
gather and a searchsorted before the kernel).

The port's attention backwards sum d(h) by sender themselves, so no op
runs the d(h) reduction: `dh_reduce` stands for the JAX package's
`_dh_reduce` (the only reader of GAT_TPU_DH_REDUCE_NT here), and the tests
and chip_smoke.py hold the port's backwards to it.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version. Every sum has a fixed order: each d(h) segment's rows are
added in ascending position, one at a time, starting from 0, in both
forms. So two calls give the same bits, the two forms give the same bits
as each other on the card, and the reduction with offsets gives the
bits of the one without. The sorted segment sum cuts its rows into
chunks of 32 and adds a segment's chunks in order: its bits, too, are
the same with ids or offsets, and on every launch.
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
        lib.segment_sum_sorted.argtypes = [p] * 4 + [i] * 4 + [p] * 5
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


def segment_sum_rows(values: torch.Tensor, sorted_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[e] over e with sorted_ids[e] == s.

    values: (E_rows >= E, D) float32; rows past E are ignored.
    sorted_ids: (E,) int32, ascending; ids >= num_segments are dropped.
    Returns (num_segments, D)."""
    e = sorted_ids.shape[0]
    if values.shape[0] < e:
        raise ValueError(f"{values.shape[0]} rows do not fit {e} ids")
    if values.is_cuda:
        build.require(sorted_ids, "sorted_ids", values.device, torch.int32,
                      (e,))
        return _segment_rows_cuda(
            values, None, build.csr_offsets(sorted_ids, num_segments))
    if values.device.type == "cpu":
        return segment_rows_plain(values, None, sorted_ids, num_segments)
    raise ValueError(f"no kernel for device {values.device}")


def dh_reduce(d_h_rows: torch.Tensor, src_order: Optional[torch.Tensor],
              senders: torch.Tensor, num_nodes: int,
              num_real_edges: Optional[int] = None,
              transposed: bool = False,
              src_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum the attention backward's per-edge d(h) rows (dst order) into
    the (num_nodes, D) table by sender, each sender's rows in the order
    of `src_order`, the stable sender-sorting permutation.

    The sender runs are build.sender_runs(senders, num_real_edges,
    num_nodes, src_order, src_ptr): src_ptr, the offsets of each
    sender's run of real edges in src_order (Graph.src_ptr), spares
    deriving them per call; without it they are derived from the real
    edges' senders, in the same order, so the two give the same bits.
    Either way the call is dh_reduce_ptr's, one kernel launch, and the
    rows from `num_real_edges` on, padding edges' rows, are not read (a
    batch padded to its bucket hangs thousands of them on the sink
    node). transposed: the feature-major form (the caller's
    dh_transposed())."""
    e_real = senders.shape[0] if num_real_edges is None else num_real_edges
    order, ptr = build.sender_runs(senders, e_real, num_nodes, src_order,
                                   src_ptr)
    return dh_reduce_ptr(d_h_rows, order, ptr, transposed)


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
        return dh_reduce_plain(d_h_rows, src_perm, src_ptr, transposed)
    raise ValueError(f"no kernel for device {d_h_rows.device}")


def dh_reduce_plain(d_h_rows: torch.Tensor, src_perm: torch.Tensor,
                    src_ptr: torch.Tensor, transposed: bool = False
                    ) -> torch.Tensor:
    """dh_reduce_ptr's function in plain torch, on either device and with
    no host synchronisation: each position of src_perm goes to the run of
    src_ptr that holds it, the positions past src_ptr[-1] to none."""
    n = src_ptr.shape[0] - 1
    pos = torch.arange(src_perm.shape[0], device=src_ptr.device)
    ids = torch.searchsorted(src_ptr.long(), pos, right=True) - 1
    ids = ids.masked_fill(ids < 0, n)
    plain = segment_rows_t_plain if transposed else segment_rows_plain
    return plain(d_h_rows, src_perm, ids, n)


def segment_sum_sorted_plain(values: torch.Tensor,
                             ids: Optional[torch.Tensor],
                             num_segments: int,
                             order: Optional[torch.Tensor] = None,
                             ptr: Optional[torch.Tensor] = None,
                             row_limit: Optional[int] = None
                             ) -> torch.Tensor:
    """segment_sum_sorted's function in plain torch: every position's row
    added to its segment by index_add in position order, the positions
    that belong to none (dropped ids, outside the offsets, from row_limit
    on) to a spill row. No host synchronisation."""
    n = num_segments
    e = (order if order is not None
         else values if ptr is not None else ids).shape[0]
    pos = torch.arange(e, device=values.device)
    rows_at = pos if order is None else order.long()
    if ptr is not None:
        keys = torch.searchsorted(ptr.long(), pos, right=True) - 1
    else:
        keys = ids.long().index_select(0, rows_at)
    limit = e if row_limit is None else row_limit
    keys = torch.where((keys < 0) | (pos >= limit), torch.full_like(keys, n),
                       keys)
    return seg.segment_sum(values.index_select(0, rows_at), keys, n)


# Per device: the sorted sum's int32 arrival counters, one a segment, zero
# between launches (the kernel hands them back zeroed), kept so that a call
# launches nothing but the kernel. Nothing else is ever written there.
_counters: dict = {}


def _counter_scratch(dev: torch.device, num_segments: int) -> torch.Tensor:
    buf = _counters.get(dev)
    if buf is None or buf.shape[0] < num_segments:
        buf = torch.zeros((num_segments,), dtype=torch.int32, device=dev)
        _counters[dev] = buf
    return buf


_CHUNK = 32     # positions a worker of the kernel (kChunk)


def _segment_sum_sorted_cuda(values, ids, num_segments: int, order, ptr,
                             row_limit):
    dev = values.device
    build.require(values, "values", dev, torch.float32, (None, None))
    rows, d = values.shape
    if not 1 <= d <= 1024:
        raise ValueError(f"row width {d} outside [1, 1024]")
    if num_segments < 1:
        raise ValueError(f"num_segments {num_segments} < 1")
    if order is not None:
        build.require(order, "order", dev, torch.int32, (None,))
    if ptr is not None:
        build.require(ptr, "ptr", dev, torch.int32, (num_segments + 1,))
        ids = None
        e = rows if order is None else order.shape[0]
    else:
        build.require(ids, "ids", dev, torch.int32, (rows,))
        e = rows if order is None else order.shape[0]
    limit = e if row_limit is None else max(0, min(int(row_limit), e))
    nchunk = max(1, -(-limit // _CHUNK))
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    part = torch.empty((nchunk * 2 * d,), dtype=torch.float32, device=dev)
    counters = _counter_scratch(dev, num_segments)
    span = torch.empty((2 * num_segments,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().segment_sum_sorted(
            build.ptr(values), build.ptr(ids), build.ptr(order),
            build.ptr(ptr), e, limit, num_segments, d, build.ptr(part),
            build.ptr(counters), build.ptr(span), build.ptr(out),
            build.stream(dev))
    build.check(err, "segment_sum_sorted")
    build.LAUNCHES["segment_sum_sorted"] += 1
    return out


def segment_sum_sorted(values: torch.Tensor, ids: Optional[torch.Tensor],
                       num_segments: int, order: Optional[torch.Tensor] = None,
                       ptr: Optional[torch.Tensor] = None,
                       row_limit: Optional[int] = None) -> torch.Tensor:
    """out[s] = sum of values[order[i]] (order None: values[i]) over the
    positions i whose segment is s; one kernel launch on CUDA tensors, the
    plain version on CPU tensors.

    values: (rows, D) float32, 1 <= D <= 1024. The segments, one of:
    ids (rows,) int32, the segment of each row, ascending in the order
    `order` reads the rows (ids < 0 or >= num_segments are dropped); or
    ptr (num_segments + 1,) int32, the CSR offsets of the positions
    (segment s holds positions [ptr[s], ptr[s+1]); ids is not read).
    order: (E,) int32 row of each position (a permutation that sorts the
    ids, Graph.src_order); None: position i is row i. row_limit: positions
    from there on are not read (the caller says their rows are zero).
    Returns (num_segments, D); a segment without rows is 0. Two calls give
    the same bits, and so do the ids and the offsets of the same rows."""
    if ids is None and ptr is None:
        raise ValueError("segment_sum_sorted needs ids or ptr")
    if values.is_cuda:
        return _segment_sum_sorted_cuda(values, ids, num_segments, order,
                                        ptr, row_limit)
    if values.device.type == "cpu":
        return segment_sum_sorted_plain(values, ids, num_segments, order,
                                        ptr, row_limit)
    raise ValueError(f"no kernel for device {values.device}")
