"""The v4 table attention op: softmax over given edge logits and aggregation.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_segment_attention_table (:506) with its VJP `_fsat_fwd`/`_fsat_bwd`
(:535-590). The kernels are csrc/table_attention.cu: the forward
(`_kernel_split`), and the backward (segment_attention_bwd.py:
`_kernel_split`) as two launches, `table_dden` (the per-destination
d(den) term) and `table_backward`, which walks each sender's edges and
writes d(h) (N, D) directly. `table_forward_plain` and
`table_backward_plain` (per-edge d(h) rows) are the plain torch versions
of the op's function; `table_dden_plain` and
`table_backward_by_sender_plain` those of the two backward kernels.

The caller computes the edge logits (any formulation: per-head scores
with a per-destination max subtracted, zeros, or the capped cross-head
scores) and masks padding edges to NEG_INF, whose exp is 0; the real
edges come first, and a caller that knows their number passes it, so
that the padding edges are not walked at all. The op owns the gather of
sender rows, the per-destination denominator (no dropout
mask in it), the dropout-weighted sum and the normalisation
    out = num / (den + eps), 0 where a destination has no real edge,
and is differentiable in the logits, h and the dropout mask. The JAX
op's `eb`, `nb`, `interpret` and `vma` arguments size TPU blocks or type
shard_map's values and are not carried. Its `num_src_nodes` (the rows of
the h table where a dst-owned shard's destinations are fewer) is h's own
row count here: the senders index h, the receivers the num_nodes rows of
the output, and d(h) has h's rows (models/gat.py's sharded_v4_table
branch; chip_smoke.py holds the kernels at N/4 destination rows).

d(h). The JAX package's backward writes a d(h) row per edge and sums them
by sender (`_dh_reduce`), a TPU workaround: Mosaic has no in-kernel
gather or scatter. Here the backward sums each sender's terms itself, in
the order of src_order and with the per-edge products rounded as the rows
were, so d(h) has the bits of the rows summed by either form of
ops/cuda/segment_sum.py's reduction: the kernel on CUDA tensors, its plain
version `table_backward_by_sender_plain` on CPU tensors. The op reads no
GAT_TPU_DH_REDUCE_NT, which picks that form in the JAX package.

The JAX package's dtype knobs of this op (ops/cuda/v5_attention.py's
v5_rounding, read when the op is called): GAT_TPU_KERNEL_DTYPE=bfloat16
rounds each edge's [weighted h | ex] to bfloat16 before the forward's
float32 sums; GAT_TPU_H_DTYPE=bfloat16 casts the h table to bfloat16
before the gather, so that the forward and the backward read rounded rows
(gather_h_src_t; d(h) stays float32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...utils.profiling import op_spans
from .. import segment as seg
from . import build
from .build import sender_runs
from .rounding import FLOAT32, Rounding, check_table, maybe_bf16
from .segment_sum import dh_reduce_plain
from .v5_attention import MAX_HEADS, NEG_INF, v5_rounding
_KERNEL = "table_attention"
_configured = set()


def _lib(bf16_table: bool = False) -> ctypes.CDLL:
    """The kernels' library for a float32 or a bfloat16 h table."""
    name = build.library(_KERNEL, bf16_table)
    lib = build.load(name)
    if name not in _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.table_forward.argtypes = ([p] * 5 + [i] * 5
                                      + [fl, p, p, i, p])
        lib.table_forward.restype = ctypes.c_int
        lib.table_dden.argtypes = [p] * 3 + [i] * 4 + [fl, p, p]
        lib.table_dden.restype = ctypes.c_int
        lib.table_backward.argtypes = ([p] * 6 + [i] * 7 + [fl] + [p] * 6
                                       + [i, p])
        lib.table_backward.restype = ctypes.c_int
        _configured.add(name)
    return lib


# -- plain versions (CPU tensors) -------------------------------------------

def _inverse(den: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))


def _real(e: int, e_real: int, device) -> torch.Tensor:
    return (torch.arange(e, device=device) < e_real)[:, None]


def table_forward_plain(logits, h, drop, senders, receivers, num_nodes: int,
                        e_real: int, eps: float,
                        rounding: Rounding = FLOAT32):
    """(out (num_nodes, D) normalised, den (num_nodes, nh)) over the
    edges e < e_real; h is the table the kernel reads (bfloat16 in the
    table mode), `acc` rounds each edge's terms before the sums."""
    e, nh = logits.shape
    d = h.shape[1]
    ex = torch.where(_real(e, e_real, logits.device), torch.exp(logits),
                     torch.zeros_like(logits))
    w = ex if drop is None else ex * drop
    h_e = seg.gather_rows(h.float(), senders)
    num = seg.segment_sum(maybe_bf16((h_e.view(e, nh, d // nh)
                                      * w[:, :, None]).reshape(e, d),
                                     rounding.acc), receivers, num_nodes)
    den = seg.segment_sum(maybe_bf16(ex, rounding.acc), receivers,
                          num_nodes)
    out = (num.view(num_nodes, nh, d // nh)
           * _inverse(den, eps)[:, :, None]).reshape(num_nodes, d)
    return out, den


def table_backward_plain(logits, h, drop, senders, receivers, e_real: int,
                         eps: float, g, out, den, need_drop: bool):
    """(d_h rows (E, D) in dst order, d_logits (E, nh), d_drop (E, nh) |
    None); all 0 on edges e >= e_real and on edges whose receiver is no
    row of `den`."""
    e, nh = logits.shape
    n, d = out.shape
    f = d // nh
    rcv = receivers.long()
    inside = (rcv < n)[:, None] & _real(e, e_real, logits.device)
    rcv_in = rcv.clamp(max=n - 1)
    inv = _inverse(den, eps)
    d_den = -(out * g).view(n, nh, f).sum(2) * inv
    ex = torch.where(inside, torch.exp(logits), torch.zeros_like(logits))
    g_e = g.index_select(0, rcv_in)
    inv_e = inv.index_select(0, rcv_in)
    m = torch.ones_like(ex) if drop is None else drop
    hg = (seg.gather_rows(h.float(), senders) * g_e).view(e, nh, f).sum(2)
    d_h_rows = ((ex * m * inv_e)[:, :, None] * g_e.view(e, nh, f)
                ).reshape(e, d)
    d_logits = ex * (hg * inv_e * m + d_den.index_select(0, rcv_in))
    d_drop = hg * ex * inv_e if need_drop else None
    return d_h_rows, d_logits, d_drop


def table_dden_plain(g, out, den, eps: float):
    """dden (N, nh) = -inv * sum over each head's features of out * g,
    the backward's per-destination d(den) term."""
    n, d = out.shape
    nh = den.shape[1]
    return -(out * g).view(n, nh, d // nh).sum(2) * _inverse(den, eps)


def table_backward_by_sender_plain(logits, h, drop, senders, receivers,
                                   e_real: int, eps: float, g, out, den,
                                   need_drop: bool, src_order=None,
                                   src_ptr=None):
    """(d_h (h rows, D), d_logits (E, nh), d_drop (E, nh) | None): the
    per-edge rows of table_backward_plain summed by sender over the runs
    the kernel walks (sender_runs), on either device."""
    rows, d_logits, d_drop = table_backward_plain(
        logits, h, drop, senders, receivers, e_real, eps, g, out, den,
        need_drop)
    order, ptr = sender_runs(senders, e_real, h.shape[0], src_order, src_ptr)
    return dh_reduce_plain(rows, order, ptr), d_logits, d_drop


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(logits, h, drop, senders, receivers, num_nodes, e_real,
                  rounding: Rounding):
    dev = logits.device
    e = logits.shape[0] if logits.dim() == 2 else -1
    nh = logits.shape[1] if logits.dim() == 2 else -1
    build.require(logits, "logits", dev, torch.float32, (None, None))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    check_table(h, rounding)
    build.require(h, "h", dev, h.dtype, (None, None))
    d = h.shape[1]
    if not 1 <= d <= 1024 or d % nh:
        raise ValueError(f"row width {d} must be nh*f and at most 1024")
    build.require(senders, "senders", dev, torch.int32, (e,))
    build.require(receivers, "receivers", dev, torch.int32, (e,))
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e, nh))
    if num_nodes < 1:
        raise ValueError(f"num_nodes {num_nodes} < 1")
    if not 0 <= e_real <= e:
        raise ValueError(f"e_real {e_real} outside [0, {e}]")
    return dev, e, d, nh


def _table_forward_cuda(logits, h, drop, senders, receivers, num_nodes: int,
                        e_real: int, eps: float, rounding: Rounding,
                        dst_ptr=None):
    dev, e, d, nh = _check_inputs(logits, h, drop, senders, receivers,
                                  num_nodes, e_real, rounding)
    row_ptr = build.row_offsets(receivers, num_nodes, dst_ptr)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((num_nodes, d), **f32)
    den = torch.empty((num_nodes, nh), **f32)
    p = build.ptr
    lib = _lib(rounding.table)
    with torch.cuda.device(dev):
        err = lib.table_forward(
            p(logits), p(h), p(drop), p(senders), p(row_ptr), num_nodes,
            e_real, d, nh, d // nh, eps, p(out), p(den), rounding.flags(),
            build.stream(dev))
    build.check(err, "table_forward")
    build.LAUNCHES[rounding.counter("table_forward")] += 1
    return out, den


def _table_dden_cuda(g, out, den, eps: float):
    dev = out.device
    n = den.shape[0] if den.dim() == 2 else -1
    nh = den.shape[1] if den.dim() == 2 else -1
    build.require(den, "den", dev, torch.float32, (None, None))
    build.require(out, "out", dev, torch.float32, (n, None))
    d = out.shape[1]
    if not 1 <= nh <= MAX_HEADS or not 1 <= d <= 1024 or d % nh:
        raise ValueError(f"row width {d} and {nh} heads: the kernel takes "
                         f"nh*f <= 1024 and 1..{MAX_HEADS} heads")
    build.require(g, "g", dev, torch.float32, (n, d))
    dden = torch.empty((n, nh), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().table_dden(build.ptr(g), build.ptr(out), build.ptr(den),
                                n, d, nh, d // nh, eps, build.ptr(dden),
                                build.stream(dev))
    build.check(err, "table_dden")
    build.LAUNCHES["table_dden"] += 1
    return dden


def _table_backward_cuda(logits, h, drop, senders, receivers, e_real: int,
                         eps: float, g, out, den, need_drop: bool,
                         rounding: Rounding, src_order, src_ptr):
    n = den.shape[0] if den.dim() == 2 else -1
    dev, e, d, nh = _check_inputs(logits, h, drop, senders, receivers, n,
                                  e_real, rounding)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    n_src = h.shape[0]
    order, ptr = sender_runs(senders, e_real, n_src, src_order, src_ptr)
    dden = table_dden(g, out, den, eps)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h = torch.empty((n_src, d), **f32)
    d_logits = torch.empty((e, nh), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    p = build.ptr
    lib = _lib(rounding.table)
    with torch.cuda.device(dev):
        err = lib.table_backward(
            p(logits), p(h), p(drop), p(receivers), p(order), p(ptr), n_src,
            n, e_real, e, d, nh, d // nh, eps, p(g), p(den), p(dden), p(d_h),
            p(d_logits), p(d_drop), rounding.flags(), build.stream(dev))
    build.check(err, "table_backward")
    build.LAUNCHES[rounding.counter("table_backward")] += 1
    return d_h, d_logits, d_drop


def table_forward(logits, h, drop, senders, receivers, num_nodes: int,
                  e_real: int, eps: float, rounding: Rounding = FLOAT32, *,
                  dst_ptr=None):
    """Kernel on CUDA tensors, plain version on CPU tensors. rounding:
    the bfloat16 mode (acc; h a bfloat16 table where `table`). dst_ptr:
    the (num_nodes + 1,) int32 CSR offsets of `receivers` where the
    caller holds them (Graph.dst_ptr); the kernel wrapper computes them
    otherwise."""
    if logits.is_cuda:
        return _table_forward_cuda(logits, h, drop, senders, receivers,
                                   num_nodes, e_real, eps, rounding, dst_ptr)
    if logits.device.type == "cpu":
        check_table(h, rounding)
        return table_forward_plain(logits, h, drop, senders, receivers,
                                   num_nodes, e_real, eps, rounding)
    raise ValueError(f"no kernel for device {logits.device}")


def table_dden(g, out, den, eps: float):
    """The backward's prelude, dden (N, nh): kernel on CUDA tensors,
    plain version on CPU tensors."""
    if out.is_cuda:
        return _table_dden_cuda(g, out, den, eps)
    build.require_cpu(out)
    return table_dden_plain(g, out, den, eps)


def table_backward(logits, h, drop, senders, receivers, e_real: int,
                   eps: float, g, out, den, need_drop: bool,
                   rounding: Rounding = FLOAT32, *, src_order=None,
                   src_ptr=None):
    """(d_h (h rows, D), d_logits (E, nh), d_drop (E, nh) | None): on
    CUDA tensors table_dden and the by-sender kernel, which walks
    sender_runs(senders, e_real, h rows, src_order, src_ptr); on CPU
    tensors the plain version (the table mode is h's dtype; no other
    point of the policy applies here)."""
    if logits.is_cuda:
        return _table_backward_cuda(logits, h, drop, senders, receivers,
                                    e_real, eps, g, out, den, need_drop,
                                    rounding, src_order, src_ptr)
    build.require_cpu(logits)
    check_table(h, rounding)
    return table_backward_by_sender_plain(logits, h, drop, senders,
                                          receivers, e_real, eps, g, out,
                                          den, need_drop, src_order, src_ptr)


# -- the differentiable op ----------------------------------------------------

@op_spans("table_attention")
class _TableAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, h_flat, drop_mask, senders, receivers,
                src_order, src_ptr, dst_ptr, num_nodes, e_real, eps,
                rounding):
        h_k = rounding.table_of(h_flat)
        out, den = table_forward(logits, h_k, drop_mask, senders,
                                 receivers, num_nodes, e_real, eps, rounding,
                                 dst_ptr=dst_ptr)
        ctx.save_for_backward(logits, h_k, drop_mask, senders, receivers,
                              src_order, src_ptr, den, out)
        ctx.e_real, ctx.eps = e_real, eps
        ctx.rounding = rounding
        return out

    @staticmethod
    def backward(ctx, g):
        (logits, h_k, drop_mask, senders, receivers, src_order, src_ptr,
         den, out) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[2]
        d_h, d_logits, d_drop = table_backward(
            logits, h_k, drop_mask, senders, receivers, ctx.e_real, ctx.eps,
            g.contiguous(), out, den, need_drop, ctx.rounding,
            src_order=src_order, src_ptr=src_ptr)
        return (d_logits, d_h, d_drop) + (None,) * 9


def fused_segment_attention_table(logits: torch.Tensor,
                                  h_flat: torch.Tensor,
                                  senders: torch.Tensor,
                                  receivers: torch.Tensor,
                                  drop_mask: Optional[torch.Tensor],
                                  src_order: Optional[torch.Tensor],
                                  num_nodes: int, nh: int, f: int,
                                  eps: float = 1e-8,
                                  num_real_edges: Optional[int] = None, *,
                                  src_ptr: Optional[torch.Tensor] = None,
                                  dst_ptr: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Normalised attention output (num_nodes, nh*f) from given edge
    logits, differentiable in logits, h_flat and drop_mask.

    logits (E, nh) float32 over the dst-sorted edges, NEG_INF on padding
    edges; h_flat (N, nh*f) node features; senders, receivers (E,) int32;
    drop_mask (E, nh) attention-dropout multipliers or None.
    src_order: the stable permutation sorting the edges by sender, in
    whose order the backward sums each sender's d(h); without it or
    without src_ptr the backward derives the order with a stable sort of
    the real edges' senders (build.sender_runs), the same order, so the
    sums keep their order either way.
    num_real_edges: the edges from there on are padding (NEG_INF logits,
    the last node as sender, as canonicalize pads) and are not walked;
    None walks every edge, which gives the same result more slowly.
    src_ptr, dst_ptr: the graph's CSR offsets (Graph.src_ptr, the sender
    runs of src_order's real prefix; Graph.dst_ptr), which spare the
    kernels' wrappers deriving them per call; src_ptr is read only with
    src_order, and src_order only with src_ptr. The dtype knobs (module
    doc) are read now."""
    e_real = senders.shape[0] if num_real_edges is None else num_real_edges
    if not 0 <= e_real <= senders.shape[0]:
        raise ValueError(f"num_real_edges {e_real} outside "
                         f"[0, {senders.shape[0]}]")
    if logits.shape != (senders.shape[0], nh) or h_flat.shape[1] != nh * f:
        raise ValueError(f"shapes logits {tuple(logits.shape)}, h "
                         f"{tuple(h_flat.shape)} do not match "
                         f"{senders.shape[0]} edges, nh={nh}, f={f}")
    return _TableAttention.apply(logits.contiguous(), h_flat.contiguous(),
                                 drop_mask, senders, receivers, src_order,
                                 src_ptr, dst_ptr, num_nodes, e_real, eps,
                                 v5_rounding())
