"""The v2 segment attention op over a pre-gathered edge table, normalised
and partial (unnormalised, for edge-sharded layers).

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_segment_attention (:594) and fused_segment_attention_partial
(:697), with their VJPs `_fsa_fwd`/`_fsa_bwd` and `_fsap_fwd`/`_fsap_bwd`.
The kernels are csrc/segment_attention.cu (forward: `_kernel` of
segment_attention.py; backward: `_kernel` of segment_attention_bwd.py,
backward_packed); `v2_forward_plain` and `v2_backward_plain` are their
plain torch versions.

The caller gathers h_src (E, nh*f), one row per edge, and computes the
edge logits (E, nh), NEG_INF on padding edges, whose exp is 0; the real
edges come first, and a caller that knows their number passes it, so
that the padding edges are not walked. Such a caller may then gather
h_src for the real edges only: h_src may hold any number of leading rows
from num_real_edges to E (the padding edges' rows are never read), and
its cotangent has as many. The op takes exp, the
per-destination denominator (no dropout mask in it) and the
dropout-weighted sum:
    num[n] = sum_{e: r_e = n} m_e ex_e h_e,   den[n] = sum ex_e,
and fused_segment_attention returns num * inv with
inv = den > 0 ? 1 / (den + eps) : 0, fused_segment_attention_partial
(num, den) for a sum over edge shards (models/gat.py). Both are
differentiable in the logits, h_src and the mask. The forward kernel walks
each destination's run of the dst-sorted edges (the v5 and table ops'
forward bodies over streamed rows, with the v5 forward's lane plan,
v5_attention.plan_of, and `forward_blocks`): a caller that holds their
CSR offsets (Graph.dst_ptr, an edge shard's own) passes them as dst_ptr,
else they are derived per call; the backward kernel is a map over the
edges and reads no offsets. The JAX ops' `eb`,
`nb`, `interpret` and `vma` arguments size TPU blocks or type shard_map
outputs and are not carried.

GAT_TPU_KERNEL_DTYPE=bfloat16, read when the op is called as the JAX
package's `_matmul_dtype` reads it, rounds each edge's [m ex h | ex] to
bfloat16 before the forward's float32 sums (rounding.V2_BF16). The JAX
package's GAT_TPU_FUSED_BWD=0 swaps its backward kernel for an XLA
quotient rule that gives the same values; it has no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.profiling import op_spans
from .. import segment as seg
from . import build
from .rounding import FLOAT32, V2_BF16, Rounding, maybe_bf16
from .v5_attention import (MAX_HEADS, LanePlan, _matmul_dtype, align_of,
                           plan_of, row_plan)

NEG_INF = -1e30          # the logit of a padding edge
_KERNEL = "segment_attention"
_configured = False


def v2_rounding() -> Rounding:
    """The op's policy under GAT_TPU_KERNEL_DTYPE, read now."""
    return V2_BF16 if _matmul_dtype() == torch.bfloat16 else FLOAT32


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.load(_KERNEL)
    if not _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.v2_forward.argtypes = ([p] * 4 + [i] * 5 + [fl, i, p, p]
                                   + [i] * 5 + [i, i, p])
        lib.v2_forward.restype = ctypes.c_int
        lib.v2_backward.argtypes = ([p] * 4 + [i] * 7 + [fl, i] + [p] * 7
                                    + [i] * 4 + [p])
        lib.v2_backward.restype = ctypes.c_int
        _configured = True
    return lib


# -- plain versions (CPU tensors) -------------------------------------------

def _inverse(den: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))


def _real(e: int, e_real: int, device) -> torch.Tensor:
    return (torch.arange(e, device=device) < e_real)[:, None]


def _all_rows(h_src: torch.Tensor, e: int) -> torch.Tensor:
    """h_src with zero rows appended up to e (rows no edge reads)."""
    if h_src.shape[0] == e:
        return h_src
    return torch.cat([h_src, h_src.new_zeros((e - h_src.shape[0],
                                              h_src.shape[1]))])


def v2_forward_plain(logits, h_src, drop, receivers, num_nodes: int,
                     e_real: int, eps: float, normalize: bool,
                     rounding: Rounding = FLOAT32):
    """(out (num_nodes, D) normalised, or num where not `normalize`; den
    (num_nodes, nh)) over the edges e < e_real; `acc` rounds each edge's
    terms before the sums."""
    e, nh = logits.shape
    d = h_src.shape[1]
    h_src = _all_rows(h_src, e)
    ex = torch.where(_real(e, e_real, logits.device), torch.exp(logits),
                     torch.zeros_like(logits))
    w = ex if drop is None else ex * drop
    num = seg.segment_sum(maybe_bf16((h_src.view(e, nh, d // nh)
                                      * w[:, :, None]).reshape(e, d),
                                     rounding.acc), receivers, num_nodes)
    den = seg.segment_sum(maybe_bf16(ex, rounding.acc), receivers,
                          num_nodes)
    if normalize:
        num = (num.view(num_nodes, nh, d // nh)
               * _inverse(den, eps)[:, :, None]).reshape(num_nodes, d)
    return num, den


def v2_backward_plain(logits, h_src, drop, receivers, e_real: int,
                      eps: float, g, out, pay, need_drop: bool,
                      normalize: bool):
    """(d_logits (E, nh), d_h_src (as many rows as h_src, D), d_drop
    (E, nh) | None). Normalised: g = d(out), `out` the forward's output
    and `pay` its den. Partial: g = d(num), `out` unused, `pay` = d(den).
    All 0 on edges e >= e_real and on edges whose receiver is no row of
    `g`."""
    e, nh = logits.shape
    n, d = g.shape
    e_h = h_src.shape[0]
    h_src = _all_rows(h_src, e)
    f = d // nh
    rcv = receivers.long()
    inside = (rcv < n)[:, None] & _real(e, e_real, logits.device)
    rcv_in = rcv.clamp(max=n - 1)
    if normalize:
        inv = _inverse(pay, eps)
        dden = -(out * g).view(n, nh, f).sum(2) * inv
    else:
        inv, dden = torch.ones_like(pay), pay
    ex = torch.where(inside, torch.exp(logits), torch.zeros_like(logits))
    g_e = g.index_select(0, rcv_in)
    inv_e = inv.index_select(0, rcv_in)
    m = torch.ones_like(ex) if drop is None else drop
    hg = (h_src * g_e).view(e, nh, f).sum(2)
    d_h = ((ex * m * inv_e)[:, :, None] * g_e.view(e, nh, f)).reshape(e, d)
    d_logits = ex * (hg * inv_e * m + dden.index_select(0, rcv_in))
    d_drop = hg * ex * inv_e if need_drop else None
    return d_logits, d_h[:e_h], d_drop


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(logits, h_src, drop, receivers, num_nodes, e_real):
    dev = logits.device
    e = logits.shape[0] if logits.dim() == 2 else -1
    nh = logits.shape[1] if logits.dim() == 2 else -1
    build.require(logits, "logits", dev, torch.float32, (None, None))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    build.require(h_src, "h_src", dev, torch.float32, (None, None))
    d = h_src.shape[1]
    if not 1 <= d <= 1024 or d % nh:
        raise ValueError(f"row width {d} must be nh*f and at most 1024")
    build.require(receivers, "receivers", dev, torch.int32, (e,))
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e, nh))
    if num_nodes < 1:
        raise ValueError(f"num_nodes {num_nodes} < 1")
    if not 0 <= e_real <= h_src.shape[0] <= e:
        raise ValueError(f"e_real {e_real} and {h_src.shape[0]} h_src rows: "
                         f"need e_real <= rows <= {e}")
    return dev, e, d, nh


def forward_blocks(plan: LanePlan, n: int) -> int:
    """The forward's grid over n destinations for its lane plan (the v5
    forward's, v5_attention.plan_of): a block each (wide; the card
    schedules them as they finish, which balances runs of unequal length,
    and no partial sum is kept a block), or eight a block, a warp each
    (narrow)."""
    return max(1, n if plan.wide else -(-n // build.WARPS_PER_BLOCK))


def _v2_forward_cuda(logits, h_src, drop, receivers, num_nodes: int,
                     e_real: int, eps: float, normalize: bool,
                     rounding: Rounding, dst_ptr=None):
    dev, e, d, nh = _check_inputs(logits, h_src, drop, receivers,
                                  num_nodes, e_real)
    if rounding not in (FLOAT32, V2_BF16):
        raise ValueError(f"no such mode of the v2 forward: {rounding}")
    row_ptr = build.row_offsets(receivers, num_nodes, dst_ptr)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((num_nodes, d), **f32)
    den = torch.empty((num_nodes, nh), **f32)
    plan = plan_of(h_src, out, nh, d // nh)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().v2_forward(
            p(logits), p(h_src), p(drop), p(row_ptr), num_nodes, e_real, d,
            nh, d // nh, eps, int(normalize), p(out), p(den), *plan,
            forward_blocks(plan, num_nodes), rounding.flags(),
            build.stream(dev))
    build.check(err, "v2_forward")
    build.LAUNCHES[rounding.counter("v2_forward")] += 1
    return out, den


def _v2_backward_cuda(logits, h_src, drop, receivers, e_real: int,
                      eps: float, g, out, pay, need_drop: bool,
                      normalize: bool):
    n = g.shape[0] if g.dim() == 2 else -1
    dev, e, d, nh = _check_inputs(logits, h_src, drop, receivers, n, e_real)
    build.require(g, "g", dev, torch.float32, (n, d))
    if normalize:
        build.require(out, "out", dev, torch.float32, (n, d))
    build.require(pay, "den" if normalize else "d_den", dev, torch.float32,
                  (n, nh))
    f32 = dict(dtype=torch.float32, device=dev)
    d_h = torch.empty((h_src.shape[0], d), **f32)
    d_logits = torch.empty((e, nh), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    dden = torch.empty((n, nh), **f32) if normalize else None
    plan = row_plan(nh, d // nh, min(align_of(h_src), align_of(g)))
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().v2_backward(
            p(logits), p(h_src), p(drop), p(receivers), n, e_real,
            h_src.shape[0], e, d, nh, d // nh, eps, int(normalize), p(g),
            p(out) if normalize else None, p(pay), p(dden), p(d_h),
            p(d_logits), p(d_drop), *plan, build.stream(dev))
    build.check(err, "v2_backward")
    build.LAUNCHES["v2_backward"] += 1
    return d_logits, d_h, d_drop


def v2_forward(logits, h_src, drop, receivers, num_nodes: int, e_real: int,
               eps: float, normalize: bool, rounding: Rounding = FLOAT32,
               dst_ptr=None):
    """Kernel on CUDA tensors, plain version on CPU tensors. dst_ptr: the
    receivers' CSR offsets (num_nodes + 1,) where the caller holds them
    (Graph.dst_ptr; build.row_offsets checks them), derived per call
    otherwise; the plain version reads the receivers alone."""
    if logits.is_cuda:
        return _v2_forward_cuda(logits, h_src, drop, receivers, num_nodes,
                                e_real, eps, normalize, rounding, dst_ptr)
    build.require_cpu(logits)
    if dst_ptr is not None:
        build.require(dst_ptr, "dst_ptr", receivers.device, torch.int32,
                      (num_nodes + 1,))
    return v2_forward_plain(logits, h_src, drop, receivers, num_nodes,
                            e_real, eps, normalize, rounding)


def v2_backward(logits, h_src, drop, receivers, e_real: int, eps: float, g,
                out, pay, need_drop: bool, normalize: bool):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if logits.is_cuda:
        return _v2_backward_cuda(logits, h_src, drop, receivers, e_real,
                                 eps, g, out, pay, need_drop, normalize)
    build.require_cpu(logits)
    return v2_backward_plain(logits, h_src, drop, receivers, e_real, eps, g,
                             out, pay, need_drop, normalize)


# -- the differentiable ops ---------------------------------------------------

class _SegmentAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, h_src, drop_mask, receivers, num_nodes, e_real,
                eps, rounding, dst_ptr):
        out, den = v2_forward(logits, h_src, drop_mask, receivers,
                              num_nodes, e_real, eps, True, rounding, dst_ptr)
        ctx.save_for_backward(logits, h_src, drop_mask, receivers, out, den)
        ctx.e_real, ctx.eps = e_real, eps
        return out

    @staticmethod
    def backward(ctx, g):
        logits, h_src, drop_mask, receivers, out, den = ctx.saved_tensors
        d_logits, d_h, d_drop = v2_backward(
            logits, h_src, drop_mask, receivers, ctx.e_real, ctx.eps,
            g.contiguous(), out, den,
            drop_mask is not None and ctx.needs_input_grad[2], True)
        return (d_logits, d_h, d_drop) + (None,) * 6


@op_spans("segment_attention_partial")
class _SegmentAttentionPartial(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, h_src, drop_mask, receivers, num_nodes, e_real,
                rounding, dst_ptr):
        num, den = v2_forward(logits, h_src, drop_mask, receivers,
                              num_nodes, e_real, 0.0, False, rounding,
                              dst_ptr)
        ctx.save_for_backward(logits, h_src, drop_mask, receivers)
        ctx.e_real = e_real
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        logits, h_src, drop_mask, receivers = ctx.saved_tensors
        if g_num is None:
            g_num = h_src.new_zeros((g_den.shape[0], h_src.shape[1]))
        if g_den is None:
            g_den = logits.new_zeros((g_num.shape[0], logits.shape[1]))
        d_logits, d_h, d_drop = v2_backward(
            logits, h_src, drop_mask, receivers, ctx.e_real, 0.0,
            g_num.contiguous(), None, g_den.contiguous(),
            drop_mask is not None and ctx.needs_input_grad[2], False)
        return (d_logits, d_h, d_drop) + (None,) * 5


def _edges(logits, h_src, receivers, nh: int, f: int,
           num_real_edges: Optional[int]) -> int:
    e = receivers.shape[0]
    if logits.shape != (e, nh) or h_src.dim() != 2 or \
            h_src.shape[1] != nh * f:
        raise ValueError(f"shapes logits {tuple(logits.shape)}, h_src "
                         f"{tuple(h_src.shape)} do not match {e} edges, "
                         f"nh={nh}, f={f}")
    e_real = h_src.shape[0] if num_real_edges is None else num_real_edges
    if not 0 <= e_real <= h_src.shape[0] <= e:
        raise ValueError(f"num_real_edges {e_real} and {h_src.shape[0]} "
                         f"h_src rows: need num_real_edges <= rows <= {e}")
    return e_real


def fused_segment_attention(logits: torch.Tensor, h_src: torch.Tensor,
                            receivers: torch.Tensor,
                            drop_mask: Optional[torch.Tensor],
                            num_nodes: int, nh: int, f: int,
                            eps: float = 1e-8,
                            num_real_edges: Optional[int] = None, *,
                            dst_ptr: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """out (num_nodes, nh*f): the softmax-weighted sum of h_src by
    destination, differentiable in logits, h_src and drop_mask.

    logits (E, nh) float32 over the dst-sorted edges, NEG_INF on padding
    edges; h_src (E, nh*f) the gathered sender rows, or only its first
    rows down to num_real_edges; receivers (E,) int32 ascending;
    drop_mask (E, nh) attention-dropout multipliers or None.
    num_real_edges: the edges from there on are padding and are not
    walked; None walks every edge that has an h_src row, which gives the
    same result. dst_ptr: the receivers' CSR offsets (num_nodes + 1,)
    int32, where the caller holds them (Graph.dst_ptr, an edge shard's
    own); the forward derives them otherwise (two launches a call). The
    dtype knob (module doc) is read now."""
    e_real = _edges(logits, h_src, receivers, nh, f, num_real_edges)
    return _SegmentAttention.apply(logits.contiguous(), h_src.contiguous(),
                                   drop_mask, receivers, num_nodes, e_real,
                                   eps, v2_rounding(), dst_ptr)


def fused_segment_attention_partial(logits: torch.Tensor,
                                    h_src: torch.Tensor,
                                    receivers: torch.Tensor,
                                    drop_mask: Optional[torch.Tensor],
                                    num_nodes: int, nh: int, f: int,
                                    num_real_edges: Optional[int] = None,
                                    *, dst_ptr: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num (num_nodes, nh*f), den (num_nodes, nh)), unnormalised: every
    destination row is written, zeros where it has no edge here, so that
    an edge-sharded layer sums them over its shards before it divides.
    Arguments as fused_segment_attention's."""
    e_real = _edges(logits, h_src, receivers, nh, f, num_real_edges)
    return _SegmentAttentionPartial.apply(
        logits.contiguous(), h_src.contiguous(), drop_mask, receivers,
        num_nodes, e_real, v2_rounding(), dst_ptr)
