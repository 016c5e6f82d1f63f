"""The v5 whole-attention op: logits, global cap, softmax and aggregation.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_gat_table_autocap (:1551) with its VJP `_fgta_fwd`/`_fgta_bwd`
(:1577-1669), in the single-sweep (v10) form the JAX package runs by
default. The kernels are csrc/v5_attention.cu (forward: `_kernel_v5_auto`;
backward: segment_attention_bwd.py:`_kernel_v5_bwd`) and the d(h)
reduction of ops/cuda/segment_sum.py. `v5_forward_plain` and
`v5_backward_plain` are their plain torch versions.

The algebra (the reference's quirks, models/gat.py in the JAX package):
the global cap' = max raw' comes BEFORE LeakyReLU, so every capped logit
is <= 0 and LeakyReLU is `slope * x` on the whole reachable domain; exp
separates and one sweep accumulates the unnormalised
    num = sum exp(slope*raw') * drop * h[src],  den = sum exp(slope*raw')
with raw' shifted by a stop-gradient bound B >= max raw (so exp <= 1).
The epilogue out = num / (den + eps'), eps' = eps*exp(slope*cap'), is the
reference's +eps softmax exactly. The cap enters only through eps', so
its cotangent is closed-form, dc = -slope*eps'*sum(g.out per head * inv),
routed to the argmax (edge, head): ties go to the lowest e*nh + k.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import segment as seg
from . import build
from .segment_sum import dh_reduce

_KERNEL = "v5_attention"
MAX_HEADS = 8
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.load(_KERNEL)
    if not _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.v5_forward.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 6
                                   + [i, p])
        lib.v5_forward.restype = ctypes.c_int
        lib.v5_backward.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 9
                                    + [i, p])
        lib.v5_backward.restype = ctypes.c_int
        _configured = True
    return lib


# -- plain versions (CPU tensors) -------------------------------------------
#
# `attention_forward_plain` / `attention_backward_plain` are written over
# any list of edge slots: `snd` and `rcv` are int64 ids, `valid` (E, 1)
# marks the slots that are edges, and an `rcv` >= N (a slot that is none)
# is dropped from every sum. ops/cuda/window_attention.py runs them over
# its layout's slots.

def _edge_logits(h, a_src, s_dst_eff, snd, rcv):
    h_e = h.index_select(0, snd)
    rcv_in = rcv.clamp(max=s_dst_eff.shape[0] - 1)
    return h_e, h_e @ a_src + s_dst_eff.index_select(0, rcv_in), rcv_in


def attention_forward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                            slope: float):
    """(num (N, D), den (N, nh), cap' (), code () int32) of the module doc,
    the code counting slots in the order given."""
    n, nh = s_dst_eff.shape
    e, d = snd.shape[0], h.shape[1]
    h_e, raw, _ = _edge_logits(h, a_src, s_dst_eff, snd, rcv)
    flat = torch.where(valid, raw, torch.full_like(raw, float("-inf")))
    flat = flat.reshape(-1)
    code = torch.argmax(flat)              # first maximal: lowest e*nh + k
    cap = flat.max()
    ex = torch.where(valid, torch.exp(slope * raw), torch.zeros_like(raw))
    w = ex if drop is None else ex * drop
    num = seg.segment_sum((h_e.view(e, nh, d // nh) * w[:, :, None]
                           ).reshape(e, d), rcv, n)
    den = seg.segment_sum(ex, rcv, n)
    return num, den, cap, code.to(torch.int32)


def attention_backward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                             slope: float, g, out, den, epsp,
                             need_drop: bool):
    """(d_h rows (E, D) in slot order, d_drop (E, nh) | None,
    d_s_dst (N, nh), d_a_src (D, nh)) of the op before the cap chain;
    the rows of slots that are no edges are 0."""
    n, nh = s_dst_eff.shape
    e, d = snd.shape[0], h.shape[1]
    f = d // nh
    h_e, raw, rcv_in = _edge_logits(h, a_src, s_dst_eff, snd, rcv)
    inv = torch.where(den > 0, 1.0 / (den + epsp), torch.zeros_like(den))
    d_den = -(out * g).view(n, nh, f).sum(2) * inv
    ex = torch.where(valid, torch.exp(slope * raw), torch.zeros_like(raw))
    g_e = g.index_select(0, rcv_in)
    inv_e = inv.index_select(0, rcv_in)
    m = torch.ones_like(ex) if drop is None else drop
    hg = (h_e * g_e).view(e, nh, f).sum(2)
    d_raw = slope * ex * (hg * inv_e * m + d_den.index_select(0, rcv_in))
    coef = ex * m * inv_e
    d_h_rows = d_raw @ a_src.t() + (coef[:, :, None]
                                    * g_e.view(e, nh, f)).reshape(e, d)
    d_drop = hg * ex * inv_e if need_drop else None
    d_sdst = seg.segment_sum(d_raw, rcv, n)
    d_asrc = h_e.t() @ d_raw
    return d_h_rows, d_drop, d_sdst, d_asrc


def _real_prefix(senders, receivers, e_real):
    valid = (torch.arange(senders.shape[0], device=senders.device)
             < e_real)[:, None]
    return senders.long(), receivers.long(), valid


def v5_forward_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                     e_real: int, slope: float):
    """(num, den, cap', code) over the dst-sorted edges e < e_real."""
    return attention_forward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope)


def v5_backward_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool):
    """(d_h rows in dst order, d_drop, d_s_dst, d_a_src)."""
    return attention_backward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope, g, out, den,
        epsp, need_drop)


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(h, a_src, s_dst_eff, drop, senders, receivers, e_real):
    dev = h.device
    d = h.shape[1] if h.dim() == 2 else -1
    nh = a_src.shape[1] if a_src.dim() == 2 else -1
    build.require(h, "h", dev, torch.float32, (None, None))
    build.require(a_src, "a_src", dev, torch.float32, (d, None))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    if not 1 <= d <= 1024 or d % nh:
        raise ValueError(f"row width {d} must be nh*f and at most 1024")
    build.require(s_dst_eff, "s_dst", dev, torch.float32, (None, nh))
    e = senders.shape[0]
    build.require(senders, "senders", dev, torch.int32, (e,))
    build.require(receivers, "receivers", dev, torch.int32, (e,))
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e, nh))
    if not 0 < e_real <= e:
        raise ValueError(f"e_real {e_real} outside (0, {e}]")
    return dev, s_dst_eff.shape[0], e, d, nh


def _v5_forward_cuda(h, a_src, s_dst_eff, drop, senders, receivers,
                     e_real: int, slope: float):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real)
    row_ptr = build.csr_offsets(receivers, n)
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    num = torch.empty((n, d), **f32)
    den = torch.empty((n, nh), **f32)
    blk_max = torch.empty((nblk,), **f32)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), **f32)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.v5_forward(
            p(h), p(a_src), p(s_dst_eff), p(drop), p(senders), p(row_ptr),
            n, e_real, d, nh, d // nh, slope,
            p(num), p(den), p(blk_max), p(blk_code), p(cap), p(code),
            nblk, build.stream(dev))
    build.check(err, "v5_forward")
    build.LAUNCHES["v5_forward"] += 1
    return num, den, cap, code


def _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(out, "out", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    build.require(epsp, "epsp", dev, torch.float32, ())
    row_ptr = build.csr_offsets(receivers, n)
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h_rows = torch.empty((e, d), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    part = torch.empty((nblk, d * nh), **f32)
    d_asrc = torch.empty((d, nh), **f32)
    p = build.ptr
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.v5_backward(
            p(h), p(a_src), p(s_dst_eff), p(drop), p(senders), p(row_ptr),
            n, e_real, d, nh, d // nh, slope,
            p(g), p(out), p(den), p(epsp), p(d_h_rows), p(d_drop),
            p(d_sdst), p(part), p(d_asrc), nblk, build.stream(dev))
    build.check(err, "v5_backward")
    build.LAUNCHES["v5_backward"] += 1
    return d_h_rows, d_drop, d_sdst, d_asrc


def v5_forward(h, a_src, s_dst_eff, drop, senders, receivers,
               e_real: int, slope: float):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if h.is_cuda:
        return _v5_forward_cuda(h, a_src, s_dst_eff, drop, senders,
                                receivers, e_real, slope)
    if h.device.type == "cpu":
        return v5_forward_plain(h, a_src, s_dst_eff, drop, senders,
                                receivers, e_real, slope)
    raise ValueError(f"no kernel for device {h.device}")


def v5_backward(h, a_src, s_dst_eff, drop, senders, receivers,
                e_real: int, slope: float, g, out, den, epsp,
                need_drop: bool):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if h.is_cuda:
        return _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders,
                                 receivers, e_real, slope, g, out, den,
                                 epsp, need_drop)
    if h.device.type == "cpu":
        return v5_backward_plain(h, a_src, s_dst_eff, drop, senders,
                                 receivers, e_real, slope, g, out, den,
                                 epsp, need_drop)
    raise ValueError(f"no kernel for device {h.device}")


# -- the differentiable op ----------------------------------------------------

def normalise(num, den, cap, eps: float, slope: float, nh: int):
    """The epilogue: (num / (den + eps'), eps'), eps' = eps*exp(slope*cap')
    and 0 where a node receives nothing."""
    n, d = num.shape
    epsp = eps * torch.exp(slope * cap)
    inv = torch.where(den > 0, 1.0 / (den + epsp), torch.zeros_like(den))
    out = (num.view(n, nh, d // nh) * inv[:, :, None]).reshape(n, d)
    return out, epsp


def route_cap_cotangent(d_h, d_asrc, d_sdst, code, senders, receivers,
                        h_flat, a_src, g, out, den, epsp, slope: float,
                        nh: int):
    """Add the cap chain to (d_h, d_a_src, d_s_dst). The cap
    cap' = h[src*] . a_src[:, k*] + s_dst'[dst*, k*] enters the output only
    through eps', so its cotangent is closed-form; it goes to the argmax
    (slot, head) that `code` = slot*nh + head names, `senders` and
    `receivers` being indexed by slot."""
    n, d = out.shape
    inv = torch.where(den > 0, 1.0 / (den + epsp), torch.zeros_like(den))
    gout_h = (g * out).view(n, nh, d // nh).sum(2)
    dc = -slope * epsp * (gout_h * inv).sum()
    code = code.long().view(1)
    eidx, hidx = code // nh, code % nh
    src_star = senders.index_select(0, eidx).long()
    dst_star = receivers.index_select(0, eidx).long()
    hrow = h_flat.index_select(0, src_star)               # (1, D)
    acol = a_src.index_select(1, hidx)                    # (D, 1)
    d_h = d_h.index_add(0, src_star, dc * acol.view(1, d))
    d_asrc = d_asrc.index_add(1, hidx, dc * hrow.view(d, 1))
    d_sdst = d_sdst.index_put((dst_star, hidx), dc.view(1), accumulate=True)
    return d_h, d_asrc, d_sdst


class _V5Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, drop_mask, senders, receivers,
                src_order, bound, e_real, nh, eps, slope):
        s_dst_eff = (s_dst - bound).contiguous()
        num, den, cap, code = v5_forward(h_flat, a_src, s_dst_eff, drop_mask,
                                         senders, receivers, e_real, slope)
        out, epsp = normalise(num, den, cap, eps, slope, nh)
        ctx.save_for_backward(h_flat, a_src, s_dst_eff, drop_mask, senders,
                              receivers, src_order, den, out, epsp, code)
        ctx.e_real, ctx.nh, ctx.slope = e_real, nh, slope
        return out

    @staticmethod
    def backward(ctx, g):
        (h_flat, a_src, s_dst_eff, drop_mask, senders, receivers, src_order,
         den, out, epsp, code) = ctx.saved_tensors
        nh, slope = ctx.nh, ctx.slope
        g = g.contiguous()
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h_rows, d_drop, d_sdst, d_asrc = v5_backward(
            h_flat, a_src, s_dst_eff, drop_mask, senders, receivers,
            ctx.e_real, slope, g, out, den, epsp, need_drop)
        d_h = dh_reduce(d_h_rows, src_order, senders, h_flat.shape[0])

        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, code, senders, receivers, h_flat, a_src,
            g, out, den, epsp, slope, nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 8


def fused_gat_table_autocap(h_flat: torch.Tensor,
                            a_src: torch.Tensor,
                            s_dst: torch.Tensor,
                            drop_mask: Optional[torch.Tensor],
                            senders: torch.Tensor,
                            receivers: torch.Tensor,
                            src_order: torch.Tensor,
                            e_real: int,
                            score_bound: Optional[torch.Tensor],
                            num_nodes: int, nh: int, f: int,
                            eps: float = 1e-8,
                            slope: float = 0.01) -> torch.Tensor:
    """Normalised attention output (num_nodes, nh*f) of the reference GAT
    layer, differentiable in h_flat, a_src, s_dst and drop_mask.

    h_flat (N, nh*f) node features, a_src (nh*f, nh) the cross-head source
    half of the attention map, s_dst (N, nh) destination scores; the graph
    is dst-sorted with the real edges first (e < e_real), padding edges
    pointing at the sink; src_order sorts the edges by sender.
    drop_mask: (E, nh) attention-dropout multipliers or None.
    score_bound: any scalar >= the max raw logit (stop-gradient); None
    computes it from the score tables."""
    if s_dst.shape != (num_nodes, nh) or h_flat.shape[1] != nh * f:
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)} do not match "
                         f"num_nodes={num_nodes}, nh={nh}, f={f}")
    if score_bound is None:
        score_bound = (h_flat @ a_src).max() + s_dst.max()
    return _V5Attention.apply(h_flat.contiguous(), a_src.contiguous(),
                              s_dst, drop_mask, senders, receivers,
                              src_order, score_bound.detach(), int(e_real),
                              nh, eps, slope)
