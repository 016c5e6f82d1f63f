"""The v5 whole-attention op: logits, global cap, softmax and aggregation.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_gat_table_autocap (:1551) with its VJP `_fgta_fwd`/`_fgta_bwd`
(:1577-1669), in the single-sweep (v10) form the JAX package runs by
default, and v5_sweep1_parts (:1674) with `_v5sp_fwd`/`_v5sp_bwd`, the
same sweep without its epilogue. The kernels are csrc/v5_attention.cu
(forward: `_kernel_v5_auto`; backward: segment_attention_bwd.py:
`_kernel_v5_bwd`, in its normalised and its parts mode) and the d(h)
reduction of ops/cuda/segment_sum.py. `v5_forward_plain` and
`v5_backward_plain` are their plain torch versions. At rows wider than
256 floats the backward takes its wide form: d(a_src) by sender
(`dasrc_by_sender`, kernel v5_dasrc) from the per-edge d(raw) rows.

The 2-phase form (the JAX package's path under GAT_TPU_V10=0 or
GAT_TPU_V5_MERGED=0) lives here too: v5_local_cap (:1765, the cap
pre-pass `_kernel_v5_cap`, kernel entry v5_cap), fused_gat_table (:1029,
the explicit-cap forward `_kernel_v5`, entry v5_forward_two_phase, and
`_kernel_v5_bwd` in its sweep1=False mode, entry v5_backward_two_phase)
and fused_gat_table_autocap(two_phase=True), which composes the two. There
the cap is taken first and the attention pass computes
    ex = exp(leaky(raw - cap)),  out = sum drop*ex*h[src] / (den + eps)
with the full LeakyReLU (a caller's cap may leave some pre = raw - cap
positive) and the plain eps; the backward has a d(cap) output, -sum of
d(raw), which the cap op routes to its argmax (edge, head). On Hopper the
merged (one launch) and unmerged (two kernels) contracts of the TPU are
the same launches: v5_cap, then v5_forward_two_phase, on one stream, the
cap handed over in device memory.

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

`v5_sweep1_parts` returns (num, den, cap', code) and leaves the epilogue
to its caller, which may first add the parts of another op over other
edges (num and den are sums over edges, so they add over any partition
of them; the hybrid layer of models/gat.py does this) and differentiates
the epilogue itself: the backward then takes the raw cotangents of num,
den and cap'.

The JAX package's dtype knobs of these ops, read at call time with its
defaults and meanings: GAT_TPU_KERNEL_DTYPE=bfloat16 (`_matmul_dtype`)
rounds each edge's [weighted h | ex] to bfloat16 before the float32
sums of the forwards (not the cap pass, which sums nothing);
GAT_TPU_H_DTYPE=bfloat16 (`_h_dtype`) casts the h table to bfloat16
before the gather, so that the logits, every product of the forward and
backward and the cap chain read rounded rows (d(h) stays float32). The
op hands its kernels the policy (rounding.Rounding) and, in the table
mode, a bfloat16 table cast once; an explicit `rounding` (the v6 form of
window_attention.fused_gat_window, which runs on these kernels) replaces
the knobs. GAT_TPU_DH_REDUCE_NT=0 (segment_sum.dh_transposed) reduces
d(h) through the feature-major kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .. import segment as seg
from . import build
from .rounding import FLOAT32, Rounding, check_table, maybe_bf16
from .segment_sum import dh_reduce, dh_transposed, segment_sum_sorted_plain

_KERNEL = "v5_attention"
MAX_HEADS = 8
_configured = set()


def _matmul_dtype() -> torch.dtype:
    """GAT_TPU_KERNEL_DTYPE as segment_attention._matmul_dtype reads it:
    bfloat16 contraction inputs of the forward kernels' sums where it is
    "bfloat16", else float32."""
    return (torch.bfloat16
            if os.environ.get("GAT_TPU_KERNEL_DTYPE") == "bfloat16"
            else torch.float32)


def _h_dtype() -> torch.dtype:
    """GAT_TPU_H_DTYPE as segment_attention._v5_operands and
    gather_h_src_t read it: the h table cast to bfloat16 before the
    gather where it is "bfloat16", else float32."""
    return (torch.bfloat16
            if os.environ.get("GAT_TPU_H_DTYPE") == "bfloat16"
            else torch.float32)


def v5_rounding() -> Rounding:
    """The policy of the v5 (and v4) ops under the JAX package's knobs,
    read now."""
    return Rounding(table=_h_dtype() == torch.bfloat16,
                    acc=_matmul_dtype() == torch.bfloat16)


def _lib(bf16_table: bool = False) -> ctypes.CDLL:
    """The kernels' library for a float32 or a bfloat16 h table."""
    name = build.library(_KERNEL, bf16_table)
    lib = build.load(name)
    if name not in _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.v5_forward.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 6
                                   + [i, i, p])
        lib.v5_forward.restype = ctypes.c_int
        lib.v5_backward.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 10
                                    + [i, i, p])
        lib.v5_backward.restype = ctypes.c_int
        lib.v5_backward_parts.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 8
                                          + [i, i, p])
        lib.v5_backward_parts.restype = ctypes.c_int
        lib.v5_cap.argtypes = [p] * 5 + [i] * 5 + [p] * 4 + [i, i, p]
        lib.v5_cap.restype = ctypes.c_int
        lib.v5_forward_two_phase.argtypes = ([p] * 7 + [i] * 5 + [fl] * 2
                                             + [p] * 2 + [i, i, p])
        lib.v5_forward_two_phase.restype = ctypes.c_int
        lib.v5_backward_two_phase.argtypes = ([p] * 7 + [i] * 5 + [fl] * 2
                                              + [p] * 9 + [i, i, p])
        lib.v5_backward_two_phase.restype = ctypes.c_int
        lib.v5_dasrc.argtypes = [p] * 4 + [i] * 3 + [p, i, p, i, i, p]
        lib.v5_dasrc.restype = ctypes.c_int
        _configured.add(name)
    return lib


# -- plain versions (CPU tensors) -------------------------------------------
#
# `attention_forward_plain` / `attention_backward_plain` are written over
# any list of edge slots: `snd` and `rcv` are int64 ids, `valid` (E, 1)
# marks the slots that are edges, and an `rcv` >= N (a slot that is none)
# is dropped from every sum. ops/cuda/window_attention.py runs them over
# its layout's slots. Each takes the kernel's rounding policy; h is the
# table the kernel reads (bfloat16 in the table mode).

def _edge_logits(h, a_src, s_dst_eff, snd, rcv, rows: bool = False):
    """(gathered rows, raw logits, clamped receivers): the logits from
    the rows as gathered, the rows rounded after that where `rows`."""
    h_e = h.float().index_select(0, snd)
    rcv_in = rcv.clamp(max=s_dst_eff.shape[0] - 1)
    raw = h_e @ a_src + s_dst_eff.index_select(0, rcv_in)
    return maybe_bf16(h_e, rows), raw, rcv_in


def _cap_of(raw, valid):
    """(max of raw over the slots that are edges, its lowest slot*nh + k
    as int32): argmax returns the first maximal element."""
    flat = torch.where(valid, raw, torch.full_like(raw, float("-inf")))
    flat = flat.reshape(-1)
    return flat.max(), torch.argmax(flat).to(torch.int32)


def _aggregate(h_e, w, rcv, n: int, nh: int, acc: bool = False):
    """sum over slots of w (E, nh) times the slots' h rows, per receiver;
    each product rounded to bfloat16 first where `acc`."""
    e, d = h_e.shape
    return seg.segment_sum(maybe_bf16(
        (h_e.view(e, nh, d // nh) * w[:, :, None]).reshape(e, d), acc),
        rcv, n)


def attention_forward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                            slope: float, rounding: Rounding = FLOAT32):
    """(num (N, D), den (N, nh), cap' (), code () int32) of the module doc,
    the code counting slots in the order given."""
    n, nh = s_dst_eff.shape
    h_e, raw, _ = _edge_logits(h, a_src, s_dst_eff, snd, rcv, rounding.rows)
    cap, code = _cap_of(raw, valid)
    ex = torch.where(valid, torch.exp(slope * raw), torch.zeros_like(raw))
    num = _aggregate(h_e, ex if drop is None else ex * drop, rcv, n, nh,
                     rounding.acc)
    return num, seg.segment_sum(maybe_bf16(ex, rounding.acc), rcv, n), \
        cap, code


def attention_cap_plain(h, a_src, s_dst, snd, rcv, valid):
    """(cap (), code () int32): the max raw logit over the slots that are
    edges and its lowest slot*nh + head (the 2-phase cap pass; a bfloat16
    h is the table mode's rounded table)."""
    return _cap_of(_edge_logits(h, a_src, s_dst, snd, rcv)[1], valid)


def _two_phase_ex(raw, cap, valid, slope: float):
    """(pre = raw - cap, ex = exp(leaky(pre)), 0 on slots that are no
    edges) of the 2-phase form."""
    pre = raw - cap
    ex = torch.exp(torch.where(pre > 0, pre, slope * pre))
    return pre, torch.where(valid, ex, torch.zeros_like(ex))


def _safe_inverse(den, eps):
    return torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))


def attention_forward_two_phase_plain(h, a_src, s_dst, cap, drop, snd, rcv,
                                      valid, eps: float, slope: float,
                                      rounding: Rounding = FLOAT32):
    """(out (N, D) = num / (den + eps), 0 where den == 0; den (N, nh)) of
    the 2-phase forward, from the given cap."""
    n, nh = s_dst.shape
    d = h.shape[1]
    h_e, raw, _ = _edge_logits(h, a_src, s_dst, snd, rcv, rounding.rows)
    _, ex = _two_phase_ex(raw, cap, valid, slope)
    num = _aggregate(h_e, ex if drop is None else ex * drop, rcv, n, nh,
                     rounding.acc)
    den = seg.segment_sum(maybe_bf16(ex, rounding.acc), rcv, n)
    inv = _safe_inverse(den, eps)
    return (num.view(n, nh, d // nh) * inv[:, :, None]).reshape(n, d), den


def attention_backward_two_phase_plain(h, a_src, s_dst, cap, drop, snd, rcv,
                                       valid, eps: float, slope: float, g,
                                       out, den, need_drop: bool,
                                       rounding: Rounding = FLOAT32):
    """(d_h rows (E, D) in slot order, d_drop (E, nh) | None, d_s_dst
    (N, nh), d_a_src (D, nh), d_cap ()) of the 2-phase op: d(pre) takes
    the slope where pre <= 0, d(raw) = d(pre), d(cap) = -sum d(raw)."""
    return attention_backward_plain(h, a_src, s_dst, drop, snd, rcv, valid,
                                    slope, g, out, den, eps, need_drop,
                                    cap=cap, rounding=rounding)


def attention_backward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                             slope: float, g, out, den, epsp,
                             need_drop: bool, normalize: bool = True,
                             cap=None, rounding: Rounding = FLOAT32,
                             with_draw: bool = False):
    """(d_h rows (E, D) in slot order, d_drop (E, nh) | None,
    d_s_dst (N, nh), d_a_src (D, nh)) of the op before the cap chain;
    the rows of slots that are no edges are 0.

    normalize=False is the parts mode: `g` carries d(num) and `den`
    carries d(den), the raw cotangents of the unnormalised parts; `out`
    and `epsp` are not read (the caller's epilogue owns the quotient).
    cap: the 2-phase op's cap (a () tensor): ex = exp(leaky(raw - cap)),
    `epsp` is the plain eps, and d_cap () = -sum d(raw) (float32) comes
    fifth. rounding: rows, payload, d_h, d_raw and d_sdst are read.
    with_draw: d(raw) (E, nh), rounded as d(a_src) reads it, comes last
    (the wide backward's per-edge rows, 0 on slots that are no edges)."""
    n, nh = s_dst_eff.shape
    e, d = snd.shape[0], h.shape[1]
    f = d // nh
    r = rounding
    h_e, raw, rcv_in = _edge_logits(h, a_src, s_dst_eff, snd, rcv, r.rows)
    if normalize:
        inv = _safe_inverse(den, epsp)
        d_den = -(out * g).view(n, nh, f).sum(2) * inv
    else:
        inv, d_den = torch.ones_like(den), den
    # each destination's payload, rounded after d(den) is taken from it
    g, inv, d_den = (maybe_bf16(t, r.payload) for t in (g, inv, d_den))
    if cap is None:
        ex = torch.where(valid, torch.exp(slope * raw), torch.zeros_like(raw))
    else:
        pre, ex = _two_phase_ex(raw, cap, valid, slope)
    g_e = g.index_select(0, rcv_in)
    inv_e = inv.index_select(0, rcv_in)
    m = torch.ones_like(ex) if drop is None else drop
    hg = (h_e * g_e).view(e, nh, f).sum(2)
    if cap is None:     # the negative branch everywhere (raw' <= cap')
        d_raw = slope * ex * (hg * inv_e * m + d_den.index_select(0, rcv_in))
    else:
        d_lg = ex * (hg * inv_e * m + d_den.index_select(0, rcv_in))
        d_raw = torch.where(pre > 0, d_lg, slope * d_lg)
    coef = ex * m * inv_e
    d_h_rows = maybe_bf16(d_raw @ a_src.t() + (
        coef[:, :, None] * g_e.view(e, nh, f)).reshape(e, d), r.d_h)
    d_drop = hg * ex * inv_e if need_drop else None
    draw = maybe_bf16(d_raw, r.d_raw)
    grads = (d_h_rows, d_drop,
             seg.segment_sum(maybe_bf16(d_raw, r.d_sdst), rcv, n),
             h_e.t() @ draw)
    if cap is not None:
        grads += (-d_raw.sum(),)
    return grads + (draw,) if with_draw else grads


def _real_prefix(senders, receivers, e_real):
    valid = (torch.arange(senders.shape[0], device=senders.device)
             < e_real)[:, None]
    return senders.long(), receivers.long(), valid


def v5_forward_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                     e_real: int, slope: float,
                     rounding: Rounding = FLOAT32):
    """(num, den, cap', code) over the dst-sorted edges e < e_real."""
    return attention_forward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope, rounding)


def v5_backward_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool, normalize: bool = True,
                      rounding: Rounding = FLOAT32, with_draw: bool = False):
    """(d_h rows in dst order, d_drop, d_s_dst, d_a_src); normalize=False
    and with_draw as attention_backward_plain takes them."""
    return attention_backward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope, g, out, den,
        epsp, need_drop, normalize, rounding=rounding, with_draw=with_draw)


def v5_cap_plain(h, a_src, s_dst, senders, receivers, e_real: int):
    """(cap, code) over the dst-sorted edges e < e_real."""
    return attention_cap_plain(h, a_src, s_dst,
                               *_real_prefix(senders, receivers, e_real))


def v5_forward_two_phase_plain(h, a_src, s_dst, cap, drop, senders,
                               receivers, e_real: int, eps: float,
                               slope: float, rounding: Rounding = FLOAT32):
    """(out, den) of the 2-phase forward over the edges e < e_real."""
    return attention_forward_two_phase_plain(
        h, a_src, s_dst, cap, drop,
        *_real_prefix(senders, receivers, e_real), eps, slope, rounding)


def v5_backward_two_phase_plain(h, a_src, s_dst, cap, drop, senders,
                                receivers, e_real: int, eps: float,
                                slope: float, g, out, den, need_drop: bool,
                                rounding: Rounding = FLOAT32,
                                with_draw: bool = False):
    """(d_h rows in dst order, d_drop, d_s_dst, d_a_src, d_cap[, draw])."""
    return attention_backward_plain(
        h, a_src, s_dst, drop, *_real_prefix(senders, receivers, e_real),
        slope, g, out, den, eps, need_drop, cap=cap, rounding=rounding,
        with_draw=with_draw)


# -- the wide backward's d(a_src), by sender ----------------------------------
#
# Rows wider than WIDE_D floats take the backward kernel's wide form
# (csrc/v5_attention.cu, kWideC): it writes each edge's d(raw) row
# (E, nh) and leaves d(a_src) to v5_dasrc, which sums those rows by
# sender, S = (n_src, nh), and takes h^T S in per-block partials and an
# ordered second pass. The steps below are the same on the CPU (plain)
# and on the card (the kernel), so the CPU runs this plumbing too.

WIDE_D = 256


def wide_form(d: int) -> bool:
    """Whether the backward at row width d takes the wide form."""
    return d > WIDE_D


def sender_runs(senders, e_real: int, n_src: int, src_order=None,
                src_ptr=None):
    """(order, ptr): the real edges' stable sender order and the
    (n_src + 1,) int32 offsets of each sender's run in it. The caller's
    (Graph.src_order with Graph.src_ptr, which cover exactly these) where
    it holds them; derived from senders[:e_real] otherwise."""
    if src_ptr is not None and src_order is not None:
        return src_order, src_ptr
    order = torch.argsort(senders[:e_real], stable=True).to(torch.int32)
    return order, build.csr_offsets(
        senders.index_select(0, order.long()), n_src)


def dasrc_by_sender_plain(h, draw, order, ptr, rounding: Rounding = FLOAT32):
    """h^T S, S[s] = the sum of draw's rows of sender s's edges (in the
    order of `order`, the runs `ptr`); h the table the kernel reads, its
    rows rounded as d(a_src) reads them (rows)."""
    s_rows = segment_sum_sorted_plain(draw, None, ptr.shape[0] - 1,
                                      order=order, ptr=ptr)
    return maybe_bf16(h.float(), rounding.rows).t() @ s_rows


def _dasrc_cuda(h, draw, order, ptr, part, rounding: Rounding):
    """The ordered sum (stride,) of v5_dasrc's partial rows, `part`
    (nblk, stride) as the backward kernel left it."""
    dev = h.device
    n_src, d = h.shape
    nh = draw.shape[1]
    build.require(draw, "draw", dev, torch.float32, (None, nh))
    build.require(order, "src_order", dev, torch.int32, (None,))
    build.require(ptr, "src_ptr", dev, torch.int32, (n_src + 1,))
    nblk, stride = part.shape
    out = torch.empty((stride,), dtype=torch.float32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_dasrc(
            p(h), p(draw), p(order), p(ptr), n_src, d, nh, p(part), stride,
            p(out), nblk, rounding.flags(), build.stream(dev))
    build.check(err, "v5_dasrc")
    build.LAUNCHES["v5_dasrc"] += 1
    return out


def dasrc_by_sender(h, draw, order, ptr, rounding: Rounding = FLOAT32,
                    part=None):
    """d(a_src) (d, nh) of the wide backward from its per-edge d(raw) rows
    draw (E, nh), by sender (sender_runs gives order and ptr). Kernel on
    CUDA tensors: `part` is the (nblk, stride) partial rows the backward
    kernel launched over (a fresh one where None); the whole ordered sum
    (stride,) comes second (its last entry the 2-phase backward's d(cap)
    where stride = d*nh + 1). Plain version on CPU tensors (second None)."""
    d, nh = h.shape[1], draw.shape[1]
    if h.is_cuda:
        if part is None:
            part = torch.empty((build.grid_blocks(h.shape[0]), d * nh),
                               dtype=torch.float32, device=h.device)
        flat = _dasrc_cuda(h, draw, order, ptr, part, rounding)
        return flat[:d * nh].view(d, nh), flat
    build.require_cpu(h)
    return dasrc_by_sender_plain(h, draw, order, ptr, rounding), None


# -- kernel wrappers (CUDA tensors) -----------------------------------------
#
# Each takes the op's rounding policy: h is a bfloat16 table in the table
# mode (rounding.check_table) and the policy goes to the C entry as its
# flags word. A mode counts its launches apart (Rounding.counter: the
# bfloat16 modes under "<entry>_bf16").

def _check_inputs(h, a_src, s_dst_eff, drop, senders, receivers, e_real,
                  rounding: Rounding):
    dev = h.device
    d = h.shape[1] if h.dim() == 2 else -1
    nh = a_src.shape[1] if a_src.dim() == 2 else -1
    check_table(h, rounding)
    build.require(h, "h", dev, h.dtype, (None, None))
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
                     e_real: int, slope: float, dst_ptr=None,
                     rounding: Rounding = FLOAT32):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real, rounding)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    num = torch.empty((n, d), **f32)
    den = torch.empty((n, nh), **f32)
    blk_max = torch.empty((nblk,), **f32)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), **f32)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    lib = _lib(rounding.table)
    with torch.cuda.device(dev):
        err = lib.v5_forward(
            p(h), p(a_src), p(s_dst_eff), p(drop), p(senders), p(row_ptr),
            n, e_real, d, nh, d // nh, slope,
            p(num), p(den), p(blk_max), p(blk_code), p(cap), p(code),
            nblk, rounding.flags(), build.stream(dev))
    build.check(err, "v5_forward")
    build.LAUNCHES[rounding.counter("v5_forward")] += 1
    return num, den, cap, code


def _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool, normalize: bool = True, dst_ptr=None,
                      rounding: Rounding = FLOAT32, src_order=None,
                      src_ptr=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real, rounding)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    if normalize:
        build.require(out, "out", dev, torch.float32, (n, d))
        build.require(epsp, "epsp", dev, torch.float32, ())
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h_rows = torch.empty((e, d), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    part = torch.empty((nblk, d * nh), **f32)
    d_asrc = torch.empty((d, nh), **f32)
    draw = torch.empty((e, nh), **f32) if wide_form(d) else None
    p = build.ptr
    lib = _lib(rounding.table)
    graph_args = (p(h), p(a_src), p(s_dst_eff), p(drop), p(senders),
                  p(row_ptr), n, e_real, d, nh, d // nh, slope)
    outputs = (p(d_h_rows), p(d_drop), p(d_sdst), p(part), p(d_asrc),
               p(draw), nblk, rounding.flags(), build.stream(dev))
    name = "v5_backward" if normalize else "v5_backward_parts"
    with torch.cuda.device(dev):
        if normalize:
            err = lib.v5_backward(*graph_args, p(g), p(out), p(den), p(epsp),
                                  *outputs)
        else:       # g is d(num), den is d(den)
            err = lib.v5_backward_parts(*graph_args, p(g), p(den), *outputs)
    build.check(err, name)
    build.LAUNCHES[rounding.counter(name)] += 1
    if draw is not None:
        d_asrc, _ = dasrc_by_sender(
            h, draw, *sender_runs(senders, e_real, h.shape[0], src_order,
                                  src_ptr), rounding, part)
    return d_h_rows, d_drop, d_sdst, d_asrc


def _v5_cap_cuda(h, a_src, s_dst, senders, receivers, e_real: int,
                 rounding: Rounding = FLOAT32, dst_ptr=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, None, senders,
                                     receivers, e_real, rounding)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    nblk = build.grid_blocks(n)
    blk_max = torch.empty((nblk,), dtype=torch.float32, device=dev)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), dtype=torch.float32, device=dev)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_cap(
            p(h), p(a_src), p(s_dst), p(senders), p(row_ptr), n, e_real, d,
            nh, d // nh, p(blk_max), p(blk_code), p(cap), p(code), nblk,
            rounding.flags(), build.stream(dev))
    build.check(err, "v5_cap")
    build.LAUNCHES[rounding.counter("v5_cap")] += 1
    return cap, code


def _v5_forward_two_phase_cuda(h, a_src, s_dst, cap, drop, senders,
                               receivers, e_real: int, eps: float,
                               slope: float, rounding: Rounding = FLOAT32,
                               dst_ptr=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, drop, senders,
                                     receivers, e_real, rounding)
    build.require(cap, "cap", dev, torch.float32, ())
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    nblk = build.grid_blocks(n)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    den = torch.empty((n, nh), dtype=torch.float32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_forward_two_phase(
            p(h), p(a_src), p(s_dst), p(cap), p(drop), p(senders),
            p(row_ptr), n, e_real, d, nh, d // nh, eps, slope, p(out),
            p(den), nblk, rounding.flags(), build.stream(dev))
    build.check(err, "v5_forward_two_phase")
    build.LAUNCHES[rounding.counter("v5_forward_two_phase")] += 1
    return out, den


def _v5_backward_two_phase_cuda(h, a_src, s_dst, cap, drop, senders,
                                receivers, e_real: int, eps: float,
                                slope: float, g, out, den, need_drop: bool,
                                rounding: Rounding = FLOAT32, dst_ptr=None,
                                src_order=None, src_ptr=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, drop, senders,
                                     receivers, e_real, rounding)
    build.require(cap, "cap", dev, torch.float32, ())
    for t, name, shape in ((g, "g", (n, d)), (out, "out", (n, d)),
                           (den, "den", (n, nh))):
        build.require(t, name, dev, torch.float32, shape)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h_rows = torch.empty((e, d), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    part = torch.empty((nblk, d * nh + 1), **f32)
    d_asrc_cap = torch.empty((d * nh + 1,), **f32)
    draw = torch.empty((e, nh), **f32) if wide_form(d) else None
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_backward_two_phase(
            p(h), p(a_src), p(s_dst), p(cap), p(drop), p(senders),
            p(row_ptr), n, e_real, d, nh, d // nh, eps, slope, p(g), p(out),
            p(den), p(d_h_rows), p(d_drop), p(d_sdst), p(part),
            p(d_asrc_cap), p(draw), nblk, rounding.flags(),
            build.stream(dev))
    build.check(err, "v5_backward_two_phase")
    build.LAUNCHES[rounding.counter("v5_backward_two_phase")] += 1
    if draw is not None:    # d(a_src), then the kernel's d(cap) column
        _, d_asrc_cap = dasrc_by_sender(
            h, draw, *sender_runs(senders, e_real, h.shape[0], src_order,
                                  src_ptr), rounding, part)
    return (d_h_rows, d_drop, d_sdst, d_asrc_cap[:d * nh].view(d, nh),
            d_asrc_cap[d * nh])


def v5_forward(h, a_src, s_dst_eff, drop, senders, receivers,
               e_real: int, slope: float, dst_ptr=None,
               rounding: Rounding = FLOAT32):
    """Kernel on CUDA tensors, plain version on CPU tensors. dst_ptr: the
    (N + 1,) int32 CSR offsets of `receivers`, where the caller holds
    them; the kernel wrapper computes them otherwise. rounding: the
    bfloat16 mode (rows, acc; h a bfloat16 table where `table`)."""
    if h.is_cuda:
        return _v5_forward_cuda(h, a_src, s_dst_eff, drop, senders,
                                receivers, e_real, slope, dst_ptr, rounding)
    build.require_cpu(h)
    return v5_forward_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope,
        rounding)


def _wide_plain(grads, h, senders, e_real, src_order, src_ptr, rounding):
    """A plain backward's grads with its d(a_src) (index 3) taken by sender
    from its draw (last), as the wide form takes it; draw dropped."""
    *grads, draw = grads
    grads[3] = dasrc_by_sender(
        h, draw, *sender_runs(senders, e_real, h.shape[0], src_order,
                              src_ptr), rounding)[0]
    return tuple(grads)


def v5_backward(h, a_src, s_dst_eff, drop, senders, receivers,
                e_real: int, slope: float, g, out, den, epsp,
                need_drop: bool, normalize: bool = True, dst_ptr=None,
                rounding: Rounding = FLOAT32, *, src_order=None,
                src_ptr=None):
    """Kernel on CUDA tensors, plain version on CPU tensors.
    normalize=False is the parts mode (attention_backward_plain says what
    `g` and `den` carry then); it launches the kernel's parts mode and
    counts as "v5_backward_parts". Rows wider than WIDE_D take d(a_src)
    by sender (dasrc_by_sender) on either device: src_order and src_ptr
    are the real edges' sender runs (sender_runs), derived where None."""
    if h.is_cuda:
        return _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders,
                                 receivers, e_real, slope, g, out, den,
                                 epsp, need_drop, normalize, dst_ptr,
                                 rounding, src_order, src_ptr)
    build.require_cpu(h)
    wide = wide_form(h.shape[1])
    grads = v5_backward_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope, g,
        out, den, epsp, need_drop, normalize, rounding, with_draw=wide)
    return (_wide_plain(grads, h, senders, e_real, src_order, src_ptr,
                        rounding) if wide else grads)


def v5_cap(h, a_src, s_dst, senders, receivers, e_real: int,
           rounding: Rounding = FLOAT32, *, dst_ptr=None):
    """(cap (), code () int32): the 2-phase cap pass (of a bfloat16 table
    in the table mode; no other point of the policy applies). Kernel on
    CUDA tensors (cap and code stay in device memory), plain version on
    CPU tensors. dst_ptr: as v5_forward's."""
    if h.is_cuda:
        return _v5_cap_cuda(h, a_src, s_dst, senders, receivers, e_real,
                            rounding, dst_ptr)
    build.require_cpu(h)
    check_table(h, rounding)
    return v5_cap_plain(h, a_src, s_dst, senders, receivers, e_real)


def v5_forward_two_phase(h, a_src, s_dst, cap, drop, senders, receivers,
                         e_real: int, eps: float, slope: float,
                         rounding: Rounding = FLOAT32, *, dst_ptr=None):
    """(out, den) of the 2-phase forward from the cap (a () float32
    tensor on the device). Kernel on CUDA tensors, plain version on CPU
    tensors. dst_ptr: as v5_forward's."""
    if h.is_cuda:
        return _v5_forward_two_phase_cuda(h, a_src, s_dst, cap, drop,
                                          senders, receivers, e_real, eps,
                                          slope, rounding, dst_ptr)
    build.require_cpu(h)
    return v5_forward_two_phase_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        rounding)


def v5_backward_two_phase(h, a_src, s_dst, cap, drop, senders, receivers,
                          e_real: int, eps: float, slope: float, g, out, den,
                          need_drop: bool, rounding: Rounding = FLOAT32, *,
                          dst_ptr=None, src_order=None, src_ptr=None):
    """(d_h rows in dst order, d_drop | None, d_s_dst, d_a_src, d_cap) of
    the 2-phase op. Kernel on CUDA tensors, plain version on CPU
    tensors. dst_ptr: as v5_forward's; src_order, src_ptr: as
    v5_backward's."""
    if h.is_cuda:
        return _v5_backward_two_phase_cuda(
            h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps,
            slope, g, out, den, need_drop, rounding, dst_ptr, src_order,
            src_ptr)
    build.require_cpu(h)
    wide = wide_form(h.shape[1])
    grads = v5_backward_two_phase_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        g, out, den, need_drop, rounding, with_draw=wide)
    return (_wide_plain(grads, h, senders, e_real, src_order, src_ptr,
                        rounding) if wide else grads)


# -- the differentiable op ----------------------------------------------------

def normalise(num, den, cap, eps: float, slope: float, nh: int):
    """The epilogue: (num / (den + eps'), eps'), eps' = eps*exp(slope*cap')
    and 0 where a node receives nothing."""
    n, d = num.shape
    epsp = eps * torch.exp(slope * cap)
    inv = _safe_inverse(den, epsp)
    out = (num.view(n, nh, d // nh) * inv[:, :, None]).reshape(n, d)
    return out, epsp


def cap_cotangent(g, out, den, epsp, slope: float, nh: int):
    """The cotangent of cap' under the normalising epilogue: the cap enters
    the output only through eps', so it is closed-form,
    -slope * eps' * sum over (node, head) of (g . out)_head * inv."""
    n, d = out.shape
    inv = _safe_inverse(den, epsp)
    gout_h = (g * out).view(n, nh, d // nh).sum(2)
    return -slope * epsp * (gout_h * inv).sum()


def route_cap_cotangent(d_h, d_asrc, d_sdst, dc, code, senders, receivers,
                        h_flat, a_src, nh: int):
    """Add the cap chain to (d_h, d_a_src, d_s_dst): the cotangent `dc`
    (a scalar tensor) of cap' = h[src*] . a_src[:, k*] + s_dst'[dst*, k*]
    goes to the argmax (slot, head) that `code` = slot*nh + head names,
    `senders` and `receivers` being indexed by slot. h_flat: the table
    the op's logits read (a bfloat16 one in the v5 ops' table mode)."""
    d = h_flat.shape[1]
    code = code.long().view(1)
    eidx, hidx = code // nh, code % nh
    src_star = senders.index_select(0, eidx).long()
    dst_star = receivers.index_select(0, eidx).long()
    hrow = h_flat.index_select(0, src_star).float()       # (1, D)
    acol = a_src.index_select(1, hidx)                    # (D, 1)
    d_h = d_h.index_add(0, src_star, dc * acol.view(1, d))
    d_asrc = d_asrc.index_add(1, hidx, dc * hrow.view(d, 1))
    d_sdst = d_sdst.index_put((dst_star, hidx), dc.view(1), accumulate=True)
    return d_h, d_asrc, d_sdst


class _V5Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, drop_mask, senders, receivers,
                src_order, src_ptr, dst_ptr, bound, e_real, nh, eps, slope,
                rounding, dh_t):
        s_dst_eff = (s_dst - bound).contiguous()
        h_k = rounding.table_of(h_flat)
        num, den, cap, code = v5_forward(h_k, a_src, s_dst_eff, drop_mask,
                                         senders, receivers, e_real, slope,
                                         dst_ptr, rounding)
        out, epsp = normalise(num, den, cap, eps, slope, nh)
        ctx.save_for_backward(h_k, a_src, s_dst_eff, drop_mask, senders,
                              receivers, src_order, src_ptr, dst_ptr, den,
                              out, epsp, code)
        ctx.e_real, ctx.nh, ctx.slope = e_real, nh, slope
        ctx.rounding, ctx.dh_t = rounding, dh_t
        return out

    @staticmethod
    def backward(ctx, g):
        (h_k, a_src, s_dst_eff, drop_mask, senders, receivers, src_order,
         src_ptr, dst_ptr, den, out, epsp, code) = ctx.saved_tensors
        nh, slope = ctx.nh, ctx.slope
        g = g.contiguous()
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h_rows, d_drop, d_sdst, d_asrc = v5_backward(
            h_k, a_src, s_dst_eff, drop_mask, senders, receivers,
            ctx.e_real, slope, g, out, den, epsp, need_drop,
            dst_ptr=dst_ptr, rounding=ctx.rounding, src_order=src_order,
            src_ptr=src_ptr)
        d_h = dh_reduce(d_h_rows, src_order, senders, h_k.shape[0],
                        ctx.e_real, transposed=ctx.dh_t, src_ptr=src_ptr)

        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, cap_cotangent(g, out, den, epsp, slope, nh),
            code, senders, receivers, h_k, a_src, nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 12


def _check_table_shapes(h_flat, s_dst, num_nodes, n_src, nh, f):
    if (s_dst.shape != (num_nodes, nh)
            or h_flat.shape != (n_src, nh * f)):
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)} do not match num_nodes="
                         f"{num_nodes}, num_src_nodes={n_src}, nh={nh}, "
                         f"f={f}")


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
                            slope: float = 0.01,
                            two_phase: bool = False, *,
                            src_ptr: Optional[torch.Tensor] = None,
                            dst_ptr: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Normalised attention output (num_nodes, nh*f) of the reference GAT
    layer, differentiable in h_flat, a_src, s_dst and drop_mask.

    h_flat (N, nh*f) node features, a_src (nh*f, nh) the cross-head source
    half of the attention map, s_dst (N, nh) destination scores; the graph
    is dst-sorted with the real edges first (e < e_real), padding edges
    pointing at the sink; src_order sorts the edges by sender.
    drop_mask: (E, nh) attention-dropout multipliers or None.
    score_bound: any scalar >= the max raw logit (stop-gradient); None
    computes it from the score tables. two_phase: the 2-phase form (the
    JAX package under GAT_TPU_V10=0 or GAT_TPU_V5_MERGED=0): v5_local_cap
    then fused_gat_table, the cap's cotangent routed to its argmax (edge,
    head); score_bound is not read there. src_ptr, dst_ptr: the graph's
    CSR offsets (Graph.src_ptr, Graph.dst_ptr), which spare the kernels'
    wrappers deriving them per call (None: derived). The dtype knobs
    (module doc) are read now."""
    _check_table_shapes(h_flat, s_dst, num_nodes, num_nodes, nh, f)
    rounding = v5_rounding()
    if two_phase:
        cap = v5_local_cap(h_flat, a_src, s_dst, senders, receivers, e_real,
                           num_nodes, nh, f, rounding=rounding,
                           dst_ptr=dst_ptr)
        return fused_gat_table(h_flat, a_src, s_dst, cap, drop_mask, senders,
                               receivers, src_order, e_real, num_nodes, nh,
                               f, eps, slope, rounding=rounding,
                               src_ptr=src_ptr, dst_ptr=dst_ptr)
    if score_bound is None:
        score_bound = (h_flat @ a_src).max() + s_dst.max()
    return _V5Attention.apply(h_flat.contiguous(), a_src.contiguous(),
                              s_dst, drop_mask, senders, receivers,
                              src_order, src_ptr, dst_ptr,
                              score_bound.detach(), int(e_real), nh, eps,
                              slope, rounding, dh_transposed())


class _V5LocalCap(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, senders, receivers, e_real,
                rounding, dst_ptr):
        h_k = rounding.table_of(h_flat)
        cap, code = v5_cap(h_k, a_src, s_dst, senders, receivers, e_real,
                           rounding, dst_ptr=dst_ptr)
        ctx.save_for_backward(h_k, a_src, senders, receivers, code)
        ctx.s_shape = s_dst.shape
        return cap

    @staticmethod
    def backward(ctx, g):
        h_k, a_src, senders, receivers, code = ctx.saved_tensors
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            h_k.new_zeros(h_k.shape, dtype=torch.float32),
            torch.zeros_like(a_src), a_src.new_zeros(ctx.s_shape), g, code,
            senders, receivers, h_k, a_src, a_src.shape[1])
        return (d_h, d_asrc, d_sdst) + (None,) * 5


def v5_local_cap(h_flat: torch.Tensor,
                 a_src: torch.Tensor,
                 s_dst: torch.Tensor,
                 senders: torch.Tensor,
                 receivers: torch.Tensor,
                 e_real: int,
                 num_nodes: int, nh: int, f: int, *,
                 rounding: Optional[Rounding] = None,
                 dst_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The max raw logit h[src] . a_src[:, k] + s_dst[dst, k] over the
    dst-sorted edges e < e_real and heads (a () tensor), differentiable in
    h_flat, a_src and s_dst: the cotangent goes to the argmax (edge, head),
    ties to the lowest e*nh + k. s_dst (num_nodes, nh) covers the rows the
    receivers index; h_flat may have more rows than num_nodes (the
    senders index it). rounding: the policy (only its table mode applies
    here); None reads the v5 knobs now. dst_ptr: the CSR offsets of the
    receivers (Graph.dst_ptr), or None to derive them per call."""
    if s_dst.shape != (num_nodes, nh) or h_flat.shape[1] != nh * f:
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)} do not match "
                         f"num_nodes={num_nodes}, nh={nh}, f={f}")
    rounding = v5_rounding() if rounding is None else rounding
    return _V5LocalCap.apply(h_flat.contiguous(), a_src.contiguous(),
                             s_dst.contiguous(), senders, receivers,
                             int(e_real), rounding, dst_ptr)


class _V5TwoPhase(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, cap, drop_mask, senders,
                receivers, src_order, src_ptr, dst_ptr, e_real, eps, slope,
                rounding, dh_t):
        h_k = rounding.table_of(h_flat)
        out, den = v5_forward_two_phase(h_k, a_src, s_dst, cap, drop_mask,
                                        senders, receivers, e_real, eps,
                                        slope, rounding, dst_ptr=dst_ptr)
        ctx.save_for_backward(h_k, a_src, s_dst, cap, drop_mask, senders,
                              receivers, src_order, src_ptr, dst_ptr, out,
                              den)
        ctx.e_real, ctx.eps, ctx.slope = e_real, eps, slope
        ctx.rounding, ctx.dh_t = rounding, dh_t
        return out

    @staticmethod
    def backward(ctx, g):
        (h_k, a_src, s_dst, cap, drop_mask, senders, receivers, src_order,
         src_ptr, dst_ptr, out, den) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[4]
        d_h_rows, d_drop, d_sdst, d_asrc, d_cap = v5_backward_two_phase(
            h_k, a_src, s_dst, cap, drop_mask, senders, receivers,
            ctx.e_real, ctx.eps, ctx.slope, g.contiguous(), out, den,
            need_drop, ctx.rounding, dst_ptr=dst_ptr, src_order=src_order,
            src_ptr=src_ptr)
        # senders index the h table, which may have more rows than the
        # destinations: d(h) is reduced to the table's rows
        d_h = dh_reduce(d_h_rows, src_order, senders, h_k.shape[0],
                        ctx.e_real, transposed=ctx.dh_t, src_ptr=src_ptr)
        return (d_h, d_asrc, d_sdst, d_cap, d_drop) + (None,) * 10


def fused_gat_table(h_flat: torch.Tensor,
                    a_src: torch.Tensor,
                    s_dst: torch.Tensor,
                    cap: torch.Tensor,
                    drop_mask: Optional[torch.Tensor],
                    senders: torch.Tensor,
                    receivers: torch.Tensor,
                    src_order: torch.Tensor,
                    e_real: int,
                    num_nodes: int, nh: int, f: int,
                    eps: float = 1e-8,
                    slope: float = 0.01,
                    num_src_nodes: Optional[int] = None, *,
                    rounding: Optional[Rounding] = None,
                    src_ptr: Optional[torch.Tensor] = None,
                    dst_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 2-phase whole-attention op with the cap given:
        out[n] = sum_e [recv_e = n] drop_e ex_e h[send_e] / (den[n] + eps),
        ex_e = exp(leaky_slope(h[send_e] . a_src + s_dst[recv_e] - cap)),
    0 where a node receives no real edge; (num_nodes, nh*f),
    differentiable in h_flat, a_src, s_dst, cap (the kernel's d(cap) =
    -sum of d(raw)) and drop_mask. cap: a () tensor, any caller's
    (v5_local_cap gives the reference's); the full LeakyReLU applies, so
    logits above it are fine. num_src_nodes: the rows of h_flat when they
    are more than num_nodes (senders index h_flat, receivers and s_dst
    cover num_nodes rows; d(h_flat) has h_flat's rows). rounding: the
    bfloat16 policy; None reads the v5 knobs now. src_ptr, dst_ptr: the
    CSR offsets of the real edges by sender ((rows of h_flat + 1,)) and
    of the edges by destination ((num_nodes + 1,)), where the caller
    built them with the graph; derived per call otherwise."""
    n_src = num_nodes if num_src_nodes is None else num_src_nodes
    _check_table_shapes(h_flat, s_dst, num_nodes, n_src, nh, f)
    rounding = v5_rounding() if rounding is None else rounding
    cap = torch.as_tensor(cap, dtype=torch.float32, device=h_flat.device)
    return _V5TwoPhase.apply(h_flat.contiguous(), a_src.contiguous(),
                             s_dst.contiguous(), cap.reshape(()), drop_mask,
                             senders, receivers, src_order, src_ptr, dst_ptr,
                             int(e_real), eps, slope, rounding,
                             dh_transposed())


class _V5Sweep1Parts(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst_eff, drop_mask, senders, receivers,
                src_order, dst_ptr, src_ptr, e_real, nh, slope, rounding,
                dh_t):
        h_k = rounding.table_of(h_flat)
        num, den, cap, code = v5_forward(h_k, a_src, s_dst_eff, drop_mask,
                                         senders, receivers, e_real, slope,
                                         dst_ptr, rounding)
        ctx.save_for_backward(h_k, a_src, s_dst_eff, drop_mask, senders,
                              receivers, src_order, dst_ptr, src_ptr, code)
        ctx.e_real, ctx.nh, ctx.slope = e_real, nh, slope
        ctx.rounding, ctx.dh_t = rounding, dh_t
        ctx.mark_non_differentiable(code)
        return num, den, cap, code

    @staticmethod
    def backward(ctx, d_num, d_den, d_cap, _d_code):
        (h_k, a_src, s_dst_eff, drop_mask, senders, receivers, src_order,
         dst_ptr, src_ptr, code) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h_rows, d_drop, d_sdst, d_asrc = v5_backward(
            h_k, a_src, s_dst_eff, drop_mask, senders, receivers,
            ctx.e_real, ctx.slope, d_num.contiguous(), None,
            d_den.contiguous(), None, need_drop, normalize=False,
            dst_ptr=dst_ptr, rounding=ctx.rounding, src_order=src_order,
            src_ptr=src_ptr)
        # senders index the h table, which may have more rows than the
        # destinations: d(h) is reduced to the table's rows
        d_h = dh_reduce(d_h_rows, src_order, senders, h_k.shape[0],
                        ctx.e_real, transposed=ctx.dh_t, src_ptr=src_ptr)
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, d_cap, code, senders, receivers, h_k,
            a_src, ctx.nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 10


def v5_sweep1_parts(h_flat: torch.Tensor,
                    a_src: torch.Tensor,
                    s_dst: torch.Tensor,
                    drop_mask: Optional[torch.Tensor],
                    senders: torch.Tensor,
                    receivers: torch.Tensor,
                    src_order: torch.Tensor,
                    e_real: int,
                    num_nodes: int, nh: int, f: int,
                    eps: float = 1e-8,
                    slope: float = 0.01,
                    num_src_nodes: Optional[int] = None, *,
                    dst_ptr: Optional[torch.Tensor] = None,
                    src_ptr: Optional[torch.Tensor] = None):
    """The unnormalised single-sweep parts (num (num_nodes, nh*f),
    den (num_nodes, nh), cap' (), code () int32) over the dst-sorted edges
    e < e_real, differentiable in h_flat, a_src, s_dst and drop_mask.

    s_dst arrives ALREADY B-shifted (the caller subtracts its bound, which
    it may share with another op over other edges). cap' is the max of the
    shifted raw logits these edges saw and code = e*nh + head its argmax
    (not differentiable). The caller completes the softmax,
        eps' = eps * exp(slope * cap'); out = num / (den + eps'),
    0 where den == 0, possibly after adding other parts; `eps` is the
    caller's to use there and is not read here. The backward assumes num
    and den feed only such an epilogue: it takes their cotangents raw and
    routes the cap's to the argmax (edge, head).

    num_src_nodes: the rows of h_flat when they are more than num_nodes:
    receivers and s_dst cover num_nodes rows, senders index h_flat, and
    d(h_flat) is reduced to its rows.
    dst_ptr, src_ptr: the CSR offsets of the edges by destination
    ((num_nodes + 1,), over all edges) and of the real edges by sender
    ((rows of h_flat + 1,)), where the caller built them with the graph;
    they are computed per call otherwise. The dtype knobs (module doc)
    are read now."""
    n_src = num_nodes if num_src_nodes is None else num_src_nodes
    _check_table_shapes(h_flat, s_dst, num_nodes, n_src, nh, f)
    return _V5Sweep1Parts.apply(
        h_flat.contiguous(), a_src.contiguous(), s_dst.contiguous(),
        drop_mask, senders, receivers, src_order, dst_ptr, src_ptr,
        int(e_real), nh, slope, v5_rounding(), dh_transposed())
