"""The v5 whole-attention op: logits, global cap, softmax and aggregation.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_gat_table_autocap (:1551) with its VJP `_fgta_fwd`/`_fgta_bwd`
(:1577-1669), in the single-sweep (v10) form the JAX package runs by
default, and v5_sweep1_parts (:1674) with `_v5sp_fwd`/`_v5sp_bwd`, the
same sweep without its epilogue. The kernels are csrc/v5_attention.cu
(forward: `_kernel_v5_auto`; backward: segment_attention_bwd.py:
`_kernel_v5_bwd`, in its normalised and its parts mode). The backward
is owned by senders and returns d(h) per node
(`v5_backward_by_sender_plain` is its plain version): the d(h) reduction
that the JAX package runs after the TPU kernel (ops/cuda/segment_sum.py)
is inside it, at every row width and table type. Its warps take items,
runs of at most L slots of one sender (build.sender_items), a longer run
cut into several whose partial d(h) rows the backward's tail adds in item
order (`v5_backward_split_plain` is that association's plain version, and
the backward on CPU tensors). `v5_backward_plain` keeps the TPU kernel's
per-edge rows, the contract the versions by sender are built on.
`v5_forward_plain` is the forward's plain version.

Every kernel here, and every windowed one (window_attention.py), takes
its raw logit from the source-score table s_src = h @ a_src
(`source_scores`, kernel source_scores, with `source_scores_plain`),
s_src[src, k] + s_dst[dst, k]. Each op computes the table once in its
forward, from the h table its kernels read, hands it to its cap pass
(the 2-phase forms) and saves it for its backward, so all of them get
the same bits for an edge's logit: the 2-phase argmax edge meets its cap
exactly. A stand-alone entry computes the table itself unless given it
(`s_src=`). The forwards split a row over lanes by `lane_plan`.

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
the knobs. GAT_TPU_DH_REDUCE_NT, which picks the form of the JAX
package's d(h) reduce and changes no value there, is not read: the
backward by sender runs no reduce after it.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from ...utils.profiling import count, op_spans
from .. import segment as seg
from . import build
from .build import sender_runs
from .rounding import (BF16_TABLE, FLOAT32, Rounding, check_table,
                       maybe_bf16)
from .segment_sum import dh_reduce_plain, segment_sum_sorted_plain

_KERNEL = "v5_attention"
MAX_HEADS = 8
NEG_INF = -1e30     # the cap' of no edges, and a padding edge's logit
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
        plan = [i] * 5      # the lane plan (LanePlan)
        lib.source_scores.argtypes = [p] * 2 + [i] * 6 + [p, i, i, p]
        lib.source_scores.restype = ctypes.c_int
        lib.v5_forward.argtypes = ([p] * 6 + [i] * 5 + [fl] + [p] * 6
                                   + plan + [i, i, p])
        lib.v5_forward.restype = ctypes.c_int
        lib.v5_backward_by_sender.argtypes = ([p] * 10 + [i] * 10
                                              + [fl] * 2 + [p] * 14
                                              + [i] * 6 + [p])
        lib.v5_backward_by_sender.restype = ctypes.c_int
        lib.v5_cap.argtypes = [p] * 4 + [i] * 2 + [p] * 4 + [i, p]
        lib.v5_cap.restype = ctypes.c_int
        lib.v5_forward_two_phase.argtypes = ([p] * 7 + [i] * 5 + [fl] * 2
                                             + [p] * 2 + plan + [i, i, p])
        lib.v5_forward_two_phase.restype = ctypes.c_int
        _configured.add(name)
    return lib


# -- lane plans -------------------------------------------------------------
#
# How the forward kernels and the source-score pass split a row over lanes
# (csrc/attention_common.cuh). The kernels check a plan and refuse one that
# does not cover the row; the CPU tests check what a plan covers.

class LanePlan(NamedTuple):
    """The forward's split of a row (attention_fwd_wide / _narrow): wide,
    a block of nh warps a destination, warp k head k, lane l holding the
    vectors b + vec*(l + 32c) of head k's elements (b: the vector holding
    its first); else one warp a destination in teams of `lanes` lanes,
    lane t of a team holding the vectors vec*(t + lanes*c), c < per_lane,
    of the whole row. unroll: the edges whose rows a warp (wide) or a
    team (narrow) has in flight."""
    wide: bool
    vec: int
    per_lane: int
    lanes: int
    unroll: int


class ScorePlan(NamedTuple):
    """The source-score pass's split of a row: teams of `lanes` lanes,
    lane t holding the vectors c0 + vec*(t + lanes*c), c < per_lane, of
    each chunk c0 of lanes*vec*per_lane elements."""
    vec: int
    per_lane: int
    lanes: int


class RowPlan(NamedTuple):
    """The split of a row for the kernels that give a whole row to a team
    of `lanes` lanes (the windowed backward by sender, the v2 backward;
    attention_common.cuh RowLanes): lane t of a team holds the vectors
    vec*(t + lanes*c), c < per_lane; unroll: the rows a team has in
    flight."""
    vec: int
    per_lane: int
    lanes: int
    unroll: int


def _pow2(x: int) -> int:
    """The least power of two >= x (x >= 1)."""
    return 1 << (x - 1).bit_length()


def in_flight(elems: int) -> int:
    """Edges whose rows a lane keeps in flight when it holds `elems`
    elements of a row (csrc/attention_common.cuh in_flight)."""
    return 1 if elems >= 32 else 2 if elems >= 16 else 4 if elems >= 8 else 8


def lane_plan(nh: int, f: int, align: int = 4) -> LanePlan:
    """The forward's plan at nh heads of f features, vectors of at most
    `align` elements (the widest to which the h table and the output are
    aligned). Wide rows (f >= 32): vectors of 4 where 4 divides f, else of
    2 where 2 divides the row (heads may start mid-vector: the kernel keeps
    a neighbouring head's elements out of the stores), else 1; enough
    vectors a lane to cover a head from its first vector. Narrow rows: the
    widest vector that divides the row and meets at most two heads
    (vec <= f + 1; where vec does not divide f the kernel tests each
    element), and the fewest lanes, a power of two, that cover the row
    with one vector each, or 32 lanes of several. A narrow team keeps two
    edges' rows in flight where a batch of 32 // nh edges gives it at most
    two (fewer registers, more resident warps), else in_flight's."""
    d = nh * f
    if f >= 32:
        vec = (4 if f % 4 == 0 and align >= 4
               else 2 if d % 2 == 0 and align >= 2 else 1)
        span = f + vec - 1 if f % vec else f
        per_lane = _pow2(-(-span // (32 * vec)))
        return LanePlan(True, vec, per_lane, 32, in_flight(vec * per_lane))
    vec = next(v for v in (4, 2, 1)
               if v <= align and d % v == 0 and (f % v == 0 or v <= f + 1))
    nvec = d // vec
    per_lane, lanes = ((1, _pow2(nvec)) if nvec <= 32
                       else (_pow2(-(-nvec // 32)), 32))
    teams = 32 // lanes
    few = -(-(32 // nh) // teams) <= 2     # a team's edges a batch
    return LanePlan(False, vec, per_lane, lanes,
                    2 if few else in_flight(vec * per_lane))


def row_plan(nh: int, f: int, align: int = 4,
             three: bool = False) -> RowPlan:
    """The team-per-row plan at nh heads of f features, vectors of at most
    `align` elements: the widest vector that divides the row and meets at
    most two heads (as lane_plan's narrow rows), and the fewest lanes, a
    power of two of at least MAX_HEADS (the kernels reduce a team's
    per-head sums across its lanes) and at most 32, that cover the row with
    one vector each, or 32 lanes of several: the most teams a warp (at
    Pubmed's 8 x 3, four teams of 8 lanes beat one of 32 lanes with heads
    of whole lanes, PERF.md). A team keeps two rows in flight where a batch
    of 32 // nh rows gives it at most two; one at 12 or more elements a
    lane (one team a warp), else in_flight's, at most four
    (csrc/attention_common.cuh row_flight). three: a team of 32 lanes takes
    three vectors a lane where three cover the row (the backwards by
    sender, whose kernels have those plans: a 320-float row in three
    vectors of four, where four left the last one dead in every lane)."""
    d = nh * f
    vec = next(v for v in (4, 2, 1)
               if v <= align and d % v == 0 and (f % v == 0 or v <= f + 1))
    nvec = d // vec
    lanes = min(32, max(MAX_HEADS, _pow2(nvec)))
    per_lane = -(-nvec // lanes)
    if not (three and lanes == 32 and per_lane == 3):
        per_lane = _pow2(per_lane)
    few = -(-(32 // nh) // (32 // lanes)) <= 2
    elems = vec * per_lane
    return RowPlan(vec, per_lane, lanes,
                   2 if few else 1 if elems >= 12
                   else min(4, in_flight(elems)))


def score_plan(d: int, align: int = 4) -> ScorePlan:
    """The source-score pass's plan at rows of d elements: the widest
    vector (of at most `align`) that divides the row, the fewest lanes
    (a power of two, at most 32) that give each a vector, and up to 8
    vectors a lane."""
    vec = next(v for v in (4, 2, 1) if v <= align and d % v == 0)
    nvec = d // vec
    lanes = min(32, _pow2(nvec))
    return ScorePlan(vec, min(8, _pow2(-(-nvec // lanes))), lanes)


def align_of(t: torch.Tensor) -> int:
    """The widest vector (4, 2 or 1 elements) to which t's start is
    aligned."""
    b = t.element_size()
    return next(v for v in (4, 2, 1) if t.data_ptr() % (v * b) == 0)


def forward_blocks(plan: LanePlan, n: int) -> int:
    """The forward's grid: a block a destination (wide, up to 16 blocks of
    nh warps an SM of the 132), or eight destinations a block (narrow, up
    to eight blocks an SM); destinations past it are taken in turn."""
    if plan.wide:
        return max(1, min(n, 16 * 132))
    return max(1, min(-(-n // build.WARPS_PER_BLOCK), 8 * 132))


# -- the source-score pass --------------------------------------------------

def source_scores_plain(h, a_src):
    """s_src = h @ a_src (n_src, nh) in float32, from the table as the
    kernels read it (a bfloat16 table widened)."""
    return h.float() @ a_src


def _source_scores_cuda(h, a_src):
    dev = h.device
    n_src, d = h.shape if h.dim() == 2 else (-1, -1)
    build.require(h, "h", dev, h.dtype, (None, None))
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"h: dtype {h.dtype}, expected float32 or bfloat16")
    build.require(a_src, "a_src", dev, torch.float32, (d, None))
    nh = a_src.shape[1]
    if not 1 <= nh <= MAX_HEADS or not 1 <= d <= 1024:
        raise ValueError(f"{nh} heads, row width {d}: the kernel takes "
                         f"1..{MAX_HEADS} heads and rows of 1..1024")
    plan = score_plan(d, align_of(h))
    s_src = torch.empty((n_src, nh), dtype=torch.float32, device=dev)
    teams = 256 // plan.lanes
    nblk = max(1, min(-(-n_src // teams), 8 * 132))
    bf16 = h.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        err = _lib(bf16).source_scores(
            build.ptr(h), build.ptr(a_src), n_src, d, nh, *plan,
            build.ptr(s_src), nblk, BF16_TABLE if bf16 else 0,
            build.stream(dev))
    build.check(err, "source_scores")
    build.LAUNCHES["source_scores_bf16" if bf16 else "source_scores"] += 1
    return s_src


def source_scores(h, a_src):
    """The source-score table s_src = h @ a_src (n_src, nh), float32: the
    sender's half of every raw logit, s_src[src, k] + s_dst[dst, k], which
    every v5 and windowed kernel reads. h is the table the kernels read
    (float32, or bfloat16 in the table mode). Kernel on CUDA tensors
    (counted as "source_scores", "source_scores_bf16" for a bfloat16
    table), plain version on CPU tensors. Not differentiable: the ops'
    backwards give h and a_src their gradients."""
    if h.is_cuda:
        return _source_scores_cuda(h, a_src)
    build.require_cpu(h)
    return source_scores_plain(h, a_src)


def check_scores(s_src, h, nh: int):
    """Raise unless s_src is a contiguous float32 (rows of h, nh) table on
    h's device."""
    build.require(s_src, "s_src", h.device, torch.float32,
                  (h.shape[0], nh))


def scores_of(h, a_src, s_src=None):
    """The caller's table, checked, or one computed now."""
    if s_src is None:
        return source_scores(h, a_src)
    check_scores(s_src, h, a_src.shape[1])
    return s_src


# -- plain versions (CPU tensors) -------------------------------------------
#
# `attention_forward_plain` / `attention_backward_plain` are written over
# any list of edge slots: `snd` and `rcv` are int64 ids, `valid` (E, 1)
# marks the slots that are edges, and an `rcv` >= N (a slot that is none)
# is dropped from every sum. ops/cuda/window_attention.py runs them over
# its layout's slots. Each takes the kernel's rounding policy; h is the
# table the kernel reads (bfloat16 in the table mode). Each takes the raw
# logit from the source-score table s_src, as the kernels do: the
# caller's, or source_scores_plain(h, a_src) where it gives none.

def _edge_logits(h, a_src, s_dst_eff, snd, rcv, rows: bool = False,
                 s_src=None):
    """(gathered rows, raw logits, clamped receivers): the logits
    s_src[snd] + s_dst[rcv], the rows rounded where `rows` (the logits
    read the table before)."""
    if s_src is None:
        s_src = source_scores_plain(h, a_src)
    h_e = h.float().index_select(0, snd)
    rcv_in = rcv.clamp(max=s_dst_eff.shape[0] - 1)
    raw = s_src.index_select(0, snd) + s_dst_eff.index_select(0, rcv_in)
    return maybe_bf16(h_e, rows), raw, rcv_in


def _cap_of(raw, valid):
    """(max of raw over the slots that are edges, its lowest slot*nh + k
    as int32): argmax returns the first maximal element. Without an edge,
    (NEG_INF, 0), as the JAX kernels give."""
    flat = torch.where(valid, raw, torch.full_like(raw, float("-inf")))
    flat = flat.reshape(-1)
    cap = flat.max()
    cap = torch.where(cap > float("-inf"), cap, torch.full_like(cap, NEG_INF))
    return cap, torch.argmax(flat).to(torch.int32)


def empty_cap(dev):
    """(cap', code) over no edges: NEG_INF and 0, launching nothing."""
    return (torch.full((), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def empty_parts(n: int, d: int, nh: int, dev):
    """(num, den, cap', code) over no edges, as the JAX op returns them:
    zeros, NEG_INF and 0, launching nothing (an empty edge shard or
    hybrid remainder of the dst-owned layout)."""
    return (torch.zeros((n, d), dtype=torch.float32, device=dev),
            torch.zeros((n, nh), dtype=torch.float32, device=dev),
            *empty_cap(dev))


def empty_grads(n_src: int, n: int, d: int, nh: int, e: int,
                need_drop: bool, dev, two_phase: bool = False):
    """A backward's (d_h (n_src, d), d_drop (e, nh) | None, d_s_dst (n,
    nh), d_a_src (d, nh) [, d_cap]) over no edges: zeros, launching
    nothing."""
    f32 = dict(dtype=torch.float32, device=dev)
    grads = (torch.zeros((n_src, d), **f32),
             torch.zeros((e, nh), **f32) if need_drop else None,
             torch.zeros((n, nh), **f32), torch.zeros((d, nh), **f32))
    return grads + (torch.zeros((), **f32),) if two_phase else grads


def _aggregate(h_e, w, rcv, n: int, nh: int, acc: bool = False):
    """sum over slots of w (E, nh) times the slots' h rows, per receiver;
    each product rounded to bfloat16 first where `acc`."""
    e, d = h_e.shape
    return seg.segment_sum(maybe_bf16(
        (h_e.view(e, nh, d // nh) * w[:, :, None]).reshape(e, d), acc),
        rcv, n)


def attention_forward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                            slope: float, rounding: Rounding = FLOAT32,
                            s_src=None):
    """(num (N, D), den (N, nh), cap' (), code () int32) of the module doc,
    the code counting slots in the order given."""
    n, nh = s_dst_eff.shape
    h_e, raw, _ = _edge_logits(h, a_src, s_dst_eff, snd, rcv, rounding.rows,
                               s_src)
    cap, code = _cap_of(raw, valid)
    ex = torch.where(valid, torch.exp(slope * raw), torch.zeros_like(raw))
    num = _aggregate(h_e, ex if drop is None else ex * drop, rcv, n, nh,
                     rounding.acc)
    return num, seg.segment_sum(maybe_bf16(ex, rounding.acc), rcv, n), \
        cap, code


def attention_cap_plain(s_src, s_dst, snd, rcv, valid):
    """(cap (), code () int32): the max raw logit s_src[snd] + s_dst[rcv]
    over the slots that are edges and its lowest slot*nh + head (the
    2-phase cap pass, a stream over the score tables)."""
    rcv_in = rcv.clamp(max=s_dst.shape[0] - 1)
    return _cap_of(s_src.index_select(0, snd)
                   + s_dst.index_select(0, rcv_in), valid)


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
                                      rounding: Rounding = FLOAT32,
                                      s_src=None):
    """(out (N, D) = num / (den + eps), 0 where den == 0; den (N, nh)) of
    the 2-phase forward, from the given cap."""
    n, nh = s_dst.shape
    d = h.shape[1]
    h_e, raw, _ = _edge_logits(h, a_src, s_dst, snd, rcv, rounding.rows,
                               s_src)
    _, ex = _two_phase_ex(raw, cap, valid, slope)
    num = _aggregate(h_e, ex if drop is None else ex * drop, rcv, n, nh,
                     rounding.acc)
    den = seg.segment_sum(maybe_bf16(ex, rounding.acc), rcv, n)
    inv = _safe_inverse(den, eps)
    return (num.view(n, nh, d // nh) * inv[:, :, None]).reshape(n, d), den


def attention_backward_two_phase_plain(h, a_src, s_dst, cap, drop, snd, rcv,
                                       valid, eps: float, slope: float, g,
                                       out, den, need_drop: bool,
                                       rounding: Rounding = FLOAT32,
                                       s_src=None):
    """(d_h rows (E, D) in slot order, d_drop (E, nh) | None, d_s_dst
    (N, nh), d_a_src (D, nh), d_cap ()) of the 2-phase op: d(pre) takes
    the slope where pre <= 0, d(raw) = d(pre), d(cap) = -sum d(raw)."""
    return attention_backward_plain(h, a_src, s_dst, drop, snd, rcv, valid,
                                    slope, g, out, den, eps, need_drop,
                                    cap=cap, rounding=rounding, s_src=s_src)


def attention_backward_plain(h, a_src, s_dst_eff, drop, snd, rcv, valid,
                             slope: float, g, out, den, epsp,
                             need_drop: bool, normalize: bool = True,
                             cap=None, rounding: Rounding = FLOAT32,
                             with_draw: bool = False, s_src=None):
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
    (0 on slots that are no edges), which the versions by sender sum per
    sender for d(a_src)."""
    n, nh = s_dst_eff.shape
    e, d = snd.shape[0], h.shape[1]
    f = d // nh
    r = rounding
    h_e, raw, rcv_in = _edge_logits(h, a_src, s_dst_eff, snd, rcv, r.rows,
                                    s_src)
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
                     rounding: Rounding = FLOAT32, s_src=None):
    """(num, den, cap', code) over the dst-sorted edges e < e_real."""
    return attention_forward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope, rounding, s_src)


def v5_backward_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool, normalize: bool = True,
                      rounding: Rounding = FLOAT32, with_draw: bool = False,
                      s_src=None):
    """(d_h rows in dst order, d_drop, d_s_dst, d_a_src); normalize=False
    and with_draw as attention_backward_plain takes them."""
    return attention_backward_plain(
        h, a_src, s_dst_eff, drop,
        *_real_prefix(senders, receivers, e_real), slope, g, out, den,
        epsp, need_drop, normalize, rounding=rounding, with_draw=with_draw,
        s_src=s_src)


def v5_cap_plain(h, a_src, s_dst, senders, receivers, e_real: int,
                 s_src=None):
    """(cap, code) over the dst-sorted edges e < e_real, from the table
    s_src (source_scores_plain(h, a_src) where None)."""
    if s_src is None:
        s_src = source_scores_plain(h, a_src)
    return attention_cap_plain(s_src, s_dst,
                               *_real_prefix(senders, receivers, e_real))


def v5_forward_two_phase_plain(h, a_src, s_dst, cap, drop, senders,
                               receivers, e_real: int, eps: float,
                               slope: float, rounding: Rounding = FLOAT32,
                               s_src=None):
    """(out, den) of the 2-phase forward over the edges e < e_real."""
    return attention_forward_two_phase_plain(
        h, a_src, s_dst, cap, drop,
        *_real_prefix(senders, receivers, e_real), eps, slope, rounding,
        s_src)


def v5_backward_two_phase_plain(h, a_src, s_dst, cap, drop, senders,
                                receivers, e_real: int, eps: float,
                                slope: float, g, out, den, need_drop: bool,
                                rounding: Rounding = FLOAT32,
                                with_draw: bool = False, s_src=None):
    """(d_h rows in dst order, d_drop, d_s_dst, d_a_src, d_cap[, draw])."""
    return attention_backward_plain(
        h, a_src, s_dst, drop, *_real_prefix(senders, receivers, e_real),
        slope, g, out, den, eps, need_drop, cap=cap, rounding=rounding,
        with_draw=with_draw, s_src=s_src)


# -- the backward by sender --------------------------------------------------
#
# On the card the backward kernel is owned by senders
# (csrc/attention_common.cuh attention_bwd_by_sender, the windowed op's
# body over the dst-sorted edges): it sums d(h) per node itself, each
# sender's edges' terms in ascending position of its run of src_order, and
# takes d(a_src) = h^T S by sender, S the per-sender sums of d(raw). The
# plain versions below have that contract; the per-edge rows of
# v5_backward_plain are the TPU kernel's, whose reduction by sender the
# JAX package runs after it. The kernel's warps take items
# (build.sender_items over sender_warps(n_src) warps): where a run is cut,
# each item sums its own slots' terms, from 0, and the tail adds the
# items' partial rows in item order; d(a_src) takes h[s]^T S per item. The
# split plain versions have that association: the same terms, so within
# float32 rounding of the by-sender ones, to the bits where no run is cut.
# The item table depends on no device (build.grid_blocks and
# WARPS_PER_BLOCK are constants), so the backward on CPU tensors is the
# split plain version.

def _by_sender_plain(grads, h, senders, e_real: int, src_order, src_ptr,
                     rounding: Rounding):
    """A plain backward's grads (with draw last) by sender: its per-edge
    d(h) rows summed per node over sender_runs (dh_reduce_plain), d(a_src)
    taken as h^T S, S the per-sender sums of draw, h's rows rounded as
    d(a_src) reads them; draw dropped."""
    *grads, draw = grads
    n_src = h.shape[0]
    order, ptr = sender_runs(senders, e_real, n_src, src_order, src_ptr)
    grads[0] = dh_reduce_plain(grads[0], order, ptr)
    s_rows = segment_sum_sorted_plain(draw, None, n_src, order=order,
                                      ptr=ptr)
    grads[3] = maybe_bf16(h.float(), rounding.rows).t() @ s_rows
    return tuple(grads)


def sender_warps(n_src: int) -> int:
    """The warps of the backward by sender over n_src senders (its grid,
    build.grid_blocks, of WARPS_PER_BLOCK warps): the item table's."""
    return build.grid_blocks(n_src) * build.WARPS_PER_BLOCK


def _split_plain(grads, h, senders, e_real: int, src_order, src_ptr,
                 rounding: Rounding):
    """A plain backward's grads (with draw last) in the kernel's items
    (build.sender_items over sender_warps warps): each item's per-edge
    d(h) rows summed from 0 in slot order (dh_reduce_plain), a cut run's
    partial rows then summed in item order; d(a_src) the sum over items of
    h[s]^T S, S the item's d(raw) sums; draw dropped."""
    *grads, draw = grads
    n_src = h.shape[0]
    order, ptr = sender_runs(senders, e_real, n_src, src_order, src_ptr)
    it = build.sender_items(ptr, sender_warps(n_src))
    rows = dh_reduce_plain(grads[0], order, it.ptr)
    whole = it.part < 0
    d_h = rows.new_zeros((n_src, rows.shape[1]))
    d_h[it.src[whole].long()] = rows[whole]
    if it.n_split:
        d_h[it.split_src.long()] = dh_reduce_plain(
            rows[~whole], torch.arange(it.n_parts, device=rows.device),
            it.split_ptr)
    grads[0] = d_h
    s_items = segment_sum_sorted_plain(draw, None, it.n_items, order=order,
                                       ptr=it.ptr)
    h_items = maybe_bf16(h.float(), rounding.rows).index_select(
        0, it.src.long())
    grads[3] = h_items.t() @ s_items
    return tuple(grads)


def v5_backward_split_plain(h, a_src, s_dst_eff, drop, senders, receivers,
                            e_real: int, slope: float, g, out, den, epsp,
                            need_drop: bool, normalize: bool = True,
                            rounding: Rounding = FLOAT32, s_src=None,
                            src_order=None, src_ptr=None):
    """v5_backward_by_sender_plain's outputs in the kernel's association
    (_split_plain): d(drop) and d(s_dst) its bits; d(h) its bits where
    no run is cut."""
    return _split_plain(v5_backward_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope, g, out,
        den, epsp, need_drop, normalize, rounding, with_draw=True,
        s_src=s_src), h, senders, e_real, src_order, src_ptr, rounding)


def v5_backward_two_phase_split_plain(h, a_src, s_dst, cap, drop, senders,
                                      receivers, e_real: int, eps: float,
                                      slope: float, g, out, den,
                                      need_drop: bool,
                                      rounding: Rounding = FLOAT32,
                                      s_src=None, src_order=None,
                                      src_ptr=None):
    """v5_backward_two_phase_by_sender_plain's outputs in the kernel's
    association (_split_plain)."""
    return _split_plain(v5_backward_two_phase_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        g, out, den, need_drop, rounding, with_draw=True, s_src=s_src), h,
        senders, e_real, src_order, src_ptr, rounding)


def v5_backward_by_sender_plain(h, a_src, s_dst_eff, drop, senders,
                                receivers, e_real: int, slope: float, g, out,
                                den, epsp, need_drop: bool,
                                normalize: bool = True,
                                rounding: Rounding = FLOAT32, s_src=None,
                                src_order=None, src_ptr=None):
    """(d_h (rows of h, D) per node, d_drop, d_s_dst, d_a_src): the
    backward by sender's function in plain torch, on either device and
    with no kernel; normalize=False is the parts mode (as
    attention_backward_plain takes it)."""
    return _by_sender_plain(v5_backward_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope, g, out,
        den, epsp, need_drop, normalize, rounding, with_draw=True,
        s_src=s_src), h, senders, e_real, src_order, src_ptr, rounding)


def v5_backward_two_phase_by_sender_plain(h, a_src, s_dst, cap, drop,
                                          senders, receivers, e_real: int,
                                          eps: float, slope: float, g, out,
                                          den, need_drop: bool,
                                          rounding: Rounding = FLOAT32,
                                          s_src=None, src_order=None,
                                          src_ptr=None):
    """(d_h (rows of h, D) per node, d_drop, d_s_dst, d_a_src, d_cap) of
    the 2-phase op by sender, in plain torch."""
    return _by_sender_plain(v5_backward_two_phase_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        g, out, den, need_drop, rounding, with_draw=True, s_src=s_src), h,
        senders, e_real, src_order, src_ptr, rounding)


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
    if not 0 <= e_real <= e:
        raise ValueError(f"e_real {e_real} outside [0, {e}]")
    return dev, s_dst_eff.shape[0], e, d, nh


def plan_of(h, out, nh: int, f: int) -> LanePlan:
    """The forward's lane plan for the h table and the output `out`."""
    return lane_plan(nh, f, min(align_of(h), align_of(out)))


def cap_blocks(items: int) -> int:
    """The cap stream's grid over `items` (slot, head) scores."""
    return max(1, min(-(-items // 256), 4 * 132))


def _v5_forward_cuda(h, a_src, s_dst_eff, drop, senders, receivers,
                     e_real: int, slope: float, dst_ptr=None,
                     rounding: Rounding = FLOAT32, s_src=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real, rounding)
    if e_real == 0:
        return empty_parts(n, d, nh, dev)
    s_src = scores_of(h, a_src, s_src)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    f32 = dict(dtype=torch.float32, device=dev)
    num = torch.empty((n, d), **f32)
    den = torch.empty((n, nh), **f32)
    plan = plan_of(h, num, nh, d // nh)
    nblk = forward_blocks(plan, n)
    blk_max = torch.empty((nblk,), **f32)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), **f32)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    lib = _lib(rounding.table)
    with torch.cuda.device(dev):
        err = lib.v5_forward(
            p(h), p(s_src), p(s_dst_eff), p(drop), p(senders), p(row_ptr),
            n, e_real, d, nh, d // nh, slope,
            p(num), p(den), p(blk_max), p(blk_code), p(cap), p(code),
            *plan, nblk, rounding.flags(), build.stream(dev))
    build.check(err, "v5_forward")
    build.LAUNCHES[rounding.counter("v5_forward")] += 1
    return num, den, cap, code


_BY_SENDER_MODES = {"v5_backward": 0, "v5_backward_parts": 1,
                    "v5_backward_two_phase": 2}


def _v5_backward_by_sender_cuda(name, h, a_src, s_src, s_dst, drop,
                                senders, receivers, e_real: int,
                                slope: float, eps: float, g, out, den, epsp,
                                cap, need_drop: bool, rounding: Rounding,
                                dst_ptr, src_order, src_ptr):
    """One call of the C entry v5_backward_by_sender in the mode of
    `name`: (d_h (rows of h, d) per node, d_drop | None, d_sdst, d_asrc
    (d*nh [+ 1])). Its warps take the items of the
    sender runs (build.sender_items, built on the first call with the
    caller's runs or senders and kept); counts the real slots (counter
    bwd_slots) and those in cut runs (bwd_split_slots)."""
    dev = h.device
    n_src, d = h.shape
    n, nh = s_dst.shape
    e = senders.shape[0]
    mode = _BY_SENDER_MODES[name]
    order, ptr = sender_runs(senders, e_real, n_src, src_order, src_ptr)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    # a fixed grid (a function of n_src: the blocks' d(a_src) partial rows
    # are summed in block order) of one wave, two blocks an SM (the main
    # path's instances hold 91-144 registers): faster than 528 or 1056
    # blocks at Cora's and Pubmed's shapes, where the tail's sum over the
    # blocks' partial rows is a part of the call (PERF.md)
    nblk = build.grid_blocks(n_src)
    # the table is kept with the caller's runs, or with the senders the
    # runs were derived from
    given = src_order is not None and src_ptr is not None
    items = build.sender_items(ptr, nblk * build.WARPS_PER_BLOCK,
                               src_ptr if given else senders,
                               () if given else (e_real, n_src))
    count("bwd_slots", items.slots)
    count("bwd_split_slots", items.split_slots)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h = torch.empty((n_src, d), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    stride = d * nh + (1 if mode == 2 else 0)
    d_asrc = torch.empty((stride,), **f32)
    dsd = torch.empty((e, nh), **f32)
    dsum = torch.empty((items.n_items, nh), **f32)
    part = torch.empty((nblk, stride), **f32)
    dh_part = (torch.empty((items.n_parts, d), **f32) if items.n_split
               else None)
    # each destination's d(den), taken once before the walk (modes 0, 2)
    dden = torch.empty((n, nh), **f32) if mode != 1 else None
    aligns = [align_of(h), align_of(g)] + ([] if out is None
                                           else [align_of(out)])
    plan = row_plan(nh, d // nh, min(aligns), three=True)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_backward_by_sender(
            p(h), p(a_src), p(s_src), p(s_dst), p(drop), p(receivers),
            p(order), p(ptr), p(row_ptr), p(items.table), items.n_items,
            items.n_split, n_src, n, e_real, e, d, nh, d // nh, mode, slope,
            eps, p(g), p(out), p(den), p(epsp), p(cap), p(d_h), p(d_drop),
            p(d_sdst), p(d_asrc), p(dsd), p(dsum), p(part), p(dh_part),
            p(dden), *plan, nblk, rounding.flags(), build.stream(dev))
    build.check(err, name)
    build.LAUNCHES[rounding.counter(name)] += 1
    return d_h, d_drop, d_sdst, d_asrc


def _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders, receivers,
                      e_real: int, slope: float, g, out, den, epsp,
                      need_drop: bool, normalize: bool = True, dst_ptr=None,
                      rounding: Rounding = FLOAT32, src_order=None,
                      src_ptr=None, s_src=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, senders,
                                     receivers, e_real, rounding)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    if normalize:
        build.require(out, "out", dev, torch.float32, (n, d))
        build.require(epsp, "epsp", dev, torch.float32, ())
    if e_real == 0:
        return empty_grads(h.shape[0], n, d, nh, e, need_drop, dev)
    s_src = scores_of(h, a_src, s_src)
    name = "v5_backward" if normalize else "v5_backward_parts"
    d_h, d_drop, d_sdst, d_asrc = _v5_backward_by_sender_cuda(
        name, h, a_src, s_src, s_dst_eff, drop, senders, receivers, e_real,
        slope, 0.0, g, out if normalize else None, den,
        epsp if normalize else None, None, need_drop, rounding, dst_ptr,
        src_order, src_ptr)
    return d_h, d_drop, d_sdst, d_asrc.view(d, nh)


def _v5_cap_cuda(h, a_src, s_dst, senders, receivers, e_real: int,
                 rounding: Rounding = FLOAT32, s_src=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, None, senders,
                                     receivers, e_real, rounding)
    if e_real == 0:
        return empty_cap(dev)
    s_src = scores_of(h, a_src, s_src)
    nblk = cap_blocks(e_real * nh)
    blk_max = torch.empty((nblk,), dtype=torch.float32, device=dev)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), dtype=torch.float32, device=dev)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().v5_cap(
            p(s_src), p(s_dst), p(senders), p(receivers), e_real, nh,
            p(blk_max), p(blk_code), p(cap), p(code), nblk,
            build.stream(dev))
    build.check(err, "v5_cap")
    build.LAUNCHES[rounding.counter("v5_cap")] += 1
    return cap, code


def _v5_forward_two_phase_cuda(h, a_src, s_dst, cap, drop, senders,
                               receivers, e_real: int, eps: float,
                               slope: float, rounding: Rounding = FLOAT32,
                               dst_ptr=None, s_src=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, drop, senders,
                                     receivers, e_real, rounding)
    build.require(cap, "cap", dev, torch.float32, ())
    if e_real == 0:
        return empty_parts(n, d, nh, dev)[:2]
    s_src = scores_of(h, a_src, s_src)
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    den = torch.empty((n, nh), dtype=torch.float32, device=dev)
    plan = plan_of(h, out, nh, d // nh)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).v5_forward_two_phase(
            p(h), p(s_src), p(s_dst), p(cap), p(drop), p(senders),
            p(row_ptr), n, e_real, d, nh, d // nh, eps, slope, p(out),
            p(den), *plan, forward_blocks(plan, n), rounding.flags(),
            build.stream(dev))
    build.check(err, "v5_forward_two_phase")
    build.LAUNCHES[rounding.counter("v5_forward_two_phase")] += 1
    return out, den


def _v5_backward_two_phase_cuda(h, a_src, s_dst, cap, drop, senders,
                                receivers, e_real: int, eps: float,
                                slope: float, g, out, den, need_drop: bool,
                                rounding: Rounding = FLOAT32, dst_ptr=None,
                                src_order=None, src_ptr=None, s_src=None):
    dev, n, e, d, nh = _check_inputs(h, a_src, s_dst, drop, senders,
                                     receivers, e_real, rounding)
    build.require(cap, "cap", dev, torch.float32, ())
    for t, name, shape in ((g, "g", (n, d)), (out, "out", (n, d)),
                           (den, "den", (n, nh))):
        build.require(t, name, dev, torch.float32, shape)
    if e_real == 0:
        return empty_grads(h.shape[0], n, d, nh, e, need_drop, dev, True)
    s_src = scores_of(h, a_src, s_src)
    d_h, d_drop, d_sdst, d_asrc_cap = _v5_backward_by_sender_cuda(
        "v5_backward_two_phase", h, a_src, s_src, s_dst, drop, senders,
        receivers, e_real, slope, eps, g, out, den, None, cap, need_drop,
        rounding, dst_ptr, src_order, src_ptr)
    return (d_h, d_drop, d_sdst, d_asrc_cap[:d * nh].view(d, nh),
            d_asrc_cap[d * nh])


def v5_forward(h, a_src, s_dst_eff, drop, senders, receivers,
               e_real: int, slope: float, dst_ptr=None,
               rounding: Rounding = FLOAT32, *, s_src=None):
    """Kernel on CUDA tensors, plain version on CPU tensors. dst_ptr: the
    (N + 1,) int32 CSR offsets of `receivers`, where the caller holds
    them; the kernel wrapper computes them otherwise. rounding: the
    bfloat16 mode (rows, acc; h a bfloat16 table where `table`). s_src:
    the source-score table of h (source_scores), where the caller holds
    it; computed here otherwise (a timed call includes the pass)."""
    if h.is_cuda:
        return _v5_forward_cuda(h, a_src, s_dst_eff, drop, senders,
                                receivers, e_real, slope, dst_ptr, rounding,
                                s_src)
    build.require_cpu(h)
    return v5_forward_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope,
        rounding, scores_of(h, a_src, s_src))


def v5_backward(h, a_src, s_dst_eff, drop, senders, receivers,
                e_real: int, slope: float, g, out, den, epsp,
                need_drop: bool, normalize: bool = True, dst_ptr=None,
                rounding: Rounding = FLOAT32, *, src_order=None,
                src_ptr=None, s_src=None):
    """(d_h (rows of h, D) per node, d_drop (E, nh) | None, d_s_dst (N,
    nh), d_a_src (D, nh)) before the cap chain. normalize=False is the
    parts mode (attention_backward_plain says what `g` and `den` carry
    then); it counts as "v5_backward_parts". src_order and src_ptr: the
    real edges' sender runs (sender_runs), derived where None. s_src: as
    v5_forward's. The backward by sender at every row width and table
    type: on CUDA tensors the kernel (C entry v5_backward_by_sender: three
    launches, two in the parts mode), on CPU tensors its plain version in
    the kernel's association (v5_backward_split_plain)."""
    if h.is_cuda:
        return _v5_backward_cuda(h, a_src, s_dst_eff, drop, senders,
                                 receivers, e_real, slope, g, out, den,
                                 epsp, need_drop, normalize, dst_ptr,
                                 rounding, src_order, src_ptr, s_src)
    build.require_cpu(h)
    return v5_backward_split_plain(
        h, a_src, s_dst_eff, drop, senders, receivers, e_real, slope, g,
        out, den, epsp, need_drop, normalize, rounding,
        scores_of(h, a_src, s_src), src_order, src_ptr)


def v5_cap(h, a_src, s_dst, senders, receivers, e_real: int,
           rounding: Rounding = FLOAT32, *, s_src=None):
    """(cap (), code () int32): the 2-phase cap pass, a stream over the
    real edges' scores s_src[sender] + s_dst[receiver] (the table of a
    bfloat16 h in the table mode; no other point of the policy applies).
    Kernel on CUDA tensors (cap and code stay in device memory), plain
    version on CPU tensors. s_src: as v5_forward's."""
    if h.is_cuda:
        return _v5_cap_cuda(h, a_src, s_dst, senders, receivers, e_real,
                            rounding, s_src)
    build.require_cpu(h)
    check_table(h, rounding)
    return v5_cap_plain(h, a_src, s_dst, senders, receivers, e_real,
                        scores_of(h, a_src, s_src))


def v5_forward_two_phase(h, a_src, s_dst, cap, drop, senders, receivers,
                         e_real: int, eps: float, slope: float,
                         rounding: Rounding = FLOAT32, *, dst_ptr=None,
                         s_src=None):
    """(out, den) of the 2-phase forward from the cap (a () float32
    tensor on the device). Kernel on CUDA tensors, plain version on CPU
    tensors. dst_ptr, s_src: as v5_forward's."""
    if h.is_cuda:
        return _v5_forward_two_phase_cuda(h, a_src, s_dst, cap, drop,
                                          senders, receivers, e_real, eps,
                                          slope, rounding, dst_ptr, s_src)
    build.require_cpu(h)
    return v5_forward_two_phase_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        rounding, scores_of(h, a_src, s_src))


def v5_backward_two_phase(h, a_src, s_dst, cap, drop, senders, receivers,
                          e_real: int, eps: float, slope: float, g, out, den,
                          need_drop: bool, rounding: Rounding = FLOAT32, *,
                          dst_ptr=None, src_order=None, src_ptr=None,
                          s_src=None):
    """(d_h (rows of h, D) per node, d_drop | None, d_s_dst, d_a_src,
    d_cap) of the 2-phase op: the kernel by sender on CUDA tensors, its
    plain version in the kernel's association
    (v5_backward_two_phase_split_plain) on CPU tensors. dst_ptr, s_src: as
    v5_forward's; src_order, src_ptr: as v5_backward's."""
    if h.is_cuda:
        return _v5_backward_two_phase_cuda(
            h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps,
            slope, g, out, den, need_drop, rounding, dst_ptr, src_order,
            src_ptr, s_src)
    build.require_cpu(h)
    return v5_backward_two_phase_split_plain(
        h, a_src, s_dst, cap, drop, senders, receivers, e_real, eps, slope,
        g, out, den, need_drop, rounding, scores_of(h, a_src, s_src),
        src_order, src_ptr)


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


def op_scores(h_k, a_src, s_src=None):
    """The one source-score table of an op call, outside autograd: the
    caller's, checked, or computed from the table the kernels read."""
    with torch.no_grad():
        return scores_of(h_k.detach(), a_src.detach(), s_src)


def score_bound_of(h_flat, a_src, s_dst, s_src=None):
    """The single sweep's bound B >= max raw logit (stop-gradient: it
    cancels in the epilogue): from the float32 source-score table s_src
    of the op call, or where None (the op's kernels read a bfloat16 table)
    from the float32 rows, as the JAX package takes it: there the bound
    decides where the rounded terms fall."""
    with torch.no_grad():
        s = h_flat.detach() @ a_src.detach() if s_src is None else s_src
        return s.max() + s_dst.detach().max()


@op_spans("v5_attention")
class _V5Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, drop_mask, senders, receivers,
                src_order, src_ptr, dst_ptr, bound, e_real, nh, eps, slope,
                rounding):
        h_k = rounding.table_of(h_flat)
        s_src = op_scores(h_k, a_src)
        if bound is None:
            bound = score_bound_of(h_flat, a_src, s_dst,
                                   None if rounding.table else s_src)
        s_dst_eff = (s_dst - bound).contiguous()
        num, den, cap, code = v5_forward(h_k, a_src, s_dst_eff, drop_mask,
                                         senders, receivers, e_real, slope,
                                         dst_ptr, rounding, s_src=s_src)
        out, epsp = normalise(num, den, cap, eps, slope, nh)
        ctx.save_for_backward(h_k, a_src, s_src, s_dst_eff, drop_mask,
                              senders, receivers, src_order, src_ptr,
                              dst_ptr, den, out, epsp, code)
        ctx.e_real, ctx.nh, ctx.slope = e_real, nh, slope
        ctx.rounding = rounding
        return out

    @staticmethod
    def backward(ctx, g):
        (h_k, a_src, s_src, s_dst_eff, drop_mask, senders, receivers,
         src_order, src_ptr, dst_ptr, den, out, epsp,
         code) = ctx.saved_tensors
        nh, slope = ctx.nh, ctx.slope
        g = g.contiguous()
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h, d_drop, d_sdst, d_asrc = v5_backward(
            h_k, a_src, s_dst_eff, drop_mask, senders, receivers,
            ctx.e_real, slope, g, out, den, epsp, need_drop,
            dst_ptr=dst_ptr, rounding=ctx.rounding, src_order=src_order,
            src_ptr=src_ptr, s_src=s_src)
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, cap_cotangent(g, out, den, epsp, slope, nh),
            code, senders, receivers, h_k, a_src, nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 11


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
    takes it from the op's own source-score table (score_bound_of).
    two_phase:
    the 2-phase form (the JAX package under GAT_TPU_V10=0 or
    GAT_TPU_V5_MERGED=0): v5_local_cap then fused_gat_table, both reading
    one source-score table, the cap's cotangent routed to its argmax
    (edge, head); score_bound is not read there. src_ptr, dst_ptr: the
    graph's CSR offsets (Graph.src_ptr, Graph.dst_ptr), which spare the
    kernels' wrappers deriving them per call (None: derived). The dtype
    knobs (module doc) are read now."""
    _check_table_shapes(h_flat, s_dst, num_nodes, num_nodes, nh, f)
    rounding = v5_rounding()
    if two_phase:
        s_src = op_scores(rounding.table_of(h_flat), a_src)
        cap = v5_local_cap(h_flat, a_src, s_dst, senders, receivers, e_real,
                           num_nodes, nh, f, rounding=rounding, s_src=s_src)
        return fused_gat_table(h_flat, a_src, s_dst, cap, drop_mask, senders,
                               receivers, src_order, e_real, num_nodes, nh,
                               f, eps, slope, rounding=rounding,
                               src_ptr=src_ptr, dst_ptr=dst_ptr, s_src=s_src)
    return _V5Attention.apply(h_flat.contiguous(), a_src.contiguous(),
                              s_dst, drop_mask, senders, receivers,
                              src_order, src_ptr, dst_ptr,
                              None if score_bound is None
                              else score_bound.detach(), int(e_real), nh,
                              eps, slope, rounding)


@op_spans("v5_local_cap")
class _V5LocalCap(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, senders, receivers, e_real,
                rounding, s_src):
        h_k = rounding.table_of(h_flat)
        cap, code = v5_cap(h_k, a_src, s_dst, senders, receivers, e_real,
                           rounding, s_src=op_scores(h_k, a_src, s_src))
        ctx.save_for_backward(h_k, a_src, senders, receivers, code)
        ctx.s_shape, ctx.e_real = s_dst.shape, e_real
        return cap

    @staticmethod
    def backward(ctx, g):
        h_k, a_src, senders, receivers, code = ctx.saved_tensors
        grads = (h_k.new_zeros(h_k.shape, dtype=torch.float32),
                 torch.zeros_like(a_src), a_src.new_zeros(ctx.s_shape))
        if ctx.e_real:      # over no edges the cap is a constant
            grads = route_cap_cotangent(*grads, g, code, senders, receivers,
                                        h_k, a_src, a_src.shape[1])
        return grads + (None,) * 5


def v5_local_cap(h_flat: torch.Tensor,
                 a_src: torch.Tensor,
                 s_dst: torch.Tensor,
                 senders: torch.Tensor,
                 receivers: torch.Tensor,
                 e_real: int,
                 num_nodes: int, nh: int, f: int, *,
                 rounding: Optional[Rounding] = None,
                 s_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The max raw logit h[src] . a_src[:, k] + s_dst[dst, k] over the
    dst-sorted edges e < e_real and heads (a () tensor), differentiable in
    h_flat, a_src and s_dst: the cotangent goes to the argmax (edge, head),
    ties to the lowest e*nh + k. s_dst (num_nodes, nh) covers the rows the
    receivers index; h_flat may have more rows than num_nodes (the
    senders index it). rounding: the policy (only its table mode applies
    here); None reads the v5 knobs now. s_src: the source-score table of
    the op call (source_scores of the table the policy reads), which a
    2-phase op hands to its forward too; computed here where None."""
    if s_dst.shape != (num_nodes, nh) or h_flat.shape[1] != nh * f:
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)} do not match "
                         f"num_nodes={num_nodes}, nh={nh}, f={f}")
    rounding = v5_rounding() if rounding is None else rounding
    return _V5LocalCap.apply(h_flat.contiguous(), a_src.contiguous(),
                             s_dst.contiguous(), senders, receivers,
                             int(e_real), rounding, s_src)


@op_spans("v5_two_phase")
class _V5TwoPhase(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, cap, drop_mask, senders,
                receivers, src_order, src_ptr, dst_ptr, e_real, eps, slope,
                rounding, s_src):
        h_k = rounding.table_of(h_flat)
        s_src = op_scores(h_k, a_src, s_src)
        out, den = v5_forward_two_phase(h_k, a_src, s_dst, cap, drop_mask,
                                        senders, receivers, e_real, eps,
                                        slope, rounding, dst_ptr=dst_ptr,
                                        s_src=s_src)
        ctx.save_for_backward(h_k, a_src, s_src, s_dst, cap, drop_mask,
                              senders, receivers, src_order, src_ptr,
                              dst_ptr, out, den)
        ctx.e_real, ctx.eps, ctx.slope = e_real, eps, slope
        ctx.rounding = rounding
        return out

    @staticmethod
    def backward(ctx, g):
        (h_k, a_src, s_src, s_dst, cap, drop_mask, senders, receivers,
         src_order, src_ptr, dst_ptr, out, den) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[4]
        # senders index the h table, which may have more rows than the
        # destinations: d(h) has the table's rows
        d_h, d_drop, d_sdst, d_asrc, d_cap = v5_backward_two_phase(
            h_k, a_src, s_dst, cap, drop_mask, senders, receivers,
            ctx.e_real, ctx.eps, ctx.slope, g.contiguous(), out, den,
            need_drop, ctx.rounding, dst_ptr=dst_ptr, src_order=src_order,
            src_ptr=src_ptr, s_src=s_src)
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
                    dst_ptr: Optional[torch.Tensor] = None,
                    s_src: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    built them with the graph; derived per call otherwise. s_src: the
    source-score table the cap was taken from (v5_local_cap's), so that
    the argmax edge meets its cap with the same bits; computed here
    where None."""
    n_src = num_nodes if num_src_nodes is None else num_src_nodes
    _check_table_shapes(h_flat, s_dst, num_nodes, n_src, nh, f)
    rounding = v5_rounding() if rounding is None else rounding
    cap = torch.as_tensor(cap, dtype=torch.float32, device=h_flat.device)
    return _V5TwoPhase.apply(h_flat.contiguous(), a_src.contiguous(),
                             s_dst.contiguous(), cap.reshape(()), drop_mask,
                             senders, receivers, src_order, src_ptr, dst_ptr,
                             int(e_real), eps, slope, rounding, s_src)


@op_spans("v5_sweep1_parts")
class _V5Sweep1Parts(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst_eff, drop_mask, senders, receivers,
                src_order, dst_ptr, src_ptr, e_real, nh, slope, rounding,
                s_src):
        h_k = rounding.table_of(h_flat)
        if e_real == 0:     # no edges: no score pass either
            num, den, cap, code = empty_parts(
                s_dst_eff.shape[0], h_k.shape[1], nh, h_k.device)
        else:
            s_src = op_scores(h_k, a_src, s_src)
            num, den, cap, code = v5_forward(
                h_k, a_src, s_dst_eff, drop_mask, senders, receivers, e_real,
                slope, dst_ptr, rounding, s_src=s_src)
        ctx.save_for_backward(h_k, a_src, s_src, s_dst_eff, drop_mask,
                              senders, receivers, src_order, dst_ptr,
                              src_ptr, code)
        ctx.e_real, ctx.nh, ctx.slope = e_real, nh, slope
        ctx.rounding = rounding
        ctx.mark_non_differentiable(code)
        return num, den, cap, code

    @staticmethod
    def backward(ctx, d_num, d_den, d_cap, _d_code):
        (h_k, a_src, s_src, s_dst_eff, drop_mask, senders, receivers,
         src_order, dst_ptr, src_ptr, code) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        if ctx.e_real == 0:     # over no edges the parts are constants
            d_h, d_drop, d_sdst, d_asrc = empty_grads(
                h_k.shape[0], s_dst_eff.shape[0], h_k.shape[1], ctx.nh,
                senders.shape[0], need_drop, h_k.device)
            return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 10
        # senders index the h table, which may have more rows than the
        # destinations: d(h) has the table's rows
        d_h, d_drop, d_sdst, d_asrc = v5_backward(
            h_k, a_src, s_dst_eff, drop_mask, senders, receivers,
            ctx.e_real, ctx.slope, d_num.contiguous(), None,
            d_den.contiguous(), None, need_drop, normalize=False,
            dst_ptr=dst_ptr, rounding=ctx.rounding, src_order=src_order,
            src_ptr=src_ptr, s_src=s_src)
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
                    src_ptr: Optional[torch.Tensor] = None,
                    s_src: Optional[torch.Tensor] = None):
    """The unnormalised single-sweep parts (num (num_nodes, nh*f),
    den (num_nodes, nh), cap' (), code () int32) over the dst-sorted edges
    e < e_real, differentiable in h_flat, a_src, s_dst and drop_mask.
    Over no edges (e_real 0: an empty shard or remainder of the dst-owned
    layout) it gives zeros, cap' NEG_INF and code 0 as the JAX op does,
    launches nothing (no score pass either), and its parts are constants
    with no gradient.

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
    they are computed per call otherwise. s_src: the source-score table
    of the table this op's kernels read (source_scores), where the caller
    shares one with another op; computed here where None. The dtype knobs
    (module doc) are read now."""
    n_src = num_nodes if num_src_nodes is None else num_src_nodes
    _check_table_shapes(h_flat, s_dst, num_nodes, n_src, nh, f)
    return _V5Sweep1Parts.apply(
        h_flat.contiguous(), a_src.contiguous(), s_dst.contiguous(),
        drop_mask, senders, receivers, src_order, dst_ptr, src_ptr,
        int(e_real), nh, slope, v5_rounding(), s_src)
