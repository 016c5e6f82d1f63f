"""The windowed whole-attention op over a block layout.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention_window.py:
fused_gat_window_v7 (:1771) with its VJP `_fgw7_fwd`/`_fgw7_bwd`
(:1803-1927), in the single-sweep (v10) mode, and v7_sweep1_parts (:1939)
with `_v7sp_fwd`/`_v7sp_bwd`, the same sweep without its epilogue
(ops/cuda/v5_attention.py says what the parts are for). The kernels are
csrc/window_attention.cu (forward: `_kernel_v6`; backward:
`_kernel_v6_bwd`, in its normalised and its parts mode, with the d(h)
reduction that the JAX package runs after it: the backward sums d(h) by
sender and returns it per node). `window_forward_plain` and
`window_backward_plain` are their plain torch versions.

It computes the function of ops/cuda/v5_attention.py (see its module doc
for the algebra) over the slots of a graph.BlockLayout instead of the
dst-sorted edge list: a pad slot (recv == -1) adds nothing; the dropout
mask and its cotangent are (E7, nh) in slot order; the argmax code of the
cap is the lowest slot*nh + head. The layout's `window`, `wb`, `base`,
`tile_base`, `tile_ptr` and `dmax` size the TPU kernel's streamed windows;
the CUDA kernels gather rows directly and walk the slots through the
layout's `dst_perm`/`dst_ptr` and `src_perm`/`src_ptr` instead. As the
v5 kernels do, they read their logits from the op's source-score table
(v5_attention.source_scores), computed once a call; window_cap reads
the tables alone.

The 2-phase form of the same op (the JAX package's v7 path under
GAT_TPU_V10=0: `_kernel_v6` and `_kernel_v6_bwd` with sweep1=False) is
fused_gat_window_v7(two_phase=True): the kernel entries window_cap,
window_forward_two_phase and window_backward_two_phase, the contract of
v5_attention.fused_gat_table over the layout's slots (code slot*nh + head).

fused_gat_window is the v6 form (segment_attention_window.py:1630), the
2-phase op over the graph's own dst-sorted edges. Its `tile_lo` and
`window` size the TPU kernel's streamed VMEM window, which it needs for
its one-hot MXU gather; Hopper gathers rows at random, so on the card the
op is v5_attention's 2-phase pair (v5_cap, v5_forward_two_phase,
v5_backward_two_phase) over the graph's CSR, with d(h) summed by sender
over a stable sort of the senders. That is the Hopper algorithm for that
contract.

The contraction dtype (GAT_TPU_V6_DTYPE, `_v6_dtype`) is bfloat16 unless
the variable says "float32", as in the JAX package, read when an op is
called. In the bfloat16 mode (`window_rounding`) the gathered h rows, each
edge's [weighted h | ex] before the float32 sums, each destination's
backward payload [g | 1/(den+eps) | d(den)], the d(h) rows and d(raw) in
d(a_src) and d(s_dst) are rounded; logits, exp, den's and d(cap)'s sums
stay float32. Where a single-sweep layer's nh*f fits the packed window
(`_pair_slot` > 0: round8(nh*f) <= 64 and GAT_TPU_V12 not "0"; never in
the 2-phase form) the JAX kernel gathers a bfloat16 table and takes the
logits from the rounded rows: the op then hands its kernels a bfloat16
table. The v6 form rounds the rows, [weighted h | ex], the d(h) rows and
d(raw) in d(a_src) only (V6_BF16). The cap chain reads the float32 row,
as the JAX op's does. GAT_TPU_V11 (a stream of the same rounded rows) and
GAT_TPU_ONEHOT_DTYPE (int8 one-hots, an exact selection) change no value
and are not read.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ...graph.graph import BlockLayout
from ...utils.profiling import op_spans
from . import build
from .rounding import FLOAT32, Rounding, check_table
from .segment_sum import dh_reduce_plain
from .v5_attention import (MAX_HEADS, attention_backward_plain,
                           attention_backward_two_phase_plain,
                           attention_cap_plain, attention_forward_plain,
                           attention_forward_two_phase_plain, cap_blocks,
                           cap_cotangent, empty_cap, empty_grads,
                           empty_parts, forward_blocks, fused_gat_table,
                           normalise, op_scores, plan_of,
                           route_cap_cotangent, row_plan, score_bound_of,
                           scores_of, v5_local_cap, align_of)

_KERNEL = "window_attention"
_configured = set()

# the v6 form's bfloat16 mode (fused_gat_window's _kernel_v6 main_body and
# _kernel_v6_bwd without v7: its payload and d(s_dst) stay float32)
V6_BF16 = Rounding(rows=True, acc=True, d_h=True, d_raw=True)


def _v6_dtype() -> torch.dtype:
    """GAT_TPU_V6_DTYPE as segment_attention_window._v6_dtype reads it:
    float32 only where it is "float32"."""
    return (torch.float32
            if os.environ.get("GAT_TPU_V6_DTYPE") == "float32"
            else torch.bfloat16)


def _pair_slot(nhf: int) -> int:
    """segment_attention_window._pair_slot: the packed window's slot width
    for a layer of nh*f = nhf (8, 16, 32 or 64, the least >= round8(nhf)),
    or 0 where nhf > 64 or GAT_TPU_V12 is "0"."""
    if os.environ.get("GAT_TPU_V12", "1") == "0":
        return 0
    nhf8 = -(-nhf // 8) * 8
    for slot in (8, 16, 32, 64):
        if nhf8 <= slot:
            return slot
    return 0


def window_rounding(nh: int, f: int, sweep1: bool = True) -> Rounding:
    """The windowed op's policy under the knobs, read now: float32, or
    the bfloat16 payload mode, from a bfloat16 table where the single
    sweep takes the packed window."""
    if _v6_dtype() == torch.float32:
        return FLOAT32
    pair = sweep1 and _pair_slot(nh * f) > 0
    return Rounding(table=pair, rows=not pair, acc=True, payload=True,
                    d_h=True, d_raw=True, d_sdst=True)


def _lib(bf16_table: bool = False) -> ctypes.CDLL:
    """The kernels' library for a float32 h table, or for the packed
    window's bfloat16 one (window_forward, and window_backward in its
    single-sweep modes, rows at most 64 wide)."""
    name = build.library(_KERNEL, bf16_table)
    lib = build.load(name)
    if name not in _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        plan = [i] * 5      # the lane plan (v5_attention.LanePlan)
        lib.window_forward.argtypes = ([p] * 7 + [i] * 4 + [fl] + [p] * 6
                                       + plan + [i, i, p])
        lib.window_forward.restype = ctypes.c_int
        lib.window_backward.argtypes = ([p] * 11 + [i] * 9 + [fl] * 2
                                        + [p] * 14 + [i] * 6 + [p])
        lib.window_backward.restype = ctypes.c_int
        _configured.add(name)
        if bf16_table:
            return lib
        lib.window_cap.argtypes = [p] * 4 + [i] * 2 + [p] * 4 + [i, p]
        lib.window_cap.restype = ctypes.c_int
        lib.window_forward_two_phase.argtypes = ([p] * 8 + [i] * 4
                                                 + [fl] * 2 + [p] * 2
                                                 + plan + [i, i, p])
        lib.window_forward_two_phase.restype = ctypes.c_int
    return lib


# -- plain versions (CPU tensors) -------------------------------------------
#
# Each takes the source-score table s_src as the kernels do (computed from
# h where None; window_cap_plain reads only the tables).

def _slots(layout: BlockLayout, n: int):
    """(send, recv with pad slots sent to n, valid (E7, 1)) as int64."""
    recv = layout.recv.long()
    valid = recv >= 0
    return (layout.send.long(), torch.where(valid, recv, n),
            valid[:, None])


def window_forward_plain(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                         slope: float, rounding: Rounding = FLOAT32,
                         s_src=None):
    """(num (N, D), den (N, nh), cap' (), code () int32)."""
    return attention_forward_plain(
        h, a_src, s_dst_eff, drop, *_slots(layout, s_dst_eff.shape[0]),
        slope, rounding, s_src)


def window_backward_rows_plain(h, a_src, s_dst_eff, drop,
                               layout: BlockLayout, slope: float, g, out,
                               den, epsp, need_drop: bool,
                               normalize: bool = True,
                               rounding: Rounding = FLOAT32, s_src=None):
    """(d_h rows (E7, D) in slot order, 0 on pad slots, d_drop (E7, nh) |
    None, d_s_dst (N, nh), d_a_src (D, nh)): the TPU kernel's outputs, whose
    per-slot rows the JAX package then reduces by sender;
    normalize=False as v5_attention.attention_backward_plain takes it."""
    return attention_backward_plain(
        h, a_src, s_dst_eff, drop, *_slots(layout, s_dst_eff.shape[0]),
        slope, g, out, den, epsp, need_drop, normalize, rounding=rounding,
        s_src=s_src)


def window_backward_plain(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                          slope: float, g, out, den, epsp, need_drop: bool,
                          normalize: bool = True,
                          rounding: Rounding = FLOAT32, s_src=None):
    """(d_h (N, D) per node, d_drop (E7, nh) | None, d_s_dst (N, nh),
    d_a_src (D, nh)) before the cap chain: window_backward_rows_plain with
    each sender's rows summed in ascending position of its run of
    layout.src_perm (dh_reduce_plain), the order of the kernel."""
    rows, *rest = window_backward_rows_plain(
        h, a_src, s_dst_eff, drop, layout, slope, g, out, den, epsp,
        need_drop, normalize, rounding, s_src)
    return (_by_sender(rows, layout), *rest)


def _by_sender(rows, layout: BlockLayout):
    """Per-slot d(h) rows (E7, D) summed by sender (N, D) over the runs of
    layout.src_perm, in ascending position."""
    return dh_reduce_plain(rows, layout.src_perm, layout.src_ptr)


def window_cap_plain(s_src, s_dst, layout: BlockLayout):
    """(cap (), code () int32) over the real slots, code slot*nh + head,
    from the score tables."""
    n = s_dst.shape[0]
    return attention_cap_plain(s_src, s_dst, *_slots(layout, n))


def window_forward_two_phase_plain(h, a_src, s_dst, cap, drop,
                                   layout: BlockLayout, eps: float,
                                   slope: float,
                                   rounding: Rounding = FLOAT32,
                                   s_src=None):
    """(out (N, D), den (N, nh)) of the 2-phase forward over the slots."""
    return attention_forward_two_phase_plain(
        h, a_src, s_dst, cap, drop, *_slots(layout, s_dst.shape[0]), eps,
        slope, rounding, s_src)


def window_backward_two_phase_rows_plain(h, a_src, s_dst, cap, drop,
                                         layout: BlockLayout, eps: float,
                                         slope: float, g, out, den,
                                         need_drop: bool,
                                         rounding: Rounding = FLOAT32,
                                         s_src=None):
    """(d_h rows (E7, D) in slot order, 0 on pad slots, d_drop | None,
    d_s_dst, d_a_src, d_cap): the 2-phase TPU kernel's outputs over the
    slots."""
    return attention_backward_two_phase_plain(
        h, a_src, s_dst, cap, drop, *_slots(layout, s_dst.shape[0]), eps,
        slope, g, out, den, need_drop, rounding, s_src)


def window_backward_two_phase_plain(h, a_src, s_dst, cap, drop,
                                    layout: BlockLayout, eps: float,
                                    slope: float, g, out, den,
                                    need_drop: bool,
                                    rounding: Rounding = FLOAT32,
                                    s_src=None):
    """(d_h (N, D) per node, d_drop | None, d_s_dst, d_a_src, d_cap) of
    the 2-phase op over the slots, d_h summed by sender as
    window_backward_plain's."""
    rows, *rest = window_backward_two_phase_rows_plain(
        h, a_src, s_dst, cap, drop, layout, eps, slope, g, out, den,
        need_drop, rounding, s_src)
    return (_by_sender(rows, layout), *rest)


# -- kernel wrappers (CUDA tensors) -----------------------------------------
#
# Each takes the op's rounding policy, as ops/cuda/v5_attention.py's do,
# and the source-score table (v5_attention.source_scores, the v5
# library's entry) where the caller holds it, computing it otherwise.

def _check_layout(layout: BlockLayout, dev, n: int):
    """The slots' arrays over n destination rows."""
    e7 = layout.num_slots
    build.require(layout.send, "layout.send", dev, torch.int32, (e7,))
    build.require(layout.dst_perm, "layout.dst_perm", dev, torch.int32,
                  (e7,))
    build.require(layout.dst_ptr, "layout.dst_ptr", dev, torch.int32,
                  (n + 1,))
    return e7


def _check_sender_runs(layout: BlockLayout, dev, n_src: int):
    """The backward by sender also walks the real slots by sender, over
    the n_src rows of the h table."""
    e7 = layout.num_slots
    build.require(layout.recv, "layout.recv", dev, torch.int32, (e7,))
    build.require(layout.src_perm, "layout.src_perm", dev, torch.int32,
                  (None,))
    build.require(layout.src_ptr, "layout.src_ptr", dev, torch.int32,
                  (n_src + 1,))


def _check_inputs(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                  rounding: Rounding = FLOAT32):
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
    # the destination rows: all of h's, or a dst-owned shard's fewer
    build.require(s_dst_eff, "s_dst", dev, torch.float32, (None, nh))
    n = s_dst_eff.shape[0]
    e7 = _check_layout(layout, dev, n)
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e7, nh))
    return dev, n, e7, d, nh


def _window_forward_cuda(h, a_src, s_dst_eff, drop, layout, slope: float,
                         rounding: Rounding = FLOAT32, s_src=None):
    dev, n, e7, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, layout,
                                      rounding)
    if layout.num_real == 0:
        return empty_parts(n, d, nh, dev)
    s_src = scores_of(h, a_src, s_src)
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
        err = lib.window_forward(
            p(h), p(s_src), p(s_dst_eff), p(drop), p(layout.send),
            p(layout.dst_perm), p(layout.dst_ptr), n, d, nh, d // nh, slope,
            p(num), p(den), p(blk_max), p(blk_code), p(cap), p(code),
            *plan, nblk, rounding.flags(), build.stream(dev))
    build.check(err, "window_forward")
    build.LAUNCHES[rounding.counter("window_forward")] += 1
    return num, den, cap, code


_MODES = {"window_backward": 0, "window_backward_parts": 1,
          "window_backward_two_phase": 2}


def _window_backward_launch(name, h, a_src, s_src, s_dst, drop, layout,
                            slope: float, eps: float, g, out, den, epsp, cap,
                            need_drop: bool, rounding: Rounding):
    """One call of the C entry window_backward in the mode of `name`:
    (d_h (n_src, d), d_drop | None, d_sdst (n, nh), d_asrc (d*nh [+
    1])), n_src the rows of h and n those of s_dst."""
    dev, n, e7, d, nh = _check_inputs(h, a_src, s_dst, drop, layout,
                                      rounding)
    n_src = h.shape[0]
    _check_sender_runs(layout, dev, n_src)
    mode = _MODES[name]
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(den, "den" if mode != 1 else "d_den", dev, torch.float32,
                  (n, nh))
    if mode != 1:
        build.require(out, "out", dev, torch.float32, (n, d))
    if mode == 0:
        build.require(epsp, "epsp", dev, torch.float32, ())
    if mode == 2:
        build.require(cap, "cap", dev, torch.float32, ())
    stride = d * nh + (1 if mode == 2 else 0)
    f32 = dict(dtype=torch.float32, device=dev)
    if layout.num_real == 0:
        return (*empty_grads(n_src, n, d, nh, e7, need_drop, dev)[:3],
                torch.zeros((stride,), **f32))
    s_src = scores_of(h, a_src, s_src)
    # a fixed grid (a function of n_src: the blocks' d(a_src) partial rows
    # are summed in block order), up to eight blocks an SM of the 132:
    # senders' runs differ in length, and more blocks than fit at once
    # balance them
    nblk = max(1, min(-(-n_src // build.WARPS_PER_BLOCK), 8 * 132))
    # the warps take items of the layout's sender runs, built once a layout
    items = build.sender_items(layout.src_ptr,
                               nblk * build.WARPS_PER_BLOCK, layout.src_ptr)
    d_h = torch.empty((n_src, d), **f32)
    d_drop = torch.empty((e7, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    d_asrc = torch.empty((stride,), **f32)
    dsd = torch.empty((e7, nh), **f32)
    dsum = torch.empty((items.n_items, nh), **f32)
    part = torch.empty((nblk, stride), **f32)
    dh_part = (torch.empty((items.n_parts, d), **f32) if items.n_split
               else None)
    dden = torch.empty((n, nh), **f32) if mode != 1 else None
    plan = row_plan(nh, d // nh, min(align_of(h), align_of(g)), three=True)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib(rounding.table).window_backward(
            p(h), p(a_src), p(s_src), p(s_dst), p(drop), p(layout.recv),
            p(layout.src_perm), p(layout.src_ptr), p(layout.dst_perm),
            p(layout.dst_ptr), p(items.table), items.n_items, items.n_split,
            n_src, n, e7, d, nh, d // nh, mode, slope,
            eps, p(g), p(out) if mode != 1 else None, p(den),
            p(epsp) if mode == 0 else None, p(cap) if mode == 2 else None,
            p(d_h), p(d_drop), p(d_sdst), p(d_asrc), p(dsd), p(dsum),
            p(part), p(dh_part), p(dden), *plan, nblk, rounding.flags(),
            build.stream(dev))
    build.check(err, name)
    build.LAUNCHES[rounding.counter(name)] += 1
    return d_h, d_drop, d_sdst, d_asrc


def _window_backward_cuda(h, a_src, s_dst_eff, drop, layout, slope: float,
                          g, out, den, epsp, need_drop: bool,
                          normalize: bool = True,
                          rounding: Rounding = FLOAT32, s_src=None):
    name = "window_backward" if normalize else "window_backward_parts"
    d_h, d_drop, d_sdst, d_asrc = _window_backward_launch(
        name, h, a_src, s_src, s_dst_eff, drop, layout, slope, 0.0, g,
        out if normalize else None, den, epsp if normalize else None, None,
        need_drop, rounding)
    return d_h, d_drop, d_sdst, d_asrc.view(h.shape[1], -1)


def _window_cap_cuda(s_src, s_dst, layout):
    dev = s_dst.device
    n, nh = s_dst.shape if s_dst.dim() == 2 else (-1, -1)
    build.require(s_dst, "s_dst", dev, torch.float32, (n, nh))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    build.require(s_src, "s_src", dev, torch.float32, (None, nh))
    e7 = _check_layout(layout, dev, n)
    build.require(layout.recv, "layout.recv", dev, torch.int32, (e7,))
    if layout.num_real == 0:
        return empty_cap(dev)
    nblk = cap_blocks(e7 * nh)
    blk_max = torch.empty((nblk,), dtype=torch.float32, device=dev)
    blk_code = torch.empty((nblk,), dtype=torch.int32, device=dev)
    cap = torch.empty((), dtype=torch.float32, device=dev)
    code = torch.empty((), dtype=torch.int32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().window_cap(
            p(s_src), p(s_dst), p(layout.send), p(layout.recv), e7, nh,
            p(blk_max), p(blk_code), p(cap), p(code), nblk,
            build.stream(dev))
    build.check(err, "window_cap")
    build.LAUNCHES["window_cap"] += 1
    return cap, code


def _window_forward_two_phase_cuda(h, a_src, s_dst, cap, drop, layout,
                                   eps: float, slope: float,
                                   rounding: Rounding = FLOAT32,
                                   s_src=None):
    dev, n, e7, d, nh = _check_inputs(h, a_src, s_dst, drop, layout,
                                      rounding)
    build.require(cap, "cap", dev, torch.float32, ())
    if layout.num_real == 0:
        return empty_parts(n, d, nh, dev)[:2]
    s_src = scores_of(h, a_src, s_src)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    den = torch.empty((n, nh), dtype=torch.float32, device=dev)
    plan = plan_of(h, out, nh, d // nh)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().window_forward_two_phase(
            p(h), p(s_src), p(s_dst), p(cap), p(drop), p(layout.send),
            p(layout.dst_perm), p(layout.dst_ptr), n, d, nh, d // nh, eps,
            slope, p(out), p(den), *plan, forward_blocks(plan, n),
            rounding.flags(), build.stream(dev))
    build.check(err, "window_forward_two_phase")
    build.LAUNCHES[rounding.counter("window_forward_two_phase")] += 1
    return out, den


def _window_backward_two_phase_cuda(h, a_src, s_dst, cap, drop, layout,
                                    eps: float, slope: float, g, out, den,
                                    need_drop: bool,
                                    rounding: Rounding = FLOAT32,
                                    s_src=None):
    d_h, d_drop, d_sdst, d_asrc_cap = _window_backward_launch(
        "window_backward_two_phase", h, a_src, s_src, s_dst, drop, layout,
        slope, eps, g, out, den, None, cap, need_drop, rounding)
    d = h.shape[1]
    return (d_h, d_drop, d_sdst, d_asrc_cap[:-1].view(d, -1),
            d_asrc_cap[-1])


def window_forward(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                   slope: float, rounding: Rounding = FLOAT32, *,
                   s_src=None):
    """Kernel on CUDA tensors, plain version on CPU tensors. s_src: the
    source-score table of h (v5_attention.source_scores), where the
    caller holds it; computed here otherwise."""
    if h.is_cuda:
        return _window_forward_cuda(h, a_src, s_dst_eff, drop, layout, slope,
                                    rounding, s_src)
    build.require_cpu(h)
    return window_forward_plain(h, a_src, s_dst_eff, drop, layout, slope,
                                rounding, scores_of(h, a_src, s_src))


def window_backward(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                    slope: float, g, out, den, epsp, need_drop: bool,
                    normalize: bool = True, rounding: Rounding = FLOAT32, *,
                    s_src=None):
    """(d_h (N, D) per node, d_drop (E7, nh) | None, d_s_dst (N, nh),
    d_a_src (D, nh)) before the cap chain: the kernel by sender on CUDA
    tensors, the plain version on CPU tensors. normalize=False is the parts
    mode; it launches the kernel's parts mode and counts as
    "window_backward_parts". s_src: as window_forward's."""
    if h.is_cuda:
        return _window_backward_cuda(h, a_src, s_dst_eff, drop, layout,
                                     slope, g, out, den, epsp, need_drop,
                                     normalize, rounding, s_src)
    build.require_cpu(h)
    return window_backward_plain(h, a_src, s_dst_eff, drop, layout, slope,
                                 g, out, den, epsp, need_drop, normalize,
                                 rounding, scores_of(h, a_src, s_src))


def window_cap(s_src, s_dst, layout: BlockLayout):
    """(cap, code) of the 2-phase cap pass over the real slots: a stream
    over the scores s_src[send] + s_dst[recv] (s_src the source-score
    table of the float32 rows, v5_attention.source_scores; the cap reads
    no h). Kernel on CUDA tensors, plain version on CPU tensors."""
    if s_dst.is_cuda:
        return _window_cap_cuda(s_src, s_dst, layout)
    build.require_cpu(s_dst)
    build.require(s_src, "s_src", s_dst.device, torch.float32,
                  (None, s_dst.shape[1]))
    return window_cap_plain(s_src, s_dst, layout)


def window_forward_two_phase(h, a_src, s_dst, cap, drop, layout: BlockLayout,
                             eps: float, slope: float,
                             rounding: Rounding = FLOAT32, *, s_src=None):
    """(out, den) of the 2-phase forward from the cap (a () float32
    tensor on the device). Kernel on CUDA tensors, plain version on CPU
    tensors. s_src: as window_forward's."""
    if h.is_cuda:
        return _window_forward_two_phase_cuda(h, a_src, s_dst, cap, drop,
                                              layout, eps, slope, rounding,
                                              s_src)
    build.require_cpu(h)
    return window_forward_two_phase_plain(h, a_src, s_dst, cap, drop, layout,
                                          eps, slope, rounding,
                                          scores_of(h, a_src, s_src))


def window_backward_two_phase(h, a_src, s_dst, cap, drop, layout: BlockLayout,
                              eps: float, slope: float, g, out, den,
                              need_drop: bool, rounding: Rounding = FLOAT32,
                              *, s_src=None):
    """(d_h (N, D) per node, d_drop | None, d_s_dst, d_a_src, d_cap) of
    the 2-phase op. Kernel on CUDA tensors, plain version on CPU tensors.
    s_src: as window_forward's."""
    if h.is_cuda:
        return _window_backward_two_phase_cuda(h, a_src, s_dst, cap, drop,
                                               layout, eps, slope, g, out,
                                               den, need_drop, rounding,
                                               s_src)
    build.require_cpu(h)
    return window_backward_two_phase_plain(h, a_src, s_dst, cap, drop,
                                           layout, eps, slope, g, out, den,
                                           need_drop, rounding,
                                           scores_of(h, a_src, s_src))


# -- the differentiable op ----------------------------------------------------

@op_spans("window_attention")
class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, drop_mask, layout, bound, nh,
                eps, slope, rounding):
        h_k = rounding.table_of(h_flat)
        s_src = op_scores(h_k, a_src)
        if bound is None:
            bound = score_bound_of(h_flat, a_src, s_dst,
                                   None if rounding.table else s_src)
        s_dst_eff = (s_dst - bound).contiguous()
        num, den, cap, code = window_forward(h_k, a_src, s_dst_eff,
                                             drop_mask, layout, slope,
                                             rounding, s_src=s_src)
        out, epsp = normalise(num, den, cap, eps, slope, nh)
        ctx.save_for_backward(h_flat, h_k, a_src, s_src, s_dst_eff,
                              drop_mask, den, out, epsp, code)
        ctx.layout, ctx.nh, ctx.slope = layout, nh, slope
        ctx.rounding = rounding
        return out

    @staticmethod
    def backward(ctx, g):
        (h_flat, h_k, a_src, s_src, s_dst_eff, drop_mask, den, out, epsp,
         code) = ctx.saved_tensors
        layout, nh, slope = ctx.layout, ctx.nh, ctx.slope
        g = g.contiguous()
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h, d_drop, d_sdst, d_asrc = window_backward(
            h_k, a_src, s_dst_eff, drop_mask, layout, slope, g, out, den,
            epsp, need_drop, rounding=ctx.rounding, s_src=s_src)
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, cap_cotangent(g, out, den, epsp, slope, nh),
            code, layout.send, layout.recv, h_flat, a_src, nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 6


def _check_layout_shapes(h_flat, s_dst, layout, num_nodes, nh, f,
                         num_src_nodes=None):
    n_src = num_nodes if num_src_nodes is None else num_src_nodes
    if (h_flat.shape != (n_src, nh * f)
            or s_dst.shape != (num_nodes, nh)
            or layout.dst_ptr.shape[0] != num_nodes + 1
            or layout.src_ptr.shape[0] != n_src + 1):
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)}, layout over "
                         f"{layout.dst_ptr.shape[0] - 1} nodes and "
                         f"{layout.src_ptr.shape[0] - 1} senders do not "
                         f"match num_nodes={num_nodes}, num_src_nodes="
                         f"{n_src}, nh={nh}, f={f}")


@op_spans("window_cap")
class _WindowCap(torch.autograd.Function):
    """The cap of the 2-phase op from its score table; differentiable in
    h_flat, a_src and s_dst through the argmax (slot, head)."""

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, layout, s_src):
        cap, code = window_cap(s_src, s_dst, layout)
        ctx.save_for_backward(h_flat, a_src, code)
        ctx.layout, ctx.s_shape = layout, s_dst.shape
        return cap

    @staticmethod
    def backward(ctx, g):
        h_flat, a_src, code = ctx.saved_tensors
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            torch.zeros_like(h_flat), torch.zeros_like(a_src),
            h_flat.new_zeros(ctx.s_shape), g, code, ctx.layout.send,
            ctx.layout.recv, h_flat, a_src, a_src.shape[1])
        return d_h, d_asrc, d_sdst, None, None


@op_spans("window_two_phase")
class _WindowTwoPhase(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, cap, drop_mask, layout, eps,
                slope, rounding, s_src):
        out, den = window_forward_two_phase(h_flat, a_src, s_dst, cap,
                                            drop_mask, layout, eps, slope,
                                            rounding, s_src=s_src)
        ctx.save_for_backward(h_flat, a_src, s_src, s_dst, cap, drop_mask,
                              out, den)
        ctx.layout, ctx.eps, ctx.slope = layout, eps, slope
        ctx.rounding = rounding
        return out

    @staticmethod
    def backward(ctx, g):
        (h_flat, a_src, s_src, s_dst, cap, drop_mask, out,
         den) = ctx.saved_tensors
        layout = ctx.layout
        need_drop = drop_mask is not None and ctx.needs_input_grad[4]
        d_h, d_drop, d_sdst, d_asrc, d_cap = window_backward_two_phase(
            h_flat, a_src, s_dst, cap, drop_mask, layout, ctx.eps, ctx.slope,
            g.contiguous(), out, den, need_drop, ctx.rounding, s_src=s_src)
        return (d_h, d_asrc, d_sdst, d_cap, d_drop) + (None,) * 5


def fused_gat_window_v7(h_flat: torch.Tensor,
                        a_src: torch.Tensor,
                        s_dst: torch.Tensor,
                        drop_mask: Optional[torch.Tensor],
                        layout: BlockLayout,
                        score_bound: Optional[torch.Tensor],
                        num_nodes: int, nh: int, f: int,
                        eps: float = 1e-8,
                        slope: float = 0.01,
                        two_phase: bool = False) -> torch.Tensor:
    """Normalised attention output (num_nodes, nh*f) of the reference GAT
    layer over the edges of `layout`, differentiable in h_flat, a_src,
    s_dst and drop_mask.

    h_flat (N, nh*f) node features, a_src (nh*f, nh) the cross-head source
    half of the attention map, s_dst (N, nh) destination scores.
    layout: the graph's BlockLayout on the tensors' device; it stands for
    the JAX op's send, recv, block_base, tile_ptr, tile_base, window, wb,
    eb, nb and dmax arguments.
    drop_mask: (E7, nh) attention-dropout multipliers in slot order, or
    None. score_bound: any scalar >= the max raw logit (stop-gradient);
    None takes it from the op's own source-score table
    (v5_attention.score_bound_of). two_phase: the 2-phase form
    (the JAX package under GAT_TPU_V10=0): the cap pass over the slots,
    then the attention pass with that cap, both reading one source-score
    table, the cap's cotangent going to the argmax (slot, head);
    score_bound is not read there. The contraction dtype (module doc) is
    read now."""
    _check_layout_shapes(h_flat, s_dst, layout, num_nodes, nh, f)
    h_flat, a_src = h_flat.contiguous(), a_src.contiguous()
    rounding = window_rounding(nh, f, sweep1=not two_phase)
    if two_phase:
        s_dst = s_dst.contiguous()
        s_src = op_scores(h_flat, a_src)    # the 2-phase form: no table mode
        cap = _WindowCap.apply(h_flat, a_src, s_dst, layout, s_src)
        return _WindowTwoPhase.apply(h_flat, a_src, s_dst, cap, drop_mask,
                                     layout, eps, slope, rounding, s_src)
    return _WindowAttention.apply(h_flat, a_src, s_dst, drop_mask, layout,
                                  None if score_bound is None
                                  else score_bound.detach(), nh, eps, slope,
                                  rounding)


def fused_gat_window(h_flat: torch.Tensor,
                     a_src: torch.Tensor,
                     s_dst: torch.Tensor,
                     drop_mask: Optional[torch.Tensor],
                     senders: torch.Tensor,
                     receivers: torch.Tensor,
                     e_real: int,
                     tile_lo: torch.Tensor,
                     num_nodes: int, nh: int, f: int,
                     window: int,
                     eps: float = 1e-8,
                     slope: float = 0.01, *,
                     src_order: Optional[torch.Tensor] = None,
                     src_ptr: Optional[torch.Tensor] = None,
                     dst_ptr: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The v6 form: the 2-phase whole-attention op over the graph's own
    dst-sorted edges (real edges first, e < e_real), its global cap taken
    in a pass of its own; (num_nodes, nh*f), differentiable in h_flat,
    a_src, s_dst and drop_mask ((E, nh) in graph edge order, or None).

    tile_lo ((ceil(num_nodes / 128),) int32, per 128-row destination tile
    the lowest sender) and window (the rows of the streamed sender window)
    size the TPU kernel's VMEM window for its one-hot MXU gather. Hopper
    gathers rows at random, so the Hopper algorithm for this contract is
    v5_local_cap then fused_gat_table over the graph's CSR (the kernels
    source_scores, v5_cap, v5_forward_two_phase, v5_backward_two_phase;
    one score table for the cap and the attention pass), d(h) summed by
    sender over the stable sender sort src_order (Graph.src_order;
    computed per call where the caller has none), with the graph's CSR
    offsets src_ptr (read
    only with src_order) and dst_ptr where the caller has them (Graph.
    src_ptr, Graph.dst_ptr). tile_lo and window are checked, not read.
    The contraction dtype is read now (V6_BF16 in the bfloat16 mode, the
    cap pass on the float32 rows); the v5 knobs are not read."""
    tiles = -(-num_nodes // 128)
    if tuple(tile_lo.shape) != (tiles,) or window < 1:
        raise ValueError(f"tile_lo of shape {tuple(tile_lo.shape)} and "
                         f"window {window}: expected ({tiles},) and >= 1 "
                         f"for num_nodes={num_nodes}")
    if src_order is None:
        src_order = torch.argsort(senders, stable=True).to(torch.int32)
        src_ptr = None
    rounding = FLOAT32 if _v6_dtype() == torch.float32 else V6_BF16
    # both passes read the float32 rows' table (V6_BF16 has no table mode)
    s_src = op_scores(h_flat, a_src)
    cap = v5_local_cap(h_flat, a_src, s_dst, senders, receivers, e_real,
                       num_nodes, nh, f, rounding=FLOAT32, s_src=s_src)
    return fused_gat_table(h_flat, a_src, s_dst, cap, drop_mask, senders,
                           receivers, src_order, e_real, num_nodes, nh, f,
                           eps, slope, rounding=rounding, src_ptr=src_ptr,
                           dst_ptr=dst_ptr, s_src=s_src)


@op_spans("window_sweep1_parts")
class _WindowSweep1Parts(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst_eff, drop_mask, layout, nh, slope,
                rounding, s_src):
        h_k = rounding.table_of(h_flat)
        if layout.num_real == 0:    # no real slot: no score pass either
            num, den, cap, code = empty_parts(
                s_dst_eff.shape[0], h_k.shape[1], nh, h_k.device)
        else:
            s_src = op_scores(h_k, a_src, s_src)
            num, den, cap, code = window_forward(
                h_k, a_src, s_dst_eff, drop_mask, layout, slope, rounding,
                s_src=s_src)
        ctx.save_for_backward(h_flat, h_k, a_src, s_src, s_dst_eff,
                              drop_mask, code)
        ctx.layout, ctx.nh, ctx.slope = layout, nh, slope
        ctx.rounding = rounding
        ctx.mark_non_differentiable(code)
        return num, den, cap, code

    @staticmethod
    def backward(ctx, d_num, d_den, d_cap, _d_code):
        (h_flat, h_k, a_src, s_src, s_dst_eff, drop_mask,
         code) = ctx.saved_tensors
        layout = ctx.layout
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        if layout.num_real == 0:    # the parts are constants
            d_h, d_drop, d_sdst, d_asrc = empty_grads(
                h_k.shape[0], s_dst_eff.shape[0], h_k.shape[1], ctx.nh,
                layout.num_slots, need_drop, h_k.device)
            return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 5
        d_h, d_drop, d_sdst, d_asrc = window_backward(
            h_k, a_src, s_dst_eff, drop_mask, layout, ctx.slope,
            d_num.contiguous(), None, d_den.contiguous(), None, need_drop,
            normalize=False, rounding=ctx.rounding, s_src=s_src)
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, d_cap, code, layout.send, layout.recv,
            h_flat, a_src, ctx.nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 5


def v7_sweep1_parts(h_flat: torch.Tensor,
                    a_src: torch.Tensor,
                    s_dst: torch.Tensor,
                    drop_mask: Optional[torch.Tensor],
                    layout: BlockLayout,
                    num_nodes: int, nh: int, f: int,
                    eps: float = 1e-8,
                    slope: float = 0.01,
                    num_src_nodes: Optional[int] = None, *,
                    s_src: Optional[torch.Tensor] = None):
    """The unnormalised single-sweep parts (num (num_nodes, nh*f),
    den (num_nodes, nh), cap' (), code () int32) over the slots of
    `layout`, differentiable in h_flat, a_src, s_dst and drop_mask: the
    contract of v5_attention.v5_sweep1_parts over layout slots.

    s_dst arrives ALREADY B-shifted, unlike fused_gat_window_v7's;
    drop_mask is (E7, nh) in slot order; code = slot*nh + head is not
    differentiable; `eps` is the caller's epilogue's and is not read
    here. On a hybrid layout the slots hold the in-window edges only;
    the remainder (layout.rem_*) is another op's. s_src: the source-score
    table of the table this op's kernels read, where the caller shares one
    with another op (the hybrid layer's v5 parts op); computed here where
    None. num_src_nodes: the rows of h_flat where they are more than
    num_nodes (a dst-owned shard's layout: its receivers are its own rows,
    its senders index the whole table, and d(h_flat) has the table's
    rows); the layout's offsets cover those rows. A layout without a
    real slot gives zeros, cap' NEG_INF and code 0, launches nothing, and
    its parts are constants with no gradient.
    The contraction dtype (module doc) is read now."""
    _check_layout_shapes(h_flat, s_dst, layout, num_nodes, nh, f,
                         num_src_nodes)
    return _WindowSweep1Parts.apply(h_flat.contiguous(), a_src.contiguous(),
                                    s_dst.contiguous(), drop_mask, layout,
                                    nh, slope, window_rounding(nh, f), s_src)
