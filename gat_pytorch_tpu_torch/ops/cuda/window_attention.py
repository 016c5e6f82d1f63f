"""The windowed whole-attention op over a block layout.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention_window.py:
fused_gat_window_v7 (:1771) with its VJP `_fgw7_fwd`/`_fgw7_bwd`
(:1803-1927), in the single-sweep (v10) mode and the float32 contraction
mode. The kernels are csrc/window_attention.cu (forward: `_kernel_v6`;
backward: `_kernel_v6_bwd`) and the d(h) reduction of
ops/cuda/segment_sum.py. `window_forward_plain` and
`window_backward_plain` are their plain torch versions.

It computes the function of ops/cuda/v5_attention.py (see its module doc
for the algebra) over the slots of a graph.BlockLayout instead of the
dst-sorted edge list: a pad slot (recv == -1) adds nothing; the dropout
mask and its cotangent are (E7, nh) in slot order; the argmax code of the
cap is the lowest slot*nh + head. The layout's `window`, `wb`, `base`,
`tile_base`, `tile_ptr` and `dmax` size the TPU kernel's streamed windows;
the CUDA kernels gather rows directly and walk the slots through the
layout's `dst_perm`/`dst_ptr` and `src_perm`/`src_ptr` instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...graph.graph import BlockLayout
from . import build
from .segment_sum import dh_reduce_ptr
from .v5_attention import (MAX_HEADS, attention_backward_plain,
                           attention_forward_plain, normalise,
                           route_cap_cotangent)

_KERNEL = "window_attention"
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.load(_KERNEL)
    if not _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.window_forward.argtypes = ([p] * 7 + [i] * 4 + [fl] + [p] * 6
                                       + [i, p])
        lib.window_forward.restype = ctypes.c_int
        lib.window_backward.argtypes = ([p] * 7 + [i] * 5 + [fl] + [p] * 9
                                        + [i, p])
        lib.window_backward.restype = ctypes.c_int
        _configured = True
    return lib


# -- plain versions (CPU tensors) -------------------------------------------

def _slots(layout: BlockLayout, n: int):
    """(send, recv with pad slots sent to n, valid (E7, 1)) as int64."""
    recv = layout.recv.long()
    valid = recv >= 0
    return (layout.send.long(), torch.where(valid, recv, n),
            valid[:, None])


def window_forward_plain(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                         slope: float):
    """(num (N, D), den (N, nh), cap' (), code () int32)."""
    return attention_forward_plain(
        h, a_src, s_dst_eff, drop, *_slots(layout, s_dst_eff.shape[0]),
        slope)


def window_backward_plain(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                          slope: float, g, out, den, epsp, need_drop: bool):
    """(d_h rows (E7, D) in slot order, 0 on pad slots, d_drop (E7, nh) |
    None, d_s_dst (N, nh), d_a_src (D, nh)) before the cap chain."""
    return attention_backward_plain(
        h, a_src, s_dst_eff, drop, *_slots(layout, s_dst_eff.shape[0]),
        slope, g, out, den, epsp, need_drop)


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(h, a_src, s_dst_eff, drop, layout: BlockLayout):
    dev = h.device
    d = h.shape[1] if h.dim() == 2 else -1
    nh = a_src.shape[1] if a_src.dim() == 2 else -1
    build.require(h, "h", dev, torch.float32, (None, None))
    build.require(a_src, "a_src", dev, torch.float32, (d, None))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    if not 1 <= d <= 1024 or d % nh:
        raise ValueError(f"row width {d} must be nh*f and at most 1024")
    n = h.shape[0]
    build.require(s_dst_eff, "s_dst", dev, torch.float32, (n, nh))
    e7 = layout.num_slots
    build.require(layout.send, "layout.send", dev, torch.int32, (e7,))
    build.require(layout.dst_perm, "layout.dst_perm", dev, torch.int32,
                  (e7,))
    build.require(layout.dst_ptr, "layout.dst_ptr", dev, torch.int32,
                  (n + 1,))
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e7, nh))
    return dev, n, e7, d, nh


def _window_forward_cuda(h, a_src, s_dst_eff, drop, layout, slope: float):
    dev, n, e7, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, layout)
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
        err = lib.window_forward(
            p(h), p(a_src), p(s_dst_eff), p(drop), p(layout.send),
            p(layout.dst_perm), p(layout.dst_ptr), n, d, nh, d // nh, slope,
            p(num), p(den), p(blk_max), p(blk_code), p(cap), p(code),
            nblk, build.stream(dev))
    build.check(err, "window_forward")
    build.LAUNCHES["window_forward"] += 1
    return num, den, cap, code


def _window_backward_cuda(h, a_src, s_dst_eff, drop, layout, slope: float,
                          g, out, den, epsp, need_drop: bool):
    dev, n, e7, d, nh = _check_inputs(h, a_src, s_dst_eff, drop, layout)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(out, "out", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    build.require(epsp, "epsp", dev, torch.float32, ())
    nblk = build.grid_blocks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h_rows = torch.empty((e7, d), **f32)
    d_drop = torch.empty((e7, nh), **f32) if need_drop else None
    d_sdst = torch.empty((n, nh), **f32)
    part = torch.empty((nblk, d * nh), **f32)
    d_asrc = torch.empty((d, nh), **f32)
    p = build.ptr
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.window_backward(
            p(h), p(a_src), p(s_dst_eff), p(drop), p(layout.send),
            p(layout.dst_perm), p(layout.dst_ptr), n, e7, d, nh, d // nh,
            slope, p(g), p(out), p(den), p(epsp), p(d_h_rows), p(d_drop),
            p(d_sdst), p(part), p(d_asrc), nblk, build.stream(dev))
    build.check(err, "window_backward")
    build.LAUNCHES["window_backward"] += 1
    return d_h_rows, d_drop, d_sdst, d_asrc


def window_forward(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                   slope: float):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if h.is_cuda:
        return _window_forward_cuda(h, a_src, s_dst_eff, drop, layout, slope)
    if h.device.type == "cpu":
        return window_forward_plain(h, a_src, s_dst_eff, drop, layout, slope)
    raise ValueError(f"no kernel for device {h.device}")


def window_backward(h, a_src, s_dst_eff, drop, layout: BlockLayout,
                    slope: float, g, out, den, epsp, need_drop: bool):
    """Kernel on CUDA tensors (the d(h) rows of pad slots are left
    unwritten there), plain version on CPU tensors."""
    if h.is_cuda:
        return _window_backward_cuda(h, a_src, s_dst_eff, drop, layout,
                                     slope, g, out, den, epsp, need_drop)
    if h.device.type == "cpu":
        return window_backward_plain(h, a_src, s_dst_eff, drop, layout,
                                     slope, g, out, den, epsp, need_drop)
    raise ValueError(f"no kernel for device {h.device}")


# -- the differentiable op ----------------------------------------------------

class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, a_src, s_dst, drop_mask, layout, bound, nh,
                eps, slope):
        s_dst_eff = (s_dst - bound).contiguous()
        num, den, cap, code = window_forward(h_flat, a_src, s_dst_eff,
                                             drop_mask, layout, slope)
        out, epsp = normalise(num, den, cap, eps, slope, nh)
        ctx.save_for_backward(h_flat, a_src, s_dst_eff, drop_mask, den, out,
                              epsp, code)
        ctx.layout, ctx.nh, ctx.slope = layout, nh, slope
        return out

    @staticmethod
    def backward(ctx, g):
        (h_flat, a_src, s_dst_eff, drop_mask, den, out, epsp,
         code) = ctx.saved_tensors
        layout, nh, slope = ctx.layout, ctx.nh, ctx.slope
        g = g.contiguous()
        need_drop = drop_mask is not None and ctx.needs_input_grad[3]
        d_h_rows, d_drop, d_sdst, d_asrc = window_backward(
            h_flat, a_src, s_dst_eff, drop_mask, layout, slope, g, out, den,
            epsp, need_drop)
        d_h = dh_reduce_ptr(d_h_rows, layout.src_perm, layout.src_ptr)
        d_h, d_asrc, d_sdst = route_cap_cotangent(
            d_h, d_asrc, d_sdst, code, layout.send, layout.recv, h_flat,
            a_src, g, out, den, epsp, slope, nh)
        return (d_h, d_asrc, d_sdst, d_drop) + (None,) * 5


def fused_gat_window_v7(h_flat: torch.Tensor,
                        a_src: torch.Tensor,
                        s_dst: torch.Tensor,
                        drop_mask: Optional[torch.Tensor],
                        layout: BlockLayout,
                        score_bound: Optional[torch.Tensor],
                        num_nodes: int, nh: int, f: int,
                        eps: float = 1e-8,
                        slope: float = 0.01) -> torch.Tensor:
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
    None computes it from the score tables."""
    if (h_flat.shape != (num_nodes, nh * f)
            or s_dst.shape != (num_nodes, nh)
            or layout.dst_ptr.shape[0] != num_nodes + 1):
        raise ValueError(f"shapes h {tuple(h_flat.shape)}, s_dst "
                         f"{tuple(s_dst.shape)}, layout over "
                         f"{layout.dst_ptr.shape[0] - 1} nodes do not match "
                         f"num_nodes={num_nodes}, nh={nh}, f={f}")
    if score_bound is None:
        score_bound = (h_flat @ a_src).max() + s_dst.max()
    return _WindowAttention.apply(h_flat.contiguous(), a_src.contiguous(),
                                  s_dst, drop_mask, layout,
                                  score_bound.detach(), nh, eps, slope)
