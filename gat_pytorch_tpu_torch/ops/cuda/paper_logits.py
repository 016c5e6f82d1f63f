"""The paper form's edge logits: one op for the table path's logits and
their per-destination max.

In the GAT paper's attention (arXiv:1710.10903 eqs. 1-3, the port's
`paper_faithful` form) each head k has its own a = [a_l || a_r], so an
edge j -> i has the logit LeakyReLU(s_src[j,k] + s_dst[i,k]) with the
per-head scores s_src = a_l . h_j and s_dst = a_r . h_i. The table op
(table_attention.py) takes them with each destination's max subtracted
and the padding edges at NEG_INF:

    z[e,k]      = s_src[j,k] + s_dst[i,k]
    l[e,k]      = mask[e] ? LeakyReLU_slope(z[e,k]) : NEG_INF
    mx[i,k]     = max over i's edges of l, 0 where that is not finite
    logits[e,k] = mask[e] ? l[e,k] - mx[i,k] : NEG_INF

The max is detached (the softmax after it is invariant to it), so the
backward is d_z = mask ? (z > 0 ? g : g * slope) : 0 (torch's
leaky_relu gradient: the slope at 0), summed by sender into d(s_src) and
by destination into d(s_dst) by the sorted segment sum
(segment_sum.py), in the order the sorted-gradient gathers' backwards
sum them (ops/segment.py sorted_gather_grad).

The JAX package forms these logits in XLA, so the op replaces no TPU
kernel. `paper_logits_plain` is the torch chain that formed them in the
model before (models/gat.py): the sorted-gradient gathers of the two
score tables, leaky_relu, the segment max and a third gather; through
torch's autograd it is also the op's function with its backward.
On CUDA tensors the kernels of csrc/paper_logits.cu run instead: a
forward by destination, and a map over the edges for d_z. Each is one
float32 operation at a time in the chain's order, so the logits, d_z
and hence d(s_src) and d(s_dst) carry the chain's bits. On CPU tensors
the op runs the chain's forward and `paper_logits_backward_plain`, whose
d_z is the chain's gradient, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.profiling import op_spans
from .. import segment as seg
from . import build
from .v5_attention import MAX_HEADS, NEG_INF, align_of

_KERNEL = "paper_logits"
_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    if _KERNEL not in _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paper_logits_forward.argtypes = [p] * 5 + [i] * 3 + [fl, p, p]
        lib.paper_logits_forward.restype = ctypes.c_int
        lib.paper_logits_backward.argtypes = ([p] * 6 + [i] * 2
                                              + [fl, i, p, p])
        lib.paper_logits_backward.restype = ctypes.c_int
        _configured.add(_KERNEL)
    return lib


# -- plain versions ------------------------------------------------------------

def paper_logits_plain(s_src, s_dst, senders, receivers, edge_mask,
                       num_nodes: int, slope: float,
                       num_real_edges: Optional[int] = None, *, src_order,
                       src_ptr=None, dst_ptr=None) -> torch.Tensor:
    """The (E, NH) logits by the torch chain, differentiable in s_src and
    s_dst through torch's autograd (the score gathers' backwards are the
    sorted segment sums); on either device. src_order: the stable
    permutation sorting the edges by sender; src_ptr, dst_ptr and
    num_real_edges go to the gathers' backwards (the padding edges'
    cotangent is zero, so the sums skip them)."""
    logits = (seg.gather_rows_sorted_grad(s_src, senders, num_nodes,
                                          src_order, ptr=src_ptr)
              + seg.gather_rows_sorted_grad(s_dst, receivers, num_nodes,
                                            ptr=dst_ptr,
                                            num_real=num_real_edges))
    # torch's LeakyReLU gradient at exactly 0 is the slope
    logits = F.leaky_relu(logits, slope)
    pad = torch.full_like(logits, NEG_INF)
    logits = torch.where(edge_mask[:, None], logits, pad)
    seg_max = seg.segment_max(logits, receivers, num_nodes).detach()
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    return torch.where(edge_mask[:, None],
                       logits - seg.gather_rows(seg_max, receivers), pad)


def paper_logits_backward_plain(g, s_src, s_dst, senders, receivers,
                                edge_mask, slope: float) -> torch.Tensor:
    """d_z (E, NH): the chain's gradient at z = s_src[j] + s_dst[i], by
    the operation torch's autograd takes for it (leaky_relu_backward),
    zero on the padding edges."""
    z = (seg.gather_rows(s_src, senders)
         + seg.gather_rows(s_dst, receivers))
    g = torch.where(edge_mask[:, None], g, 0.0)
    return torch.ops.aten.leaky_relu_backward(g, z, slope, False)


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(s_src, s_dst, senders, receivers, edge_mask):
    dev = s_src.device
    n, nh = s_src.shape if s_src.dim() == 2 else (-1, -1)
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernels take 1..{MAX_HEADS}")
    build.require(s_src, "s_src", dev, torch.float32, (n, nh))
    build.require(s_dst, "s_dst", dev, torch.float32, (n, nh))
    e = senders.shape[0] if senders.dim() == 1 else -1
    build.require(senders, "senders", dev, torch.int32, (e,))
    build.require(receivers, "receivers", dev, torch.int32, (e,))
    build.require(edge_mask, "edge_mask", dev, torch.bool, (e,))
    return dev, n, e, nh


def _forward_cuda(s_src, s_dst, senders, receivers, edge_mask,
                  num_nodes: int, slope: float, dst_ptr=None):
    dev, n, e, nh = _check_inputs(s_src, s_dst, senders, receivers,
                                  edge_mask)
    if num_nodes != n:
        raise ValueError(f"s_src has {n} rows, not num_nodes={num_nodes}")
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    logits = torch.empty((e, nh), dtype=torch.float32, device=dev)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().paper_logits_forward(
            p(s_src), p(s_dst), p(senders), p(edge_mask), p(row_ptr), n, e,
            nh, slope, p(logits), build.stream(dev))
    build.check(err, "paper_logits_forward")
    build.LAUNCHES["paper_logits_forward"] += 1
    return logits


def _backward_cuda(g, s_src, s_dst, senders, receivers, edge_mask,
                   slope: float):
    dev, _, e, nh = _check_inputs(s_src, s_dst, senders, receivers,
                                  edge_mask)
    build.require(g, "g", dev, torch.float32, (e, nh))
    d_z = torch.empty((e, nh), dtype=torch.float32, device=dev)
    vec4 = nh % 4 == 0 and min(align_of(g), align_of(d_z)) == 4
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().paper_logits_backward(
            p(g), p(s_src), p(s_dst), p(senders), p(receivers), p(edge_mask),
            e, nh, slope, int(vec4), p(d_z), build.stream(dev))
    build.check(err, "paper_logits_backward")
    build.LAUNCHES["paper_logits_backward"] += 1
    return d_z


def paper_logits_forward(s_src, s_dst, senders, receivers, edge_mask,
                         num_nodes: int, slope: float,
                         num_real_edges: Optional[int] = None, *, src_order,
                         src_ptr=None, dst_ptr=None) -> torch.Tensor:
    """The logits (E, NH): the kernel on CUDA tensors (dst_ptr, the
    receivers' offsets, computed where not given), the plain chain on CPU
    tensors."""
    if s_src.is_cuda:
        return _forward_cuda(s_src, s_dst, senders, receivers, edge_mask,
                             num_nodes, slope, dst_ptr)
    build.require_cpu(s_src)
    return paper_logits_plain(s_src, s_dst, senders, receivers, edge_mask,
                              num_nodes, slope, num_real_edges,
                              src_order=src_order, src_ptr=src_ptr,
                              dst_ptr=dst_ptr)


def paper_logits_backward(g, s_src, s_dst, senders, receivers, edge_mask,
                          slope: float) -> torch.Tensor:
    """d_z (E, NH): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if s_src.is_cuda:
        return _backward_cuda(g, s_src, s_dst, senders, receivers, edge_mask,
                              slope)
    build.require_cpu(s_src)
    return paper_logits_backward_plain(g, s_src, s_dst, senders, receivers,
                                       edge_mask, slope)


# -- the differentiable op ----------------------------------------------------

@op_spans("paper_logits")
class _PaperLogits(torch.autograd.Function):

    @staticmethod
    def forward(ctx, s_src, s_dst, senders, receivers, edge_mask, src_order,
                src_ptr, dst_ptr, num_nodes, num_real, slope):
        logits = paper_logits_forward(
            s_src, s_dst, senders, receivers, edge_mask, num_nodes, slope,
            num_real, src_order=src_order, src_ptr=src_ptr, dst_ptr=dst_ptr)
        ctx.save_for_backward(s_src, s_dst, senders, receivers, edge_mask,
                              src_order, src_ptr, dst_ptr)
        ctx.num_nodes, ctx.num_real, ctx.slope = num_nodes, num_real, slope
        return logits

    @staticmethod
    def backward(ctx, g):
        (s_src, s_dst, senders, receivers, edge_mask, src_order, src_ptr,
         dst_ptr) = ctx.saved_tensors
        d_z = paper_logits_backward(g.contiguous(), s_src, s_dst, senders,
                                    receivers, edge_mask, ctx.slope)
        n = ctx.num_nodes
        # the two sorted segment sums of the score gathers' backwards
        return ((seg.sorted_gather_grad(d_z, senders, n, src_order, src_ptr),
                 seg.sorted_gather_grad(d_z, receivers, n, None, dst_ptr,
                                        ctx.num_real))
                + (None,) * 9)


def paper_logits(s_src: torch.Tensor, s_dst: torch.Tensor,
                 senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor, num_nodes: int, slope: float = 0.2,
                 num_real_edges: Optional[int] = None, *,
                 src_order: torch.Tensor,
                 src_ptr: Optional[torch.Tensor] = None,
                 dst_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The table op's (E, NH) logits from the per-head scores (module
    doc), differentiable in s_src and s_dst.

    s_src, s_dst (num_nodes, NH) float32; senders, receivers (E,) int32,
    the dst-sorted edges; edge_mask (E,) bool, the real edges (the first
    num_real_edges of them where that is given). src_order: the stable
    permutation sorting the edges by sender (Graph.src_order), in whose
    order d(s_src) is summed; src_ptr, dst_ptr (Graph.src_ptr,
    Graph.dst_ptr): the CSR offsets that spare the sums (and the forward
    kernel) deriving them."""
    e = senders.shape[0]
    if s_src.shape != s_dst.shape or s_src.shape[0] != num_nodes:
        raise ValueError(f"shapes s_src {tuple(s_src.shape)}, s_dst "
                         f"{tuple(s_dst.shape)} do not match num_nodes="
                         f"{num_nodes}")
    if num_real_edges is not None and not 0 <= num_real_edges <= e:
        raise ValueError(f"num_real_edges {num_real_edges} outside "
                         f"[0, {e}]")
    return _PaperLogits.apply(s_src.contiguous(), s_dst.contiguous(),
                              senders, receivers, edge_mask, src_order,
                              src_ptr, dst_ptr, num_nodes, num_real_edges,
                              slope)
