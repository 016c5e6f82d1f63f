"""The v4 table attention op: softmax over given edge logits and aggregation.

Counterpart of gat_pytorch_tpu/ops/pallas/segment_attention.py:
fused_segment_attention_table (:506) with its VJP `_fsat_fwd`/`_fsat_bwd`
(:535-590). The kernels are csrc/table_attention.cu (forward:
`_kernel_split`; backward: segment_attention_bwd.py:`_kernel_split`) and
the d(h) reduction of ops/cuda/segment_sum.py. `table_forward_plain` and
`table_backward_plain` are their plain torch versions.

The caller computes the edge logits (any formulation: per-head scores
with a per-destination max subtracted, zeros, or the capped cross-head
scores) and masks padding edges to NEG_INF, whose exp is 0; the real
edges come first, and a caller that knows their number passes it, so
that the padding edges are not walked at all. The op owns the gather of
sender rows, the per-destination denominator (no dropout
mask in it), the dropout-weighted sum and the normalisation
    out = num / (den + eps), 0 where a destination has no real edge,
and is differentiable in the logits, h and the dropout mask. The JAX
op's `eb`, `nb`, `interpret`, `num_src_nodes` and `vma` arguments size
TPU blocks or serve the sharded layout and are not carried.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import segment as seg
from . import build
from .segment_sum import dh_reduce
from .v5_attention import MAX_HEADS

NEG_INF = -1e30          # the logit of a padding edge
_KERNEL = "table_attention"
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.load(_KERNEL)
    if not _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.table_forward.argtypes = [p] * 5 + [i] * 5 + [fl, p, p, i, p]
        lib.table_forward.restype = ctypes.c_int
        lib.table_backward.argtypes = ([p] * 5 + [i] * 6 + [fl] + [p] * 6
                                       + [i, p])
        lib.table_backward.restype = ctypes.c_int
        _configured = True
    return lib


# -- plain versions (CPU tensors) -------------------------------------------

def _inverse(den: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))


def _real(e: int, e_real: int, device) -> torch.Tensor:
    return (torch.arange(e, device=device) < e_real)[:, None]


def table_forward_plain(logits, h, drop, senders, receivers, num_nodes: int,
                        e_real: int, eps: float):
    """(out (num_nodes, D) normalised, den (num_nodes, nh)) over the
    edges e < e_real."""
    e, nh = logits.shape
    d = h.shape[1]
    ex = torch.where(_real(e, e_real, logits.device), torch.exp(logits),
                     torch.zeros_like(logits))
    w = ex if drop is None else ex * drop
    h_e = seg.gather_rows(h, senders)
    num = seg.segment_sum((h_e.view(e, nh, d // nh) * w[:, :, None]
                           ).reshape(e, d), receivers, num_nodes)
    den = seg.segment_sum(ex, receivers, num_nodes)
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
    hg = (seg.gather_rows(h, senders) * g_e).view(e, nh, f).sum(2)
    d_h_rows = ((ex * m * inv_e)[:, :, None] * g_e.view(e, nh, f)
                ).reshape(e, d)
    d_logits = ex * (hg * inv_e * m + d_den.index_select(0, rcv_in))
    d_drop = hg * ex * inv_e if need_drop else None
    return d_h_rows, d_logits, d_drop


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(logits, h, drop, senders, receivers, num_nodes, e_real):
    dev = logits.device
    e = logits.shape[0] if logits.dim() == 2 else -1
    nh = logits.shape[1] if logits.dim() == 2 else -1
    build.require(logits, "logits", dev, torch.float32, (None, None))
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernel takes 1..{MAX_HEADS}")
    build.require(h, "h", dev, torch.float32, (None, None))
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
                        e_real: int, eps: float):
    dev, e, d, nh = _check_inputs(logits, h, drop, senders, receivers,
                                  num_nodes, e_real)
    row_ptr = build.csr_offsets(receivers, num_nodes)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((num_nodes, d), **f32)
    den = torch.empty((num_nodes, nh), **f32)
    p = build.ptr
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.table_forward(
            p(logits), p(h), p(drop), p(senders), p(row_ptr), num_nodes,
            e_real, d, nh, d // nh, eps, p(out), p(den),
            build.grid_blocks(num_nodes), build.stream(dev))
    build.check(err, "table_forward")
    build.LAUNCHES["table_forward"] += 1
    return out, den


def _table_backward_cuda(logits, h, drop, senders, receivers, e_real: int,
                         eps: float, g, out, den, need_drop: bool):
    n = den.shape[0] if den.dim() == 2 else -1
    dev, e, d, nh = _check_inputs(logits, h, drop, senders, receivers, n,
                                  e_real)
    build.require(g, "g", dev, torch.float32, (n, d))
    build.require(out, "out", dev, torch.float32, (n, d))
    build.require(den, "den", dev, torch.float32, (n, nh))
    row_ptr = build.csr_offsets(receivers, n)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h_rows = torch.empty((e, d), **f32)
    d_logits = torch.empty((e, nh), **f32)
    d_drop = torch.empty((e, nh), **f32) if need_drop else None
    p = build.ptr
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.table_backward(
            p(logits), p(h), p(drop), p(senders), p(row_ptr), n, e_real, e,
            d, nh, d // nh, eps, p(g), p(out), p(den), p(d_h_rows),
            p(d_logits), p(d_drop), build.grid_blocks(n), build.stream(dev))
    build.check(err, "table_backward")
    build.LAUNCHES["table_backward"] += 1
    return d_h_rows, d_logits, d_drop


def table_forward(logits, h, drop, senders, receivers, num_nodes: int,
                  e_real: int, eps: float):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if logits.is_cuda:
        return _table_forward_cuda(logits, h, drop, senders, receivers,
                                   num_nodes, e_real, eps)
    if logits.device.type == "cpu":
        return table_forward_plain(logits, h, drop, senders, receivers,
                                   num_nodes, e_real, eps)
    raise ValueError(f"no kernel for device {logits.device}")


def table_backward(logits, h, drop, senders, receivers, e_real: int,
                   eps: float, g, out, den, need_drop: bool):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if logits.is_cuda:
        return _table_backward_cuda(logits, h, drop, senders, receivers,
                                    e_real, eps, g, out, den, need_drop)
    if logits.device.type == "cpu":
        return table_backward_plain(logits, h, drop, senders, receivers,
                                    e_real, eps, g, out, den, need_drop)
    raise ValueError(f"no kernel for device {logits.device}")


# -- the differentiable op ----------------------------------------------------

class _TableAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, h_flat, drop_mask, senders, receivers,
                src_order, num_nodes, e_real, eps):
        out, den = table_forward(logits, h_flat, drop_mask, senders,
                                 receivers, num_nodes, e_real, eps)
        ctx.save_for_backward(logits, h_flat, drop_mask, senders, receivers,
                              src_order, den, out)
        ctx.e_real, ctx.eps = e_real, eps
        return out

    @staticmethod
    def backward(ctx, g):
        (logits, h_flat, drop_mask, senders, receivers, src_order, den,
         out) = ctx.saved_tensors
        need_drop = drop_mask is not None and ctx.needs_input_grad[2]
        d_h_rows, d_logits, d_drop = table_backward(
            logits, h_flat, drop_mask, senders, receivers, ctx.e_real,
            ctx.eps, g.contiguous(), out, den, need_drop)
        if src_order is None:
            # a stable sort of the real edges keeps the order of the sums
            # fixed; the padding edges' rows are zero and stay out
            src_order = torch.argsort(senders[:ctx.e_real],
                                      stable=True).to(torch.int32)
        d_h = dh_reduce(d_h_rows, src_order, senders, h_flat.shape[0],
                        ctx.e_real)
        return (d_logits, d_h, d_drop) + (None,) * 6


def fused_segment_attention_table(logits: torch.Tensor,
                                  h_flat: torch.Tensor,
                                  senders: torch.Tensor,
                                  receivers: torch.Tensor,
                                  drop_mask: Optional[torch.Tensor],
                                  src_order: Optional[torch.Tensor],
                                  num_nodes: int, nh: int, f: int,
                                  eps: float = 1e-8,
                                  num_real_edges: Optional[int] = None
                                  ) -> torch.Tensor:
    """Normalised attention output (num_nodes, nh*f) from given edge
    logits, differentiable in logits, h_flat and drop_mask.

    logits (E, nh) float32 over the dst-sorted edges, NEG_INF on padding
    edges; h_flat (N, nh*f) node features; senders, receivers (E,) int32;
    drop_mask (E, nh) attention-dropout multipliers or None.
    src_order: the stable permutation sorting the edges by sender, which
    the backward's d(h) reduction reads through; with None the backward
    derives it with a stable sort, so the sums keep a fixed order either
    way.
    num_real_edges: the edges from there on are padding (NEG_INF logits,
    the last node as sender, as canonicalize pads) and are not walked;
    None walks every edge, which gives the same result more slowly."""
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
                                 num_nodes, e_real, eps)
