"""The GATv2 attention op: dynamic attention (Brody, Alon and Yahav, How
Attentive are Graph Attention Networks?, ICLR 2022, arXiv:2105.14491),
the layer of PyG's and DGL's GATv2Conv with share_weights=False.

Per head k, for an edge j -> i of the dst-sorted edges (self-loops
included), from the sender-side transform xl = x @ W_l and the
destination-side one xr = x @ W_r, (N, NH*F) each, and a (NH, F):

    z_ij,k  = xl_j,k + xr_i,k
    e_ij,k  = a_k . LeakyReLU(z_ij,k)
    p_ij,k  = softmax over i's in-edges of e_ij,k (the maximum subtracted)
    out_i,k = sum_j m_ij,k p_ij,k xl_j,k      m: attention dropout

The nonlinearity sits inside the dot with a, so the logit does not split
into per-node scores: the op computes it from the xl_j row that its
weighted sum loads. The JAX package has no such layer, so the op replaces
no TPU kernel. Its kernels are csrc/gatv2_attention.cu: the forward by
destination (`gatv2_forward`: out, and each destination's max and
denominator for the backward) and the backward (`gatv2_backward`: a pass
by destination that writes de and m p (E, NH) and d(xr), a pass by sender
over build.sender_items that writes d(xl) and the d(a) partial rows, and
a tail); the passes by destination take the destinations by descending
degree (`destination_order`). No tensor of shape (E, NH*F) is made on the card, and no sum
uses float atomics, so a step gives the same bits every time.
`gatv2_forward_plain` and `gatv2_backward_plain` are the plain torch
versions of the op's function (on CPU tensors, in any float dtype).

LeakyReLU's derivative at 0 is its slope, as torch's leaky_relu gives it.
The dropout multipliers take no gradient (the model draws them without
one). Padding edges (from num_real_edges on) are not read; a destination
without a real edge has a zero output row. Float32 only on the card: the
JAX package's bfloat16 knobs have no counterpart here (the model refuses
them with this op).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...utils.profiling import count, op_spans
from . import build
from .build import sender_runs
from .v5_attention import MAX_HEADS, align_of

_KERNEL = "gatv2_attention"
# blocks of the backward's pass by sender: one wave of eight blocks of 256
# threads on each of the H100's 132 SMs; fixed, as the d(a) partial rows
# are summed in block order
SENDER_BLOCKS = 1056
_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    if _KERNEL not in _configured:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gatv2_forward.argtypes = ([p] * 7 + [i] * 8 + [fl] + [p] * 4)
        lib.gatv2_forward.restype = ctypes.c_int
        lib.gatv2_backward.argtypes = ([p] * 10 + [i] * 10 + [fl] + [p] * 11
                                       + [i, p])
        lib.gatv2_backward.restype = ctypes.c_int
        _configured.add(_KERNEL)
    return lib


class Plan(NamedTuple):
    """The kernels' split of a head of f features over a warp: vectors of
    `vec` elements, `per_lane` of them a lane, teams of `lanes` lanes."""
    vec: int
    per_lane: int
    lanes: int


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def plan(f: int, align: int = 4) -> Plan:
    """The widest vector (of at most `align` elements) that divides f, the
    fewest lanes (a power of two, at most 32) that give each a vector of
    the head, and where 32 lanes do not cover it, the vectors a lane
    holds (a power of two). At most 8 elements a lane: f <= 256."""
    vec = next(v for v in (4, 2, 1) if v <= align and f % v == 0)
    nvec = -(-f // vec)
    lanes = min(32, _pow2(nvec))
    per_lane = _pow2(-(-nvec // lanes))
    if vec * per_lane > 8:
        raise ValueError(f"heads of {f} features: the kernels take at most "
                         f"256")
    return Plan(vec, per_lane, lanes)


# -- the order of the destinations ------------------------------------------
#
# The destination kernels give block b the destination order[b], the
# destinations by descending count of real edges: a hub's walk starts with
# the launch and runs beside the other blocks. In the order of the ids it
# started wherever the graph's labels put the hub and, late, ran on after
# every other block had ended, so that a step's time moved with the
# labelling. Each destination's sums are the same in any order.

def destination_order(row_ptr: torch.Tensor, e_real: int,
                      owner: Optional[torch.Tensor] = None,
                      key: tuple = ()) -> torch.Tensor:
    """(n,) int32 on row_ptr's device: the n destinations of the offsets
    row_ptr (n + 1,) by descending count of the real edges (those before
    e_real), ties in id order. owner: a tensor held across calls (a
    graph's) whose contents, with `key`, fix the offsets; the order is
    then made once and kept while the owner lives (build.kept)."""
    def make():
        deg = torch.diff(torch.clamp(row_ptr.long(), max=e_real))
        return torch.argsort(-deg, stable=True).to(torch.int32)

    return build.kept(owner, ("destination_order",) + tuple(key), make)


def _order_of(row_ptr, receivers, e_real: int, dst_ptr):
    """destination_order, kept with the caller's offsets or with the
    receivers they were derived from."""
    if dst_ptr is not None:
        return destination_order(row_ptr, e_real, dst_ptr, (e_real,))
    return destination_order(row_ptr, e_real, receivers,
                             (e_real, row_ptr.shape[0]))


# -- plain versions (CPU tensors) -------------------------------------------

def _edge_terms(xl, xr, a, senders, receivers, e_real: int, slope: float):
    """(s, r, xl_e (E_real, NH, F), z, logits (E_real, NH)) of the real
    edges."""
    nh, f = a.shape
    s, r = senders[:e_real].long(), receivers[:e_real].long()
    xl_e = xl.view(-1, nh, f).index_select(0, s)
    z = xl_e + xr.view(-1, nh, f).index_select(0, r)
    return s, r, xl_e, z, (F.leaky_relu(z, slope) * a).sum(-1)


def gatv2_forward_plain(xl, xr, a, drop, senders, receivers, num_nodes: int,
                        e_real: int, slope: float):
    """(out (num_nodes, NH*F), mx, den (num_nodes, NH)): mx each
    destination's largest logit, den the sum of exp(logit - mx); 0 where
    a destination has no real edge."""
    nh, f = a.shape
    s, r, xl_e, _, logits = _edge_terms(xl, xr, a, senders, receivers,
                                        e_real, slope)
    idx = r[:, None].expand(-1, nh)
    mx = logits.new_full((num_nodes, nh), float("-inf")).scatter_reduce(
        0, idx, logits, "amax")
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(logits - mx.index_select(0, r))
    den = logits.new_zeros((num_nodes, nh)).index_add(0, r, ex)
    p = ex / den.index_select(0, r)
    w = p if drop is None else p * drop[:e_real]
    out = xl.new_zeros((num_nodes, nh, f)).index_add(0, r,
                                                     xl_e * w[:, :, None])
    return out.reshape(num_nodes, nh * f), mx, den


def gatv2_backward_plain(xl, xr, a, drop, senders, receivers, e_real: int,
                         slope: float, g, out, mx, den):
    """(d_xl, d_xr (N, NH*F), d_a (NH, F)) of the op's output cotangent
    g, from the forward's out, mx and den (the module doc's function)."""
    nh, f = a.shape
    n = g.shape[0]
    s, r, xl_e, z, logits = _edge_terms(xl, xr, a, senders, receivers,
                                        e_real, slope)
    p = torch.exp(logits - mx.index_select(0, r)) / den.index_select(0, r)
    m = torch.ones_like(p) if drop is None else drop[:e_real]
    gv = g.view(n, nh, f)
    g_e = gv.index_select(0, r)
    go = (gv * out.view(n, nh, f)).sum(-1)
    de = p * (m * (g_e * xl_e).sum(-1) - go.index_select(0, r))
    t = de[:, :, None] * a * torch.where(z > 0, torch.ones_like(z),
                                          torch.full_like(z, slope))
    d_xl = xl.new_zeros((xl.shape[0], nh, f)).index_add(
        0, s, (m * p)[:, :, None] * g_e + t)
    d_xr = xr.new_zeros((xr.shape[0], nh, f)).index_add(0, r, t)
    d_a = (de[:, :, None] * F.leaky_relu(z, slope)).sum(0)
    return (d_xl.reshape(xl.shape), d_xr.reshape(xr.shape), d_a)


# -- kernel wrappers (CUDA tensors) -----------------------------------------

def _check_inputs(xl, xr, a, drop, senders, receivers, e_real: int):
    dev = xl.device
    nh, f = a.shape if a.dim() == 2 else (-1, -1)
    if not 1 <= nh <= MAX_HEADS:
        raise ValueError(f"{nh} heads: the kernels take 1..{MAX_HEADS}")
    build.require(a, "a", dev, torch.float32, (nh, f))
    build.require(xl, "xl", dev, torch.float32, (None, nh * f))
    n = xl.shape[0]
    build.require(xr, "xr", dev, torch.float32, (n, nh * f))
    e = senders.shape[0] if senders.dim() == 1 else -1
    build.require(senders, "senders", dev, torch.int32, (e,))
    build.require(receivers, "receivers", dev, torch.int32, (e,))
    if drop is not None:
        build.require(drop, "drop_mask", dev, torch.float32, (e, nh))
    if not 0 <= e_real <= e:
        raise ValueError(f"e_real {e_real} outside [0, {e}]")
    return dev, n, e, nh, f


def _plan_of(f: int, *tables) -> Plan:
    return plan(f, min(align_of(t) for t in tables))


def _forward_cuda(xl, xr, a, drop, senders, receivers, num_nodes: int,
                  e_real: int, slope: float, dst_ptr=None):
    dev, n, _, nh, f = _check_inputs(xl, xr, a, drop, senders, receivers,
                                     e_real)
    if num_nodes != n:
        raise ValueError(f"xl has {n} rows, not num_nodes={num_nodes}")
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    order = _order_of(row_ptr, receivers, e_real, dst_ptr)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((n, nh * f), **f32)
    mx = torch.empty((n, nh), **f32)
    den = torch.empty((n, nh), **f32)
    pl = _plan_of(f, xl, xr, a, out)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().gatv2_forward(
            p(xl), p(xr), p(a), p(drop), p(senders), p(row_ptr), p(order), n,
            e_real, nh * f, nh, f, *pl, slope, p(out), p(mx), p(den),
            build.stream(dev))
    build.check(err, "gatv2_forward")
    build.LAUNCHES["gatv2_forward"] += 1
    return out, mx, den


def _backward_cuda(xl, xr, a, drop, senders, receivers, e_real: int,
                   slope: float, g, out, mx, den, dst_ptr=None,
                   src_order=None, src_ptr=None):
    dev, n, e, nh, f = _check_inputs(xl, xr, a, drop, senders, receivers,
                                     e_real)
    d = nh * f
    for name, t in (("g", g), ("out", out)):
        build.require(t, name, dev, torch.float32, (n, d))
    for name, t in (("mx", mx), ("den", den)):
        build.require(t, name, dev, torch.float32, (n, nh))
    f32 = dict(dtype=torch.float32, device=dev)
    if e_real == 0:
        return (torch.zeros((n, d), **f32), torch.zeros((n, d), **f32),
                torch.zeros((nh, f), **f32))
    row_ptr = build.row_offsets(receivers, n, dst_ptr)
    dst_order = _order_of(row_ptr, receivers, e_real, dst_ptr)
    order, ptr = sender_runs(senders, e_real, n, src_order, src_ptr)
    # the table is kept with the caller's runs, or with the senders the
    # runs were derived from
    given = src_order is not None and src_ptr is not None
    items = build.sender_items(ptr, SENDER_BLOCKS,
                               src_ptr if given else senders,
                               () if given else (e_real, n))
    count("gatv2_bwd_slots", items.slots)
    count("gatv2_bwd_split_slots", items.split_slots)
    d_xl = torch.empty((n, d), **f32)
    d_xr = torch.empty((n, d), **f32)
    d_a = torch.empty((nh, f), **f32)
    de = torch.empty((e, nh), **f32)
    w = torch.empty((e, nh), **f32)
    dh_part = (torch.empty((items.n_parts, d), **f32) if items.n_split
               else None)
    da_part = torch.empty((SENDER_BLOCKS, d), **f32)
    pl = _plan_of(f, xl, xr, a, g, out, d_xl, d_xr, da_part)
    p = build.ptr
    with torch.cuda.device(dev):
        err = _lib().gatv2_backward(
            p(xl), p(xr), p(a), p(drop), p(senders), p(receivers),
            p(row_ptr), p(dst_order), p(order), p(items.table),
            items.n_items, items.n_split, n, e_real, d, nh, f, *pl, slope,
            p(g), p(out),
            p(mx), p(den), p(d_xl), p(d_xr), p(d_a), p(de), p(w),
            p(dh_part), p(da_part), SENDER_BLOCKS, build.stream(dev))
    build.check(err, "gatv2_backward")
    build.LAUNCHES["gatv2_backward"] += 1
    return d_xl, d_xr, d_a


def gatv2_forward(xl, xr, a, drop, senders, receivers, num_nodes: int,
                  e_real: int, slope: float, *, dst_ptr=None):
    """(out, mx, den): the kernel on CUDA tensors, the plain version on
    CPU tensors. dst_ptr: the (num_nodes + 1,) int32 offsets of the
    receivers (Graph.dst_ptr), computed where not given."""
    if xl.is_cuda:
        return _forward_cuda(xl, xr, a, drop, senders, receivers, num_nodes,
                             e_real, slope, dst_ptr)
    build.require_cpu(xl)
    return gatv2_forward_plain(xl, xr, a, drop, senders, receivers,
                               num_nodes, e_real, slope)


def gatv2_backward(xl, xr, a, drop, senders, receivers, e_real: int,
                   slope: float, g, out, mx, den, *, dst_ptr=None,
                   src_order=None, src_ptr=None):
    """(d_xl, d_xr, d_a): the kernels on CUDA tensors (the pass by sender
    over sender_runs(senders, e_real, N, src_order, src_ptr)), the plain
    version on CPU tensors."""
    if xl.is_cuda:
        return _backward_cuda(xl, xr, a, drop, senders, receivers, e_real,
                              slope, g, out, mx, den, dst_ptr, src_order,
                              src_ptr)
    build.require_cpu(xl)
    return gatv2_backward_plain(xl, xr, a, drop, senders, receivers, e_real,
                                slope, g, out, mx, den)


# -- the differentiable op ----------------------------------------------------

@op_spans("gatv2_attention")
class _Gatv2Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xl, xr, a, drop_mask, senders, receivers, src_order,
                src_ptr, dst_ptr, num_nodes, e_real, slope):
        out, mx, den = gatv2_forward(xl, xr, a, drop_mask, senders,
                                     receivers, num_nodes, e_real, slope,
                                     dst_ptr=dst_ptr)
        ctx.save_for_backward(xl, xr, a, drop_mask, senders, receivers,
                              src_order, src_ptr, dst_ptr, out, mx, den)
        ctx.e_real, ctx.slope = e_real, slope
        return out

    @staticmethod
    def backward(ctx, g):
        (xl, xr, a, drop_mask, senders, receivers, src_order, src_ptr,
         dst_ptr, out, mx, den) = ctx.saved_tensors
        d_xl, d_xr, d_a = gatv2_backward(
            xl, xr, a, drop_mask, senders, receivers, ctx.e_real, ctx.slope,
            g.contiguous(), out, mx, den, dst_ptr=dst_ptr,
            src_order=src_order, src_ptr=src_ptr)
        return (d_xl, d_xr, d_a) + (None,) * 9


def gatv2_attention(xl: torch.Tensor, xr: torch.Tensor, a: torch.Tensor,
                    drop_mask: Optional[torch.Tensor],
                    senders: torch.Tensor, receivers: torch.Tensor,
                    num_nodes: int, slope: float = 0.2,
                    num_real_edges: Optional[int] = None, *,
                    src_order: Optional[torch.Tensor] = None,
                    src_ptr: Optional[torch.Tensor] = None,
                    dst_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GATv2 attention output (num_nodes, NH*F), differentiable in xl,
    xr and a (module doc).

    xl, xr (num_nodes, NH*F): the sender-side and destination-side
    transforms; a (NH, F); drop_mask (E, NH) attention-dropout multipliers
    or None; senders, receivers (E,) int32, the dst-sorted edges, the
    real ones first (num_real_edges of them; None: every edge is real).
    src_order, src_ptr, dst_ptr: the graph's sender order and CSR offsets
    (Graph.src_order, Graph.src_ptr, Graph.dst_ptr), which spare the
    kernels' wrappers deriving them; src_ptr is read only with
    src_order."""
    e = senders.shape[0]
    e_real = e if num_real_edges is None else num_real_edges
    if not 0 <= e_real <= e:
        raise ValueError(f"num_real_edges {e_real} outside [0, {e}]")
    nh, f = a.shape
    if xl.shape != (num_nodes, nh * f) or xr.shape != xl.shape:
        raise ValueError(f"shapes xl {tuple(xl.shape)}, xr "
                         f"{tuple(xr.shape)} do not match num_nodes="
                         f"{num_nodes}, nh={nh}, f={f}")
    return _Gatv2Attention.apply(xl.contiguous(), xr.contiguous(),
                                 a.contiguous(), drop_mask, senders,
                                 receivers, src_order, src_ptr, dst_ptr,
                                 num_nodes, e_real, slope)
