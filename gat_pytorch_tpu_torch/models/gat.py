"""GAT layer and model stack in PyTorch, parameters as plain dicts of tensors.

Counterpart of gat_pytorch_tpu/models/gat.py, keeping its parameter
layout so the two packages compute the same function from the same
numbers (utils/convert.py carries JAX parameters over):
  W: (F_in, NH*F_out), right-multiplied;
  a: (NH*2F, NH), the reference's cross-head attention map
     (or (NH, 2F) per head with paper_faithful; (NH, F) with gatv2);
  W_r: (F_in, NH*F), GATv2's destination-side transform (gatv2 only);
  bias: (NH*F,) when enabled; skips: {} (identity) or {"w": (in, out)}.

Reference quirks kept (paper_faithful=False, the default): cross-head
`a`, a global max-cap on the raw logits BEFORE LeakyReLU, slope 0.01 with
torch's gradient convention at 0, and +1e-8 in the softmax denominator.

Three layer paths, chosen by `backend`:
  "kernel"  a whole-attention op: the CUDA kernels on a CUDA graph, their
            plain versions on a CPU graph. paper_faithful,
            const_attention and a graph without `src_order` take the
            table op (ops/cuda/table_attention.py, PATH_TRACE
            "v4_table"). paper_faithful's logits and their
            per-destination max are one op (ops/cuda/paper_logits.py);
            the others' come from plain torch (their gathers through
            ops/segment.gather_rows_sorted_grad, so that the step is
            reproducible bit for bit);
            otherwise a graph that carries a block layout
            (canonicalize(..., src_windows=True)) takes the windowed op
            (ops/cuda/window_attention.py, "v7"), one whose layout has a
            remainder (hybrid=True) the windowed parts op over the
            in-window edges plus the v5 parts op over the remainder
            ("v7_hybrid"), and any other the v5 op
            (ops/cuda/v5_attention.py, "v5"): the counterparts of the JAX
            "pallas" v4, v7, hybrid and v5 branches. GAT_TPU_V10=0 and
            GAT_TPU_V5_MERGED=0 select the 2-phase (cap, then attention)
            forms as in the JAX package (two_phase_modes): the v5 and v7
            ops take their two_phase mode, and a hybrid layout, which
            needs the single sweep, gives way to the v6 form
            fused_gat_window over the graph's edges ("v6"). The JAX
            package's GAT_TPU_V6 / force_windowed switch and its VMEM and
            cost gates on v6 are not ported. The JAX package also
            gates v7 on models of the TPU's VMEM and MXU cost, v5 on 4096
            edges, the sorted-gradient gathers on 200,000 edges and the
            hybrid remainder's kernel on 65,536 edges (below, XLA segment
            ops); those gates price the TPU's launches, do not apply to
            this card and are not ported. The ops read the JAX package's
            dtype knobs of their kernels themselves (GAT_TPU_V6_DTYPE,
            GAT_TPU_KERNEL_DTYPE, GAT_TPU_H_DTYPE); their backwards sum
            d(h) by sender at every width and read no
            GAT_TPU_DH_REDUCE_NT.
  "segment" plain torch segment ops (ops/segment.py), the counterpart of
            the JAX "xla" path and the reference the kernel path is held
            against.
  "naive"   the oracle layer of models/naive.py (the JAX package's
            backend "naive", which --layer_type naive selects): a second
            transcription of the layer that shares none of this module's
            code; single device only.

gatv2 (GATv2's dynamic attention, Brody, Alon and Yahav, ICLR 2022,
arXiv:2105.14491; PyG's GATv2Conv with share_weights=False and no bias):
W is the sender-side and message transform W_l, W_r the destination-side
one, a (NH, F) per head, LeakyReLU 0.2 inside the dot with a, a softmax
over each destination's edges (its maximum subtracted, no epsilon) and
attention dropout after it. The kernel path takes the GATv2 op
(ops/cuda/gatv2_attention.py, PATH_TRACE "gatv2"), the segment path the
same layer in plain torch. Its naive, edge-sharded and dst-owned layers,
block layouts, the 2-phase knobs and the bfloat16 tables have no
counterpart and raise ValueError.

return_attention: every path also returns the layer's attention
coefficients alpha, (E, NH) over the graph's dst-sorted edges (never over
a layout's slots), taken before dropout, 0 on padding edges, as the JAX
package does. The segment and naive paths return the alpha they
aggregate with; the kernel path computes it beside the op's output
(`_alpha_replica` on the v5, v7, hybrid and v6 branches, from the score
tables; on the table branches the softmax of the logits the branch
holds), through ops/segment.segment_softmax_sorted, so that its sums and
those of its backward are the sorted segment sum (no atomics) and the
step stays reproducible. Alpha's cotangent reaches the parameters through
h and `a` beside the op's own; the kernels are not changed.
calc_attention_norm is the attention regulariser of the JAX package.

Under `edge_axis` (a mesh Axis, ops/collectives.py: the edge arrays are
one contiguous shard of the dst-sorted edge list, the node arrays
replicated) the layer is the JAX package's cut-neighbourhood layer
(edge_axis set, dst_owned False): the sharded GEMM (each shard transforms
its rows of x, a tiled all_gather rebuilds h; a replicated product where
the nodes do not divide over the shards), the global cap by the owner
trick, and then on the kernel path ("sharded_v4_partial") the partial
v2 op (ops/cuda/segment_attention.py) over the shard's gathered h rows,
psum of num and den and the divide, on the segment path
("sharded_segment") the distributed segment softmax and a psum of the
aggregate. The collectives (ops/collectives.py) carry shard_map's
gradient semantics, so the parameters' gradients come out complete over
the edge axis. The v5, v7, hybrid and v6 branches need edge_axis None or
the dst-owned layout in the JAX package and are not taken there.

dst_owned (with edge_axis: a graph partitioned by destination,
parallel/partition.py, each rank's edges the in-edges of its N/K node
rows, parallel/sharding.dst_shard) is the JAX package's boundary-free
layer (`_dst_owned_layer`): the replicated product x @ W, then the
attention over the shard's own rows, local but for the global cap, and
one tiled all_gather of the (N/K, nh*f) output slices
(GAT_TPU_AG_DTYPE=bfloat16: in bfloat16, read when the layer is called).
On the kernel path it takes the JAX package's branches in its order:
"sharded_v7" (the windowed parts op over the shard's block layout),
"sharded_v7_hybrid" (the windowed and the v5 parts ops over a hybrid
layout's two edge lists, single sweep only), "sharded_v5" (the v5 parts
op, or under GAT_TPU_V10=0 v5_local_cap and fused_gat_table), each with
the global cap' by the owner trick and the epilogue over the shard's
rows; "sharded_v4_table" (paper_faithful, const_attention,
return_attention, and whatever the others do not take: the table op over
the shard's rows, the per-destination max without a pmax); the segment
path is "dst_owned_segment", a local segment softmax. Every op reads the
whole replicated h table by sender and writes the shard's rows. Between
the layers of a dst-owned stack the node tables are varying
(ops/collectives.py): the layer takes its parameters through vary, its
output leaves through all_gather_varying, and gat_model_apply ends in
owned_rows, so that the step runs no (N, nh*f) all_reduce and the
parameters' gradients come out whole on every rank.

GAT_TPU_GEMM_DTYPE=bfloat16 (`_gemm_dtype`, read when gat_model_apply or
gat_layer_apply is called, on both backends) takes the products x @ W and
the skip projections from bfloat16 operands with a float32 result, as the
JAX package's jnp.dot(..., preferred_element_type=float32) does, and
rounds their cotangents d(x) and d(W) to bfloat16 as its transpose does
(`bf16_product`); the model casts its input to bfloat16 once, so that
layer 0's input dropout runs in bfloat16 arithmetic (`input_dropout`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..graph.graph import BlockLayout, Graph
from ..ops import collectives as C
from ..ops import segment as seg
from ..ops.cuda import gatv2_attention as g2
from ..ops.cuda import paper_logits as pl
from ..ops.cuda import segment_attention as v2
from ..ops.cuda import table_attention as v4
from ..ops.cuda import v5_attention as v5
from ..ops.cuda import window_attention as v7
from ..ops.cuda.build import csr_offsets as build_offsets
from ..utils import profiling
from ..utils.device import check_device, resolve_device
from .naive import gat_layer_naive

Params = Dict[str, list]
BACKENDS = ("kernel", "segment", "naive")

# Which layer path each gat_layer_apply call took, one entry per call
# (tests clear and read it, as the JAX package's PATH_TRACE).
PATH_TRACE: List[str] = []


def _gemm_dtype() -> torch.dtype:
    """GAT_TPU_GEMM_DTYPE as the JAX package's models/gat._gemm_dtype
    reads it: bfloat16 operands of x @ W and the skip products where it is
    "bfloat16", else float32."""
    return (torch.bfloat16
            if os.environ.get("GAT_TPU_GEMM_DTYPE") == "bfloat16"
            else torch.float32)


class _Bf16Product(torch.autograd.Function):
    """bf16(x) @ bf16(W) with a float32 result. The cotangents are those
    of the JAX product's transpose: d(x) = bf16(g @ bf16(W)^T) in x's
    dtype and d(W) = bf16(bf16(x)^T @ g), each a float32 product (g is not
    rounded) rounded once."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.x_dtype = x.dtype
        if x.is_cuda:   # a bfloat16 GEMM with float32 accumulation and output
            return torch.mm(xb, wb, out_dtype=torch.float32)
        # the products of two bfloat16 values are exact in float32
        return xb.float() @ wb.float()

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = (g @ wb.float().t()).to(torch.bfloat16).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            d_w = (xb.float().t() @ g).to(torch.bfloat16).float()
        return d_x, d_w


def bf16_product(x: torch.Tensor, w: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """x @ w: in float32, or from bfloat16 operands (_Bf16Product)."""
    if dtype == torch.float32:
        return x @ w
    return _Bf16Product.apply(x, w)


def input_dropout(x: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """x / (1 - rate) where `keep`, else 0, in x's dtype. The scale is
    rounded to that dtype first and divides as a tensor, as the JAX
    package's weakly typed scalar does in `_dropout` (a bfloat16 x then
    divides by bfloat16(1 - rate))."""
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


def two_phase_modes() -> Tuple[bool, bool]:
    """(v5 2-phase, v7 2-phase), read from the environment at call time
    with the JAX package's defaults and meanings: the single-sweep forms
    run unless GAT_TPU_V10=0, which turns both ops 2-phase, or
    GAT_TPU_V5_MERGED=0, which turns the v5 op 2-phase."""
    v10 = os.environ.get("GAT_TPU_V10", "1") != "0"
    merged = os.environ.get("GAT_TPU_V5_MERGED", "1") != "0"
    return not (v10 and merged), not v10


@dataclasses.dataclass(frozen=True)
class GATLayerConfig:
    in_features: int
    out_features: int
    num_heads: int
    concat: bool
    dropout: float = 0.0
    bias: bool = False
    const_attention: bool = False
    paper_faithful: bool = False
    gatv2: bool = False
    negative_slope: Optional[float] = None  # default depends on the form

    @property
    def slope(self) -> float:
        if self.negative_slope is not None:
            return self.negative_slope
        return 0.2 if self.paper_faithful or self.gatv2 else 0.01


def _xavier_uniform(gen: torch.Generator, shape, fan_in: int, fan_out: int,
                    device: torch.device) -> torch.Tensor:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def init_gat_layer(gen: torch.Generator, cfg: GATLayerConfig,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    nh, f = cfg.num_heads, cfg.out_features
    params = {"W": _xavier_uniform(gen, (cfg.in_features, nh * f),
                                   cfg.in_features, nh * f, device)}
    if cfg.gatv2:
        # the destination-side transform, and a per head with the bound of
        # PyG's glorot on its (1, NH, F) att
        params["W_r"] = _xavier_uniform(gen, (cfg.in_features, nh * f),
                                        cfg.in_features, nh * f, device)
        params["a"] = _xavier_uniform(gen, (nh, f), f, nh, device)
    elif not cfg.const_attention:
        if cfg.paper_faithful:
            params["a"] = _xavier_uniform(gen, (nh, 2 * f), 2 * f, 1, device)
        else:
            params["a"] = _xavier_uniform(gen, (nh * 2 * f, nh),
                                          nh * 2 * f, nh, device)
    if cfg.bias:
        params["bias"] = torch.zeros(nh * f, device=device)
    return params


def _split_attention_map(a: torch.Tensor, nh: int, f: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split the cross-head map (NH*2F, NH) into its source and
    destination halves, (NH*F, NH) each: row head*2F + j maps source
    feature j of that head when j < F, else destination feature j - F
    (the reference's view(E, NH*2F) of concat([src, dst], -1))."""
    a4 = a.reshape(nh, 2, f, -1)
    return (a4[:, 0].reshape(nh * f, -1), a4[:, 1].reshape(nh * f, -1))


def _attention_dropout(shape, rate: float, gen: Optional[torch.Generator],
                       device: torch.device) -> torch.Tensor:
    """(E, NH) keep mask scaled by 1/(1-rate)."""
    if gen is None:
        raise ValueError("a generator is required for attention dropout")
    keep = torch.rand(shape, generator=gen, device=device) >= rate
    return keep.to(torch.float32) / (1.0 - rate)


def _head_combine(out: torch.Tensor, cfg: GATLayerConfig, num_nodes: int,
                  params) -> torch.Tensor:
    nh, f = cfg.num_heads, cfg.out_features
    if cfg.concat:
        out = out.reshape(num_nodes, nh * f)
    else:
        out = out.reshape(num_nodes, nh, f).mean(dim=1)
    if cfg.bias:
        out = out + params["bias"]
    return out


def _edge_logits(params, cfg: GATLayerConfig, h_flat: torch.Tensor,
                 senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor,
                 src_order: Optional[torch.Tensor] = None,
                 edge_axis=None, *,
                 src_ptr: Optional[torch.Tensor] = None,
                 dst_ptr: Optional[torch.Tensor] = None,
                 num_real_edges: Optional[int] = None,
                 own: Optional[slice] = None) -> torch.Tensor:
    """(E, NH) edge logits after LeakyReLU, from node scores: zeros under
    const_attention, per-head a = [a_l || a_r] scores under paper_faithful,
    else the cross-head scores with the global max-cap BEFORE LeakyReLU.
    With src_order (the stable sender sort of the edges) the two score
    gathers take the sorted-gradient form, whose backward has a fixed
    order of sums; without it, plain gathers (the segment path). src_ptr
    (the offsets of the real edges in src_order), dst_ptr and
    num_real_edges go to those gathers' backwards: the caller replaces
    the padding edges' logits, so their cotangent is zero and the sums
    skip them.
    edge_axis: the edges are this rank's shard over that axis; the
    replicated score tables enter the shard's edges through vary, and the
    global cap is completed over the shards (_global_cap). own: the rows
    of a dst-owned shard (its receivers are then local to them, its score
    tables already varying, and dst_ptr covers its rows)."""
    nh, f = cfg.num_heads, cfg.out_features
    n = h_flat.shape[0]
    if cfg.const_attention:
        return torch.zeros((senders.shape[0], nh), dtype=h_flat.dtype,
                           device=h_flat.device)
    if cfg.paper_faithful:
        s_both = torch.cat(_paper_scores(params, cfg, h_flat), dim=1)
    else:
        s_both = h_flat @ torch.cat(_split_attention_map(params["a"], nh, f),
                                    dim=1)
    if edge_axis is not None and own is None:
        s_both = C.vary(s_both, edge_axis)
    s_src, s_dst = s_both[:, :nh], s_both[:, nh:]
    n_dst = n
    if own is not None:
        s_dst, n_dst = s_dst[own], own.stop - own.start
    if src_order is None:
        logits = seg.gather_rows(s_src, senders) + seg.gather_rows(
            s_dst, receivers)
    else:   # the receivers are sorted as they are
        logits = (seg.gather_rows_sorted_grad(s_src, senders, n, src_order,
                                              ptr=src_ptr)
                  + seg.gather_rows_sorted_grad(s_dst, receivers, n_dst,
                                                ptr=dst_ptr,
                                                num_real=num_real_edges))
    if not cfg.paper_faithful:
        cap = torch.where(edge_mask[:, None], logits,
                          torch.full_like(logits, float("-inf"))).max()
        if edge_axis is not None:
            cap = C.vary(_global_cap(cap, edge_axis), edge_axis)
        logits = logits - cap
    # torch's LeakyReLU gradient at exactly 0 is the slope; the capped
    # argmax logit sits at 0, so the convention matters here
    return F.leaky_relu(logits, cfg.slope)


def _paper_scores(params, cfg: GATLayerConfig, h_flat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """paper_faithful's per-head scores (N, NH): s_src = a[:, :F] . h_j
    of a sender, s_dst = a[:, F:] . h_i of a destination."""
    nh, f = cfg.num_heads, cfg.out_features
    h = h_flat.reshape(-1, nh, f)
    a = params["a"]
    return (torch.einsum("nhf,hf->nh", h, a[:, :f]),
            torch.einsum("nhf,hf->nh", h, a[:, f:]))


def _alpha_replica(params, cfg: GATLayerConfig, h_flat: torch.Tensor,
                   senders: torch.Tensor, receivers: torch.Tensor,
                   edge_mask: torch.Tensor, num_nodes: int,
                   src_order: Optional[torch.Tensor],
                   src_ptr: Optional[torch.Tensor],
                   dst_ptr: Optional[torch.Tensor],
                   num_real_edges: Optional[int]) -> torch.Tensor:
    """Alpha as a value beside a v5, v7, hybrid or v6 op's output (JAX
    models/gat.py _alpha_replica): the edge logits of _edge_logits (the
    source scores from a plain, differentiable h @ a_src; the global cap
    before LeakyReLU, torch's gradient at 0), then the sorted softmax at
    eps 1e-8 without a per-segment max. Its cotangent into h and `a` adds
    to the op's own (a shared input), which the op's kernels never see.
    The score gathers take the sorted-gradient form at every edge count
    (the JAX package does from 200,000 edges): a graph without src_order
    is sorted by sender here."""
    if src_order is None:
        src_order, src_ptr = (torch.argsort(senders, stable=True)
                              .to(torch.int32), None)
    logits = _edge_logits(params, cfg, h_flat, senders, receivers, edge_mask,
                          src_order, src_ptr=src_ptr, dst_ptr=dst_ptr,
                          num_real_edges=num_real_edges)
    return seg.segment_softmax_sorted(logits, receivers, num_nodes,
                                      edge_mask=edge_mask, ptr=dst_ptr,
                                      num_real=num_real_edges, eps=1e-8)


def _global_cap(local: torch.Tensor, ax) -> torch.Tensor:
    """The max of the shards' local maxima over `ax`, differentiable, by
    the owner trick: forward, only the owner shard (the lowest index
    reaching the pmax of the detached local maxima) adds its local max
    into the psum; backward, the psum hands the owner the replicated cap
    cotangent, which its max routes to the argmax logit. A
    where(owner, local, pmax) form drops every other shard's cotangent
    (the JAX package measured about 2.5% of d(a))."""
    top = C.pmax(local.detach(), ax)
    cand = torch.where(local.detach() >= top, float(ax.index),
                       float(ax.size))
    owner = C.pmin(cand, ax) == ax.index
    return C.psum(torch.where(owner, local, torch.zeros_like(local)), ax)


def _ag_tiled(out_local: torch.Tensor, ax) -> torch.Tensor:
    """The tiled all_gather of a dst-owned shard's output rows
    (all_gather_varying), carried in bfloat16 and widened after it where
    GAT_TPU_AG_DTYPE=bfloat16 (read now; the cotangent then travels in
    bfloat16 too), as the JAX package's _ag_tiled."""
    if (os.environ.get("GAT_TPU_AG_DTYPE") == "bfloat16"
            and out_local.dtype == torch.float32):
        return C.all_gather_varying(out_local.to(torch.bfloat16),
                                    ax).float()
    return C.all_gather_varying(out_local, ax)


def _shard_bound(h_flat, a_src, s_dst, s_src, ax) -> torch.Tensor:
    """The single sweep's score bound B on a dst-owned shard, equal on
    every rank: the largest source score of the whole table (from the op's
    float32 table s_src, or where None from h_flat @ a_src, as
    v5_attention.score_bound_of) plus the pmax of the shards' largest
    destination scores. It cancels in the epilogue: no gradient."""
    with torch.no_grad():
        s = h_flat.detach() @ a_src.detach() if s_src is None else s_src
        return s.max() + C.pmax(s_dst.detach().max(), ax)


def _dst_owned_layer(params, cfg: GATLayerConfig, x, senders, receivers,
                     edge_mask, num_nodes: int, ax, *, num_real_edges,
                     src_order, src_ptr, dst_ptr, block_layout, generator,
                     training: bool, backend: str, gemm_dtype,
                     return_attention: bool):
    """The dst-owned layer (module doc; JAX models/gat.py:401-417,
    :741-1020, :1155-1165 and :1203-1251): x and the result are the
    varying node tables of a dst-owned stack, the parameters replicated.
    The drawn dropout masks are the shard's: its slots (then its
    remainder's), or its edges."""
    nh, f = cfg.num_heads, cfg.out_features
    if num_nodes % ax.size:
        raise ValueError(f"{num_nodes} nodes do not divide over {ax.size} "
                         f"dst-owned shards")
    rows = num_nodes // ax.size
    own = slice(ax.index * rows, (ax.index + 1) * rows)
    p = {name: C.vary(t, ax) for name, t in params.items()}
    h_flat = bf16_product(x, p["W"], gemm_dtype)
    recv = receivers - own.start
    e_real = (int(edge_mask.sum()) if num_real_edges is None
              else num_real_edges)
    dropping = training and cfg.dropout > 0.0

    def mask(slots: int):
        return (_attention_dropout((slots, nh), cfg.dropout, generator,
                                   x.device) if dropping else None)

    def finish(out_local, alpha=None):
        out = _head_combine(_ag_tiled(out_local, ax), cfg, num_nodes, p)
        return (out, alpha) if return_attention else out

    bl = block_layout
    hybrid = bl is not None and bl.rem_send is not None
    v10 = os.environ.get("GAT_TPU_V10", "1") != "0"
    branch = None
    if backend == "kernel" and not (cfg.paper_faithful or cfg.const_attention
                                    or return_attention):
        if bl is not None and not hybrid:
            branch = "sharded_v7"
        elif hybrid and v10:
            branch = "sharded_v7_hybrid"
        elif src_order is not None:
            branch = "sharded_v5"
    if branch is not None:
        PATH_TRACE.append(branch)
        a_src, a_dst = _split_attention_map(p["a"], nh, f)
        s_dst = h_flat[own] @ a_dst
        if branch == "sharded_v5" and not v10:
            # the 2-phase form: the global cap first, then the attention
            # pass with it over the shard's rows
            r = v5.v5_rounding()
            s_src = v5.op_scores(r.table_of(h_flat), a_src)
            cap = v5.v5_local_cap(h_flat, a_src, s_dst, senders, recv,
                                  e_real, rows, nh, f, rounding=r,
                                  s_src=s_src)
            return finish(v5.fused_gat_table(
                h_flat, a_src, s_dst, C.vary(_global_cap(cap, ax), ax),
                mask(senders.shape[0]), senders, recv, src_order, e_real,
                rows, nh, f, 1e-8, cfg.slope, num_nodes, rounding=r,
                src_ptr=src_ptr, dst_ptr=dst_ptr, s_src=s_src))
        # the single sweep: unnormalised parts over the shard's rows in
        # the frame of one bound B on every rank, the global cap' by the
        # owner trick (a shard without edges has cap' NEG_INF and never
        # owns it), and the epilogue
        if branch == "sharded_v5":
            r = v5.v5_rounding()
            s_src = v5.op_scores(r.table_of(h_flat), a_src)
            s_eff = s_dst - _shard_bound(h_flat, a_src, s_dst,
                                         None if r.table else s_src, ax)
            num, den, cap, _ = v5.v5_sweep1_parts(
                h_flat, a_src, s_eff, mask(senders.shape[0]), senders, recv,
                src_order, e_real, rows, nh, f, 1e-8, cfg.slope, num_nodes,
                dst_ptr=dst_ptr, src_ptr=src_ptr, s_src=s_src)
        else:
            rw = v7.window_rounding(nh, f)
            # one source-score table for both ops of a hybrid layout where
            # their kernels read the same h table
            share = not hybrid or rw.table == v5.v5_rounding().table
            s_src = (v5.op_scores(rw.table_of(h_flat), a_src) if share
                     else None)
            s_eff = s_dst - _shard_bound(h_flat, a_src, s_dst,
                                         None if rw.table else s_src, ax)
            num, den, cap, _ = v7.v7_sweep1_parts(
                h_flat, a_src, s_eff, mask(bl.num_slots), bl, rows, nh, f,
                1e-8, cfg.slope, num_nodes, s_src=s_src)
            if hybrid:
                num2, den2, cap2, _ = v5.v5_sweep1_parts(
                    h_flat, a_src, s_eff, mask(bl.rem_send.shape[0]),
                    bl.rem_send, bl.rem_recv, bl.rem_order, bl.rem_e, rows,
                    nh, f, 1e-8, cfg.slope, num_nodes,
                    dst_ptr=bl.rem_dst_ptr, src_ptr=bl.rem_src_ptr,
                    s_src=s_src)
                num, den = num + num2, den + den2
                cap = torch.maximum(cap, cap2)
        out, _ = v5.normalise(num, den, C.vary(_global_cap(cap, ax), ax),
                              1e-8, cfg.slope, nh)
        return finish(out)

    kernel = backend == "kernel"
    if kernel and src_order is None:
        src_order, src_ptr = seg.real_first_order(senders, edge_mask,
                                                  num_nodes), None
    logits = _edge_logits(p, cfg, h_flat, senders, recv, edge_mask,
                          src_order if kernel else None, ax, src_ptr=src_ptr,
                          dst_ptr=dst_ptr, num_real_edges=num_real_edges,
                          own=own)
    eps = 0.0 if cfg.paper_faithful else 1e-8
    drop = mask(senders.shape[0])
    if kernel:
        PATH_TRACE.append("sharded_v4_table")
        raw_logits = logits
        pad = torch.full_like(logits, v4.NEG_INF)
        logits = torch.where(edge_mask[:, None], logits, pad)
        if cfg.paper_faithful:
            # every destination's edges are the shard's: no pmax
            seg_max = seg.segment_max(logits, recv, rows).detach()
            seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                                  torch.zeros_like(seg_max))
            logits = torch.where(edge_mask[:, None],
                                 logits - seg.gather_rows(seg_max, recv), pad)
        out = v4.fused_segment_attention_table(
            logits, h_flat, senders, recv, drop, src_order, rows, nh, f, eps,
            e_real, src_ptr=src_ptr, dst_ptr=dst_ptr)
        alpha = (seg.segment_softmax_sorted(
            raw_logits, recv, rows, edge_mask=edge_mask, ptr=dst_ptr,
            num_real=e_real, eps=eps,
            subtract_segment_max=cfg.paper_faithful)
            if return_attention else None)
        return finish(out, alpha)
    PATH_TRACE.append("dst_owned_segment")
    alpha = seg.segment_softmax(logits, recv, rows, edge_mask=edge_mask,
                                eps=eps,
                                subtract_segment_max=cfg.paper_faithful)
    weights = alpha if drop is None else alpha * drop
    out = seg.segment_sum(seg.gather_rows(h_flat.reshape(num_nodes, nh, f),
                                          senders) * weights[:, :, None],
                          recv, rows)
    return finish(out.reshape(rows, nh * f), alpha)


def _gatv2_layer(params, cfg: GATLayerConfig, x, h_flat, senders, receivers,
                 edge_mask, num_nodes: int, *, num_real_edges, src_order,
                 src_ptr, dst_ptr, block_layout, generator, training: bool,
                 backend: str, gemm_dtype, return_attention: bool):
    """The GATv2 layer (module doc): h_flat = x @ W is the sender side,
    x @ W_r the destination side. The attention mask is drawn as the v5
    branch draws it, (E, NH) over the dst-sorted edges."""
    nh, f = cfg.num_heads, cfg.out_features
    kernel = backend == "kernel"
    if kernel:
        v5_two, v7_two = two_phase_modes()
        r = v5.v5_rounding()
        unsupported = [name for name, on in (
            ("a block layout", block_layout is not None),
            ("the 2-phase knobs GAT_TPU_V10=0 / GAT_TPU_V5_MERGED=0",
             v5_two or v7_two),
            ("a bfloat16 table (GAT_TPU_KERNEL_DTYPE / GAT_TPU_H_DTYPE)",
             r.table or r.acc)) if on]
        if unsupported:
            raise ValueError(f"gatv2 on the kernel path has no form for "
                             f"{' or '.join(unsupported)}")
    xr = bf16_product(x, params["W_r"], gemm_dtype)
    e = senders.shape[0]
    drop = (_attention_dropout((e, nh), cfg.dropout, generator, x.device)
            if training and cfg.dropout > 0.0 else None)

    def finish(out, alpha):
        out = _head_combine(out, cfg, num_nodes, params)
        return (out, alpha) if return_attention else out

    def softmax():
        """alpha in plain torch from gathered rows: the segment path's,
        and return_attention's on the kernel path (eval, vis)."""
        z = (seg.gather_rows(h_flat.reshape(-1, nh, f), senders)
             + seg.gather_rows(xr.reshape(-1, nh, f), receivers))
        logits = (F.leaky_relu(z, cfg.slope) * params["a"]).sum(-1)
        return seg.segment_softmax(logits, receivers, num_nodes,
                                   edge_mask=edge_mask, eps=0.0,
                                   subtract_segment_max=True)

    if kernel:
        PATH_TRACE.append("gatv2")
        e_real = (int(edge_mask.sum()) if num_real_edges is None
                  else num_real_edges)
        out = g2.gatv2_attention(h_flat, xr, params["a"], drop, senders,
                                 receivers, num_nodes, cfg.slope, e_real,
                                 src_order=src_order, src_ptr=src_ptr,
                                 dst_ptr=dst_ptr)
        return finish(out, softmax() if return_attention else None)
    PATH_TRACE.append("segment")
    alpha = softmax()
    weights = alpha if drop is None else alpha * drop
    out = seg.segment_sum(
        seg.gather_rows(h_flat.reshape(num_nodes, nh, f), senders)
        * weights[:, :, None], receivers, num_nodes)
    return finish(out, alpha)


def _node_transform(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                    edge_axis, num_nodes: int) -> torch.Tensor:
    """h = x @ W (bf16_product). Under an edge axis whose size divides
    the nodes, the sharded GEMM: each shard transforms its node rows and
    a tiled all_gather rebuilds the replicated h (JAX models/gat.py
    :401-416); otherwise the product is replicated."""
    if edge_axis is None or num_nodes % edge_axis.size:
        return bf16_product(x, w, dtype)
    return C.all_gather_rows(bf16_product(
        C.split_rows(x, edge_axis), C.vary(w, edge_axis), dtype), edge_axis)


def gat_layer_apply(params, cfg: GATLayerConfig, x: torch.Tensor,
                    senders: torch.Tensor, receivers: torch.Tensor,
                    edge_mask: torch.Tensor, num_nodes: int, *,
                    num_real_edges: Optional[int] = None,
                    src_order: Optional[torch.Tensor] = None,
                    src_ptr: Optional[torch.Tensor] = None,
                    dst_ptr: Optional[torch.Tensor] = None,
                    block_layout: Optional[BlockLayout] = None,
                    tile_lo: Optional[torch.Tensor] = None,
                    src_band: int = 0,
                    generator: Optional[torch.Generator] = None,
                    training: bool = False,
                    backend: str = "kernel",
                    gemm_dtype: Optional[torch.dtype] = None,
                    edge_axis=None,
                    dst_owned: bool = False,
                    return_attention: bool = False):
    """One GAT layer on a canonicalised graph (self-loops, dst-sorted,
    padded to a sink node, real edges first): its (N, out) output, or
    (output, alpha) where return_attention (the module doc).
    num_real_edges defaults to edge_mask.sum() (one host sync) where the
    op needs it; Graph.num_real_edges avoids it.
    edge_axis: the mesh Axis the edge arrays are sharded over (the module
    doc); the layer then reads src_order as the shard's own stable sender
    order with its padding edges last (parallel/sharding.edge_shard; None:
    sorted here) and ignores block_layout, tile_lo and src_band.
    src_ptr and dst_ptr (Graph.src_ptr, Graph.dst_ptr): the CSR offsets
    the kernel ops' wrappers would otherwise derive per call; src_ptr
    describes src_order and is read only with it.
    dst_owned (with edge_axis): the boundary-free layer of the module
    doc, on a rank's shard of a graph partitioned by destination
    (receivers global, src_order its local order, src_ptr over the N
    senders, dst_ptr and block_layout its own rows'); x and the output
    are the varying node tables of gat_model_apply's dst-owned stack.
    block_layout (Graph.block_layout) puts the kernel path on the windowed
    op, or on the hybrid of the windowed and the v5 parts ops where the
    layout has a remainder; the table op and the segment path ignore it.
    tile_lo and src_band (Graph.tile_lo, Graph.src_band) size the v6
    form's window arguments, as the JAX package derives them. gemm_dtype:
    the operands' dtype of x @ W (None reads GAT_TPU_GEMM_DTYPE now).
    backend "naive" takes none of these but the generator."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    if cfg.gatv2 and (backend == "naive" or edge_axis is not None
                      or dst_owned):
        raise ValueError("gatv2 has no naive, edge-sharded or dst-owned "
                         "layer: backend 'kernel' or 'segment' on one "
                         "device")
    if backend == "naive":
        if edge_axis is not None:
            raise ValueError("backend 'naive' is the single-device oracle "
                             "layer: no edge sharding")
        PATH_TRACE.append("naive")
        return gat_layer_naive(params, cfg, x, senders, receivers,
                               edge_mask, num_nodes, generator=generator,
                               training=training,
                               return_attention=return_attention)
    gdt = _gemm_dtype() if gemm_dtype is None else gemm_dtype
    if dst_owned:
        if edge_axis is None:
            raise ValueError("dst_owned needs the edge axis of the shards")
        return _dst_owned_layer(
            params, cfg, x, senders, receivers, edge_mask, num_nodes,
            edge_axis, num_real_edges=num_real_edges, src_order=src_order,
            src_ptr=src_ptr, dst_ptr=dst_ptr, block_layout=block_layout,
            generator=generator, training=training, backend=backend,
            gemm_dtype=gdt, return_attention=return_attention)
    nh, f = cfg.num_heads, cfg.out_features
    e = senders.shape[0]
    ax = edge_axis
    # x @ W is a plain product outside any kernel, in full float32
    # (utils/device.resolve_device turns TF32 off) or from bfloat16
    # operands
    h_flat = _node_transform(x, params["W"], gdt, ax, num_nodes)
    if cfg.gatv2:
        return _gatv2_layer(
            params, cfg, x, h_flat, senders, receivers, edge_mask, num_nodes,
            num_real_edges=num_real_edges, src_order=src_order,
            src_ptr=src_ptr, dst_ptr=dst_ptr, block_layout=block_layout,
            generator=generator, training=training, backend=backend,
            gemm_dtype=gdt, return_attention=return_attention)
    dropping = training and cfg.dropout > 0.0
    given_logits = cfg.paper_faithful or cfg.const_attention

    def finish(out, alpha=None):
        out = _head_combine(out, cfg, num_nodes, params)
        return (out, alpha) if return_attention else out

    # the v5, v7 and hybrid branches need edge_axis None (or the dst-owned
    # layout) in the JAX package
    if backend == "kernel" and not given_logits and ax is None and (
            block_layout is not None or src_order is not None):
        a_src, a_dst = _split_attention_map(params["a"], nh, f)
        v5_two, v7_two = two_phase_modes()
        bl = block_layout
        hybrid = bl is not None and bl.rem_send is not None
        # the hybrid's parts add only in the single sweep: under 2-phase
        # the graph's own edges take the v6 form, as in the JAX package
        v6 = hybrid and v7_two
        if v6:
            bl = None
        # s_dst for the op; the sender's half of each logit is the op's
        # own source-score pass, which also gives the single sweep's score
        # bound B (any bound >= max raw logit; it cancels algebraically in
        # the epilogue, so no gradient); the 2-phase forms take their cap
        # in a pass instead
        s_dst = h_flat @ a_dst
        e_real = None
        if bl is None:
            e_real = (int(edge_mask.sum()) if num_real_edges is None
                      else num_real_edges)
        # the mask is drawn in the order of the op's edge list: the
        # layout's slots (E7, nh) or the dst-sorted edges (E, nh)
        slots = e if bl is None else bl.num_slots
        drop = (_attention_dropout((slots, nh), cfg.dropout, generator,
                                   x.device) if dropping else None)
        if v6:
            PATH_TRACE.append("v6")
            n_rows8 = -(-num_nodes // 8) * 8
            window, tl = n_rows8, tile_lo
            if src_band > 0 and tile_lo is not None:
                window = min(-(-src_band // 8) * 8, n_rows8)
            if window == n_rows8 or tile_lo is None:
                # the JAX package's whole-table-resident mode
                tl = torch.zeros((-(-num_nodes // 128),), dtype=torch.int32,
                                 device=x.device)
            out = v7.fused_gat_window(
                h_flat, a_src, s_dst, drop, senders, receivers, e_real, tl,
                num_nodes, nh, f, window, 1e-8, cfg.slope,
                src_order=src_order, src_ptr=src_ptr, dst_ptr=dst_ptr)
        elif hybrid:
            # The split-locality layout: the windowed parts op over the
            # in-window edges, the v5 parts op over the remainder. num
            # and den add over any partition of the edges (both sum
            # exp(slope*(raw - B)) terms), the global cap' is the larger
            # of the two (torch.maximum sends its cotangent to the
            # winner's argmax chain), and one epilogue in plain torch
            # normalises under autograd. The second mask, the remainder's
            # (rem_E, nh), is drawn after the layout's (E7, nh).
            PATH_TRACE.append("v7_hybrid")
            drop_rem = (_attention_dropout(
                (bl.rem_send.shape[0], nh), cfg.dropout, generator, x.device)
                if dropping else None)
            # one source-score table for both ops where their kernels read
            # the same h table, and the bound that both share from it
            rw = v7.window_rounding(nh, f)
            s_src = (v5.op_scores(rw.table_of(h_flat), a_src)
                     if rw.table == v5.v5_rounding().table else None)
            s_dst_eff = s_dst - v5.score_bound_of(
                h_flat, a_src, s_dst, None if rw.table else s_src)
            num1, den1, cap1, _ = v7.v7_sweep1_parts(
                h_flat, a_src, s_dst_eff, drop, bl, num_nodes, nh, f, 1e-8,
                cfg.slope, s_src=s_src)
            # The JAX package sends a remainder of up to 65,536 edges
            # through XLA segment ops instead, a gate on the TPU's launch
            # cost; here the remainder always takes the kernel.
            num2, den2, cap2, _ = v5.v5_sweep1_parts(
                h_flat, a_src, s_dst_eff, drop_rem, bl.rem_send,
                bl.rem_recv, bl.rem_order, bl.rem_e, num_nodes, nh, f, 1e-8,
                cfg.slope, dst_ptr=bl.rem_dst_ptr, src_ptr=bl.rem_src_ptr,
                s_src=s_src)
            out, _ = v5.normalise(num1 + num2, den1 + den2,
                                  torch.maximum(cap1, cap2), 1e-8, cfg.slope,
                                  nh)
        elif bl is not None:
            # The JAX package takes v7 only where its VMEM and MXU-cost
            # gates pass and from 4096 edges; here every graph that
            # carries a block layout does.
            PATH_TRACE.append("v7")
            out = v7.fused_gat_window_v7(
                h_flat, a_src, s_dst, drop, bl, None, num_nodes, nh, f,
                1e-8, cfg.slope, two_phase=v7_two)
        else:
            # The JAX package takes v5 from 4096 edges and the table op
            # below that: a gate on the TPU's launch cost, not ported.
            # Every edge count runs v5 here.
            PATH_TRACE.append("v5")
            out = v5.fused_gat_table_autocap(
                h_flat, a_src, s_dst, drop, senders, receivers, src_order,
                e_real, None, num_nodes, nh, f, 1e-8, cfg.slope,
                two_phase=v5_two, src_ptr=src_ptr, dst_ptr=dst_ptr)
        # alpha over the graph's own edges, whatever the op's edge list
        return finish(out, _alpha_replica(
            params, cfg, h_flat, senders, receivers, edge_mask, num_nodes,
            src_order, src_ptr, dst_ptr, num_real_edges)
            if return_attention else None)

    kernel = backend == "kernel"
    if kernel and src_order is None:
        # a stable sort keeps the order of every sum over senders fixed
        # (the table op's backward would sort them itself otherwise); an
        # edge shard's order puts its padding edges last
        src_order = (torch.argsort(senders, stable=True).to(torch.int32)
                     if ax is None
                     else seg.real_first_order(senders, edge_mask, num_nodes))
        src_ptr = None      # the table op derives the offsets of this order
    # the paper form's logits on one device: one op, the per-destination
    # max subtracted and the padding edges at NEG_INF, as the table op
    # takes them
    paper = kernel and cfg.paper_faithful and ax is None
    if paper:
        logits = pl.paper_logits(
            *_paper_scores(params, cfg, h_flat), senders, receivers,
            edge_mask, num_nodes, cfg.slope, num_real_edges,
            src_order=src_order, src_ptr=src_ptr, dst_ptr=dst_ptr)
    else:
        logits = _edge_logits(params, cfg, h_flat, senders, receivers,
                              edge_mask, src_order if kernel else None, ax,
                              src_ptr=src_ptr, dst_ptr=dst_ptr,
                              num_real_edges=num_real_edges)
    eps = 0.0 if cfg.paper_faithful else 1e-8

    def table_alpha(num_real):
        """The sorted softmax of the branch's logits before their padding
        (JAX models/gat.py:1182-1198), completed over the edge axis."""
        if not return_attention:
            return None
        return seg.segment_softmax_sorted(
            raw_logits, receivers, num_nodes, edge_mask=edge_mask,
            ptr=dst_ptr, num_real=num_real, eps=eps,
            subtract_segment_max=cfg.paper_faithful, edge_axis=ax)

    drop = (_attention_dropout((e, nh), cfg.dropout, generator, x.device)
            if dropping else None)

    if kernel:
        if paper:
            # alpha from the logits before the max and the padding, as
            # the other table branches take it
            raw_logits = (_edge_logits(
                params, cfg, h_flat, senders, receivers, edge_mask,
                src_order, src_ptr=src_ptr, dst_ptr=dst_ptr,
                num_real_edges=num_real_edges) if return_attention else None)
        else:
            # the table op (const_attention, and graphs without src_order;
            # the op then derives the order itself), or on an edge shard
            # the partial v2 op, also under paper_faithful
            raw_logits = logits
            pad = torch.full_like(logits, v4.NEG_INF)
            logits = torch.where(edge_mask[:, None], logits, pad)
            if cfg.paper_faithful:
                # the per-destination max, detached (softmax is invariant
                # to it) and completed over the shards, is subtracted
                # here; the op then only needs exp
                seg_max = seg.segment_max(logits, receivers, num_nodes,
                                          edge_axis=ax).detach()
                seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                                      torch.zeros_like(seg_max))
                logits = torch.where(
                    edge_mask[:, None],
                    logits - seg.gather_rows(seg_max, receivers), pad)
        if ax is None:
            PATH_TRACE.append("v4_table")
            out = v4.fused_segment_attention_table(
                logits, h_flat, senders, receivers, drop, src_order,
                num_nodes, nh, f, eps, num_real_edges, src_ptr=src_ptr,
                dst_ptr=dst_ptr)
            return finish(out, table_alpha(num_real_edges))
        PATH_TRACE.append("sharded_v4_partial")
        # only the real edges' rows: the op reads no other, and the
        # sorted sum of their gradient then has no padding rows (all the
        # sink's, one long segment) to walk
        er = (int(edge_mask.sum()) if num_real_edges is None
              else num_real_edges)
        h_src = seg.gather_rows_sorted_grad(C.vary(h_flat, ax), senders[:er],
                                            num_nodes, src_order[:er],
                                            ptr=src_ptr)
        num, den = v2.fused_segment_attention_partial(
            logits, h_src, receivers, drop, num_nodes, nh, f, er,
            dst_ptr=dst_ptr)
        num, den = C.psum(num, ax), C.psum(den, ax)
        inv = torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))
        out = num.reshape(num_nodes, nh, f) * inv[:, :, None]
        return finish(out, table_alpha(er))

    PATH_TRACE.append("segment" if ax is None else "sharded_segment")
    alpha = seg.segment_softmax(
        logits, receivers, num_nodes, edge_mask=edge_mask, eps=eps,
        subtract_segment_max=cfg.paper_faithful, edge_axis=ax)
    alpha_pre = alpha
    if drop is not None:
        alpha = alpha * drop
    h_rep = h_flat if ax is None else C.vary(h_flat, ax)
    out = seg.segment_sum(
        seg.gather_rows(h_rep.reshape(num_nodes, nh, f), senders)
        * alpha[:, :, None], receivers, num_nodes)
    if ax is not None:
        out = C.psum(out, ax)
    return finish(out, alpha_pre)


@dataclasses.dataclass(frozen=True)
class GATConfig:
    """The reference hyperparameter surface (JAX GATConfig)."""
    num_input_node_features: int
    num_layers: int
    num_heads_per_layer: Sequence[int]
    heads_concat_per_layer: Sequence[bool]
    head_output_features_per_layer: Sequence[int]  # len == num_layers + 1
    num_classes: int
    add_skip_connection: Sequence[bool]
    dropout: float = 0.0
    const_attention: bool = False
    paper_faithful: bool = False
    gatv2: bool = False

    def validate(self) -> None:
        """Shape-consistency checks; raises ValueError."""
        nl = self.num_layers
        if self.gatv2 and (self.paper_faithful or self.const_attention):
            raise ValueError("gatv2 is its own attention form: not with "
                             "paper_faithful or const_attention")
        if len(self.num_heads_per_layer) != nl:
            raise ValueError(
                f"num_heads_per_layer has {len(self.num_heads_per_layer)} "
                f"entries, need num_layers={nl}")
        if len(self.heads_concat_per_layer) != nl:
            raise ValueError(
                f"heads_concat_per_layer has "
                f"{len(self.heads_concat_per_layer)} entries, need {nl}")
        if len(self.head_output_features_per_layer) != nl + 1:
            raise ValueError(
                f"head_output_features_per_layer has "
                f"{len(self.head_output_features_per_layer)} entries, need "
                f"num_layers+1={nl + 1} (entry 0 is the input width)")
        if len(self.add_skip_connection) != nl:
            raise ValueError(
                f"add_skip_connection has {len(self.add_skip_connection)} "
                f"entries, need {nl}")
        if self.head_output_features_per_layer[0] != \
                self.num_input_node_features:
            raise ValueError(
                "head_output_features_per_layer[0] "
                f"({self.head_output_features_per_layer[0]}) must equal "
                f"num_input_node_features ({self.num_input_node_features})")
        tail_heads = self.num_heads_per_layer[-1]
        tail_f = self.head_output_features_per_layer[-1]
        out_dim = (tail_heads * tail_f if self.heads_concat_per_layer[-1]
                   else tail_f)
        if out_dim != self.num_classes:
            raise ValueError(
                f"final layer produces {out_dim} features but "
                f"num_classes={self.num_classes}")

    def layer_configs(self) -> List[GATLayerConfig]:
        self.validate()
        heads = [1] + list(self.num_heads_per_layer)
        return [GATLayerConfig(
            in_features=heads[i] * self.head_output_features_per_layer[i],
            out_features=self.head_output_features_per_layer[i + 1],
            num_heads=heads[i + 1],
            concat=self.heads_concat_per_layer[i],
            dropout=self.dropout, bias=False,
            const_attention=self.const_attention,
            paper_faithful=self.paper_faithful, gatv2=self.gatv2)
            for i in range(self.num_layers)]

    def skip_dims(self) -> List[Optional[Tuple[int, int]]]:
        """Per layer: None if no skip, else the projection's (in, out);
        in == out means identity."""
        heads = [1] + list(self.num_heads_per_layer)
        dims: List[Optional[Tuple[int, int]]] = []
        for i in range(self.num_layers):
            if not self.add_skip_connection[i]:
                dims.append(None)
                continue
            dims.append((heads[i] * self.head_output_features_per_layer[i],
                         heads[i + 1]
                         * self.head_output_features_per_layer[i + 1]))
        return dims


def init_gat_model(cfg: GATConfig, *, seed: int = 0,
                   device="cuda") -> Params:
    """Random parameters from `seed` (xavier for W, W_r and a, torch
    Linear's default for skip projections), requiring grad, on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {"layers": [init_gat_layer(gen, lc, dev)
                                 for lc in cfg.layer_configs()],
                      "skips": []}
    for dims in cfg.skip_dims():
        if dims is None:
            continue
        skip_in, skip_out = dims
        if skip_in == skip_out:
            params["skips"].append({})
        else:
            lim = 1.0 / (skip_in ** 0.5)
            u = torch.rand((skip_in, skip_out), generator=gen, device=dev)
            params["skips"].append({"w": (2.0 * u - 1.0) * lim})
    for p in parameters(params):
        p.requires_grad_(True)
    return params


def parameters(params: Params) -> List[torch.Tensor]:
    """Every tensor of `params`, in a fixed order (layers, then skips;
    keys sorted)."""
    return [d[k] for group in ("layers", "skips") for d in params[group]
            for k in sorted(d)]


def gat_model_apply(params: Params, cfg: GATConfig, graph: Graph, *,
                    device="cuda",
                    generator: Optional[torch.Generator] = None,
                    training: bool = False,
                    backend: str = "kernel",
                    edge_axis=None,
                    edge_generator: Optional[torch.Generator] = None,
                    dst_owned: bool = False,
                    return_attention: bool = False):
    """The stack: [input dropout -> layer -> skip -> ELU between] x L; the
    logits, or (logits, [alpha of each layer]) where return_attention
    (gat_layer_apply).
    `graph` and `params` must lie on `device`; the CUDA default raises
    where there is no GPU. Only checked here: the caller resolves the
    device once (resolve_device, which also turns TF32 off), as
    Trainer.fit and the CLI do.

    edge_axis: the mesh Axis over which `graph` is an edge shard
    (parallel/sharding.shard_batch): every layer is the cut-neighbourhood
    layer (gat_layer_apply), the input dropout masks come from
    `generator`, which must be in the same state on every shard (x is
    replicated), and the attention dropout masks from `edge_generator`,
    the shard's own stream (the JAX package folds the shard index into
    the key); each layer's alpha is then the shard's edges'. dst_owned:
    `graph` is a rank's shard of a graph partitioned by destination
    (parallel/sharding.dst_shard) and every layer the dst-owned layer; the
    stack's node tables are varying (module doc): the skip projections
    take their weights through vary, and the logits, replicated in value,
    leave through owned_rows."""
    check_device(graph.device, device)
    dev = graph.device
    if training and cfg.dropout > 0.0 and (
            generator is None or (edge_axis is not None
                                  and edge_generator is None)):
        raise ValueError(
            "gat_model_apply(training=True) with dropout > 0 requires a "
            "generator (and an edge_generator under an edge axis)")
    heads = [1] + list(cfg.num_heads_per_layer)
    skip_dims = cfg.skip_dims()
    gdt = _gemm_dtype()
    x = graph.x.to(gdt)     # cast once: layer 0's dropout runs in gdt
    attention: List[torch.Tensor] = []
    skip_count = 0
    for i, lc in enumerate(cfg.layer_configs()):
        layer_input = x
        with profiling.span("gat.layer", i):
            if training and cfg.dropout > 0.0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=dev) >= cfg.dropout
                x = input_dropout(x, keep, cfg.dropout)
            x = gat_layer_apply(
                params["layers"][i], lc, x, graph.senders, graph.receivers,
                graph.edge_mask, graph.num_nodes,
                num_real_edges=graph.num_real_edges,
                src_order=graph.src_order, src_ptr=graph.src_ptr,
                dst_ptr=graph.dst_ptr, block_layout=graph.block_layout,
                tile_lo=graph.tile_lo, src_band=graph.src_band,
                generator=generator if edge_axis is None
                else edge_generator,
                training=training, backend=backend, gemm_dtype=gdt,
                edge_axis=edge_axis, dst_owned=dst_owned,
                return_attention=return_attention)
        if return_attention:
            x, alpha = x
            attention.append(alpha)
        if skip_dims[i] is not None:
            skip_p = params["skips"][skip_count]
            skip_count += 1
            skip_w = skip_p.get("w")
            if skip_w is not None and dst_owned:
                skip_w = C.vary(skip_w, edge_axis)
            skip_out = (layer_input if skip_w is None
                        else bf16_product(layer_input, skip_w, gdt))
            if cfg.heads_concat_per_layer[i]:
                x = x + skip_out
            else:
                # mean-fold the projection over heads
                x = x + skip_out.reshape(
                    -1, heads[i + 1],
                    cfg.head_output_features_per_layer[i + 1]).mean(dim=1)
        if i != cfg.num_layers - 1:
            x = F.elu(x)
    if dst_owned:
        x = C.owned_rows(x, edge_axis)
    return (x, attention) if return_attention else x


def calc_attention_norm(graph: Graph, attention: Sequence[torch.Tensor], *,
                        edge_axis=None, dst_owned: bool = False
                        ) -> torch.Tensor:
    """The attention regulariser (JAX models/gat.py calc_attention_norm,
    the reference's GATModel.py:189-234): the mean over layers of
    sum(|alpha * deg - 1| over the real edges) / E_real, deg the real
    in-degree of each edge's destination. edge_axis: `graph` is an edge
    shard over that axis; the degrees, E_real and the sums are completed
    by psum, so the result is the unsharded graph's, equal on every
    rank. dst_owned: `graph` is a dst-owned shard (dst_shard) and alpha
    the shard's; the degrees of its rows are complete on the shard (its
    dst_ptr covers them), E_real and the sums are psummed.

    The degrees are differences of the destinations' CSR offsets
    (Graph.dst_ptr, or computed from the sorted receivers) clipped to the
    real edges, which come first: exact counts, no scatter and no
    atomics. E_real is at least 1."""
    recv, n = graph.receivers, graph.num_nodes
    local = edge_axis is not None and dst_owned
    if local:
        n //= edge_axis.size
        recv = recv - edge_axis.index * n
    ptr = graph.dst_ptr
    if ptr is None:
        ptr = build_offsets(recv, n)
    real = graph.edge_mask.sum()
    degrees = torch.diff(torch.minimum(ptr.long(), real)).float()
    e_real = real.float()
    if edge_axis is not None:
        if not local:
            degrees = C.psum(degrees, edge_axis)
        e_real = C.psum(e_real, edge_axis)
    e_real = e_real.clamp(min=1.0)
    deg_per_edge = seg.gather_rows(degrees, recv)[:, None]
    mask = graph.edge_mask[:, None]
    total = 0.0
    for alpha in attention:
        dev = torch.where(mask, (alpha * deg_per_edge - 1.0).abs(), 0.0)
        s = dev.sum()
        if edge_axis is not None:
            s = C.psum(s, edge_axis)
        total = total + s / e_real
    return total / float(len(attention))
