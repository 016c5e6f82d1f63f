"""GAT layer and model stack in PyTorch, parameters as plain dicts of tensors.

Counterpart of gat_pytorch_tpu/models/gat.py, keeping its parameter
layout so the two packages compute the same function from the same
numbers (utils/convert.py carries JAX parameters over):
  W: (F_in, NH*F_out), right-multiplied;
  a: (NH*2F, NH), the reference's cross-head attention map
     (or (NH, 2F) per head with paper_faithful);
  bias: (NH*F,) when enabled; skips: {} (identity) or {"w": (in, out)}.

Reference quirks kept (paper_faithful=False, the default): cross-head
`a`, a global max-cap on the raw logits BEFORE LeakyReLU, slope 0.01 with
torch's gradient convention at 0, and +1e-8 in the softmax denominator.

Two layer paths, chosen by `backend`:
  "kernel"  a whole-attention op: the CUDA kernels on a CUDA graph, their
            plain versions on a CPU graph. paper_faithful,
            const_attention and a graph without `src_order` take the
            table op (ops/cuda/table_attention.py, PATH_TRACE
            "v4_table"), which gets its edge logits from plain torch
            (their gathers through ops/segment.gather_rows_sorted_grad,
            so that the step is reproducible bit for bit);
            otherwise a graph that carries a block layout
            (canonicalize(..., src_windows=True)) takes the windowed op
            (ops/cuda/window_attention.py, "v7"), one whose layout has a
            remainder (hybrid=True) the windowed parts op over the
            in-window edges plus the v5 parts op over the remainder
            ("v7_hybrid"), and any other the v5 op
            (ops/cuda/v5_attention.py, "v5"): the counterparts of the JAX
            "pallas" v4, v7, hybrid and v5 branches. The JAX package also
            gates v7 on models of the TPU's VMEM and MXU cost, v5 on 4096
            edges, the sorted-gradient gathers on 200,000 edges and the
            hybrid remainder's kernel on 65,536 edges (below, XLA segment
            ops); those gates price the TPU's launches, do not apply to
            this card and are not ported.
  "segment" plain torch segment ops (ops/segment.py), the counterpart of
            the JAX "xla" path and the reference the kernel path is held
            against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..graph.graph import BlockLayout, Graph
from ..ops import segment as seg
from ..ops.cuda import table_attention as v4
from ..ops.cuda import v5_attention as v5
from ..ops.cuda import window_attention as v7
from ..utils.device import check_device, resolve_device

Params = Dict[str, list]
BACKENDS = ("kernel", "segment")

# Which layer path each gat_layer_apply call took, one entry per call
# (tests clear and read it, as the JAX package's PATH_TRACE).
PATH_TRACE: List[str] = []


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
    negative_slope: Optional[float] = None  # default depends on faithfulness

    @property
    def slope(self) -> float:
        if self.negative_slope is not None:
            return self.negative_slope
        return 0.2 if self.paper_faithful else 0.01


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
    if not cfg.const_attention:
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
                 src_order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E, NH) edge logits after LeakyReLU, from node scores: zeros under
    const_attention, per-head a = [a_l || a_r] scores under paper_faithful,
    else the cross-head scores with the global max-cap BEFORE LeakyReLU.
    With src_order (the stable sender sort of the edges) the two score
    gathers take the sorted-gradient form, whose backward has a fixed
    order of sums; without it, plain gathers (the segment path)."""
    nh, f = cfg.num_heads, cfg.out_features
    n = h_flat.shape[0]
    if cfg.const_attention:
        return torch.zeros((senders.shape[0], nh), dtype=h_flat.dtype,
                           device=h_flat.device)
    if cfg.paper_faithful:
        h = h_flat.reshape(-1, nh, f)
        a_l, a_r = params["a"][:, :f], params["a"][:, f:]
        s_src = torch.einsum("nhf,hf->nh", h, a_l)
        s_dst = torch.einsum("nhf,hf->nh", h, a_r)
    else:
        a_src, a_dst = _split_attention_map(params["a"], nh, f)
        s_both = h_flat @ torch.cat([a_src, a_dst], dim=1)
        s_src, s_dst = s_both[:, :nh], s_both[:, nh:]
    if src_order is None:
        logits = seg.gather_rows(s_src, senders) + seg.gather_rows(
            s_dst, receivers)
    else:   # the receivers are sorted as they are
        logits = (seg.gather_rows_sorted_grad(s_src, senders, n, src_order)
                  + seg.gather_rows_sorted_grad(s_dst, receivers, n))
    if not cfg.paper_faithful:
        masked = torch.where(edge_mask[:, None], logits,
                             torch.full_like(logits, float("-inf")))
        logits = logits - masked.max()
    # torch's LeakyReLU gradient at exactly 0 is the slope; the capped
    # argmax logit sits at 0, so the convention matters here
    return F.leaky_relu(logits, cfg.slope)


def gat_layer_apply(params, cfg: GATLayerConfig, x: torch.Tensor,
                    senders: torch.Tensor, receivers: torch.Tensor,
                    edge_mask: torch.Tensor, num_nodes: int, *,
                    num_real_edges: Optional[int] = None,
                    src_order: Optional[torch.Tensor] = None,
                    block_layout: Optional[BlockLayout] = None,
                    generator: Optional[torch.Generator] = None,
                    training: bool = False,
                    backend: str = "kernel") -> torch.Tensor:
    """One GAT layer on a canonicalised graph (self-loops, dst-sorted,
    padded to a sink node, real edges first). num_real_edges defaults to
    edge_mask.sum() (one host sync); Graph.num_real_edges avoids it.
    block_layout (Graph.block_layout) puts the kernel path on the windowed
    op, or on the hybrid of the windowed and the v5 parts ops where the
    layout has a remainder; the table op and the segment path ignore it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    nh, f = cfg.num_heads, cfg.out_features
    e = senders.shape[0]
    # x @ W is a plain product outside any kernel, in full float32
    # (utils/device.resolve_device turns TF32 off)
    h_flat = x @ params["W"]
    dropping = training and cfg.dropout > 0.0
    given_logits = cfg.paper_faithful or cfg.const_attention

    if backend == "kernel" and not given_logits and (
            block_layout is not None or src_order is not None):
        a_src, a_dst = _split_attention_map(params["a"], nh, f)
        # one product gives both score tables: s_dst for the op, s_src
        # only for the score bound B (any bound >= max raw logit; it
        # cancels algebraically in the op's epilogue, so no gradient)
        s_both = h_flat @ torch.cat([a_src, a_dst], dim=1)
        s_dst = s_both[:, nh:]
        bound = (s_both[:, :nh].max() + s_dst.max()).detach()
        # the mask is drawn in the order of the op's edge list: the
        # layout's slots (E7, nh) or the dst-sorted edges (E, nh)
        slots = e if block_layout is None else block_layout.num_slots
        drop = (_attention_dropout((slots, nh), cfg.dropout, generator,
                                   x.device) if dropping else None)
        if block_layout is not None and block_layout.rem_send is not None:
            # The split-locality layout: the windowed parts op over the
            # in-window edges, the v5 parts op over the remainder. num
            # and den add over any partition of the edges (both sum
            # exp(slope*(raw - B)) terms), the global cap' is the larger
            # of the two (torch.maximum sends its cotangent to the
            # winner's argmax chain), and one epilogue in plain torch
            # normalises under autograd. The second mask, the remainder's
            # (rem_E, nh), is drawn after the layout's (E7, nh).
            PATH_TRACE.append("v7_hybrid")
            bl = block_layout
            drop_rem = (_attention_dropout(
                (bl.rem_send.shape[0], nh), cfg.dropout, generator, x.device)
                if dropping else None)
            s_dst_eff = s_dst - bound
            num1, den1, cap1, _ = v7.v7_sweep1_parts(
                h_flat, a_src, s_dst_eff, drop, bl, num_nodes, nh, f, 1e-8,
                cfg.slope)
            # The JAX package sends a remainder of up to 65,536 edges
            # through XLA segment ops instead, a gate on the TPU's launch
            # cost; here the remainder always takes the kernel.
            num2, den2, cap2, _ = v5.v5_sweep1_parts(
                h_flat, a_src, s_dst_eff, drop_rem, bl.rem_send,
                bl.rem_recv, bl.rem_order, bl.rem_e, num_nodes, nh, f, 1e-8,
                cfg.slope, dst_ptr=bl.rem_dst_ptr, src_ptr=bl.rem_src_ptr)
            out, _ = v5.normalise(num1 + num2, den1 + den2,
                                  torch.maximum(cap1, cap2), 1e-8, cfg.slope,
                                  nh)
        elif block_layout is not None:
            # The JAX package takes v7 only where its VMEM and MXU-cost
            # gates pass and from 4096 edges; here every graph that
            # carries a block layout does.
            PATH_TRACE.append("v7")
            out = v7.fused_gat_window_v7(
                h_flat, a_src, s_dst, drop, block_layout, bound, num_nodes,
                nh, f, 1e-8, cfg.slope)
        else:
            # The JAX package takes v5 from 4096 edges and the table op
            # below that: a gate on the TPU's launch cost, not ported.
            # Every edge count runs v5 here.
            PATH_TRACE.append("v5")
            e_real = (int(edge_mask.sum()) if num_real_edges is None
                      else num_real_edges)
            out = v5.fused_gat_table_autocap(
                h_flat, a_src, s_dst, drop, senders, receivers, src_order,
                e_real, bound, num_nodes, nh, f, 1e-8, cfg.slope)
        return _head_combine(out, cfg, num_nodes, params)

    if backend == "kernel" and src_order is None:
        # a stable sort keeps the order of every sum over senders fixed
        # (the table op's backward would sort them itself otherwise)
        src_order = torch.argsort(senders, stable=True).to(torch.int32)
    logits = _edge_logits(params, cfg, h_flat, senders, receivers, edge_mask,
                          src_order if backend == "kernel" else None)
    eps = 0.0 if cfg.paper_faithful else 1e-8

    if backend == "kernel":
        # the table op: paper_faithful, const_attention, and graphs
        # without src_order (the op then derives the order itself)
        PATH_TRACE.append("v4_table")
        pad = torch.full_like(logits, v4.NEG_INF)
        logits = torch.where(edge_mask[:, None], logits, pad)
        if cfg.paper_faithful:
            # the per-destination max, detached (softmax is invariant to
            # it), is subtracted here; the op then only needs exp
            seg_max = seg.segment_max(logits, receivers, num_nodes).detach()
            seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                                  torch.zeros_like(seg_max))
            logits = torch.where(
                edge_mask[:, None],
                logits - seg.gather_rows(seg_max, receivers), pad)
        drop = (_attention_dropout((e, nh), cfg.dropout, generator, x.device)
                if dropping else None)
        out = v4.fused_segment_attention_table(
            logits, h_flat, senders, receivers, drop, src_order, num_nodes,
            nh, f, eps, num_real_edges)
        return _head_combine(out, cfg, num_nodes, params)

    PATH_TRACE.append("segment")
    alpha = seg.segment_softmax(
        logits, receivers, num_nodes, edge_mask=edge_mask, eps=eps,
        subtract_segment_max=cfg.paper_faithful)
    if dropping:
        alpha = alpha * _attention_dropout(alpha.shape, cfg.dropout,
                                           generator, x.device)
    src_feats = seg.gather_rows(h_flat.reshape(num_nodes, nh, f), senders)
    out = seg.segment_sum(src_feats * alpha[:, :, None], receivers,
                          num_nodes)
    return _head_combine(out, cfg, num_nodes, params)


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

    def validate(self) -> None:
        """Shape-consistency checks; raises ValueError."""
        nl = self.num_layers
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
            paper_faithful=self.paper_faithful)
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
    """Random parameters from `seed` (xavier for W and a, torch Linear's
    default for skip projections), requiring grad, on `device`."""
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
                    backend: str = "kernel") -> torch.Tensor:
    """The stack: [input dropout -> layer -> skip -> ELU between] x L.
    `graph` and `params` must lie on `device`; the CUDA default raises
    where there is no GPU. Only checked here: the caller resolves the
    device once (resolve_device, which also turns TF32 off), as
    Trainer.fit and the CLI do."""
    check_device(graph.device, device)
    dev = graph.device
    if training and cfg.dropout > 0.0 and generator is None:
        raise ValueError(
            "gat_model_apply(training=True) with dropout > 0 requires a "
            "generator")
    heads = [1] + list(cfg.num_heads_per_layer)
    skip_dims = cfg.skip_dims()
    x = graph.x
    skip_count = 0
    for i, lc in enumerate(cfg.layer_configs()):
        layer_input = x
        if training and cfg.dropout > 0.0:
            keep = torch.rand(x.shape, generator=generator,
                              device=dev) >= cfg.dropout
            x = torch.where(keep, x / (1.0 - cfg.dropout),
                            torch.zeros_like(x))
        x = gat_layer_apply(
            params["layers"][i], lc, x, graph.senders, graph.receivers,
            graph.edge_mask, graph.num_nodes,
            num_real_edges=graph.num_real_edges, src_order=graph.src_order,
            block_layout=graph.block_layout, generator=generator,
            training=training, backend=backend)
        if skip_dims[i] is not None:
            skip_p = params["skips"][skip_count]
            skip_count += 1
            skip_out = (layer_input if "w" not in skip_p
                        else layer_input @ skip_p["w"])
            if cfg.heads_concat_per_layer[i]:
                x = x + skip_out
            else:
                # mean-fold the projection over heads
                x = x + skip_out.reshape(
                    -1, heads[i + 1],
                    cfg.head_output_features_per_layer[i + 1]).mean(dim=1)
        if i != cfg.num_layers - 1:
            x = F.elu(x)
    return x
