"""The naive layer: a second, unoptimised GAT layer, the runtime oracle.

Counterpart of gat_pytorch_tpu/models/naive.py. The reference can build
its network from PyG's GATConv instead of its own layer by one config
switch, and uses the flip as a correctness oracle; this layer is that
second implementation: a direct transcription of the layer's documented
behaviour (gather both endpoints, concatenate, apply `a` to the pair
tensor, global cap, LeakyReLU, unsorted segment softmax, weighted
scatter) in plain torch with unsorted index_add sums. It shares nothing
with models/gat.py's score tables, sorted sums and kernel ops, so a
mismatch between the two localises a fault. `backend="naive"` selects it
(gat.gat_layer_apply, Trainer(backend=...); cli: --layer_type naive). It
runs on any device and launches no kernel of this repository; its sums
use atomics on the card, so it is not held to equal bits run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import segment as seg


def gat_layer_naive(params, cfg, x: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, edge_mask: torch.Tensor,
                    num_nodes: int, *,
                    generator: Optional[torch.Generator] = None,
                    training: bool = False,
                    return_attention: bool = False):
    """One GAT layer (cfg: gat.GATLayerConfig) on a canonicalised graph;
    returns the (N, out) output, with the (E, NH) attention coefficients
    (before dropout, 0 on padding edges) where return_attention. The
    attention dropout mask is drawn from `generator` in the coefficients'
    shape."""
    nh, f = cfg.num_heads, cfg.out_features
    e = senders.shape[0]
    h = (x.float() @ params["W"]).reshape(num_nodes, nh, f)
    hs = h.index_select(0, senders.long())                  # (E, NH, F)
    hd = h.index_select(0, receivers.long())
    real = edge_mask[:, None]

    if cfg.const_attention:
        logits = torch.zeros((e, nh), dtype=h.dtype, device=h.device)
    elif cfg.paper_faithful:
        a = params["a"]                                      # (NH, 2F)
        logits = ((hs * a[None, :, :f]).sum(-1)
                  + (hd * a[None, :, f:]).sum(-1))
        logits = torch.where(logits > 0, logits, cfg.slope * logits)
    else:
        pairs = torch.cat([hs, hd], dim=-1).reshape(e, nh * 2 * f)
        logits = pairs @ params["a"]                         # (E, NH)
        cap = torch.where(real, logits,
                          torch.full_like(logits, float("-inf"))).max()
        pre = logits - cap
        logits = torch.where(pre > 0, pre, cfg.slope * pre)

    masked = torch.where(real, logits, torch.full_like(logits, float("-inf")))
    if cfg.paper_faithful:
        seg_max = seg.segment_max(masked, receivers, num_nodes)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros_like(seg_max))
        masked = torch.where(real, masked - seg.gather_rows(seg_max,
                                                            receivers),
                             torch.full_like(masked, float("-inf")))
    ex = torch.where(real, torch.exp(masked), torch.zeros_like(masked))
    denom = seg.gather_rows(seg.segment_sum(ex, receivers, num_nodes),
                            receivers)
    eps = 0.0 if cfg.paper_faithful else 1e-8
    alpha = ex / torch.where(denom + eps > 0, denom + eps,
                             torch.ones_like(denom))

    alpha_drop = alpha
    if training and cfg.dropout > 0.0:
        if generator is None:
            raise ValueError("a generator is required for attention dropout")
        keep = torch.rand(alpha.shape, generator=generator,
                          device=alpha.device) >= cfg.dropout
        alpha_drop = torch.where(keep, alpha / (1.0 - cfg.dropout),
                                 torch.zeros_like(alpha))

    out = seg.segment_sum(hs * alpha_drop[:, :, None], receivers, num_nodes)
    out = (out.reshape(num_nodes, nh * f) if cfg.concat
           else out.mean(dim=1))
    if cfg.bias:
        out = out + params["bias"]
    return (out, alpha) if return_attention else out
