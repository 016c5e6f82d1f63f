"""The layer stack of a plain reference and the readout of its first
steps of full-batch training (check.Readout), in plain torch, float32,
TF32 off, for a model form that gives its attention layer:

  layer(x, p, ld, b, att) -> the layer's output (N, NH*F) where it
  concatenates its heads, (N, F) where it averages them; p the layer's
  leaves, ld its inputs.LayerDims, b the reference.gat.Batch, att the
  attention multipliers (E, NH) or None.

The stack: input dropout, the layer, the skip connection (identity, or
x @ w; averaged over heads where the layer averages), ELU between layers.
The dropout masks and their order, the loss and Adam with L2 are
reference/gat.py's. reference/gat.py keeps its own copy of this stack and
readout, with its layer in place of `layer`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.check import Readout
from portbench.inputs import (DROPOUT, layer_dims, leaves, make_weights,
                              torch_seed)
from portbench.reference.gat import (B1, B2, EPS, Batch, loss, masks,
                                     precision)
from portbench.traffic import HostGraph


def forward(config: dict, params, b: Batch, step_masks,
            layer) -> torch.Tensor:
    """The logits of batch `b`."""
    rate = float(config["dropout"])
    x = b.x
    skips = iter(params["skips"])
    dims = layer_dims(config)
    for i, ld in enumerate(dims):
        layer_input = x
        keep, att = step_masks[i] if step_masks is not None else (None, None)
        if keep is not None:
            x = torch.where(keep, x / torch.tensor(1.0 - rate,
                                                   device=x.device),
                            torch.zeros_like(x))
        x = layer(x, params["layers"][i], ld, b, att)
        if ld.skip is not None:
            w = next(skips).get("w")
            skip = layer_input if w is None else layer_input @ w
            x = x + (skip if ld.concat
                     else skip.reshape(-1, ld.nh, ld.f).mean(dim=1))
        if i != len(dims) - 1:
            x = F.elu(x)
    return x


def readout(config: dict, graph: HostGraph, steps: int, seed: int,
            device, layer, *, control: bool = False,
            half_batch: bool = False) -> Readout:
    """The readout of the first `steps` steps of full-batch training on
    `graph`. control: TF32 products (the precision below the
    configuration's). half_batch: the loss over half of the batch."""
    params = make_weights(config, seed, device)
    ps = leaves(params)
    p0 = [p.clone() for p in ps]
    b = Batch(graph, device)
    lr, wd = float(config["learning_rate"]), float(config["l2_reg"])
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    losses, first = [], None
    for t, sm in enumerate(masks(config, b, steps,
                                 torch_seed(seed, DROPOUT), device), start=1):
        for p in ps:
            p.requires_grad_(True)
        with precision(control):
            value = loss(config, forward(config, params, b, sm, layer), b,
                         half_batch)
            grads = torch.autograd.grad(value, ps)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for p, g, mi, vi in zip(ps, grads, m, v):
                p.requires_grad_(False)
                g = g + wd * p
                mi.mul_(B1).add_(g, alpha=1.0 - B1)
                vi.mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = (vi.sqrt() / (1.0 - B2 ** t) ** 0.5).add_(EPS)
                p.addcdiv_(mi, denom, value=-lr / (1.0 - B1 ** t))
            if first is None:
                first = [float(mi.norm()) / (1.0 - B1) for mi in m]
    changes = [float((p - q).norm()) for p, q in zip(ps, p0)]
    return Readout(losses=losses, grads=first, changes=changes)
