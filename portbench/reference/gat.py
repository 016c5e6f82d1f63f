"""Plain reference of the GAT configurations: the model (Velickovic et
al., ICLR 2018, arXiv:1710.10903, in the form of the reference
implementation that the port keeps as its default), the task's loss and
Adam with L2, in plain torch, float32, TF32 off; and `readout`, the first
steps of full-batch training and what the check compares of them
(check.Readout).

The layer, per head k, for an edge j -> i (self-loops included):
  h = x @ W                                  (N, NH*F)
  the cross-head map a (NH*2F, NH) splits into a source and a destination
  half; e_ji = s_src[j] + s_dst[i] with s = h @ half; the global max over
  every real edge and head is subtracted BEFORE LeakyReLU (slope 0.01);
  alpha = exp(e) / (sum over i's edges + 1e-8)
  attention dropout multiplies alpha; out_i = sum_j alpha_ji h_j
  heads concatenated, or averaged (the output layer)
The stack: input dropout, layer, skip connection (identity, or x @ w;
averaged over heads where the layer averages), ELU between layers. The
paper's own form (a per-head a, LeakyReLU 0.2, a per-destination softmax)
is not here: no configuration runs it.

Dropout. The port draws its masks from the run's dropout generator, in
this order each step and layer: the input mask, uniform (N_pad, F_in) >=
rate, then the attention mask, uniform (E_pad, NH) >= rate scaled by
1 / (1 - rate), over the edges in the port's canonical order (the edges
without self-loops, then one self-loop a node, stably sorted by
destination) and its padded sizes (nodes + 1 sink rounded up to 128;
edges rounded up to 128). `masks` draws the same uniforms from a
generator seeded as the run's, and the model uses their rows of the real
nodes and edges.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.check import Readout
from portbench.inputs import (DROPOUT, LayerDims, layer_dims, leaves,
                              make_weights, torch_seed)
from portbench.traffic import HostGraph

PAD = 128
B1, B2, EPS = 0.9, 0.999, 1e-8      # Adam


def round_up(n: int, multiple: int = PAD) -> int:
    return max(multiple, -(-n // multiple) * multiple)


class Batch:
    """The full batch as the reference computes it: the graph with
    self-loops added and edges stably sorted by destination, on `device`;
    the loss's node mask; and the padded sizes the port's masks are drawn
    over."""

    def __init__(self, g: HostGraph, device):
        n = g.num_nodes
        keep = g.senders != g.receivers
        loop = np.arange(n, dtype=np.int64)
        s = np.concatenate([g.senders[keep], loop])
        r = np.concatenate([g.receivers[keep], loop])
        order = np.argsort(r, kind="stable")
        self.n, self.e = n, int(s.shape[0])
        self.n_pad = round_up(n + 1)
        self.e_pad = round_up(self.e)
        self.senders = torch.from_numpy(s[order]).to(device)
        self.receivers = torch.from_numpy(r[order]).to(device)
        self.x = torch.from_numpy(g.x).to(device)
        self.y = torch.from_numpy(g.y).to(device)
        self.loss_mask = torch.from_numpy(g.train_mask).to(device)


def masks(config: dict, b: Batch, steps: int, seed_value: int,
          device) -> Iterator[Optional[List[Tuple[torch.Tensor,
                                                   torch.Tensor]]]]:
    """Each of `steps` steps' (input keep mask, attention multipliers) per
    layer, as the port draws them; None per step without dropout."""
    rate = float(config["dropout"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_value)
    for _ in range(steps):
        if rate == 0.0:
            yield None
            continue
        step = []
        for ld in layer_dims(config):
            keep = torch.rand((b.n_pad, ld.fin), generator=gen,
                              device=device) >= rate
            att = (torch.rand((b.e_pad, ld.nh), generator=gen,
                              device=device) >= rate).float() / (1.0 - rate)
            step.append((keep[:b.n], att[:b.e]))
        yield step


def _layer(x, p, ld: LayerDims, b: Batch, att):
    nh, f = ld.nh, ld.f
    s, r = b.senders, b.receivers
    h = x @ p["W"]
    hv = h.view(-1, nh, f)
    a = p["a"].reshape(nh, 2, f, nh)
    s_src = h @ a[:, 0].reshape(nh * f, nh)
    s_dst = h @ a[:, 1].reshape(nh * f, nh)
    logit = s_src[s] + s_dst[r]
    ex = torch.exp(F.leaky_relu(logit - logit.max(), 0.01))
    den = torch.zeros((b.n, nh), device=x.device).index_add(0, r, ex)
    alpha = ex / (den[r] + 1e-8)
    if att is not None:
        alpha = alpha * att
    out = torch.zeros((b.n, nh, f), device=x.device).index_add(
        0, r, hv[s] * alpha[:, :, None])
    return out.reshape(b.n, nh * f) if ld.concat else out.mean(dim=1)


def forward(config: dict, params, b: Batch, step_masks) -> torch.Tensor:
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
        x = _layer(x, params["layers"][i], ld, b, att)
        if ld.skip is not None:
            w = next(skips).get("w")
            skip = layer_input if w is None else layer_input @ w
            x = x + (skip if ld.concat
                     else skip.reshape(-1, ld.nh, ld.f).mean(dim=1))
        if i != len(dims) - 1:
            x = F.elu(x)
    return x


def loss(config: dict, logits: torch.Tensor, b: Batch,
         half_batch: bool = False) -> torch.Tensor:
    """The task's loss, the mean cross-entropy over the batch's loss mask
    ("planetoid"). half_batch: only the first half of the masked nodes,
    the mean over them (a fault the check must catch)."""
    if config["task"] != "planetoid":
        raise ValueError(f"unknown task {config['task']!r}")
    mask = b.loss_mask
    if half_batch:
        idx = torch.nonzero(mask)[:, 0]
        mask = torch.zeros_like(mask)
        mask[idx[: idx.shape[0] // 2]] = True
    nll = -F.log_softmax(logits, dim=-1).gather(
        1, b.y.long()[:, None])[:, 0]
    return nll[mask].mean()


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (the reference), or on (the
    control: the next precision below the configuration's)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def readout(config: dict, graph: HostGraph, steps: int, seed: int,
            device, *, control: bool = False,
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
            value = loss(config, forward(config, params, b, sm), b,
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
