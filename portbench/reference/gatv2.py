"""Plain reference of GATv2's dynamic attention (Brody, Alon and Yahav,
How Attentive are Graph Attention Networks?, ICLR 2022, arXiv:2105.14491,
eqs. 7-8; PyG's and DGL's GATv2Conv with share_weights=False and no
bias), its loss and Adam with L2, in plain torch, float32, TF32 off; and
`readout`, the first steps of full-batch training and what the check
compares of them (check.Readout).

The layer, per head k, for an edge j -> i (self-loops included):
  xl = x @ W, xr = x @ W_r                      (N, NH*F) each
  e_ij = a_k . LeakyReLU(xl_j + xr_i), slope 0.2, a (NH, F)
  alpha_ij = softmax over i's edges of e_ij, the per-destination maximum
  subtracted first (softmax is invariant to it), no epsilon
  attention dropout multiplies alpha after the normalisation;
  out_i = sum_j alpha_ij xl_j; heads concatenated, or averaged (the output
  layer)
The whole layer is formed edge by edge: at ogbn-arxiv size its (E, NH*F)
tensors take some 16 GB of the card, after the port's state is freed.
The stack and the readout are reference/stack.py's; the dropout masks
and their order (the input mask, then the attention mask, each step and
layer), the loss and the optimiser reference/gat.py's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.check import Readout
from portbench.inputs import LayerDims
from portbench.reference import stack
from portbench.reference.gat import Batch
from portbench.traffic import HostGraph

SLOPE = 0.2


def _layer(x, p, ld: LayerDims, b: Batch, att):
    nh, f = ld.nh, ld.f
    s, r = b.senders, b.receivers
    xl = (x @ p["W"]).view(-1, nh, f)
    xr = (x @ p["W_r"]).view(-1, nh, f)
    logit = (F.leaky_relu(xl[s] + xr[r], SLOPE) * p["a"]).sum(-1)
    top = torch.full((b.n, nh), float("-inf"), device=x.device
                     ).scatter_reduce(0, r[:, None].expand(-1, nh),
                                      logit.detach(), "amax")
    ex = torch.exp(logit - top[r])
    den = torch.zeros((b.n, nh), device=x.device).index_add(0, r, ex)
    alpha = ex / den[r]
    if att is not None:
        alpha = alpha * att
    out = torch.zeros((b.n, nh, f), device=x.device).index_add(
        0, r, xl[s] * alpha[:, :, None])
    return out.reshape(b.n, nh * f) if ld.concat else out.mean(dim=1)


def forward(config: dict, params, b: Batch, step_masks) -> torch.Tensor:
    """The logits of batch `b` (stack.forward with GATv2's layer)."""
    return stack.forward(config, params, b, step_masks, _layer)


def readout(config: dict, graph: HostGraph, steps: int, seed: int,
            device, **mode) -> Readout:
    """stack.readout with GATv2's layer."""
    return stack.readout(config, graph, steps, seed, device, _layer, **mode)
