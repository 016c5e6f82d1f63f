"""Plain reference of the GAT paper's own attention form (Velickovic et
al., ICLR 2018, arXiv:1710.10903, section 2.1, eqs. 1-4), its loss and
Adam with L2, in plain torch, float32, TF32 off; and `readout`, the first
steps of full-batch training and what the check compares of them
(check.Readout).

The layer, per head k, for an edge j -> i (self-loops included):
  h = x @ W                                  (N, NH*F)
  e_ij = LeakyReLU(a_k . [W h_j || W h_i]), slope 0.2, with the per-head
  a (NH, 2F) in the port's layout (forms/gat_paper.py): a[k, :F] scores
  the sender j, a[k, F:] the destination i (the paper writes
  a^T [W h_i || W h_j]; the same function, the halves named the other way)
  alpha_ij = softmax over i's edges of e_ij, the per-destination maximum
  subtracted first (softmax is invariant to it), no epsilon
  attention dropout multiplies alpha after the normalisation;
  out_i = sum_j alpha_ij h_j; heads concatenated, or averaged (the output
  layer)
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
    hv = (x @ p["W"]).view(-1, nh, f)
    a = p["a"]
    s_src = (hv * a[None, :, :f]).sum(-1)
    s_dst = (hv * a[None, :, f:]).sum(-1)
    logit = F.leaky_relu(s_src[s] + s_dst[r], SLOPE)
    top = torch.full((b.n, nh), float("-inf"), device=x.device
                     ).scatter_reduce(0, r[:, None].expand(-1, nh),
                                      logit.detach(), "amax")
    ex = torch.exp(logit - top[r])
    den = torch.zeros((b.n, nh), device=x.device).index_add(0, r, ex)
    alpha = ex / den[r]
    if att is not None:
        alpha = alpha * att
    out = torch.zeros((b.n, nh, f), device=x.device).index_add(
        0, r, hv[s] * alpha[:, :, None])
    return out.reshape(b.n, nh * f) if ld.concat else out.mean(dim=1)


def forward(config: dict, params, b: Batch, step_masks) -> torch.Tensor:
    """The logits of batch `b` (stack.forward with the paper's layer)."""
    return stack.forward(config, params, b, step_masks, _layer)


def readout(config: dict, graph: HostGraph, steps: int, seed: int,
            device, **mode) -> Readout:
    """stack.readout with the paper's layer."""
    return stack.readout(config, graph, steps, seed, device, _layer, **mode)
