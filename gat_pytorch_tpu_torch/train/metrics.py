"""Masked losses and metrics (counterpart of gat_pytorch_tpu/train/metrics.py
for the Planetoid task). Padded nodes never contribute: every function
takes a node mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fraction of correctly argmax-classified nodes within `mask`."""
    correct = (logits.argmax(dim=-1) == labels) & mask
    return correct.sum() / mask.sum().clamp(min=1)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the masked nodes (torch's
    CrossEntropyLoss(reduction='mean') on the mask-indexed rows)."""
    nll = -F.log_softmax(logits, dim=-1).gather(
        1, labels.long()[:, None])[:, 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1)
