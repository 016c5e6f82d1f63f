"""Masked losses and metrics (counterpart of
gat_pytorch_tpu/train/metrics.py). Padded nodes never contribute: every
function takes a node mask. All of them run on the device without a host
synchronisation."""

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


def micro_f1(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Micro-averaged F1 with pred = logits > 0 (sklearn
    f1_score(average='micro')). labels: (N, C) multi-hot."""
    pred = (logits > 0) & mask[:, None]
    true = (labels > 0.5) & mask[:, None]
    tp = (pred & true).sum()
    fp = (pred & ~true).sum()
    fn = (~pred & true).sum()
    return 2 * tp / (2 * tp + fp + fn).clamp(min=1)


def balanced_accuracy_predweighted(logits: torch.Tensor,
                                   labels: torch.Tensor, mask: torch.Tensor,
                                   prop_pos: float) -> torch.Tensor:
    """The reference's PATTERN metric: sklearn balanced_accuracy_score
    with sample weights keyed on the *predicted* class, w = 1/p if
    pred == 1 else 1/(1-p) (weighting by the prediction and not by the
    ground truth is the reference's own idiosyncrasy, kept).

    balanced accuracy = mean over the true classes c present in y of
        recall_c = sum(w * [y==c][pred==c]) / sum(w * [y==c])."""
    pred = (logits > 0).float()
    y = labels.float()
    w = ((1.0 / prop_pos) * pred + (1.0 / (1.0 - prop_pos)) * (1.0 - pred)
         ) * mask.float()
    recalls, present = [], []
    for cls in (0.0, 1.0):
        in_cls = torch.where(y == cls, w, torch.zeros_like(w)).sum()
        hit = torch.where((y == cls) & (pred == cls), w,
                          torch.zeros_like(w)).sum()
        here = (in_cls > 0).float()
        recalls.append(hit / in_cls.clamp(min=1e-12) * here)
        present.append(here)
    return (recalls[0] + recalls[1]) / (present[0] + present[1]).clamp(
        min=1.0)


def masked_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor,
                           pos_weight: float = 1.0) -> torch.Tensor:
    """Mean BCE-with-logits over the masked rows; `pos_weight` scales the
    positive term (PATTERN: 1/0.1765; PPI: 1). The stable log-sigmoid
    form of torch's BCEWithLogitsLoss. A (N, C) input with a (N,) mask
    averages over the masked rows times C."""
    y = labels.float()
    per = -(pos_weight * y * F.logsigmoid(logits)
            + (1.0 - y) * F.logsigmoid(-logits))
    if per.dim() == 2 and mask.dim() == 1:
        per = per * mask[:, None]
        count = mask.sum() * per.shape[1]
    else:
        per = per * mask
        count = mask.sum()
    return per.sum() / count.clamp(min=1)
