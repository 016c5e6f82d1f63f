"""Optimizer and early stopping.

Counterpart of gat_pytorch_tpu/train/optim.py. `adam_l2` is
torch.optim.Adam(lr, weight_decay): the L2 term is added to the gradient
before the moment updates, which is what the JAX package's optax chain
add_decayed_weights -> scale_by_adam -> scale_by_learning_rate computes.
ReduceLROnPlateau (PATTERN only) waits for ROADMAP queue A item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


def adam_l2(params: Iterable[torch.Tensor], learning_rate: float,
            weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> torch.optim.Adam:
    """torch.optim.Adam with L2 weight decay."""
    return torch.optim.Adam(list(params), lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


@dataclasses.dataclass
class EarlyStopping:
    """Lightning EarlyStopping(monitor, patience, mode='min') semantics
    (the reference's patience is 100, min_delta 0)."""
    patience: int = 100
    min_delta: float = 0.0
    best: float = float("inf")
    wait: int = 0

    def update(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
        return self.wait >= self.patience
