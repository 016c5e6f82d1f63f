"""Optimizer, learning-rate schedule and early stopping.

Counterpart of gat_pytorch_tpu/train/optim.py. `adam_l2` is
torch.optim.Adam(lr, weight_decay): the L2 term is added to the gradient
before the moment updates, which is what the JAX package's optax chain
add_decayed_weights -> scale_by_adam -> scale_by_learning_rate computes.
`ReduceLROnPlateau` is the JAX package's host-side state machine (torch's
scheduler of that name in mode 'min' with the relative threshold; PATTERN
trains with factor 0.5, patience 5, min_lr 1e-6); it is kept as that plain
state machine, fed one validation loss per epoch, so both packages halve
the rate at the same epoch.
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


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group mid-run."""
    for group in opt.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Plateau schedule (mode 'min', threshold_mode 'rel')."""
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-6
    threshold: float = 1e-4
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed one validation metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad = 0
        return lr


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
