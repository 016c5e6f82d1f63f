"""Task heads: per-dataset loss and metrics over (logits, Graph).

Counterpart of gat_pytorch_tpu/train/tasks.py for the Planetoid datasets.
PPI and PATTERN wait for ROADMAP queue A item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..data.datasets import PLANETOID
from ..graph.graph import Graph
from . import metrics as M


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    # loss(logits, graph, phase) -> scalar
    loss: Callable[[torch.Tensor, Graph, str], torch.Tensor]
    # metrics(logits, graph, phase) -> dict of scalars
    metrics: Callable[[torch.Tensor, Graph, str], Dict[str, torch.Tensor]]
    # coefficient on the attention regulariser (not ported: must be 0)
    attention_coef: float = 0.0


def _phase_mask(graph: Graph, phase: str) -> torch.Tensor:
    m = {"train": graph.train_mask, "val": graph.val_mask,
         "test": graph.test_mask}[phase]
    if m is None:
        return graph.node_mask
    return m & graph.node_mask


def planetoid_task(attention_reward: float = 0.0) -> Task:
    """Masked cross-entropy and accuracy."""
    if attention_reward != 0.0:
        raise NotImplementedError(
            "the attention regulariser needs return_attention "
            "(ROADMAP queue A item 3, not ported)")

    def loss(logits, graph, phase):
        return M.masked_cross_entropy(logits, graph.y,
                                      _phase_mask(graph, phase))

    def mets(logits, graph, phase):
        m = _phase_mask(graph, phase)
        return {"loss": M.masked_cross_entropy(logits, graph.y, m),
                "acc": M.masked_accuracy(logits, graph.y, m)}

    return Task(name="planetoid", loss=loss, metrics=mets,
                attention_coef=attention_reward)


def make_task(dataset: str, *, attention_reward: float = 0.0) -> Task:
    if dataset in PLANETOID:
        return planetoid_task(attention_reward)
    if dataset in ("PPI", "PATTERN"):
        raise NotImplementedError(
            f"{dataset} is not ported yet (ROADMAP queue A item 9)")
    raise ValueError(f"unknown dataset {dataset!r}")
