"""Task heads: per-dataset loss and metrics over (logits, Graph).

Counterpart of gat_pytorch_tpu/train/tasks.py: a `Task` bundles the loss,
the metric set and which node mask applies in each phase. The attention
regulariser (a non-zero `attention_coef`) needs `return_attention`, which
is not ported (ROADMAP: return_attention and the attention regulariser),
so a non-zero coefficient raises.
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
    # squeeze logits (N, 1) -> (N,) before loss and metrics (PATTERN)
    squeeze_output: bool = False


PATTERN_PROP_POS = 0.1765  # the positive fraction of the PATTERN labels


def _refuse_regulariser(coef: float) -> None:
    if coef != 0.0:
        raise NotImplementedError(
            "the attention regulariser needs return_attention "
            "(ROADMAP: return_attention and the attention regulariser, not "
            "ported)")


def _phase_mask(graph: Graph, phase: str) -> torch.Tensor:
    """Transductive phase mask; inductive graphs have none and use
    node_mask in every phase."""
    m = {"train": graph.train_mask, "val": graph.val_mask,
         "test": graph.test_mask}[phase]
    if m is None:
        return graph.node_mask
    return m & graph.node_mask


def planetoid_task(attention_reward: float = 0.0) -> Task:
    """Masked cross-entropy and accuracy."""
    _refuse_regulariser(attention_reward)

    def loss(logits, graph, phase):
        return M.masked_cross_entropy(logits, graph.y,
                                      _phase_mask(graph, phase))

    def mets(logits, graph, phase):
        m = _phase_mask(graph, phase)
        return {"loss": M.masked_cross_entropy(logits, graph.y, m),
                "acc": M.masked_accuracy(logits, graph.y, m)}

    return Task(name="planetoid", loss=loss, metrics=mets,
                attention_coef=attention_reward)


def ppi_task(attention_penalty: float = 0.0) -> Task:
    """Multi-label BCE and micro-F1 over whole graphs."""
    _refuse_regulariser(attention_penalty)

    def loss(logits, graph, phase):
        return M.masked_bce_with_logits(logits, graph.y, graph.node_mask)

    def mets(logits, graph, phase):
        return {"loss": loss(logits, graph, phase),
                "f1": M.micro_f1(logits, graph.y, graph.node_mask)}

    return Task(name="ppi", loss=loss, metrics=mets,
                attention_coef=attention_penalty)


def pattern_task() -> Task:
    """Pos-weighted BCE and the prediction-weighted balanced accuracy."""
    pos_weight = 1.0 / PATTERN_PROP_POS

    def loss(logits, graph, phase):
        return M.masked_bce_with_logits(logits, graph.y, graph.node_mask,
                                        pos_weight=pos_weight)

    def mets(logits, graph, phase):
        return {"loss": loss(logits, graph, phase),
                "weighted_acc": M.balanced_accuracy_predweighted(
                    logits, graph.y, graph.node_mask, PATTERN_PROP_POS)}

    return Task(name="pattern", loss=loss, metrics=mets,
                squeeze_output=True)


def make_task(dataset: str, *, attention_reward: float = 0.0,
              attention_penalty: float = 0.0) -> Task:
    if dataset in PLANETOID:
        return planetoid_task(attention_reward)
    if dataset == "PPI":
        return ppi_task(attention_penalty)
    if dataset == "PATTERN":
        return pattern_task()
    raise ValueError(f"unknown dataset {dataset!r}")
