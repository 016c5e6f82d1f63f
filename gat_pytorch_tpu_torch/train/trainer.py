"""The training loop for transductive (full-graph) datasets.

Counterpart of gat_pytorch_tpu/train/trainer.py:Trainer.fit_compiled, run
one epoch at a time: a train step (forward with dropout, masked loss,
backward, Adam with L2), then a forward on the validation mask. The
best-validation parameters are kept by validation loss (ModelCheckpoint
semantics, as make_scanned_fit_block does on the device), and early
stopping ends the run after `patience` epochs without a better loss.
One host synchronisation per epoch reads the epoch's metrics.

Checkpoints, TensorBoard, gradient histograms and the inductive and
sampled fits wait for ROADMAP queue A items 6, 9 and 10.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..graph.graph import Graph
from ..models import gat
from ..utils.device import resolve_device
from . import optim as O
from .tasks import Task


@dataclasses.dataclass
class TrainResult:
    params: dict            # best-validation parameters
    final_params: dict
    history: List[Dict[str, float]]
    best_val_loss: float
    best_epoch: int
    stopped_early: bool
    wall_time_s: float


def _snapshot(params: gat.Params) -> gat.Params:
    return {group: [{k: v.detach().clone() for k, v in d.items()}
                    for d in params[group]] for group in params}


@dataclasses.dataclass
class Trainer:
    cfg: gat.GATConfig
    task: Task
    learning_rate: float
    weight_decay: float = 0.0
    max_epochs: int = 1000
    patience: int = 100                  # early stop (reference: 100)
    seed: int = 0
    log_every: int = 0                   # 0 = silent
    device: str = "cuda"
    backend: str = "kernel"              # gat.BACKENDS

    def init_params(self) -> gat.Params:
        return gat.init_gat_model(self.cfg, seed=self.seed,
                                  device=self.device)

    def dropout_generator(self) -> torch.Generator:
        """The dropout stream of a run, seeded apart from the init."""
        gen = torch.Generator(device=resolve_device(self.device))
        gen.manual_seed(self.seed + 1)
        return gen

    def apply(self, params: gat.Params, graph: Graph, *,
              generator: Optional[torch.Generator] = None,
              training: bool = False) -> torch.Tensor:
        return gat.gat_model_apply(params, self.cfg, graph,
                                   device=self.device, generator=generator,
                                   training=training, backend=self.backend)

    def train_step(self, params: gat.Params, opt: torch.optim.Optimizer,
                   graph: Graph, generator: torch.Generator):
        """One step: forward with dropout, loss, backward, update.
        Returns (loss, logits), both detached."""
        logits = self.apply(params, graph, generator=generator,
                            training=True)
        loss = self.task.loss(logits, graph, "train")
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), logits.detach()

    def fit(self, graph: Graph,
            params: Optional[gat.Params] = None) -> TrainResult:
        """Train on one full graph (moved to the trainer's device)."""
        dev = resolve_device(self.device)
        graph = graph.to(dev)
        if params is None:
            params = self.init_params()
        opt = O.adam_l2(gat.parameters(params), self.learning_rate,
                        self.weight_decay)
        gen = self.dropout_generator()
        stopper = O.EarlyStopping(patience=self.patience)
        best_val, best_epoch = float("inf"), -1
        best_params = _snapshot(params)
        history: List[Dict[str, float]] = []
        stopped = False
        t0 = time.time()
        for epoch in range(self.max_epochs):
            loss, logits = self.train_step(params, opt, graph, gen)
            with torch.no_grad():
                train = self.task.metrics(logits, graph, "train")
                val = self.task.metrics(self.apply(params, graph), graph,
                                        "val")
            keys = (["train_loss"] + [f"train_{k}" for k in train
                                      if k != "loss"]
                    + [f"val_{k}" for k in val])
            vals = torch.stack([loss] + [v for k, v in train.items()
                                         if k != "loss"]
                               + list(val.values())).tolist()
            row = dict(zip(keys, vals))
            row["epoch"] = epoch
            history.append(row)
            if self.log_every and epoch % self.log_every == 0:
                print({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in row.items()})
            if row["val_loss"] < best_val:
                best_val, best_epoch = row["val_loss"], epoch
                best_params = _snapshot(params)
            if stopper.update(row["val_loss"]):
                stopped = True
                break
        return TrainResult(params=best_params, final_params=params,
                           history=history, best_val_loss=best_val,
                           best_epoch=best_epoch, stopped_early=stopped,
                           wall_time_s=time.time() - t0)

    def evaluate(self, params: gat.Params, data: Sequence[Graph],
                 phase: str = "test") -> Dict[str, float]:
        """Mean of the task's metrics over `data` for `phase`."""
        dev = resolve_device(self.device)
        rows = []
        with torch.no_grad():
            for g in data:
                g = g.to(dev)
                rows.append(self.task.metrics(self.apply(params, g), g,
                                              phase))
        return {f"{phase}_{k}": sum(float(r[k]) for r in rows) / len(rows)
                for k in rows[0]}
