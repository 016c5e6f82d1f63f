"""The training loop: epochs of minibatches, or one full graph per epoch.

Counterpart of gat_pytorch_tpu/train/trainer.py: `Trainer.fit_epochs` of
`fit_scanned_epochs` (the inductive datasets: per epoch, reshuffled
block-diagonal batches, one train step per batch, then the validation
metrics over the validation batches) and `Trainer.fit` of `fit_compiled`
(the transductive datasets: the same loop over the one graph). There is
no scan to mirror: a plain loop over batches that live on the device. Each
epoch's row is the mean over its batches; the metrics stay on the device
and one host synchronisation per epoch reads them. The best-validation
parameters are kept by validation loss (ModelCheckpoint semantics), early
stopping ends the run after `patience` epochs without a better loss, and
a plateau schedule may lower the learning rate between epochs. With a
task's attention coefficient set, a train step runs the model with
return_attention and adds coef * calc_attention_norm to the loss (the
regulariser); each row's `train_loss` is that total and
`train_attention_norm` the norm (0.0 without the regulariser, whose step
computes no attention).

`Trainer.fit_sharded` is the counterpart of the JAX package's
fit_sharded: the same epochs over a (data, edge) mesh of
torch.distributed ranks, through the sharded steps of parallel/train.py.

Checkpoints, TensorBoard, gradient histograms, the prefetch thread and
the sampled fit wait for their ports (ROADMAP: checkpoints and logging;
sampling and prefetch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..graph.graph import Graph
from ..models import gat
from ..parallel import (DropoutGenerators, make_sharded_eval_step,
                        make_sharded_train_step, replicated, shard_batch,
                        stack_graphs)
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


def _prefixed(prefix: str, metrics: Dict[str, torch.Tensor],
              skip: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    return {f"{prefix}_{k}": v for k, v in metrics.items() if k not in skip}


def _epoch_means(rows: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Mean over the batches of each metric, read with one host sync."""
    keys = list(rows[0])
    table = torch.stack([torch.stack([r[k].float() for k in keys])
                         for r in rows])
    return dict(zip(keys, table.mean(dim=0).tolist()))


@dataclasses.dataclass
class Trainer:
    cfg: gat.GATConfig
    task: Task
    learning_rate: float
    weight_decay: float = 0.0
    max_epochs: int = 1000
    patience: int = 100                  # early stop (reference: 100)
    plateau: Optional[O.ReduceLROnPlateau] = None
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
              training: bool = False, return_attention: bool = False):
        """The model's logits, (N, 1) squeezed to (N,) where the task
        says so; with return_attention, (logits, [alpha per layer])."""
        out = gat.gat_model_apply(params, self.cfg, graph,
                                  device=self.device, generator=generator,
                                  training=training, backend=self.backend,
                                  return_attention=return_attention)
        logits, attention = out if return_attention else (out, None)
        if self.task.squeeze_output and logits.dim() == 2:
            logits = logits[:, 0]
        return (logits, attention) if return_attention else logits

    def train_loss(self, params: gat.Params, graph: Graph, *,
                   generator: Optional[torch.Generator] = None,
                   training: bool = True):
        """(loss, logits, attention norm or None): the task's training
        loss, plus coef * calc_attention_norm where the task's attention
        coefficient is not 0."""
        coef = self.task.attention_coef
        if coef == 0.0:
            logits = self.apply(params, graph, generator=generator,
                                training=training)
            return self.task.loss(logits, graph, "train"), logits, None
        logits, attention = self.apply(params, graph, generator=generator,
                                       training=training,
                                       return_attention=True)
        norm = gat.calc_attention_norm(graph, attention)
        return (self.task.loss(logits, graph, "train") + coef * norm, logits,
                norm)

    def train_step(self, params: gat.Params, opt: torch.optim.Optimizer,
                   graph: Graph, generator: torch.Generator):
        """One step: forward with dropout, loss (train_loss), backward,
        update. Returns (loss, logits, attention norm or None), detached."""
        loss, logits, norm = self.train_loss(params, graph,
                                             generator=generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return (loss.detach(), logits.detach(),
                None if norm is None else norm.detach())

    def fit(self, graph: Graph,
            params: Optional[gat.Params] = None) -> TrainResult:
        """Train on one full graph, which is each epoch's one train and
        one validation batch (its masks tell the phases apart)."""
        return self.fit_epochs([graph], [graph], params=params)

    def fit_epochs(self, train_data: Sequence[Graph],
                   val_data: Sequence[Graph],
                   reshuffle: Optional[Callable[[int], Sequence[Graph]]]
                   = None,
                   params: Optional[gat.Params] = None) -> TrainResult:
        """Train over `train_data` (or, with `reshuffle`, over the batches
        reshuffle(epoch) builds anew for each epoch) and validate over
        `val_data`; all batches are moved to the trainer's device."""
        dev = resolve_device(self.device)
        train_data = [g.to(dev) for g in train_data]
        val_data = [g.to(dev) for g in val_data]
        if params is None:
            params = self.init_params()
        opt = O.adam_l2(gat.parameters(params), self.learning_rate,
                        self.weight_decay)
        gen = self.dropout_generator()
        zero = torch.zeros((), device=dev)   # the norm without a regulariser

        def run_epoch(epoch):
            data = (train_data if reshuffle is None
                    else [g.to(dev) for g in reshuffle(epoch)])
            train_rows = []
            for g in data:
                loss, logits, norm = self.train_step(params, opt, g, gen)
                with torch.no_grad():
                    train_rows.append({
                        "train_loss": loss,
                        "train_attention_norm": zero if norm is None
                        else norm, **_prefixed(
                            "train", self.task.metrics(logits, g, "train"),
                            skip=("loss",))})
            with torch.no_grad():
                val_rows = [_prefixed("val", self.task.metrics(
                    self.apply(params, g), g, "val")) for g in val_data]
            return train_rows, val_rows

        return self._fit_loop(params, opt, run_epoch)

    def fit_sharded(self, mesh, train_data: Sequence[Graph],
                    val_data: Sequence[Graph],
                    reshuffle: Optional[Callable[[int], Sequence[Graph]]]
                    = None,
                    params: Optional[gat.Params] = None,
                    dst_owned: bool = False) -> TrainResult:
        """fit_epochs over a (data, edge) mesh of torch.distributed ranks
        (parallel/mesh.make_mesh), the cut-neighbourhood layout: every
        rank calls it with the same arguments. Consecutive batches are
        grouped `data`-axis-wide, the last group filled by wrapping around
        to the first batches; each rank takes its shard of each group
        (parallel/sharding.shard_batch) and runs the sharded train step
        (parallel/train.py), then the sharded eval step over the
        validation groups. The same bookkeeping as fit_epochs (best
        parameters by validation loss, plateau schedule, early stopping)
        on values that are equal on every rank, so every rank returns the
        same result. The parameters must be equal on every rank (the same
        seed): it is checked, not broadcast. The attention dropout masks
        are drawn per edge shard (parallel/train.DropoutGenerators).
        dst_owned (the boundary-free layout) is not ported and raises."""
        dev = resolve_device(self.device)
        step = make_sharded_train_step(self.cfg, self.task, mesh,
                                       backend=self.backend,
                                       dst_owned=dst_owned)
        val_step = make_sharded_eval_step(self.cfg, self.task, mesh, "val",
                                          backend=self.backend)
        dp = mesh.data.size

        def group(batches):
            batches = list(batches)
            out = []
            for i in range(0, len(batches), dp):
                chunk = batches[i:i + dp]
                while len(chunk) < dp:           # wrap-around fill
                    chunk.append(batches[len(chunk) % len(batches)])
                out.append([g.to(dev) for g in
                            shard_batch(stack_graphs(chunk), mesh)])
            return out

        if params is None:
            params = self.init_params()
        replicated(gat.parameters(params))
        opt = O.adam_l2(gat.parameters(params), self.learning_rate,
                        self.weight_decay)
        gens = DropoutGenerators.for_rank(self.seed + 1, mesh, dev)
        train_groups, val_groups = group(train_data), group(val_data)
        zero = torch.zeros((), device=dev)   # the norm without a regulariser

        def run_epoch(epoch):
            groups = (train_groups if reshuffle is None
                      else group(reshuffle(epoch)))
            train_rows = []
            for batch in groups:
                loss, mets = step(params, opt, batch, gens)
                train_rows.append({"train_loss": loss,
                                   "train_attention_norm": zero,
                                   **_prefixed("train", mets)})
            val_rows = [_prefixed("val", val_step(params, batch))
                        for batch in val_groups]
            return train_rows, val_rows

        return self._fit_loop(params, opt, run_epoch)

    def _fit_loop(self, params: gat.Params, opt: torch.optim.Optimizer,
                  run_epoch: Callable) -> TrainResult:
        """The epochs of a fit: run_epoch(epoch) trains and validates and
        returns (train rows, validation rows), dicts of scalar tensors;
        their means make the epoch's history row (one host sync), which
        drives the best-parameter tracking, the plateau schedule and
        early stopping."""
        stopper = O.EarlyStopping(patience=self.patience)
        lr = self.learning_rate
        best_val, best_epoch = float("inf"), -1
        best_params = _snapshot(params)
        history: List[Dict[str, float]] = []
        stopped = False
        t0 = time.time()
        for epoch in range(self.max_epochs):
            train_rows, val_rows = run_epoch(epoch)
            row = {**_epoch_means(train_rows), **_epoch_means(val_rows),
                   "epoch": epoch, "lr": lr}
            history.append(row)
            if self.log_every and epoch % self.log_every == 0:
                print({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in row.items()})
            val_loss = row["val_loss"]
            if val_loss < best_val:
                best_val, best_epoch = val_loss, epoch
                best_params = _snapshot(params)
            if self.plateau is not None:
                new_lr = self.plateau.step(val_loss, lr)
                if new_lr != lr:
                    lr = new_lr
                    O.set_learning_rate(opt, lr)
            if stopper.update(val_loss):
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
        with torch.no_grad():
            rows = []
            for g in data:
                g = g.to(dev)
                rows.append(self.task.metrics(self.apply(params, g), g,
                                              phase))
        return _prefixed(phase, _epoch_means(rows))
