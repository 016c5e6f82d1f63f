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

Around every fit: checkpoints (`save_checkpoint`: one torch.save file for
`<checkpoint_dir>/best` whenever the validation loss improves, and
`epoch-<E>` every `checkpoint_every_n_epochs`; `load_checkpoint`,
`resume_state`), the metrics logger (train/logging.py: each history row to
`metrics_file` and `tensorboard_dir`, with the attention histograms, and
the gradient histograms under `track_grads`, every max(log_every, 1)
epochs on the epoch's first batch) and, where a `reshuffle` builds each
epoch's batches anew, the prefetch thread (data/prefetch.py) that builds
the next epoch while this one trains. The neighbour-sampled fit is
fit_epochs with data/sampling.py's batcher as `reshuffle`. Under
torch.distributed only rank 0 writes checkpoints and logs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.prefetch import PrefetchIterator
from ..graph.graph import Graph
from ..models import gat
from ..ops import segment as seg
from ..parallel import (DropoutGenerators, make_sharded_eval_step,
                        make_sharded_train_step, partition_batches,
                        replicated, shard_batch, stack_graphs)
from ..utils import profiling
from ..utils.device import resolve_device
from . import optim as O
from .logging import MetricsLogger
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


@dataclasses.dataclass
class TrainState:
    """What a continued run needs (the JAX package's TrainState): the
    parameters, the optimizer over them (Adam's moments and step count)
    and the dropout stream, a torch.Generator (a sharded fit's
    DropoutGenerators)."""
    params: gat.Params
    opt: torch.optim.Optimizer
    generator: Union[torch.Generator, DropoutGenerators]

    @property
    def step(self) -> int:
        """Optimizer steps taken (Adam's step count; 0 before the first)."""
        for st in self.opt.state.values():
            if "step" in st:
                return int(st["step"])
        return 0


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


def _host_parts(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """`tensors` as numpy arrays of their shapes, copied to the host in
    one transfer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = np.split(flat.cpu().numpy(),
                     np.cumsum([t.numel() for t in tensors])[:-1])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def _writes() -> bool:
    """Whether this process writes checkpoints and logs: rank 0 of a
    torch.distributed group, or a process outside one."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


@dataclasses.dataclass
class Trainer:
    cfg: gat.GATConfig
    task: Task
    learning_rate: float
    weight_decay: float = 0.0
    max_epochs: int = 1000
    patience: int = 100                  # early stop (reference: 100)
    plateau: Optional[O.ReduceLROnPlateau] = None
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    log_every: int = 0                   # 0 = silent
    metrics_file: Optional[str] = None   # JSONL stream of the history rows
    tensorboard_dir: Optional[str] = None  # TensorBoard event files
    track_grads: bool = False            # gradient histograms (reference
    #                                      GATModel.on_after_backward),
    #                                      every max(log_every, 1) epochs
    prefetch: bool = True                # a reshuffled fit's next epoch
    #                                      built by the prefetch thread
    checkpoint_every_n_epochs: int = 0   # 0 = best only; N > 0 also saves
    #                                      <checkpoint_dir>/epoch-<E> every
    #                                      N epochs (E 1-based)
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
        update. Returns (loss, logits, attention norm or None), detached.
        Under a profiler, the step's spans (utils/profiling)."""
        with profiling.step(graph.device):
            with profiling.span("gat.forward"):
                loss, logits, norm = self.train_loss(params, graph,
                                                     generator=generator)
            with profiling.span("gat.optimizer"):
                opt.zero_grad(set_to_none=True)
            with profiling.span("gat.backward"):
                loss.backward()
            with profiling.span("gat.optimizer"):
                opt.step()
            return (loss.detach(), logits.detach(),
                    None if norm is None else norm.detach())

    # -- logging -----------------------------------------------------------
    def _logger(self):
        return MetricsLogger(self.metrics_file, self.tensorboard_dir)

    def _log_grad_histograms(self, logger, epoch: int, state: TrainState,
                             graph: Graph) -> None:
        """Histograms of the task loss's gradients (the task's loss only,
        as the JAX package takes them) at the current parameters in
        training mode, tagged grad/layers/<i>/<name> and grad/skips/<j>/w
        as the JAX tree paths name them. The dropout masks come from a
        clone of the fit's generator, so the fit draws the masks it draws
        without the histograms."""
        if not (self.track_grads and self.tensorboard_dir):
            return
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
        logits = self.apply(state.params, graph, generator=gen,
                            training=True)
        loss = self.task.loss(logits, graph, "train")
        grads = torch.autograd.grad(loss, gat.parameters(state.params))
        names = [f"grad/{group}/{i}/{k}" for group in ("layers", "skips")
                 for i, d in enumerate(state.params[group])
                 for k in sorted(d)]
        for name, values in zip(names, _host_parts(grads)):
            logger.log_histogram(epoch, name, values)

    def _log_attention_histograms(self, logger, epoch: int,
                                  params: gat.Params, graph: Graph) -> None:
        """Per-layer attention histograms: alpha * in-degree over the real
        edges ("unnormalised attention") and that minus 1, with the
        reference's tag names, from the segment path's return_attention
        (the JAX package's "xla" backend)."""
        if not self.tensorboard_dir:
            return
        with torch.no_grad():
            _, attention = gat.gat_model_apply(
                params, self.cfg, graph, device=self.device, training=False,
                return_attention=True, backend="segment")
            emask = graph.edge_mask
            deg = seg.in_degree(graph.receivers, graph.num_nodes,
                                edge_mask=emask)
            deg_e = seg.gather_rows(deg, graph.receivers)[emask]
            unnorm = [alpha[emask] * deg_e[:, None] for alpha in attention]
        for i, values in enumerate(_host_parts(unnorm)):
            logger.log_histogram(
                epoch, f"unnormalised_attention_layer_{i}", values)
            logger.log_histogram(
                epoch, f"attention_minus_const_layer_{i}", values - 1.0)

    # -- fits --------------------------------------------------------------
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
        reshuffle(epoch) builds anew for each epoch: with `prefetch`, in
        the prefetch thread, one epoch ahead) and validate over
        `val_data`; all batches are moved to the trainer's device, on this
        thread."""
        dev = resolve_device(self.device)
        if reshuffle is None:
            train_data = [g.to(dev) for g in train_data]
        val_data = [g.to(dev) for g in val_data]
        if params is None:
            params = self.init_params()
        state = TrainState(params, O.adam_l2(gat.parameters(params),
                                             self.learning_rate,
                                             self.weight_decay),
                           self.dropout_generator())
        zero = torch.zeros((), device=dev)   # the norm without a regulariser

        def run_epoch(epoch):
            batches = (train_data if reshuffle is None
                       else (g.to(dev) for g in next(built)))
            train_rows, first = [], None
            for g in batches:
                first = g if first is None else first
                loss, logits, norm = self.train_step(
                    state.params, state.opt, g, state.generator)
                with torch.no_grad():
                    train_rows.append({
                        "train_loss": loss,
                        "train_attention_norm": zero if norm is None
                        else norm, **_prefixed(
                            "train", self.task.metrics(logits, g, "train"),
                            skip=("loss",))})
            with torch.no_grad():
                val_rows = [_prefixed("val", self.task.metrics(
                    self.apply(state.params, g), g, "val"))
                    for g in val_data]
            return train_rows, val_rows, first

        if reshuffle is None:
            return self._fit_loop(state, run_epoch)
        built = self._built_epochs(reshuffle, list)
        return self._fit_loop(state, run_epoch, streams=(built,))

    def fit_sharded(self, mesh, train_data: Sequence[Graph],
                    val_data: Sequence[Graph],
                    reshuffle: Optional[Callable[[int], Sequence[Graph]]]
                    = None,
                    params: Optional[gat.Params] = None,
                    dst_owned: bool = False) -> TrainResult:
        """fit_epochs over a (data, edge) mesh of torch.distributed ranks
        (parallel/mesh.make_mesh), in the cut-neighbourhood layout or
        (dst_owned) the dst-owned one: every rank calls it with the same
        arguments. Consecutive batches are grouped `data`-axis-wide, the
        last group filled by wrapping around to the first batches; each
        rank takes its shard of each group
        (parallel/sharding.shard_batch) and runs the sharded train step
        (parallel/train.py), then the sharded eval step over the
        validation groups. The same bookkeeping as fit_epochs (best
        parameters by validation loss, plateau schedule, early stopping,
        checkpoints and logs, which rank 0 alone writes) on values that
        are equal on every rank, so every rank returns the same result.
        The parameters must be equal on every rank (the same seed): it is
        checked, not broadcast. The attention dropout masks are drawn per
        edge shard (parallel/train.DropoutGenerators). With `reshuffle`,
        each epoch's groups (reshuffle, stack_graphs, shard_batch: host
        work) are built as fit_epochs builds its batches: with `prefetch`,
        in the prefetch thread, one epoch ahead.

        dst_owned: the dst-owned layout (parallel/partition.py) over the
        edge axis, train and validation steps both. Each epoch's batches
        (the validation batches first) are partitioned by destination with
        one sticky per-shard bucket, as the JAX package's fit_sharded
        keeps it: the first partition's bucket with 25% headroom rounded
        up to 256 edges, regrown so once a later epoch overflows it. Where
        the graphs carry a block layout (canonicalize(src_windows=True)),
        each shard gets its own (hybrid where the graph's has a
        remainder), which puts the kernel path on the sharded windowed or
        hybrid branch; the JAX package's fit builds none and runs v5."""
        dev = resolve_device(self.device)
        step = make_sharded_train_step(self.cfg, self.task, mesh,
                                       backend=self.backend,
                                       dst_owned=dst_owned)
        val_step = make_sharded_eval_step(self.cfg, self.task, mesh, "val",
                                          backend=self.backend,
                                          dst_owned=dst_owned)
        dp = mesh.data.size
        bucket = [None]     # the sticky per-shard edge bucket

        def partition(batches):
            bl = batches[0].block_layout
            kw = dict(src_windows=bl is not None,
                      hybrid=bl is not None and bl.rem_send is not None)
            k = mesh.edge.size

            def headroom(eps):
                return ((int(eps * 1.25) + 255) // 256) * 256

            try:
                parts, eps = partition_batches(batches, k, eps=bucket[0],
                                               **kw)
            except ValueError:
                # a reshuffled epoch overflowed the bucket: regrow it once
                _, eps = partition_batches(batches, k, **kw)
                parts, eps = partition_batches(batches, k,
                                               eps=headroom(eps), **kw)
            if bucket[0] is None:
                parts, eps = partition_batches(batches, k,
                                               eps=headroom(eps), **kw)
            bucket[0] = eps
            return parts

        def build(batches):
            """This rank's shard of each data-axis-wide group, unmoved."""
            batches = list(batches)
            if dst_owned:
                batches = partition(batches)
            out = []
            for i in range(0, len(batches), dp):
                chunk = batches[i:i + dp]
                while len(chunk) < dp:           # wrap-around fill
                    chunk.append(batches[len(chunk) % len(batches)])
                out.append(shard_batch(stack_graphs(chunk), mesh,
                                       dst_owned=dst_owned))
            return out

        def to_device(groups):
            return [[g.to(dev) for g in shard] for shard in groups]

        if params is None:
            params = self.init_params()
        replicated(gat.parameters(params))
        state = TrainState(params, O.adam_l2(gat.parameters(params),
                                             self.learning_rate,
                                             self.weight_decay),
                           DropoutGenerators.for_rank(self.seed + 1, mesh,
                                                      dev))
        val_groups = to_device(build(val_data))
        if reshuffle is None:
            train_groups = to_device(build(train_data))
        zero = torch.zeros((), device=dev)   # the norm without a regulariser

        def run_epoch(epoch):
            train_rows = []
            groups = (train_groups if reshuffle is None
                      else to_device(next(built)))
            for batch in groups:
                loss, mets = step(state.params, state.opt, batch,
                                  state.generator)
                train_rows.append({"train_loss": loss,
                                   "train_attention_norm": zero,
                                   **_prefixed("train", mets)})
            val_rows = [_prefixed("val", val_step(state.params, batch))
                        for batch in val_groups]
            return train_rows, val_rows, None

        if reshuffle is None:
            return self._fit_loop(state, run_epoch)
        built = self._built_epochs(reshuffle, build)
        return self._fit_loop(state, run_epoch, streams=(built,))

    def _built_epochs(self, reshuffle: Callable[[int], Sequence[Graph]],
                      build: Callable):
        """The epochs' training data, build(reshuffle(epoch)) for each
        epoch in turn: with `prefetch` (and more than one epoch), built by
        the prefetch thread one epoch ahead of the consumer and handed
        over as built (put=False), the copies to the device left to the
        consumer's thread, where they cost less than in the thread
        (tools/prefetch_ab.py; PERF.md). Host work only: the reshuffle
        draws from its own numpy generator, which nothing else draws from.
        The caller's _fit_loop closes it."""
        built = (build(reshuffle(epoch)) for epoch in range(self.max_epochs))
        if self.prefetch and self.max_epochs > 1:
            return PrefetchIterator(built, depth=1, put=False)
        return built

    def _fit_loop(self, state: TrainState, run_epoch: Callable,
                  streams: Sequence = ()) -> TrainResult:
        """The epochs of a fit: run_epoch(epoch) trains and validates and
        returns (train rows, validation rows, the epoch's first train batch
        on the device or None), the rows dicts of scalar tensors; their
        means make the epoch's history row (one host sync), which is
        logged and drives the best-parameter tracking (saved to
        <checkpoint_dir>/best on each improvement), the epoch snapshots,
        the plateau schedule and early stopping. The histograms run on the
        first batch every max(log_every, 1) epochs. `streams` (prefetch
        iterators) are closed when the loop ends, breaks or raises."""
        writer = _writes()
        logger = self._logger() if writer else MetricsLogger()
        stopper = O.EarlyStopping(patience=self.patience)
        lr = self.learning_rate
        best_val, best_epoch = float("inf"), -1
        best_params = _snapshot(state.params)
        history: List[Dict[str, float]] = []
        stopped = False
        t0 = time.time()
        try:
            for epoch in range(self.max_epochs):
                train_rows, val_rows, first = run_epoch(epoch)
                row = {**_epoch_means(train_rows), **_epoch_means(val_rows),
                       "epoch": epoch, "lr": lr}
                history.append(row)
                logger.log_scalars(epoch, row)
                if first is not None and epoch % max(self.log_every, 1) == 0:
                    self._log_grad_histograms(logger, epoch, state, first)
                    self._log_attention_histograms(logger, epoch,
                                                   state.params, first)
                if self.log_every and epoch % self.log_every == 0:
                    print({k: (round(v, 4) if isinstance(v, float) else v)
                           for k, v in row.items()})
                val_loss = row["val_loss"]
                if val_loss < best_val:
                    best_val, best_epoch = val_loss, epoch
                    best_params = _snapshot(state.params)
                    if self.checkpoint_dir and writer:
                        self.save_checkpoint(state, epoch, best_val)
                if writer:
                    self._maybe_snapshot(epoch, state, best_val)
                if self.plateau is not None:
                    new_lr = self.plateau.step(val_loss, lr)
                    if new_lr != lr:
                        lr = new_lr
                        O.set_learning_rate(state.opt, lr)
                if stopper.update(val_loss):
                    stopped = True
                    break
        finally:
            for stream in streams:
                stream.close()
            logger.close()
        return TrainResult(params=best_params, final_params=state.params,
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

    # -- checkpoints -------------------------------------------------------
    # The logical content of the JAX package's Orbax checkpoints (and of
    # the reference's Lightning ones): parameters, optimizer state, the
    # dropout stream, step, epoch and the monitored metric, so a restore
    # resumes training exactly, not just inference.
    def _maybe_snapshot(self, epoch: int, state: TrainState,
                        best_val: float) -> None:
        """Every-N-epochs snapshot to <checkpoint_dir>/epoch-<E> (E the
        1-based epoch count, as the reference's '<ds>-<E>epochs.ckpt')."""
        n = self.checkpoint_every_n_epochs
        if n and self.checkpoint_dir and (epoch + 1) % n == 0:
            self.save_checkpoint(state, epoch, best_val,
                                 name=f"epoch-{epoch + 1}")

    def save_checkpoint(self, state: TrainState, epoch: int,
                        best_val: float, name: str = "best") -> None:
        """Write <checkpoint_dir>/<name>, one torch.save file: the
        parameters (detached, on the CPU), the optimizer's state_dict, the
        dropout generator's state (a sharded fit's: this rank's node and
        edge streams), the step, the epoch and best_val_loss. It is
        written under a temporary name and renamed over the old file, so
        an interrupted save leaves the previous checkpoint whole."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, name)
        gen = state.generator
        rng = ({"node": gen.node.get_state(), "edge": gen.edge.get_state()}
               if isinstance(gen, DropoutGenerators) else gen.get_state())
        payload = {"params": {group: [{k: v.detach().cpu()
                                       for k, v in d.items()}
                                      for d in state.params[group]]
                              for group in state.params},
                   "opt_state": state.opt.state_dict(),
                   "rng": rng,
                   "step": state.step,
                   "epoch": int(epoch),
                   "best_val_loss": float(best_val)}
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @staticmethod
    def load_checkpoint(checkpoint_path: str, device="cuda") -> dict:
        """A checkpoint's payload (save_checkpoint) with its tensors on
        `device`, the parameters as plain tensors. `checkpoint_path` is a
        checkpoint file itself (.../best, .../epoch-20) or a checkpoint_dir
        that holds "best"."""
        dev = resolve_device(device)
        path = checkpoint_path
        if os.path.isdir(path):
            path = os.path.join(path, "best")
        return torch.load(path, map_location=dev, weights_only=True)

    def resume_state(self, checkpoint_dir: Optional[str] = None
                     ) -> TrainState:
        """The TrainState a saved checkpoint holds (full resume): its
        parameters requiring grad, an adam_l2 optimizer over them with the
        saved state (moments, step count, learning rate) loaded, and a
        generator with the saved dropout stream's state, not re-seeded.
        `checkpoint_dir` (default: the trainer's) as load_checkpoint takes
        it. A sharded fit's checkpoint holds rank 0's streams only and is
        not resumed (ValueError)."""
        ck = self.load_checkpoint(checkpoint_dir or self.checkpoint_dir,
                                  self.device)
        if isinstance(ck["rng"], dict):
            raise ValueError("a sharded fit's checkpoint holds rank 0's "
                             "dropout streams only; it restores parameters "
                             "(load_checkpoint), not a run")
        params = ck["params"]
        for p in gat.parameters(params):
            p.requires_grad_(True)
        opt = O.adam_l2(gat.parameters(params), self.learning_rate,
                        self.weight_decay)
        opt_state = ck["opt_state"]
        for st in opt_state["state"].values():
            # Adam (neither capturable nor fused) keeps its step count on
            # the CPU; load_checkpoint mapped it to the device
            st["step"] = st["step"].cpu()
        opt.load_state_dict(opt_state)
        gen = torch.Generator(device=resolve_device(self.device))
        gen.set_state(ck["rng"].cpu())
        return TrainState(params, opt, gen)
