"""Train and eval steps over the (data, edge) mesh.

Counterpart of gat_pytorch_tpu/parallel/train.py (make_sharded_train_step
and make_sharded_eval_step), in the cut-neighbourhood layout and, with
dst_owned=True, the dst-owned one (the rank's graphs are dst shards,
shard_batch(..., dst_owned=True)). One step on every rank:

  * the rank's graphs (its data rows of the batch, parallel/sharding.py)
    go through the model with their edge arrays cut over ``edge``; the
    layers complete the cut neighbourhoods with sums over the edge axis
    (models/gat.py `edge_axis`), or in the dst-owned layout own the
    attention of their rows and gather the layer's output rows, so every
    rank of an edge group holds the same replicated logits;
  * the loss is the sum of the per-graph losses over the global batch
    size, each with coef * calc_attention_norm (over the edge axis) where
    the task's attention coefficient is not 0; its cotangent is
    replicated, and the collectives' backwards
    (ops/collectives.py) leave every parameter's gradient complete
    over the edge axis;
  * nothing crosses the data axis inside the loss, so the gradients are
    summed over ``data`` once (one all_reduce of all of them), as JAX's
    invariant-to-varying transpose sums them; the reported loss and
    metrics are summed over ``data`` too. Every rank then holds the same
    gradient bits and takes the same Adam step.

There is no jit and no scan: each step runs eagerly, as Trainer.train_step
does. The JAX package's dst-owned step scales the loss by 1/K and sums
the gradients over the edge axis, a workaround for shard_map without
check_vma; here the collectives' own backwards (ops/collectives.py) leave
the gradients whole, in both layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from ..graph.graph import Graph
from ..models import gat
from ..ops import collectives as C
from ..train.tasks import Task
from .mesh import Mesh


@dataclasses.dataclass
class DropoutGenerators:
    """The dropout streams of one rank: `node` draws the input dropout
    masks, the same on every rank of an edge group (the node features are
    replicated over it); `edge` draws the attention dropout masks of the
    rank's own edge shard, a stream of its own. Both differ per data
    index, as the JAX package folds each graph's key with its global
    batch index."""
    node: torch.Generator
    edge: torch.Generator

    @classmethod
    def for_rank(cls, seed: int, mesh: Mesh,
                 device: torch.device) -> "DropoutGenerators":
        node_seed = C.fold_in(seed, mesh.data.index)
        node = torch.Generator(device=device)
        node.manual_seed(node_seed)
        edge = torch.Generator(device=device)
        edge.manual_seed(C.fold_in(node_seed, mesh.edge.index))
        return cls(node=node, edge=edge)


def _squeeze(logits: torch.Tensor, task: Task) -> torch.Tensor:
    if task.squeeze_output and logits.dim() == 2:
        return logits[:, 0]
    return logits


def make_sharded_train_step(cfg: gat.GATConfig, task: Task, mesh: Mesh, *,
                            backend: str = "kernel",
                            dst_owned: bool = False) -> Callable:
    """step(params, opt, batch, gens) -> (loss, metrics): one train step
    over this rank's shard of a batch (shard_batch), whose global size is
    len(batch) x the data axis's size. The loss and the metrics (the
    task's "train" metrics but its loss, each a mean over the global
    batch) are detached scalar tensors, equal on every rank; `opt` (over
    gat.parameters(params)) has taken its step. With the regulariser the
    metrics carry `attention_norm`, the per-graph norm's mean over the
    global batch. dst_owned: the batch holds dst shards."""
    edge_axis = mesh.edge
    coef = task.attention_coef

    def train_step(params: gat.Params, opt: torch.optim.Optimizer,
                   batch: Sequence[Graph], gens: DropoutGenerators):
        b_global = len(batch) * mesh.data.size
        loss = 0.0
        mets: Dict[str, torch.Tensor] = {}
        for g in batch:
            out = gat.gat_model_apply(
                params, cfg, g, device=g.device, generator=gens.node,
                edge_generator=gens.edge, training=True, backend=backend,
                edge_axis=edge_axis, dst_owned=dst_owned,
                return_attention=coef != 0.0)
            logits = _squeeze(out[0] if coef != 0.0 else out, task)
            loss = loss + task.loss(logits, g, "train")
            if coef != 0.0:
                norm = gat.calc_attention_norm(g, out[1], edge_axis=edge_axis,
                                               dst_owned=dst_owned)
                loss = loss + coef * norm
                mets["attention_norm"] = (mets.get("attention_norm", 0.0)
                                          + norm.detach())
            with torch.no_grad():
                for k, v in task.metrics(logits, g, "train").items():
                    if k != "loss":
                        mets[k] = mets.get(k, 0.0) + v.float()
        loss = loss / b_global
        opt.zero_grad(set_to_none=True)
        loss.backward()
        C.psum_grads(gat.parameters(params), mesh.data)
        opt.step()
        loss = C.psum(loss.detach(), mesh.data)
        return loss, {k: C.psum(v / b_global, mesh.data)
                      for k, v in mets.items()}

    return train_step


def make_sharded_eval_step(cfg: gat.GATConfig, task: Task, mesh: Mesh,
                           phase: str, *, backend: str = "kernel",
                           dst_owned: bool = False) -> Callable:
    """step(params, batch) -> metrics: the task's metrics of `phase`, each
    a mean over the global batch, equal on every rank (no regulariser:
    the loss is the task's). dst_owned: the batch holds dst shards."""

    def eval_step(params: gat.Params, batch: Sequence[Graph]):
        b_global = len(batch) * mesh.data.size
        mets: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for g in batch:
                logits = _squeeze(gat.gat_model_apply(
                    params, cfg, g, device=g.device, backend=backend,
                    edge_axis=mesh.edge, dst_owned=dst_owned), task)
                for k, v in task.metrics(logits, g, phase).items():
                    mets[k] = mets.get(k, 0.0) + v.float()
            return {k: C.psum(v / b_global, mesh.data)
                    for k, v in mets.items()}

    return eval_step
