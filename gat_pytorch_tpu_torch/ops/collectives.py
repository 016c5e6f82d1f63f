"""Collectives over one mesh axis, with the gradient semantics of the JAX
package's shard_map(check_vma=True).

Counterpart of the jax.lax collectives that gat_pytorch_tpu's models/gat.py,
ops/segment.py and parallel/train.py use: psum, pmax, pmin and tiled
all_gather over a named mesh axis (axis_index and axis_size are the
fields `index` and `size` of the rank's mesh `Axis`, defined here; the
mesh of axes is parallel/mesh.py). The module sits with the ops, below
the model, so that the segment ops and the layer take an axis directly.

The convention. A tensor on a rank is either *replicated* over an axis
(every rank of the axis's group holds the same value: node tables,
parameters, the loss) or *varying* (each rank holds its own: anything
computed from its edge shard). Under check_vma JAX types every value so
and transposes the conversions between the two:
  * psum (varying partials -> replicated sum): its transpose hands each
    shard the replicated cotangent unchanged (`psum` here: all_reduce
    forward, identity backward);
  * a replicated value entering per-shard work is implicitly made
    varying (pvary); its transpose sums the shards' partial cotangents
    (`vary` here: identity forward, all_reduce backward);
  * a tiled all_gather of varying slices gives a replicated table; with
    a replicated cotangent its transpose is the rank's own slice
    (`all_gather_rows`), and the converse, a rank taking its slice of a
    replicated table, all-gathers the cotangent slices (`split_rows`).
These are Megatron-LM's pairs of region ops. Every replicated tensor that
enters per-shard work (a gather by the shard's edges, the shard's GEMM
rows, the global cap subtracted from the shard's logits) goes through
`vary` or `split_rows`, and every sum over shards through `psum`; then the
cotangent of every replicated tensor, the parameters included, is the
full (unsharded) one and is equal on every rank of the axis, and nothing
is counted K times. torch.distributed.nn.functional.all_reduce all-reduces
in both directions; under replicated cotangents that multiplies a
gradient by K, so it is not used.

`pmax` and `pmin` carry no gradient (JAX's have no differentiation rule);
their callers detach. Every collective is a real call, also on a mesh of
one rank, so that a one-rank NCCL group runs the same path as a larger
one. The all_gather is the list form, which NCCL and gloo both have in
every torch version the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its name, its size, this
    rank's index along it, and the process group of the ranks that share
    this rank's index on every other axis (group rank == index)."""
    name: str
    size: int
    index: int
    group: dist.ProcessGroup


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=0)


def _own_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    rows = x.shape[0] // axis.size
    return x[axis.index * rows:(axis.index + 1) * rows].contiguous()


class _Psum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Vary(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, dist.ReduceOp.SUM), None


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _own_rows(g, ctx.axis), None


class _SplitRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _own_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.axis), None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of the shards' x over `axis` (varying -> replicated); the
    backward passes the replicated cotangent to each shard as it is."""
    return _Psum.apply(x, axis)


def vary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x, replicated over `axis`, as the input of per-shard work: the
    identity forward; the backward sums the shards' cotangents."""
    return _Vary.apply(x, axis)


def all_gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The shards' row slices concatenated in axis order (jax.lax.
    all_gather(..., axis=0, tiled=True)); the backward takes the rank's
    own rows of the replicated cotangent."""
    return _AllGatherRows.apply(x, axis)


def split_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The rank's slice of rows [index*R, (index+1)*R), R = rows/size, of
    a replicated x (JAX: dynamic_slice at axis_index); the backward
    all-gathers the slices' cotangents."""
    if x.shape[0] % axis.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{axis.size} shards")
    return _SplitRows.apply(x, axis)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise max over `axis`; no gradient."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise min over `axis`; no gradient."""
    return _all_reduce(x, axis, dist.ReduceOp.MIN)


def psum_grads(tensors: List[torch.Tensor], axis: Axis) -> None:
    """Sum the .grad of every tensor over `axis` in place, in one
    all_reduce of their concatenation (tensors without a grad are
    skipped)."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def fold_in(seed: int, index: int) -> int:
    """A 63-bit seed derived from (seed, index), as jax.random.fold_in
    derives a key: equal inputs give equal seeds, and neighbouring
    indices unrelated ones (a splitmix64 finaliser)."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
