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

The dst-owned model (models/gat.py, dst_owned) keeps its node tables
varying between its layers: every rank holds the same values, but each
holds its own part of their cotangents, which sum to the whole. Its
parameters enter through `vary` (their parts are summed once, at the
parameter, in a parameter-sized all_reduce); a layer's output slices are
joined by `all_gather_varying`, whose backward sums the ranks' parts of
the cotangent and hands each rank its own rows (a reduce_scatter: JAX's
all_gather under check_vma, whose transpose is psum_scatter); and the
model's logits leave through `owned_rows`, whose backward keeps the
rank's own rows of the replicated cotangent, so that the ranks' parts sum
to it. So no (N, nh*f) all_reduce runs in the step, and the parameters'
gradients still come out whole and equal on every rank.

`pmax` and `pmin` carry no gradient (JAX's have no differentiation rule);
their callers detach. Every collective is a real call, also on a mesh of
one rank, so that a one-rank NCCL group runs the same path as a larger
one. The all_gather and the reduce_scatter are the list forms, which
NCCL and gloo both have in the torch versions the port runs on.

`recording()` lists the collectives a block of code makes: each call's
kind and the shape and dtype of the whole tensor it reduces or gathers
(the tests and chip_smoke.py count a step's collectives and bytes).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

_MASK64 = (1 << 64) - 1
# the calls of an open recording(): (kind, shape, dtype) each
_RECORD: Optional[List[Tuple[str, Tuple[int, ...], torch.dtype]]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, Tuple[int, ...], torch.dtype]]]:
    """A list that receives (kind, shape, dtype) for every collective
    made inside the block: "all_reduce", "all_gather" (the gathered
    shape) or "reduce_scatter" (the shape reduced)."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _note(kind: str, shape, dtype) -> None:
    if _RECORD is not None:
        _RECORD.append((kind, tuple(shape), dtype))


def collective_bytes(calls) -> int:
    """The bytes of the tensors a recording's calls reduce or gather."""
    total = 0
    for _, shape, dtype in calls:
        n = 1
        for s in shape:
            n *= s
        total += n * torch.empty((), dtype=dtype).element_size()
    return total


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
    _note("all_reduce", out.shape, out.dtype)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(axis.size)]
    _note("all_gather", (x.shape[0] * axis.size,) + tuple(x.shape[1:]),
          x.dtype)
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=0)


def _reduce_scatter_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over `axis` of x's row slice [index*R, (index+1)*R),
    R = rows/size (a reduce_scatter of the row slices)."""
    x = x.contiguous()
    rows = x.shape[0] // axis.size
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _note("reduce_scatter", x.shape, x.dtype)
    dist.reduce_scatter(out, list(x.split(rows)), group=axis.group)
    return out


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


class _AllGatherVarying(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_rows(g, ctx.axis), None


class _OwnedRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // ctx.axis.size
        lo = ctx.axis.index * rows
        out = torch.zeros_like(g)
        out[lo:lo + rows] = g[lo:lo + rows]
        return out, None


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


def all_gather_varying(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The shards' row slices concatenated in axis order, as a varying
    table (the module doc): the backward sums the ranks' parts of the
    cotangent and returns the rank's own rows of the sum."""
    return _AllGatherVarying.apply(x, axis)


def owned_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x, a varying table that holds the same values on every rank, as a
    replicated one (the module doc): the identity forward; the backward
    keeps the rank's rows [index*R, (index+1)*R), R = rows/size, of the
    replicated cotangent and zeroes the others."""
    if x.shape[0] % axis.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{axis.size} shards")
    return _OwnedRows.apply(x, axis)


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
    _note("all_reduce", flat.shape, flat.dtype)
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
