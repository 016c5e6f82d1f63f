"""Operations and bytes of the training step, counted by operation from
shapes (so the count does not depend on which kernel does the work), and
the card's published peaks.

Sizes are the real ones: real nodes n and real edges e (self-loops in,
padding out) of each step's batch. Bytes count each input read once and
each output written once, float32 values and int32 indices (the senders,
and the destinations as n + 1 offsets of the dst-sorted edges). Each
per-edge, per-head term of the attention counts its multiply-adds as two
operations and every other arithmetic operation (add, LeakyReLU, exp,
the dropout multiply, the divide) as one.

The attention operation, one layer of NH heads of F features (D = NH*F),
default form:
  forward   reads h (n, D), a_src (D, NH), s_dst (n, NH), the dropout
            multipliers (e, NH) where the layer drops, the senders and
            offsets; writes the output (n, D). Operations: the source
            scores h @ a_src, 2nD*NH; per edge and head the logit, the
            LeakyReLU, the exp, the denominator's add and the dropout
            multiply, 5, and the weighted sum, 2F; the normalising
            divide, nD.
  backward  reads the output's cotangent g and h (n, D), s_dst, a_src,
            the multipliers, the senders and offsets; writes d(h), d(s_dst)
            and d(a_src). Operations: per edge and head the logit chain
            again and its derivative, 8, g . h_src, 2F, and d(h)'s
            weighted sum, 2F; per node d(a_src) and d(h) through the
            source scores, 4nD*NH.
The step adds the products outside the attention: x @ W (2n*F_in*D), the
destination scores h @ a_dst (2nD*NH) and skip projections, each once
forward and twice backward (once where the input needs no gradient,
layer 0's), and the attention forward and backward. Elementwise work
(dropout, ELU, the loss, Adam) is not counted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from portbench.inputs import layer_dims

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = I32 = 4


def attention_forward(n: int, e: int, nh: int, f: int,
                      dropout: bool) -> Tuple[float, float]:
    """(operations, bytes) of one attention forward."""
    d = nh * f
    ops = 2 * n * d * nh + e * nh * (5 + 2 * f) + n * d
    nbytes = (F32 * (n * d + d * nh + n * nh + (e * nh if dropout else 0)
                     + n * d)
              + I32 * (e + n + 1))
    return float(ops), float(nbytes)


def attention_backward(n: int, e: int, nh: int, f: int,
                       dropout: bool) -> Tuple[float, float]:
    """(operations, bytes) of one attention backward."""
    d = nh * f
    ops = e * nh * (8 + 4 * f) + 4 * n * d * nh
    nbytes = (F32 * (2 * n * d + n * nh + d * nh + (e * nh if dropout else 0)
                     + n * d + n * nh + d * nh)
              + I32 * (e + n + 1))
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of work of `ops` operations and `nbytes` bytes, and
    which bound sets it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Counts:
    """The counts of a run of steps over batches of `nodes[k]` real nodes
    and `edges[k]` real edges, for `config`."""

    def __init__(self, config: dict, nodes: Sequence[int],
                 edges: Sequence[int]):
        self.dims = layer_dims(config)
        self.dropout = float(config["dropout"]) > 0.0
        self.steps = list(zip(nodes, edges))

    def step_ops(self) -> float:
        """Operations of every step, summed."""
        total = 0.0
        for n, e in self.steps:
            for i, ld in enumerate(self.dims):
                backward = 1 if i == 0 else 2
                product = 2.0 * n * ld.fin * ld.d
                total += product * (1 + backward)
                total += 2.0 * n * ld.d * ld.nh * 3
                if ld.skip == "project":
                    total += product * (1 + backward)
                total += attention_forward(n, e, ld.nh, ld.f,
                                           self.dropout)[0]
                total += attention_backward(n, e, ld.nh, ld.f,
                                            self.dropout)[0]
        return total

    def attention_least(self, direction: str) -> float:
        """The least seconds of every step's attention forward or backward,
        summed over layers and steps."""
        fn = {"forward": attention_forward,
              "backward": attention_backward}[direction]
        return sum(least_seconds(*fn(n, e, ld.nh, ld.f, self.dropout))[0]
                   for n, e in self.steps for ld in self.dims)
