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

What depends on the model's form (its attention forward and backward,
and the products outside it) is the form module's (portbench/forms); a
kernel's own contract is a module here (`table`). The step is the
products outside the attention and the attention forward and backward,
a layer. Elementwise work (dropout, ELU, the loss, Adam) is not counted.
"""

from __future__ import annotations

from types import ModuleType
from typing import Callable, Sequence, Tuple

from portbench.inputs import layer_dims

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = I32 = 4


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of work of `ops` operations and `nbytes` bytes, and
    which bound sets it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Counts:
    """The counts of a run of steps over batches of `nodes[k]` real nodes
    and `edges[k]` real edges, for `config` in the model form `form` (its
    module, portbench/forms)."""

    def __init__(self, form: ModuleType, config: dict, nodes: Sequence[int],
                 edges: Sequence[int]):
        self.form = form
        self.dims = layer_dims(config)
        self.dropout = float(config["dropout"]) > 0.0
        self.steps = list(zip(nodes, edges))

    def step_ops(self) -> float:
        """Operations of every step, summed."""
        total = 0.0
        for n, e in self.steps:
            for i, ld in enumerate(self.dims):
                total += self.form.outside_ops(n, ld, i == 0)
                total += self.form.attention_forward(n, e, ld.nh, ld.f,
                                                     self.dropout)[0]
                total += self.form.attention_backward(n, e, ld.nh, ld.f,
                                                      self.dropout)[0]
        return total

    def least(self, fn: Callable[..., Tuple[float, float]]) -> float:
        """The least seconds of `fn(n, e, nh, f, dropout)`'s (operations,
        bytes), summed over every step's layers."""
        return sum(least_seconds(*fn(n, e, ld.nh, ld.f, self.dropout))[0]
                   for n, e in self.steps for ld in self.dims)

    def attention_least(self, direction: str) -> float:
        """The least seconds of every step's attention forward or backward,
        summed over layers and steps."""
        return self.least({"forward": self.form.attention_forward,
                           "backward": self.form.attention_backward
                           }[direction])
