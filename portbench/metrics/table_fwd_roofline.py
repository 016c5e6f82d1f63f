"""table_fwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The table attention op's forward share of its roofline, in percent: the
least time of the op's own contract over the traced steps' layers
(portbench/counts/table.py `forward`: the logits, h, the dropout
multipliers, the senders and offsets read, the output and its
denominators written; each layer's larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s), over the device time of the kernel below. The
logits' gathers and the per-destination max run in torch outside it and
are charged to neither. Nothing is read where it did not run (another
attention path).
"""

from portbench.counts import table

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("table_fwd_kernel",)


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].least(table.forward) / spent * 100.0
