"""table_bwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The table attention op's backward share of its roofline, in percent: the
least time of the op's own contract over the traced steps' layers
(portbench/counts/table.py `backward`: the output's cotangent, h, the
output, its denominators, the logits, the dropout multipliers, the
receivers and the sender order and offsets read; d(h) and d(logits)
written, no d(drop), as the multipliers take no gradient; each layer's
larger of bytes / 3.35 TB/s and operations
/ 67 TFLOP/s), over the device time of the kernels below: the backward by
sender and its d(den) prologue (the wide form at heads of 32 features or
more, the narrow one below). The backward of the logits' gathers runs
outside them and is charged to neither. Nothing is read where none of
them ran.
"""

from portbench.counts import table

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("table_bwd_kernel", "dden_kernel", "dden_narrow_kernel")


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].least(table.backward) / spent * 100.0
