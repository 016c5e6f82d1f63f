"""gatv2_fwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The GATv2 op's forward share of its roofline, in percent: the least time
of the op's own contract over the traced steps' layers
(portbench/counts/gatv2.py `forward`: xl, xr, a, the dropout multipliers,
the senders and offsets read, the output and each destination's max and
denominator written; each layer's larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s), over the device time of the kernel below, which
forms the logits too. Nothing is read where it did not run (another
attention path).
"""

from portbench.counts import gatv2

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("gatv2_fwd_kernel",)


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].least(gatv2.forward) / spent * 100.0
