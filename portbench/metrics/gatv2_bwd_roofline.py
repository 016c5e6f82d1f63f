"""gatv2_bwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The GATv2 op's backward share of its roofline, in percent: the least time
of the op's own contract over the traced steps' layers
(portbench/counts/gatv2.py `backward`: g, the output, xl, xr, a, the max
and denominator, the multipliers, the senders, receivers, sender order and
both offsets read; d(xl), d(xr) and d(a) written; each layer's larger of
bytes / 3.35 TB/s and operations / 67 TFLOP/s), over the device time of
the kernels below: the pass by destination, the pass by sender, and the
tail that adds the blocks' d(a) partial rows and a cut sender's partial
rows (the v5 backward's bwd_tail_kernel, which no other op of this cell's
path launches). Nothing is read where none of them ran.
"""

from portbench.counts import gatv2

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("gatv2_bwd_dst_kernel", "gatv2_bwd_src_kernel",
           "bwd_tail_kernel")


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].least(gatv2.backward) / spent * 100.0
