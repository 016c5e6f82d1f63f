"""attn_fwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The v5 attention forward's share of its roofline, in percent: the least
time of the traced steps' attention forwards (portbench/counts: each
layer's larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s; at the
cells' shapes the bytes bound it), over the device time of the kernels
below. Nothing is read where none of them ran (another attention path).
"""

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("source_scores_kernel", "v5_fwd_kernel", "cap_reduce_kernel")


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].attention_least("forward") / spent * 100.0
