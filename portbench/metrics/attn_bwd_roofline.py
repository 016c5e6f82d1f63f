"""attn_bwd_roofline, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The v5 attention backward's share of its roofline, in percent: the least
time of the traced steps' attention backwards (portbench/counts: each
layer's larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s; at the
cells' shapes the bytes bound it), over the device time of the kernels
below: the backward by sender and its tail (rows of 256 floats or fewer),
or the wide form, its d(a_src) pass and partial sums, and the d(h) reduce
after it. Nothing is read where none of them ran.
"""

LAYER = "kernels"
MOVES = "train_edges_per_s"
KERNELS = ("v5_bwd_sender_kernel", "bwd_tail_kernel", "v5_bwd_kernel",
           "v5_dasrc_kernel", "sum_partials_kernel", "seg_rows_wide_kernel",
           "seg_rows_kernel")


def read(ctx):
    spent = sum(sec for name, sec in ctx["kernels"]
                if any(k in name for k in KERNELS))
    if spent <= 0.0:
        return None
    return ctx["counts"].attention_least("backward") / spent * 100.0
