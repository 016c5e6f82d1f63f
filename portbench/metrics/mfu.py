"""mfu, layer "step" (models/gat.py through the optimiser); moves
train_edges_per_s.

The step's float32 operations, counted from shapes (portbench/counts:
the products forward and backward and the per-edge attention work), over
the traced steps, divided by the traced window's seconds and by the
card's float32 peak outside the tensor cores (67 TFLOP/s; the port runs
its products with TF32 off), in percent.
"""

from portbench.counts import PEAK_F32_OPS

LAYER = "step"
MOVES = "train_edges_per_s"


def read(ctx):
    if ctx["window_s"] <= 0.0 or ctx["busy_s"] <= 0.0:
        return None
    ops = ctx["counts"].step_ops()
    return ops / ctx["window_s"] / PEAK_F32_OPS * 100.0
