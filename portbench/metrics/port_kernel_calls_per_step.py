"""port_kernel_calls_per_step, layer "op" (ops/cuda/*.py wrappers);
moves train_edges_per_s.

The change over the traced steps of the port's count of its kernel
wrappers' launches (ops/cuda/build.py LAUNCHES), divided by the steps: an
exact count of the port's own kernels a step (torch's kernels are not in
it).
"""

LAYER = "op"
MOVES = "train_edges_per_s"


def read(ctx):
    if not ctx["steps"]:
        return None
    return sum(ctx["launches"].values()) / ctx["steps"]
