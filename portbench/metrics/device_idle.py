"""device_idle, layer "device"; moves train_edges_per_s.

1 - (the union of the device's activity intervals in the traced window /
the window), from torch.profiler, in percent.
"""

LAYER = "device"
MOVES = "train_edges_per_s"


def read(ctx):
    if ctx["window_s"] <= 0.0 or ctx["busy_s"] <= 0.0:
        return None
    return (1.0 - ctx["busy_s"] / ctx["window_s"]) * 100.0
