"""optimizer_device_ms, layer "optimiser" (train/optim.py); moves
train_edges_per_s.

The stream's milliseconds between the CUDA events the port records at
the open and the close of its two spans "gat.optimizer" (the device's
idle time between them included), the sum a step, the mean over the
traced steps: the last ctx["steps"] of the port's step records
(utils/profiling `records()`, kept while the profiler records; the
harness synchronises before it reads). Nothing is read from a port that
keeps no records, where no record holds the span, or where its spans
carry no events (the CPU).
"""

LAYER = "optimiser"
MOVES = "train_edges_per_s"
SPAN = "gat.optimizer"


def read(ctx):
    try:
        from gat_pytorch_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    steps = records()[-ctx["steps"]:] if ctx["steps"] else []
    ms = [s.device_ms for r in steps for s in r.spans if s.name == SPAN]
    if not ms or None in ms:
        return None
    return sum(ms) / len(steps)
