"""backward_host_ms, layer "autograd" (loss.backward(), the ops' backward
wrappers); moves train_edges_per_s.

The host milliseconds of the port's span "gat.backward" (in
Trainer.train_step: loss.backward(), until the autograd engine returns;
on a CUDA device the engine's thread enqueues the backward while the
step's thread waits), the sum a step, the mean over the traced steps:
the last ctx["steps"] of the port's step records (utils/profiling
`records()`, kept while the profiler records). Nothing is read from a
port that keeps no records, or where no record holds such a span.
"""

LAYER = "autograd"
MOVES = "train_edges_per_s"
SPAN = "gat.backward"


def read(ctx):
    try:
        from gat_pytorch_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    steps = records()[-ctx["steps"]:] if ctx["steps"] else []
    ms = [s.host_ms for r in steps for s in r.spans if s.name == SPAN]
    if not ms:
        return None
    return sum(ms) / len(steps)
