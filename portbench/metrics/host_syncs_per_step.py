"""host_syncs_per_step, layer "trainer" (train/trainer.py
Trainer.train_step and all it calls); moves train_edges_per_s.

The host's waits for the device inside a step: the port's counter
"host_syncs" (utils/profiling: each synchronising CUDA operation torch's
sync debug mode reports while the span "gat.step" is open on a CUDA
device; none on the CPU), from the port's step records (`records()`,
kept while the profiler records), the mean over the last ctx["steps"]
records, the traced steps'. Nothing is read from a port that keeps no
records.
"""

LAYER = "trainer"
MOVES = "train_edges_per_s"


def read(ctx):
    try:
        from gat_pytorch_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    steps = records()[-ctx["steps"]:] if ctx["steps"] else []
    if not steps:
        return None
    return sum(r.counters.get("host_syncs", 0) for r in steps) / len(steps)
