"""host_enqueue_ms, layer "trainer" (train/trainer.py Trainer.train_step,
train/optim.py); moves train_edges_per_s.

The benchmark's own span around each traced `train_step` call: the host's
milliseconds until the eager step returns (its launches enqueued, any
wait on a full launch queue or a synchronisation inside the step
included), the mean over the traced steps.
"""

LAYER = "trainer"
MOVES = "train_edges_per_s"


def read(ctx):
    times = ctx["host_step_s"]
    if not times:
        return None
    return sum(times) / len(times) * 1e3
