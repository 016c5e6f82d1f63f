"""op_host_ms, layer "op" (ops/cuda/*.py wrappers); moves
train_edges_per_s.

The host milliseconds of the port's spans "gat.op.<op>.forward" and
"gat.op.<op>.backward", around the forward and backward of each
attention op's autograd Function: the port's own wrapper cost (plans,
checks, ctypes calls and the launches they make), the sum a step, the
mean over the traced steps: the last ctx["steps"] of the port's step
records (utils/profiling `records()`, kept while the profiler records).
Nothing is read from a port that keeps no records, or where no record
holds such a span.
"""

LAYER = "op"
MOVES = "train_edges_per_s"
PREFIX = "gat.op."


def read(ctx):
    try:
        from gat_pytorch_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    steps = records()[-ctx["steps"]:] if ctx["steps"] else []
    ms = [s.host_ms for r in steps for s in r.spans
          if s.name.startswith(PREFIX)]
    if not ms:
        return None
    return sum(ms) / len(steps)
