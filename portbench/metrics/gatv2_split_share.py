"""gatv2_split_share, layer "kernels" (ops/cuda/csrc/*.cu); moves
train_edges_per_s.

The share of the GATv2 op's real slots that the warps of its backward's
pass by sender walk in the items of a cut run (ops/cuda/build.py
sender_items: a sender's run longer than L slots is cut into items of at
most L, each on its own warp, and the tail adds the parts), in percent:
the port's counters "gatv2_bwd_split_slots" over "gatv2_bwd_slots" (each
call of the GATv2 backward, ops/cuda/gatv2_attention.py), summed over the
last ctx["steps"] step records, the traced steps'. Nothing is read from a
port that counts no GATv2 backward slots.
"""

LAYER = "kernels"
MOVES = "train_edges_per_s"


def read(ctx):
    try:
        from gat_pytorch_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    steps = records()[-ctx["steps"]:] if ctx["steps"] else []
    slots = sum(r.counters.get("gatv2_bwd_slots", 0) for r in steps)
    if not slots:
        return None
    split = sum(r.counters.get("gatv2_bwd_split_slots", 0) for r in steps)
    return 100.0 * split / slots
