"""GATv2's dynamic attention (Brody, Alon and Yahav, ICLR 2022,
arXiv:2105.14491): the port's GATConfig with gatv2, which takes the GATv2
op on the kernel path.

Weights, per layer: W (F_in, NH*F), the sender-side and message transform
W_l, and W_r (F_in, NH*F), the destination-side one, both xavier-uniform;
the per-head attention vectors a (NH, F), xavier-uniform of fan NH and F
(PyG's glorot on its (1, NH, F) att); per skip projection w (in, out),
torch Linear's bound. In the order of the one flat draw: W, W_r, a (the
port's sorted keys).

The attention operation, one layer: the GATv2 op's own contract
(counts/gatv2.py), forward and backward; the logit is formed inside it.
Outside the attention: x @ W and x @ W_r (2n*F_in*D each) and skip
projections, each once forward and twice backward (once where the input
needs no gradient, layer 0's).
"""

from __future__ import annotations

from portbench.counts import gatv2
from portbench.forms import gat
from portbench.inputs import LayerDims, layer_dims


def port_args(config: dict) -> dict:
    return dict(gat.port_args(config), gatv2=True)


def leaf_shapes(config: dict):
    shapes = []
    for i, ld in enumerate(layer_dims(config)):
        bound = (6.0 / (ld.fin + ld.d)) ** 0.5
        shapes.append((("layers", i, "W"), (ld.fin, ld.d), bound))
        shapes.append((("layers", i, "W_r"), (ld.fin, ld.d), bound))
        shapes.append((("layers", i, "a"), (ld.nh, ld.f),
                       (6.0 / (ld.nh + ld.f)) ** 0.5))
        if ld.skip == "project":
            shapes.append((("skips", i, "w"), (ld.fin, ld.d),
                           1.0 / ld.fin ** 0.5))
    return shapes


attention_forward = gatv2.forward
attention_backward = gatv2.backward


def outside_ops(n: int, ld: LayerDims, first: bool) -> float:
    """x @ W, x @ W_r and a skip projection, forward and backward."""
    backward = 1 if first else 2
    return gat.products_ops(n, ld, first) + 2.0 * n * ld.fin * ld.d * (
        1 + backward)
