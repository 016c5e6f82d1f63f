"""The repo's default GAT form (the reference implementation's): the
port's GATConfig with no form flag, the cross-head attention map, and the
v5 op's counts.

Weights, per layer: W (F_in, NH*F) and the cross-head attention map
a (NH*2F, NH), xavier-uniform; per skip projection w (in, out), torch
Linear's bound.

The attention operation, one layer of NH heads of F features (D = NH*F):
  forward   reads h (n, D), a_src (D, NH), s_dst (n, NH), the dropout
            multipliers (e, NH) where the layer drops, the senders and
            offsets; writes the output (n, D). Operations: the source
            scores h @ a_src, 2nD*NH; per edge and head the logit, the
            LeakyReLU, the exp, the denominator's add and the dropout
            multiply, 5, and the weighted sum, 2F; the normalising
            divide, nD.
  backward  reads the output's cotangent g and h (n, D), s_dst, a_src,
            the multipliers, the senders and offsets; writes d(h), d(s_dst)
            and d(a_src). Operations: per edge and head the logit chain
            again and its derivative, 8, g . h_src, 2F, and d(h)'s
            weighted sum, 2F; per node d(a_src) and d(h) through the
            source scores, 4nD*NH.
Outside the attention: x @ W (2n*F_in*D), the destination scores
h @ a_dst (2nD*NH) and skip projections, each once forward and twice
backward (once where the input needs no gradient, layer 0's).
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import F32, I32
from portbench.inputs import LayerDims, layer_dims

PORT_KEYS = ("num_input_node_features", "num_layers", "num_heads_per_layer",
             "heads_concat_per_layer", "head_output_features_per_layer",
             "num_classes", "add_skip_connection", "dropout")


def port_args(config: dict) -> dict:
    args = {k: config[k] for k in PORT_KEYS}
    args["dropout"] = float(args["dropout"])
    return args


def cross_head_a(ld: LayerDims):
    """The shape and bound of the cross-head attention map a."""
    return (ld.d * 2, ld.nh), (6.0 / (ld.d * 2 + ld.nh)) ** 0.5


def leaf_shapes(config: dict, attention=cross_head_a):
    """attention(ld): the shape and bound of the layer's a."""
    shapes = []
    for i, ld in enumerate(layer_dims(config)):
        shapes.append((("layers", i, "W"), (ld.fin, ld.d),
                       (6.0 / (ld.fin + ld.d)) ** 0.5))
        shapes.append((("layers", i, "a"),) + attention(ld))
        if ld.skip == "project":
            shapes.append((("skips", i, "w"), (ld.fin, ld.d),
                           1.0 / ld.fin ** 0.5))
    return shapes


def attention_forward(n: int, e: int, nh: int, f: int,
                      dropout: bool) -> Tuple[float, float]:
    d = nh * f
    ops = 2 * n * d * nh + e * nh * (5 + 2 * f) + n * d
    nbytes = (F32 * (n * d + d * nh + n * nh + (e * nh if dropout else 0)
                     + n * d)
              + I32 * (e + n + 1))
    return float(ops), float(nbytes)


def attention_backward(n: int, e: int, nh: int, f: int,
                       dropout: bool) -> Tuple[float, float]:
    d = nh * f
    ops = e * nh * (8 + 4 * f) + 4 * n * d * nh
    nbytes = (F32 * (2 * n * d + n * nh + d * nh + (e * nh if dropout else 0)
                     + n * d + n * nh + d * nh)
              + I32 * (e + n + 1))
    return float(ops), float(nbytes)


def products_ops(n: int, ld: LayerDims, first: bool) -> float:
    """x @ W and a skip projection, forward and backward."""
    backward = 1 if first else 2
    product = 2.0 * n * ld.fin * ld.d * (1 + backward)
    return 2 * product if ld.skip == "project" else product


def outside_ops(n: int, ld: LayerDims, first: bool) -> float:
    return products_ops(n, ld, first) + 2.0 * n * ld.d * ld.nh * 3
