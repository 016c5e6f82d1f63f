"""The GAT paper's own attention form (Velickovic et al., ICLR 2018,
arXiv:1710.10903, eqs. 1-4): the port's GATConfig with paper_faithful,
which takes the table op on the kernel path.

Weights, per layer: W (F_in, NH*F), xavier-uniform, and the per-head
attention vectors a (NH, 2F) in the port's layout, xavier-uniform of fan
2F in and 1 out: a[k, :F] scores the sender, a[k, F:] the destination;
per skip projection w (in, out), torch Linear's bound.

The attention operation, one layer of NH heads of F features (D = NH*F),
in operations alone: no metric reads this form's bytes (the attention
rooflines list the default form's cells only), so it gives None for them.
  forward   the per-head scores on each side, 2nD each; per edge and head
            the logit's gather-add, the LeakyReLU, the per-destination
            max's compare and its subtract, 4; and the table op's own
            forward (counts/table.py).
  backward  the table op's own backward; per edge and head the LeakyReLU's
            derivative and the two gathers' sums, 3; d(h) and d(a)
            through the scores on each side, 8nD.
Outside the attention: x @ W (2n*F_in*D) and skip projections, each once
forward and twice backward (once where the input needs no gradient,
layer 0's).
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import table
from portbench.forms import gat
from portbench.inputs import LayerDims


def port_args(config: dict) -> dict:
    return dict(gat.port_args(config), paper_faithful=True)


def per_head_a(ld: LayerDims):
    """The shape and bound of the per-head attention vectors a."""
    return (ld.nh, 2 * ld.f), (6.0 / (2 * ld.f + 1)) ** 0.5


def leaf_shapes(config: dict):
    return gat.leaf_shapes(config, per_head_a)


def attention_forward(n: int, e: int, nh: int, f: int,
                      dropout: bool) -> Tuple[float, None]:
    ops = 4 * n * nh * f + 4 * e * nh + table.forward(n, e, nh, f,
                                                       dropout)[0]
    return float(ops), None


def attention_backward(n: int, e: int, nh: int, f: int,
                       dropout: bool) -> Tuple[float, None]:
    ops = (table.backward(n, e, nh, f, dropout)[0] + 3 * e * nh
           + 8 * n * nh * f)
    return float(ops), None


outside_ops = gat.products_ops
