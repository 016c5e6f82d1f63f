"""The GATv2 attention op's own contract (the port's
ops/cuda/gatv2_attention.py, its kernels gatv2_fwd_kernel and the
backward's gatv2_bwd_dst_kernel, gatv2_bwd_src_kernel and tail):
operations and bytes of one call over n real nodes and e real edges, NH
heads of F features (D = NH*F), by the conventions of portbench/counts.

  forward   reads xl and xr (n, D), a (D), the dropout multipliers (e, NH)
            where the layer drops, the senders and the n + 1 destination
            offsets; writes the output (n, D) and each destination's max
            and denominator (n, NH) the backward reads. Operations: per
            edge and head the logit, z = xl_j + xr_i, its LeakyReLU and the
            dot with a, 4F; the exp and the denominator's add, 2; the
            dropout multiply where it drops; the weighted sum, 2F; the
            normalising multiply, nD.
  backward  reads the output's cotangent g, the output, xl and xr (n, D),
            a, the max and the denominator, the multipliers, the senders
            and receivers, the n + 1 destination offsets, the sender order
            and the n + 1 sender offsets; writes d(xl), d(xr) (n, D) and
            d(a) (D). Operations: per destination g . out, 2nD; per edge
            and head the logit again and its softmax weight, 4F + 2;
            g . xl_j, 2F; de, 3; de * a * LeakyReLU'(z), 2F; d(xr)'s sum,
            F; d(xl)'s term m p g + that and its sum, 3F + 1; d(a)'s
            multiply-add of de * LeakyReLU(z), 2F.
The backward's per-edge scratch (de and m p, (E, NH), written by its pass
by destination for its pass by sender) is the kernels' and not the op's:
it is not counted.
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import F32, I32


def forward(n: int, e: int, nh: int, f: int,
            dropout: bool) -> Tuple[float, float]:
    d = nh * f
    drop = 1 if dropout else 0
    ops = e * nh * (6 * f + 2 + drop) + n * d
    nbytes = (F32 * (2 * n * d + d + drop * e * nh + n * d + 2 * n * nh)
              + I32 * (e + n + 1))
    return float(ops), float(nbytes)


def backward(n: int, e: int, nh: int, f: int,
             dropout: bool) -> Tuple[float, float]:
    d = nh * f
    drop = 1 if dropout else 0
    ops = e * nh * (14 * f + 6) + 2 * n * d
    nbytes = (F32 * (4 * n * d + d + 2 * n * nh + drop * e * nh
                     + 2 * n * d + d)
              + I32 * (3 * e + 2 * (n + 1)))
    return float(ops), float(nbytes)
