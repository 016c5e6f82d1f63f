"""The table attention op's own contract (the port's
ops/cuda/table_attention.py, its kernels table_fwd_kernel, the d(den)
prologue and table_bwd_kernel): operations and bytes of one call over n
real nodes and e real edges, NH heads of F features (D = NH*F), by the
conventions of portbench/counts. The edge logits come from the caller;
their gathers and the per-destination max are not the op's.

  forward   reads the logits (e, NH), h (n, D), the dropout multipliers
            (e, NH) where the layer drops, the senders and the n + 1
            destination offsets; writes the output (n, D) and the
            denominators (n, NH) the backward reads. Operations: per edge
            and head the exp, the denominator's add and the dropout
            multiply where it drops, and the weighted sum, 2F; the
            normalising divide, nD.
  backward  reads the output's cotangent g, h and the output (n, D), the
            denominators, the logits and multipliers, the receivers, the
            sender order and the n + 1 sender offsets; writes d(h) (n, D)
            and d(logits) (e, NH). No d(drop): the port draws the dropout
            multipliers without a gradient, so the op writes none in
            training. Operations: per destination d(den) = -inv * out . g,
            2nD + n*NH; per edge and head the exp and the coefficients, 8,
            g . h_src, 2F, and d(h)'s weighted sum, 2F.
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import F32, I32


def forward(n: int, e: int, nh: int, f: int,
            dropout: bool) -> Tuple[float, float]:
    d = nh * f
    masks = 2 if dropout else 1          # the logits, the multipliers
    ops = e * nh * (masks + 1 + 2 * f) + n * d
    nbytes = F32 * (masks * e * nh + 2 * n * d + n * nh) + I32 * (e + n + 1)
    return float(ops), float(nbytes)


def backward(n: int, e: int, nh: int, f: int,
             dropout: bool) -> Tuple[float, float]:
    d = nh * f
    masks = 2 if dropout else 1
    ops = e * nh * (8 + 4 * f) + 2 * n * d + n * nh
    nbytes = (F32 * (3 * n * d + n * nh + masks * e * nh + n * d + e * nh)
              + I32 * (2 * e + n + 1))
    return float(ops), float(nbytes)
