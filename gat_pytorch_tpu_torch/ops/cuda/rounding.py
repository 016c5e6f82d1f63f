"""Where an attention kernel rounds to bfloat16: the JAX package's dtype
knobs as one policy that the ops hand to their kernels and plain versions.

The JAX package's kernels feed bfloat16 operands to some of their
contractions and keep float32 accumulators (GAT_TPU_V6_DTYPE, the
windowed op's default; GAT_TPU_KERNEL_DTYPE and GAT_TPU_H_DTYPE, opt-in
modes of the v5 and v4 ops). What decides the result is where a value is
rounded, not the dtype: `Rounding` names those points. The knobs are read
where the JAX package reads them (window_attention._v6_dtype and
_pair_slot, v5_attention._matmul_dtype and _h_dtype), at call time, and
the op passes the policy down. A CUDA wrapper packs it into the flags
word of its C entry (`flags`, the kRound* / kBf16Table bits of
csrc/attention_common.cuh); a plain version applies it with `maybe_bf16`.
Rounding is to the nearest bfloat16, ties to even, as XLA's convert,
torch's .to(torch.bfloat16) and the kernels' __float2bfloat16_rn do.
"""

from __future__ import annotations

import dataclasses

import torch

# the bits of the flags word (csrc/attention_common.cuh)
_BITS = {"rows": 1, "acc": 2, "payload": 4, "d_h": 8, "d_raw": 16,
         "d_sdst": 32}
BF16_TABLE = 64


@dataclasses.dataclass(frozen=True)
class Rounding:
    """The points where an attention op rounds to bfloat16; all False is
    the float32 mode.

    table    the h table is cast to bfloat16 before the gather: the op
             hands its kernel a bfloat16 table, so the logits and every
             product read rounded rows (GAT_TPU_H_DTYPE; the windowed
             op's packed window);
    rows     the gathered float32 rows are rounded after the logits are
             taken from them (the windowed op's other forms);
    acc      forward: each edge's weighted h row and its exp term, before
             the float32 sums of num and den;
    payload  backward: g, 1/(den + eps) and d(den) of each destination;
    d_h      backward: each edge's d(h) row, before the sum by sender;
    d_raw    backward: d(raw) in the products that give d(a_src);
    d_sdst   backward: d(raw) in the sums that give d(s_dst).
    A field that an op's forward or backward has no such point for is not
    read there."""
    table: bool = False
    rows: bool = False
    acc: bool = False
    payload: bool = False
    d_h: bool = False
    d_raw: bool = False
    d_sdst: bool = False

    def flags(self) -> int:
        """The flags word of a C entry; the table bit says that h is a
        bfloat16 table."""
        word = BF16_TABLE if self.table else 0
        for name, bit in _BITS.items():
            if getattr(self, name):
                word |= bit
        return word

    def counter(self, name: str) -> str:
        """The launch counter of kernel entry `name` in this mode."""
        return name if self == FLOAT32 else name + "_bf16"

    def table_of(self, h: torch.Tensor) -> torch.Tensor:
        """The h table as this mode's kernels read it: cast to bfloat16
        once where `table`, else h."""
        return h.to(torch.bfloat16) if self.table else h


FLOAT32 = Rounding()
# the v2 segment attention op (segment_attention.py) under
# GAT_TPU_KERNEL_DTYPE=bfloat16: each edge's [m*ex*h | ex] rounded before
# the forward's float32 sums (the JAX kernel's `combined` operand); its
# h_src rows arrive gathered in float32 and its backward does not round
V2_BF16 = Rounding(acc=True)


def maybe_bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    """t rounded to the nearest bfloat16, as float32, where `on`."""
    return t.to(torch.bfloat16).to(torch.float32) if on else t


def check_table(h: torch.Tensor, rounding: Rounding) -> None:
    """Raise unless h is the table `rounding` reads: bfloat16 in the
    table mode, float32 otherwise."""
    want = torch.bfloat16 if rounding.table else torch.float32
    if h.dtype != want:
        raise ValueError(f"h: dtype {h.dtype}, expected {want} for "
                         f"{rounding}")
