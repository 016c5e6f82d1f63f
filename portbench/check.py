"""The numbers that decide `correct`, from two readouts of the first steps
of training: the program's and the plain reference's.

A readout holds, for the first steps of one run from one seed: each
step's loss; per parameter leaf, the norm of the first gradient as the
optimiser took it (the L2 term included; the program's is worked out from
Adam's first moment after one step, m / (1 - beta1)); and per leaf, the
norm of the parameters' change over those steps.

Compared, each the worst case over steps or leaves:
  loss_gap    |loss - ref| / |ref|
  grad_gap    |norm - ref norm| / max(ref norm, the median leaf's ref norm)
  change_gap  the same for the change's norm, over the leaves whose
              reference gradient is at least a thousandth of the median
              leaf's (a leaf with no gradient moves under Adam by
              round-off alone)
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVING = 1e-3     # a leaf moves where its ref gradient is this x median


@dataclasses.dataclass
class Readout:
    losses: List[float]
    grads: List[float]
    changes: List[float]


def _gap(value: float, ref: float, scale: float) -> float:
    if not (math.isfinite(value) and math.isfinite(ref)):
        return math.inf
    return abs(value - ref) / scale


def compare(prog: Readout, ref: Readout) -> Dict[str, float]:
    if (len(prog.losses) != len(ref.losses)
            or len(prog.grads) != len(ref.grads)
            or len(prog.changes) != len(ref.changes)):
        raise ValueError("readouts of different steps or leaves")
    loss_gap = max(_gap(p, r, abs(r)) for p, r in zip(prog.losses,
                                                      ref.losses))
    gmed = statistics.median(ref.grads)
    grad_gap = max(_gap(p, r, max(r, gmed))
                   for p, r in zip(prog.grads, ref.grads))
    moving = [i for i, g in enumerate(ref.grads) if g >= MOVING * gmed]
    cmed = statistics.median(ref.changes[i] for i in moving)
    change_gap = max(_gap(prog.changes[i], ref.changes[i],
                          max(ref.changes[i], cmed)) for i in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): correct where every number
    is at most its limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, table
