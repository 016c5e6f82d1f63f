"""On the card (marked `card`; skipped without one): each cell's control,
the reference in the program's place with TF32 products (the precision
below the configurations' float32), fails the check at the cell's own
size, where the program's own first steps pass it."""

import gc

import pytest
import torch

from portbench import check, harness, spec
from portbench import traffic as T
from portbench.tests.helpers import benchmark

CELLS = [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, name):
    cell = spec.load_cell(name)
    seed = 2 ** 31 + 77
    data = T.make(cell.traffic, cell.generator(), seed)
    prog = harness.build_program(cell, data, seed, card)
    readout = harness.first_steps(prog)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    ref = harness.reference_readout(cell, data, seed, card)
    control = harness.reference_readout(cell, data, seed, card, control=True)
    assert check.judge(check.compare(readout, ref), cell.limits)[0]
    assert not check.judge(check.compare(control, ref), cell.limits)[0]
