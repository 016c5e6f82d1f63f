"""The reader of bwd_split_share: the port's counters bwd_split_slots over
bwd_slots, summed over the last ctx["steps"] step records, in percent;
nothing where no record counts a backward slot (a port without the
counters, or a run on the CPU, whose backward runs no kernel)."""

import pytest
import torch

from gat_pytorch_tpu_torch.utils import profiling as P
from portbench import spec
from portbench.tests.helpers import BENCH


def reader():
    return spec.load_module(BENCH / "metrics" / "bwd_split_share.py")


def _record(i, slots, split):
    rec = P.StepRecord(i, torch.device("cuda"))
    if slots is not None:
        rec.counters.update(bwd_slots=slots, bwd_split_slots=split)
    return rec


def test_share_of_the_traced_steps(monkeypatch):
    # the first record is not a traced step's, and its share is other
    recs = [_record(0, 100, 90)] + [_record(i, 200, 10 * i)
                                    for i in range(1, 5)]
    monkeypatch.setattr(P, "records", lambda: recs)
    got = reader().read({"steps": 4})
    assert got == pytest.approx(100.0 * (10 + 20 + 30 + 40) / 800)


@pytest.mark.parametrize("records", [[], [None, None]])
def test_nothing_to_read(records, monkeypatch):
    monkeypatch.setattr(P, "records", lambda: [
        _record(i, r, 0) for i, r in enumerate(records)])
    assert reader().read({"steps": 2}) is None
    assert reader().read({"steps": 0}) is None
