"""A run whose timed path is broken underneath comes out not correct:
each fault a training cell on one chip can have, planted in the port and
driven through the whole run but for the look for a card (the exchange
between chips and an answer altered where it is produced do not apply:
one chip, and training serves no answers)."""

import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests.helpers import WORKLOADS, small_root


def half(fn):
    """`fn` (a masked loss) over the first half of the mask's nodes."""
    def broken(logits, labels, mask, *args, **kw):
        idx = torch.nonzero(mask)[:, 0]
        kept = torch.zeros_like(mask)
        kept[idx[: idx.shape[0] // 2]] = True
        return fn(logits, labels, kept, *args, **kw)
    return broken


def plant(monkeypatch, fault):
    from gat_pytorch_tpu_torch.train import metrics
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        monkeypatch.setattr(metrics, "masked_cross_entropy",
                            half(metrics.masked_cross_entropy))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_fault_comes_out_not_correct(name, fault, tmp_path, monkeypatch):
    cell = spec.load_cell(name, data_root=small_root(tmp_path))
    plant(monkeypatch, fault)
    res = harness.run_cell(cell, 31, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    assert res["correct"] is False
    over = [k for k, v in res["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]]
    assert over
