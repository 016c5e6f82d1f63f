"""The readers of the port's spans and counters (`forward_host_ms` to
`host_syncs_per_step`): each reads the mean of the last ctx["steps"] step
records the port keeps, and nothing where there is nothing to read (no
records, no device events, a port without records); a traced run on the
CPU reports the host's spans and the sync count and no device time; on
the card (marked `card`), a traced step reads device times and counts a
planted synchronisation."""

import math
import time

import pytest
import torch

from gat_pytorch_tpu_torch.utils import profiling as P
from portbench import harness, spec
from portbench.tests.helpers import BENCH, small_root

CPU = torch.device("cpu")
HOST = ["forward_host_ms", "backward_host_ms", "optimizer_host_ms",
        "op_host_ms"]
DEVICE = ["forward_device_ms", "backward_device_ms", "optimizer_device_ms"]
READERS = HOST + DEVICE + ["host_syncs_per_step"]


def reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py")


class _Events:
    """A pair of events whose interval is `ms`."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms


def _record(i, events=True):
    """Step i: each span's host and device ms grow with i where the
    expected means below say so."""
    rec = P.StepRecord(i, torch.device("cuda" if events else "cpu"))
    at = 0

    def add(name, host_ms, device_ms=None):
        nonlocal at
        ns = round(host_ms * 1e6)
        span = P.SpanRecord(name, None, 1, at, at + ns)
        if events and device_ms is not None:
            span.events = (_Events(0.0), _Events(device_ms))
        rec.spans.append(span)
        at += ns

    add("gat.step", 10 + i, 20 + i)
    add("gat.forward", 4 + i, 5 + i)
    add("gat.layer.0", 1.5)
    add("gat.op.v5_attention.forward", 0.25)
    add("gat.op.v5_attention.forward", 0.25)
    add("gat.optimizer", 0.125, 0.25)
    add("gat.backward", 3, 8 + 2 * i)
    add("gat.op.v5_attention.backward", 0.5)
    add("gat.op.v5_attention.backward", 0.5)
    add("gat.optimizer", 0.5 + i, 1.0)
    rec.counters["host_syncs"] = i
    return rec


# over steps 2, 3 and 4 (the last 3 of 5)
EXPECTED = {
    "forward_host_ms": 7.0, "backward_host_ms": 3.0,
    "optimizer_host_ms": 0.125 + 0.5 + 3.0, "op_host_ms": 1.5,
    "forward_device_ms": 8.0, "backward_device_ms": 14.0,
    "optimizer_device_ms": 1.25, "host_syncs_per_step": 3.0,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_means_the_last_steps(name, monkeypatch):
    monkeypatch.setattr(P, "records", lambda: [_record(i) for i in range(5)])
    assert reader(name).read({"steps": 3}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_records(name, monkeypatch):
    monkeypatch.setattr(P, "records", lambda: [])
    assert reader(name).read({"steps": 3}) is None
    monkeypatch.setattr(P, "records", lambda: [_record(i) for i in range(5)])
    assert reader(name).read({"steps": 0}) is None
    monkeypatch.delattr(P, "records")          # a port that keeps none
    assert reader(name).read({"steps": 3}) is None


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_need_events(name, monkeypatch):
    monkeypatch.setattr(P, "records",
                        lambda: [_record(i, events=False) for i in range(5)])
    assert reader(name).read({"steps": 3}) is None


def test_a_traced_cpu_run_reports_the_host_spans_and_syncs(tmp_path):
    root = small_root(tmp_path)
    cell = spec.load_cell("arxiv-full-v5", data_root=root)
    res = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True, CPU,
                           time.perf_counter())
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    for name in HOST:
        assert metrics[name]["unit"] == "ms"
        assert math.isfinite(metrics[name]["value"])
        assert metrics[name]["value"] > 0.0
    assert metrics["host_syncs_per_step"] == {"value": 0.0,
                                              "unit": "syncs"}
    assert not set(DEVICE) & set(metrics)
    assert (metrics["forward_host_ms"]["value"]
            < metrics["host_enqueue_ms"]["value"])


@pytest.mark.card
def test_a_traced_step_on_the_card_reads_device_times_and_syncs(card):
    """One profiled train step on the card, and one with a planted
    .item(): device times for every phase, the planted sync counted."""
    from gat_pytorch_tpu_torch.graph import transforms as TT
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train import optim as O
    from gat_pytorch_tpu_torch.train.tasks import make_task
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    import numpy as np
    cfg = gat.GATConfig(num_input_node_features=16, num_layers=2,
                        num_heads_per_layer=[4, 1],
                        heads_concat_per_layer=[True, False],
                        head_output_features_per_layer=[16, 8, 5],
                        num_classes=5, add_skip_connection=[False, False],
                        dropout=0.5)
    rng = np.random.default_rng(0)
    g = TT.canonicalize(rng.random((300, 16)).astype(np.float32),
                        rng.integers(0, 300, 2000),
                        rng.integers(0, 300, 2000),
                        y=rng.integers(0, 5, 300),
                        train_mask=np.ones(300, bool),
                        val_mask=np.ones(300, bool)).to(card)
    trainer = Trainer(cfg=cfg, task=make_task("Cora"), learning_rate=0.01,
                      device=str(card))
    params = trainer.init_params()
    opt = O.adam_l2(gat.parameters(params), trainer.learning_rate)
    gen = trainer.dropout_generator()
    trainer.train_step(params, opt, g, gen)
    with torch.profiler.profile():
        trainer.train_step(params, opt, g, gen)
        with P.step(card):
            planted = torch.ones(8, device=card).sum().item()
    torch.cuda.synchronize(card)
    step, plant = P.records()[-2:]
    assert planted == 8.0
    for name in ("gat.step", "gat.forward", "gat.backward"):
        (span,) = step.named(name)
        assert span.device_ms > 0.0
    assert all(s.device_ms >= 0.0 for s in step.named("gat.optimizer"))
    assert step.named("gat.op.v5_attention.backward")
    assert plant.counters["host_syncs"] >= 1
    assert torch.cuda.get_sync_debug_mode() == 0
