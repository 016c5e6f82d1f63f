"""utils/profiling.py: time_fn's contract (the JAX version's), and a
trace written by trace() that names the annotate() regions."""

import glob
import json
import os

import pytest
import torch

from gat_pytorch_tpu_torch.utils import profiling as P


def test_time_fn_calls_and_median(monkeypatch):
    """warmup + iters calls, the median of the iters' times, the last
    output back; the clock read around each timed call only."""
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return torch.tensor([len(calls)])

    stamps = []
    for i, d in enumerate([5.0, 1.0, 3.0, 4.0, 2.0]):
        stamps += [10.0 * i, 10.0 * i + d]
    clock = iter(stamps)
    monkeypatch.setattr(P.time, "perf_counter", lambda: next(clock))
    sec, out = P.time_fn(fn, 1, 2, warmup=3, iters=5)
    assert calls == [(1, 2)] * 8
    assert sec == 3.0                     # sorted 1 2 3 4 5: the middle
    assert int(out) == 8
    assert next(clock, None) is None


def test_time_fn_syncs_only_the_outputs_cuda_devices(monkeypatch):
    """No sync for CPU outputs (a tensor, or nested tuples, lists and
    dicts of them); one sync a CUDA device the output holds."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    cpu = torch.zeros(2)
    for out in (cpu, (cpu, [cpu]), {"a": cpu, "b": (cpu, None)}, None, 3):
        P.time_fn(lambda: out, warmup=1, iters=2)
    assert synced == []
    cards = {torch.device("cuda", 0), torch.device("cuda", 1)}
    monkeypatch.setattr(P, "_cuda_devices", lambda out, found: set(cards))
    P.block_until_ready(cpu)
    assert set(synced) == cards and len(synced) == 2


def test_trace_writes_the_annotated_regions(tmp_path):
    """trace() writes a Chrome-format trace under logdir that names the
    annotate() region and the ops run inside it."""
    x = torch.randn(64, 64)
    logdir = tmp_path / "trace"
    with P.trace(str(logdir)) as prof:
        with P.annotate("gat_layer_0"):
            y = x @ x
        z = torch.relu(y)
    assert torch.isfinite(z).all()
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert files == [prof.trace_path]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "gat_layer_0" in names
    assert any("mm" in (n or "") for n in names)
    region = next(e for e in events if e.get("name") == "gat_layer_0")
    assert region.get("dur", 0) > 0
    assert os.path.getsize(files[0]) > 0


@pytest.mark.parametrize("warmup,iters", [(0, 1), (2, 10)])
def test_time_fn_on_a_real_clock(warmup, iters):
    sec, out = P.time_fn(lambda a: a * 2, torch.ones(3), warmup=warmup,
                         iters=iters)
    assert sec >= 0.0 and torch.equal(out, torch.full((3,), 2.0))
