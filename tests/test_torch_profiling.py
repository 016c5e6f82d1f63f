"""utils/profiling.py: time_fn's contract (the JAX version's), a trace
written by trace() that names the span() regions, and the port's spans
and counters: off without a profiler, on and nested under one."""

import glob
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat
from gat_pytorch_tpu_torch.train import optim as O
from gat_pytorch_tpu_torch.train.tasks import make_task
from gat_pytorch_tpu_torch.train.trainer import Trainer
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
    span() region and the ops run inside it."""
    x = torch.randn(64, 64)
    logdir = tmp_path / "trace"
    with P.trace(str(logdir)) as prof:
        with P.span("gat_layer_0"):
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


def _tiny_step(backend="segment"):
    """A two-layer model with dropout on a 12-node graph, and a function
    that takes one Trainer.train_step on it."""
    cfg = gat.GATConfig(num_input_node_features=4, num_layers=2,
                        num_heads_per_layer=[2, 1],
                        heads_concat_per_layer=[True, False],
                        head_output_features_per_layer=[4, 3, 3],
                        num_classes=3, add_skip_connection=[False, False],
                        dropout=0.5)
    rng = np.random.default_rng(0)
    g = TT.canonicalize(rng.random((12, 4)).astype(np.float32),
                        rng.integers(0, 12, 40), rng.integers(0, 12, 40),
                        y=rng.integers(0, 3, 12),
                        train_mask=np.ones(12, bool),
                        val_mask=np.ones(12, bool))
    trainer = Trainer(cfg=cfg, task=make_task("Cora"), learning_rate=0.01,
                      device="cpu", backend=backend)
    params = trainer.init_params()
    opt = O.adam_l2(gat.parameters(params), trainer.learning_rate)
    gen = trainer.dropout_generator()
    return lambda: trainer.train_step(params, opt, g, gen)


def test_the_profiler_flag_spans_read():
    """Spans are on exactly while a torch profiler records: the flag they
    read is torch.autograd.profiler._is_profiler_enabled, a plain bool,
    set by torch.profiler.profile and by trace() alike."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa
    assert flag() is False
    with torch.profiler.profile():
        assert flag() is True
    assert flag() is False


def test_span_off_is_the_shared_null_context():
    before = P.records()
    spans = {id(P.span("gat.forward")), id(P.span("gat.layer", 3)),
             id(P.step("cpu"))}
    assert spans == {id(P._OFF)}
    with P.step("cpu"):
        with P.span("gat.forward") as opened:
            P.count("host_syncs", 5)
    assert opened is None
    _tiny_step()()
    after = P.records()
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))


@pytest.mark.parametrize("backend,ops", [("segment", 0), ("kernel", 2)])
def test_train_step_records_nested_spans(backend, ops):
    """Under a CPU profiler, one train step is one record: gat.step holds
    the forward, backward and the two optimiser spans, the forward holds
    a span a layer, and with the kernel backend each layer's op has a
    forward span in its layer and a backward span in gat.backward; every
    span of the record shares its step and ends after it starts."""
    step = _tiny_step(backend)
    with torch.profiler.profile():
        step()
    rec = P.records()[-1]
    by_parent = {}
    for s in rec.spans:
        assert s.end_ns >= s.start_ns > 0
        assert s.device_ms is None
        by_parent.setdefault(s.parent.name if s.parent else None,
                             []).append(s.name)
    layer_ops = ["gat.op.v5_attention.forward"] if ops else []
    assert by_parent[None] == ["gat.step"]
    assert by_parent["gat.step"] == ["gat.forward", "gat.optimizer",
                                     "gat.backward", "gat.optimizer"]
    assert by_parent["gat.forward"] == ["gat.layer.0", "gat.layer.1"]
    assert by_parent.get("gat.layer.0", []) == layer_ops
    assert by_parent.get("gat.layer.1", []) == layer_ops
    assert by_parent.get("gat.backward", []) == [
        "gat.op.v5_attention.backward"] * ops
    assert rec.counters == {"host_syncs": 0}
    assert rec.device == torch.device("cpu")
    (outer,) = rec.named("gat.step")
    assert all(outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
               for s in rec.spans)


class _Spanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        with P.span("inner"):
            return g * 2.0


def _backward_in_thread():
    """gat.backward's body as the CUDA autograd engine runs it: on
    another thread, while the step's thread waits."""
    box = []
    worker = threading.Thread(target=lambda: box.append(
        P.span("inner").__enter__()))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and box
    return box[0]


@pytest.mark.parametrize("where", ["function", "thread"])
def test_a_span_inside_backward_takes_gat_backward_as_parent(where):
    x = torch.ones(3, requires_grad=True)
    with torch.profiler.profile():
        with P.step("cpu"):
            y = _Spanned.apply(x).sum()
            with P.span("gat.backward"):
                if where == "function":
                    y.backward()
                else:
                    _backward_in_thread()
    rec = P.records()[-1]
    (inner,) = rec.named("inner")
    assert inner.parent is rec.named("gat.backward")[0]
    assert inner.parent.parent is rec.named("gat.step")[0]
    if where == "thread":
        assert inner.thread != rec.named("gat.backward")[0].thread


def test_the_written_trace_names_the_spans(tmp_path):
    step = _tiny_step("kernel")
    with P.trace(str(tmp_path)) as prof:
        step()
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gat.step", "gat.forward", "gat.backward", "gat.optimizer",
            "gat.layer.0", "gat.layer.1", "gat.op.v5_attention.forward",
            "gat.op.v5_attention.backward"} <= names


def test_the_records_are_bounded():
    with torch.profiler.profile():
        for _ in range(P.RECORDS_KEPT + 7):
            with P.step("cpu"):
                pass
    recs = P.records()
    assert len(recs) == P.RECORDS_KEPT
    ids = [r.step_id for r in recs]
    assert ids == list(range(ids[0], ids[0] + P.RECORDS_KEPT))
    assert ids[-1] == P._TRACING.steps_opened


def test_count_adds_to_the_open_step():
    with torch.profiler.profile():
        P.count("planted", 4)              # outside a step: nowhere
        with P.step("cpu"):
            P.count("planted")
            P.count("planted", 2)
        with P.step("cpu"):
            pass
    first, second = P.records()[-2:]
    assert first.counters == {"host_syncs": 0, "planted": 3}
    assert second.counters == {"host_syncs": 0}


def test_a_step_inside_a_step_is_refused():
    with torch.profiler.profile():
        with P.step("cpu"):
            with pytest.raises(RuntimeError, match="open already"):
                with P.step("cpu"):
                    pass


def _warn_twice():
    warnings.warn("planted, not a sync", RuntimeWarning)
    warnings.warn(P.SYNC_MESSAGE, UserWarning)
    return _warn_twice.__code__.co_firstlineno


def test_warnings_in_a_traced_step_are_counted_or_passed_on():
    """A warning that reports a synchronising CUDA operation counts one
    host sync; any other reaches the caller as it was raised (category,
    message, file and line), once each, with the caller's filters."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with torch.profiler.profile():
            with P.step("cpu"):
                first = _warn_twice()
                _warn_twice()
    rec = P.records()[-1]
    assert rec.counters["host_syncs"] == 2
    ours = [w for w in seen if "planted" in str(w.message)]
    assert len(ours) == 2
    for w in ours:
        assert w.category is RuntimeWarning
        assert w.filename == __file__ and w.lineno == first + 1
    assert not any(P.SYNC_MESSAGE in str(w.message) for w in seen)
