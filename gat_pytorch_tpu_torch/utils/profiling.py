"""Profiling and timing utilities.

Counterpart of gat_pytorch_tpu/utils/profiling.py, on torch.profiler:

- `trace(logdir)`: context manager around torch.profiler.profile. It
  records CPU activity, and CUDA activity (CUPTI) where a card is
  present; on exit it writes a Chrome-format trace (`*.pt.trace.json`,
  which Perfetto and TensorBoard's profiler open) under `logdir`.
- `span(name)`, `step(device)`, `count(name)`, `records()`: the port's
  own spans and counters (below), named regions of that trace.
- `time_fn(fn, *args)`: the median wall-clock seconds of a call after
  warm-up, synchronising the CUDA devices of the output's tensors before
  the clock stops (the JAX version's block_until_ready), so host launch
  cost is in the time.

Spans. A span is on exactly while a torch profiler records (the flag
torch.autograd.profiler._is_profiler_enabled, which every torch profiler
sets while it records, `trace`'s too); there is no other switch. Off,
`span` returns one shared null context and records nothing. On, it opens
torch.profiler.record_function(name), so that the span lies in the
profiler's trace on the clock of its device records, and keeps a
SpanRecord: its name; its parent, the innermost open span of its thread
or, on a thread with none open (the autograd engine's device thread,
while the step's thread waits in loss.backward()), the innermost open
span of the step's thread; its thread; its host start and end
(perf_counter_ns); and, for the phase spans (PHASES) of a step on a CUDA
device, a pair of timing events recorded on the device's current stream
at its open and close. `step(device)` opens the span "gat.step" with a
StepRecord: every span and counter (`count`) until it closes is the
step's. While a step is open the process's warnings are recorded and,
for a step on a CUDA device, torch's sync debug mode is "warn": each
warning that reports a synchronising CUDA operation counts one
"host_syncs" (the autograd thread's too, which torch issues again on
the step's thread); every other warning is issued again as it was.
`records()` gives the last RECORDS_KEPT steps. A span outside a step is
in the trace alone.

The sites: Trainer.train_step (gat.step; gat.forward, the model and the
task's loss; gat.backward; gat.optimizer, zero_grad and the update),
each layer of gat_model_apply (gat.layer.<i>: its input dropout and the
layer), and the forward and backward of each autograd Function of the
attention ops (`op_spans`: gat.op.<op>.forward, gat.op.<op>.backward).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import socket
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import torch

_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()
STEP = "gat.step"
PHASES = frozenset((STEP, "gat.forward", "gat.backward", "gat.optimizer"))
HOST_SYNCS = "host_syncs"
SYNC_MESSAGE = "called a synchronizing CUDA operation"
RECORDS_KEPT = 256


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; write its trace to
    `<logdir>/<host>.<pid>.<ns>.pt.trace.json` on exit (the profiler is
    yielded: its `key_averages()` and the path, `.trace_path`, are read
    after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            logdir, f"{socket.gethostname()}.{os.getpid()}."
                    f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)


@dataclasses.dataclass(eq=False)
class SpanRecord:
    name: str
    parent: Optional["SpanRecord"]
    thread: int                       # threading.get_ident()
    start_ns: int                     # time.perf_counter_ns()
    end_ns: int = 0
    events: Optional[Tuple[Any, Any]] = None   # torch.cuda.Event pair

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The stream's milliseconds from the span's open to its close
        (the device's idle time between included); None without events.
        Read once the device has passed the close: synchronise first."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


@dataclasses.dataclass(eq=False)
class StepRecord:
    step_id: int                      # shared by the step's spans
    device: torch.device
    spans: List[SpanRecord] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {HOST_SYNCS: 0})

    def named(self, name: str) -> List[SpanRecord]:
        return [s for s in self.spans if s.name == name]


class _Tracing:
    """The process's step records (as the profiler that turns spans on
    is the process's), the open step, and each thread's open spans."""

    def __init__(self):
        self.records: collections.deque = collections.deque(
            maxlen=RECORDS_KEPT)
        self.step: Optional[StepRecord] = None
        self.step_stack: List[SpanRecord] = []  # the step thread's spans
        self.steps_opened = 0
        self._local = threading.local()

    def stack(self) -> List[SpanRecord]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


_TRACING = _Tracing()


class _Span:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> SpanRecord:
        self._function = torch.profiler.record_function(self.name)
        self._function.__enter__()
        step, stack = _TRACING.step, _TRACING.stack()
        outer = stack or (_TRACING.step_stack if step is not None else [])
        rec = SpanRecord(self.name, outer[-1] if outer else None,
                         threading.get_ident(), time.perf_counter_ns())
        self._stream = None
        if (step is not None and step.device.type == "cuda"
                and self.name in PHASES):
            self._stream = torch.cuda.current_stream(step.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self._stream)
        if step is not None:
            step.spans.append(rec)
        stack.append(rec)
        self._stack, self._record = stack, rec
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self._record
        if rec.events is not None:
            rec.events[1].record(self._stream)
        rec.end_ns = time.perf_counter_ns()
        self._stack.pop()
        self._function.__exit__(*exc)
        return False


class _Step(_Span):
    def __init__(self, device: torch.device):
        super().__init__(STEP)
        self.device = device

    def __enter__(self) -> SpanRecord:
        if _TRACING.step is not None:
            raise RuntimeError("profiling.step: a step is open already")
        _TRACING.steps_opened += 1
        _TRACING.step = StepRecord(_TRACING.steps_opened, self.device)
        _TRACING.step_stack = _TRACING.stack()
        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        self._mode = None
        if self.device.type == "cuda":
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        step = _TRACING.step
        try:
            super().__exit__(*exc)
        finally:
            if self._mode is not None:
                torch.cuda.set_sync_debug_mode(self._mode)
            self._warnings.__exit__(*exc)
            _TRACING.step, _TRACING.step_stack = None, []
            _TRACING.records.append(step)
        for w in self._caught:
            if SYNC_MESSAGE in str(w.message):
                step.counters[HOST_SYNCS] += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno, source=w.source)
        return False


def span(name: str, index: Optional[int] = None):
    """with span("gat.forward"): ... -- a span while a profiler records
    (the module doc), named `name.<index>` where an index is given;
    otherwise the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name if index is None else f"{name}.{index}")


def step(device):
    """with step(graph.device): ... -- the span "gat.step" and a new step
    record while a profiler records; otherwise the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Step(torch.device(device))


def count(name: str, n: int = 1) -> None:
    """Add n to the open step's counter `name` (nothing outside a
    step)."""
    step = _TRACING.step
    if step is not None:
        step.counters[name] = step.counters.get(name, 0) + n


def records() -> List[StepRecord]:
    """The last RECORDS_KEPT step records, oldest first."""
    return list(_TRACING.records)


def op_spans(op: str):
    """Class decorator of an autograd Function: its forward and backward
    run inside the spans gat.op.<op>.forward and gat.op.<op>.backward."""
    def decorate(cls):
        for phase in ("forward", "backward"):
            setattr(cls, phase, staticmethod(
                _spanned(f"gat.op.{op}.{phase}", getattr(cls, phase))))
        return cls
    return decorate


def _spanned(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)
    return run


def _cuda_devices(out, found: Set[torch.device]) -> Set[torch.device]:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block_until_ready(out):
    """Synchronise the CUDA device of every CUDA tensor in `out` (a
    tensor, or tuples, lists and dicts of them); nothing for CPU
    tensors. Returns `out`."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn: Callable, *args,
            warmup: int = 2, iters: int = 10) -> Tuple[float, Any]:
    """Median-of-iters seconds per call, after warmup calls. Returns
    (seconds_per_call, last_output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out
