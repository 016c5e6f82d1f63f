"""Profiling and timing utilities.

Counterpart of gat_pytorch_tpu/utils/profiling.py, on torch.profiler:

- `trace(logdir)`: context manager around torch.profiler.profile. It
  records CPU activity, and CUDA activity (CUPTI) where a card is
  present; on exit it writes a Chrome-format trace (`*.pt.trace.json`,
  which Perfetto and TensorBoard's profiler open) under `logdir`.
- `annotate(name)`: torch.profiler.record_function, a named region inside
  that trace.
- `time_fn(fn, *args)`: the median wall-clock seconds of a call after
  warm-up, synchronising the CUDA devices of the output's tensors before
  the clock stops (the JAX version's block_until_ready), so host launch
  cost is in the time.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Callable, Iterator, Set, Tuple

import torch


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


def annotate(name: str):
    """with annotate('gat_layer_0'): ... -- named region in the trace."""
    return torch.profiler.record_function(name)


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
