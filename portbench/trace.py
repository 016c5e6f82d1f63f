"""The traced steps' profile: torch.profiler over the steps, with the
benchmark's own spans around its calls into the port (the port itself
records none), read back as device intervals.

  window_s   the span "portbench.traced_window" around the steps and the
             synchronise that ends them
  busy_s     the union of the device's activity (kernels, copies, fills)
             inside that window
  kernels    [(name, seconds)] of every device activity in the window
  breakdown  the 10 device operations that took most time, and the 10
             longest idle gaps, each named by the host operation or span
             that was running when the device went idle
"""

from __future__ import annotations

import collections
from typing import List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.traced_window"
TOP = 10


def short(name: str, width: int = 96) -> str:
    """A device or host operation's name without its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name if cut < 0 else name[:cut])[:width]


class Recorder:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: List[Tuple[str, float]] = []
        self._gaps: List[Tuple[float, float]] = []
        self._host: List[Tuple[float, float, str]] = []

    def __enter__(self):
        self.prof.__enter__()
        self._window = None
        return self

    def open(self) -> None:
        """Start the traced window (after steps that let the profiler's
        own start-up pass), once the device has caught up."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def __exit__(self, *exc):
        try:
            if self.cuda:
                torch.cuda.synchronize(self.device)
        finally:
            if self._window is not None:
                self._window.__exit__(*exc)
            self.prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        events = self.prof.events()
        w0 = w1 = None
        device, host = [], []
        for ev in events:
            lo, hi = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CPU:
                if ev.name == WINDOW:
                    w0, w1 = lo, hi
                else:
                    host.append((lo, hi, ev.name))
            elif (ev.device_type == DeviceType.CUDA
                  and not getattr(ev, "is_user_annotation", False)):
                device.append((lo, hi, ev.name))
        if w0 is None:
            raise RuntimeError("the traced window's span is not in the "
                               "profile")
        self.window_s = (w1 - w0) * 1e-6
        device = sorted((max(lo, w0), min(hi, w1), name)
                        for lo, hi, name in device if hi > w0 and lo < w1)
        self.kernels = [(name, (hi - lo) * 1e-6) for lo, hi, name in device]
        busy, gaps, at = 0.0, [], w0
        for lo, hi, _ in device:
            if lo > at:
                gaps.append((at, lo))
            if hi > at:
                busy += hi - max(lo, at)
                at = hi
        if w1 > at:
            gaps.append((at, w1))
        self.busy_s = busy * 1e-6
        self._gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        self._host = host

    def _host_at(self, t: float) -> str:
        """The innermost host operation or span running at time t."""
        best, start = "host idle", None
        for lo, hi, name in self._host:
            if lo <= t <= hi and (start is None or lo >= start):
                best, start = name, lo
        return best

    def breakdown(self) -> dict:
        by_name = collections.defaultdict(float)
        for name, sec in self.kernels:
            by_name[short(name)] += sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = [[short(self._host_at(lo)), (hi - lo) * 1e-6]
                for lo, hi in self._gaps]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
