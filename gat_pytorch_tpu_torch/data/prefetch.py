"""Host-side prefetch: overlap batch preparation and transfer with compute.

Counterpart of gat_pytorch_tpu/data/prefetch.py (the reference's
DataLoader workers behind fast_dataloading): a background thread that
stays `depth` items ahead of the consumer, building each item from its
source (sampling, batching and stacking are host numpy) and, with
put=True, copying it to the device while the device works on the
previous one.

What the worker does: it iterates the source and, with put=True, copies.
It launches no kernel on the card, draws from no torch generator and
calls no collective: everything that draws or launches stays on the
consumer's thread, so a fit gives the same bits with and without the
thread. A source that draws from its own numpy generator (a batcher's
reshuffle) is drawn by the worker alone, in order.

A copy to a CUDA device runs on a side stream of the worker's. The worker
records an event after it; the consumer makes its current stream wait on
that event before it hands the item out, and marks every tensor of the
item as used on that stream (Tensor.record_stream), so the caching
allocator does not give the memory back to the side stream while the
consumer's kernels may still read it.

The iterator has a stop event and a `close()` (and is a context manager):
closing it ends the worker at its next item and drops what it holds, so no
thread keeps a built epoch alive after the consumer stops early
(Trainer._fit_loop closes it when early stopping breaks its loop, and when
anything raises). An exception in the worker reaches the consumer, after
the items built before it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch

from ..utils.device import resolve_device

_POLL_S = 0.05      # how often a blocked worker looks at the stop event


def _tensors(item):
    """The tensors of a tensor or of a Graph (its block layout's too)."""
    if isinstance(item, torch.Tensor):
        yield item
    elif dataclasses.is_dataclass(item):
        for f in dataclasses.fields(item):
            yield from _tensors(getattr(item, f.name))


def _to(item, device: torch.device):
    """item.to(device) (a Graph or a tensor); an item already there is
    returned as it is."""
    if all(t.device == device for t in _tensors(item)):
        return item
    return item.to(device)


class PrefetchIterator:
    """Iterate the items of `src` built `depth` ahead by a background
    thread.

    put=True copies each item (a Graph or a tensor) to `device` (default:
    the entry points' device, cuda) in the worker; put=False hands the
    items over as the source built them, for a consumer that places them
    itself (the Trainer's fits: the worker builds the next epoch's
    batches on the host, the copies to the card stay on the consumer's
    thread, where they cost less: tools/prefetch_ab.py).
    """

    _SENTINEL = object()

    def __init__(self, src: Iterable, depth: int = 2,
                 device: Optional[torch.device] = None, put: bool = True):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._device = resolve_device(device) if put else None
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(iter(src),), daemon=True)
        self._thread.start()

    def _offer(self, item) -> bool:
        """Queue `item` unless stopped first; True when queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator) -> None:
        side = (torch.cuda.Stream(self._device)
                if self._device is not None and self._device.type == "cuda"
                else None)
        try:
            for item in it:
                if self._stop.is_set():
                    return
                ready = None
                if self._device is not None:
                    if side is None:
                        item = _to(item, self._device)
                    else:
                        with torch.cuda.stream(side):
                            item = _to(item, self._device)
                            ready = torch.cuda.Event()
                            ready.record(side)
                if not self._offer((item, ready)):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised in the consumer
            self._err = exc
        finally:
            self._offer(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        entry = self._q.get()
        if entry is self._SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        item, ready = entry
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in _tensors(item):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker, drop the items it queued and wait for it to
        end (RuntimeError if it has not within `timeout` seconds: its
        source is stuck inside one item)."""
        self._stop.set()
        self._done = True
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(_POLL_S)
            timeout -= _POLL_S
            if timeout <= 0 and self._thread.is_alive():
                raise RuntimeError("the prefetch worker did not stop")
        while not self._q.empty():
            self._q.get_nowait()

    @property
    def alive(self) -> bool:
        """Whether the worker thread is still running."""
        return self._thread.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_epochs(make_epoch: Callable[[int], Sequence], num_epochs: int,
                    depth: int = 2, device: Optional[torch.device] = None
                    ) -> Iterator[PrefetchIterator]:
    """Per-epoch prefetched streams: make_epoch(epoch) is built on the
    caller's thread and its items copied by a worker while the previous
    items train. Each stream is closed when the next is asked for, or
    when the generator is closed."""
    for epoch in range(num_epochs):
        with PrefetchIterator(make_epoch(epoch), depth=depth,
                              device=device) as stream:
            yield stream
