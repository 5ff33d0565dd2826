"""Host-side prefetch (counterpart of pcseg_tpu/data/prefetch.py).

``Prefetcher`` runs a batch iterable in a daemon thread that stays
``depth`` batches ahead, so reading the event files and packing a batch
overlap the steps on the card. ``DevicePlace`` is the H2D step the thread
runs on each batch: the batch into pinned host memory, copied on a
dedicated CUDA stream with ``non_blocking=True``, an event recorded
there; the consumer (``device_batch``) makes its stream wait on that
event and calls ``record_stream`` so the caching allocator never hands a
batch's memory out while the consumer's stream may still read it. On the
CPU the place is ``torch.from_numpy``.

Only native code (the packer's ctypes call, the copies) releases the GIL,
so how much the thread gains beside a host-bound step is a measurement,
not a given (``chip_smoke.py``'s file phase reads it).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

_DONE = object()
# how often a producer blocked on a full queue looks for a stop request
_POLL_S = 0.05


class Prefetcher:
    """Wrap a batch iterable; a daemon thread stays ``depth`` batches
    ahead.

    ``place`` (optional) maps a host batch to what the consumer receives
    (``DevicePlace``) inside the thread. Each ``__iter__`` starts a new
    pass over ``it``; an exception in the producer is re-raised at the
    consumer. ``close()`` stops every open pass and joins its thread,
    dropping the batches it held (the training loop calls it in a
    ``finally``, so an early stop or an error frees its memory); leaving
    or closing the iteration does the same for its own pass.
    """

    def __init__(self, it: Iterable, depth: int = 2, place=None):
        self._it = it
        self._depth = max(1, depth)
        self._place = place
        self._runs: list = []

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self._it:
                    if stop.is_set():
                        return
                    if self._place is not None:
                        item = self._place(item)
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                err.append(e)
            finally:
                put(_DONE)

        thread = threading.Thread(target=worker, daemon=True,
                                  name="pcseg-prefetch")
        run = (stop, q, thread)
        self._runs.append(run)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            self._stop(run)

    def _stop(self, run) -> None:
        stop, q, thread = run
        stop.set()
        while thread.is_alive():
            _drain(q)
            thread.join(timeout=_POLL_S)
        _drain(q)
        if run in self._runs:
            self._runs.remove(run)

    def close(self) -> None:
        """Stop every open pass, join its thread, drop its batches."""
        for run in list(self._runs):
            self._stop(run)


def _drain(q: queue.Queue) -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


def prefetch(it: Iterable, depth: int = 2, place=None) -> Prefetcher:
    return Prefetcher(it, depth=depth, place=place)


class _OnDevice:
    """A placed batch; on a card, ``event`` marks the end of its copies on
    the place's stream (None on the CPU)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


class DevicePlace:
    """The H2D step of a prefetch thread for ``device``: numpy arrays ->
    tensors on the device (see the module docstring). On the CPU the
    arrays become tensors that share their memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device)
                       if device.type == "cuda" else None)

    def __call__(self, batch):
        if self.stream is None:
            return _OnDevice(tuple(torch.from_numpy(a) for a in batch), None)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tensors = tuple(
                torch.from_numpy(a).pin_memory().to(self.device,
                                                    non_blocking=True)
                for a in batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _OnDevice(tensors, event)


def device_batch(item, device: torch.device) -> tuple:
    """What the step takes from a batcher's item: a placed batch made
    ready for the current stream, or a host batch copied inline."""
    if not isinstance(item, _OnDevice):
        return tuple(torch.from_numpy(a).to(device, non_blocking=True)
                     for a in item)
    if item.event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(item.event)
        for t in item.tensors:
            t.record_stream(stream)
    return item.tensors
