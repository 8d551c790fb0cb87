"""Host-side prefetch: batch preparation and the host-to-device copy overlap
the device's work (port of ``sttode_tpu/data/prefetch.py``).

A background thread runs the (numpy) batch pipeline and the transfer and
pushes the results into a bounded queue. On a CUDA device the default
transfer pins each host tensor and copies it with ``non_blocking=True`` on a
side stream; the consumer's stream waits for that copy, and each copied
tensor is recorded on the consumer's stream, before the consumer gets the
batch. On the CPU the transfer is a plain ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

_SENTINEL = object()


def tree_to(item, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor of ``item``: tensors, dataclasses (the
    port's ``Batch``), NamedTuples (``TrainNoise``), tuples and lists of
    them; anything else (numpy arrays, numbers, None) is kept as it is."""
    if isinstance(item, torch.Tensor):
        return fn(item)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{
            f.name: fn(getattr(item, f.name))
            for f in dataclasses.fields(item)
            if isinstance(getattr(item, f.name), torch.Tensor)})
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(tree_to(v, fn) for v in item))
    if isinstance(item, (tuple, list)):
        return type(item)(tree_to(v, fn) for v in item)
    return item


class _CudaCopy:
    """The default transfer to a CUDA device: pinned host memory, a
    non-blocking copy on a side stream and an event after it (producer
    thread); the consumer's stream waits on the event and takes ownership
    of the copies (``finish``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, item):
        def copy(t):
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            moved = tree_to(item, copy)
            event = torch.cuda.Event()
            event.record(self.stream)
        return moved, event

    def finish(self, payload):
        moved, event = payload
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)

        def own(t):
            if t.device == self.device:
                # allocated on the side stream: keep the memory from being
                # reused before the consumer's work on it has run
                t.record_stream(consumer)
            return t

        return tree_to(moved, own)


def prefetch(batches: Iterable, *, size: int = 2,
             device: torch.device | str | None = None,
             device_put: Callable | None = None) -> Iterator:
    """Iterate ``batches`` through a ``size``-deep background queue.

    ``device_put`` (default: every tensor of the item to ``device``, the
    CPU when None) runs in the worker thread, so transfers are in flight
    when the consumer asks. An exception in the producer re-raises at the
    consumer; closing the iterator early (a step's exception, ``break``,
    garbage collection) releases the producer."""
    device = torch.device("cpu" if device is None else device)
    finish = None
    if device_put is None:
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            device_put = _CudaCopy(device)
            finish = device_put.finish
        else:
            def device_put(item):
                return tree_to(item, lambda t: t.to(device))

    q: queue.Queue = queue.Queue(maxsize=size)
    err: list[BaseException] = []
    cancelled = threading.Event()

    def _put(item) -> bool:
        # a bounded wait, so that an abandoned consumer releases the
        # producer instead of leaking a thread that holds device buffers
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not _put(device_put(b)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item if finish is None else finish(item)
    finally:
        cancelled.set()
