"""Host-to-device input prefetch (the port's ``train/prefetch.py``).

A step is launched asynchronously on the card, but building a
:class:`~privacy_preserve_federated_asr_tpu_torch.train.steps.DeviceBatch`
(the host padding copies and the host-to-device copies) runs on the loop
thread and serialises with the launches. A daemon thread staging ``depth``
batches ahead overlaps that host work and the copies with device compute.

On the card each batch is copied from pinned memory with
``non_blocking=True`` on a side CUDA stream; the consumer's stream waits on
an event recorded after the copies before it touches the batch, and
``record_stream`` tells the caching allocator that the consumer's stream
uses the buffers, so none is reused while a step still reads it.

A failure in the producer is re-raised in the consumer (the JAX package's
``_Failure``): staging never falls back to the loop thread. Both generators
release their worker when the consumer abandons them early (an exception or
a break): the worker checks a stop flag around every bounded put.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

from ..data.collate import Batch
from .steps import DeviceBatch

_END = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _producer_consumer(items: Iterable, depth: int, stage: Callable) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not _put((stage(item),)):
                    return  # consumer gone: drop staged work, exit
            _put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            _put(_Failure(e))

    threading.Thread(target=worker, daemon=True, name="prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, _Failure):
                raise item.exc
            yield item[0]
    finally:
        stop.set()  # unblock the worker if the consumer leaves early


def prefetch_iter(items: Iterable, depth: int = 1) -> Iterator:
    """Generic producer thread: evaluate ``items`` up to ``depth`` elements
    ahead of the consumer (the federated engine builds round r+1 on the host
    while round r runs). ``depth <= 0`` is plain iteration."""
    if depth <= 0:
        yield from items
        return
    yield from _producer_consumer(items, depth, lambda x: x)


def _tensors(db: DeviceBatch) -> list[torch.Tensor]:
    return [getattr(db, f.name) for f in dataclasses.fields(db)]


def prefetch_device_batches(batches: Iterable[Batch], depth: int = 2,
                            device: str | torch.device = "cpu"
                            ) -> Iterator[tuple[Batch, DeviceBatch]]:
    """Yield ``(host_batch, device_batch)`` with up to ``depth`` device
    batches staged ahead of the consumer. ``depth <= 0`` stages on the
    calling thread (the same batches)."""
    device = torch.device(device)
    if depth <= 0:
        for b in batches:
            yield b, DeviceBatch.from_host(b, device)
        return
    if device.type != "cuda":
        yield from _producer_consumer(batches, depth,
                                      lambda b: (b, DeviceBatch.from_host(b, device)))
        return
    side = torch.cuda.Stream(device)

    def stage(b: Batch):
        with torch.cuda.stream(side):
            db = DeviceBatch(*(torch.from_numpy(getattr(b, f.name)).pin_memory()
                               .to(device, non_blocking=True)
                               for f in dataclasses.fields(DeviceBatch)))
            ready = torch.cuda.Event()
            ready.record(side)
        return b, db, ready

    for b, db, ready in _producer_consumer(batches, depth, stage):
        compute = torch.cuda.current_stream(device)
        compute.wait_event(ready)
        for t in _tensors(db):
            t.record_stream(compute)
        yield b, db
