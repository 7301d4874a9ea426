"""Host->device input prefetching (counterpart of `data/prefetch.py`).

The reference's input path is torch ``DataLoader`` workers feeding a
blocking ``.to(device)`` per step (e.g. `generative.py:1118-1127`).  Two
layers replace it:

  * :func:`prefetch_to_device` -- wrap any host-batch iterator; yields the
    batches as tensors on the device, ``size`` batches ahead: each batch is
    pinned and copied ``non_blocking`` on a side stream while the current
    step computes.
  * :class:`ThreadedLoader` -- run the whole per-epoch iterator (shuffle,
    slice, augment) on a background thread with a bounded queue, so
    host-side batch assembly never serializes with the step (a copy of the
    JAX package's; its logic is plain threading).

On the CPU both hand the batches through unchanged.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import torch


def to_device(batch: Iterable, device) -> Tuple[torch.Tensor, ...]:
    """A host batch (arrays or tensors) as a tuple of tensors on
    ``device``, copied synchronously (no copy on the CPU)."""
    return tuple(torch.as_tensor(x, device=device) for x in batch)


def prefetch_to_device(iterator: Iterable, device, *,
                       size: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield the batches of ``iterator`` (each a tuple of arrays or
    tensors) as tuples of tensors on ``device``, keeping up to ``size``
    batches in flight ahead of the consumer.

    On a CUDA device each batch is pinned and copied ``non_blocking`` on a
    side stream, and an event is recorded after its copies.  The stream
    that consumes a batch waits on its event, so no batch is read before
    its copy lands, and each tensor is ``record_stream``-ed on that stream,
    so its memory is not reused while the consumer's work on it is in
    flight.  On any other device the batches pass through ``to_device``
    one at a time."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield to_device(batch, device)
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = tuple(torch.as_tensor(x).pin_memory().to(
                device, non_blocking=True) for x in batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(item):
        out, done = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        return out

    buf: collections.deque = collections.deque()
    it = iter(iterator)
    try:
        while True:
            while len(buf) < max(size, 1):
                buf.append(put(next(it)))
            yield take(buf.popleft())
    except StopIteration:
        while buf:
            yield take(buf.popleft())


class ThreadedLoader:
    """Run a host batch-iterator factory on a background thread.

    ``data_iter_fn()`` is called once per epoch (same contract as
    ``train_diffusion``'s); batches are assembled on the worker thread and
    handed over through a bounded queue (default depth 4).  Exceptions on
    the worker re-raise at the consuming site; the worker is a daemon and
    also honors :meth:`close` for deterministic shutdown mid-epoch.

    Composes with :func:`prefetch_to_device`::

        loader = ThreadedLoader(lambda: batch_iterator(X, y, 256, rng=rng))
        for cond, target in prefetch_to_device(loader.epoch(), "cuda"):
            loss = step(state, cond, target, generator)
    """

    _DONE = object()

    def __init__(self, data_iter_fn: Callable[[], Iterable], *,
                 queue_depth: int = 4):
        self._fn = data_iter_fn
        self._depth = queue_depth
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _worker(self, q: "queue.Queue") -> None:
        try:
            for item in self._fn():
                while not self._stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            q.put(self._DONE)
        except BaseException as e:  # surfaced at the consumer
            while not self._stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def epoch(self) -> Iterator[Any]:
        """One epoch's batches, produced on the worker thread.  Abandoning
        the generator early (break / GeneratorExit) stops the worker via
        the ``finally`` — no spinning producer is left behind."""
        self.close()
        self._stop.clear()
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._queue = q
        self._thread = threading.Thread(target=self._worker, args=(q,),
                                        daemon=True)
        self._thread.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    self._thread.join()
                    self._thread = None
                    return
                if isinstance(item, BaseException):
                    self._thread.join()
                    self._thread = None
                    raise item
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the worker (if mid-epoch) and drop queued batches."""
        if self._thread is not None:
            self._stop.set()
            while True:     # drain so the producer can observe _stop
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ThreadedLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
