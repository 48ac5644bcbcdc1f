"""Overlapped input pipeline: background host prefetch + device double buffering.

Port of ``determined_tpu/data/_prefetch.py``.  Three stages, as there:

1. **host fetch**: a background worker thread runs the sampler and the
   fetch into a bounded queue (``PrefetchingIterator``);
2. **host to device**: ``device_prefetch`` copies batch N+1 while the device
   runs step N.  On CUDA the host arrays are staged in pinned memory and
   copied with ``non_blocking=True`` on a side stream; the consumer's stream
   waits on the copy's event before it uses the batch, and the device
   tensors are ``record_stream``-ed onto it so the caching allocator does
   not hand their memory to the next copy while the step still reads them;
3. **device compute**: the trainer's step.

Exact resume: every stage carries ``(SamplerState, batch)`` pairs, and only
``InputPipeline.__next__`` (the consumer, at the moment it takes a batch)
commits the state to the loader, so the loader's state is that of the batch
consumed, never of one fetched ahead.  An exception on the worker is queued
and raised from the consumer's next ``__next__`` with its original type.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from determined_tpu_torch.data._loader import to_device
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.utils import faults


class _WorkerError:
    """Envelope carrying a worker exception across the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


_DONE = object()


class PrefetchingIterator:
    """Run any iterator on a background thread behind a bounded queue.

    ``depth`` bounds how far the worker may run ahead of the consumer.
    ``close()`` is idempotent, never blocks on a full queue, and joins the
    worker.
    """

    def __init__(
        self,
        source: Iterable[Any],
        *,
        depth: int = 2,
        name: str = "dtt-prefetch",
        fault_site: str = "data.prefetch.fetch",
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._fault_site = fault_site
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # -- worker side ---------------------------------------------------------

    def _put(self, item: Any) -> bool:
        """Blocking put that wakes up if the consumer closes us."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        produced = 0
        tracer = get_tracer()
        try:
            it = iter(self._source)
            while not self._stop.is_set():
                faults.fire(self._fault_site, batches=produced)
                try:
                    t0 = time.monotonic()
                    item = next(it)
                    tracer.record_span("data.fetch", "data", t0, time.monotonic())
                except StopIteration:
                    self._put(_DONE)
                    return
                produced += 1
                if not self._put(item):
                    return
                tracer.gauge("data.queue_depth", float(self._queue.qsize()))
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            self._put(_WorkerError(e))

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> "PrefetchingIterator":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    self._done = True
                    raise RuntimeError("prefetch worker died without a result")
        if item is _DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, _WorkerError):
            self._done = True
            raise item.exc
        return item

    def close(self) -> None:
        """Stop the worker and join it.  Safe to call more than once."""
        self._done = True
        self._stop.set()
        # drain so a worker blocked on put() sees the stop event promptly
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchingIterator":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _Copy:
    """One host batch in flight to the device: the device tensors and, on
    CUDA, the event that marks the end of their copy."""

    __slots__ = ("tensors", "event", "device")

    def __init__(
        self, tensors: Dict[str, torch.Tensor], event: Optional[Any], device: torch.device
    ) -> None:
        self.tensors = tensors
        self.event = event
        self.device = device

    def take(self) -> Dict[str, torch.Tensor]:
        """Make the current stream wait for the copy and hand the tensors
        over to it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


def _start_copy(
    batch: Dict[str, np.ndarray], device: torch.device, copy_stream: Optional[Any]
) -> _Copy:
    if copy_stream is None:
        return _Copy(to_device(batch, device), None, device)
    pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}
    with torch.cuda.stream(copy_stream):
        tensors = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
        event = torch.cuda.Event()
        event.record(copy_stream)
    # the pinned buffers may be dropped now: the pinned allocator keeps a
    # block until the copies queued on it have run
    return _Copy(tensors, event, device)


def device_prefetch(
    pairs: Iterable[Tuple[Any, Dict[str, np.ndarray]]],
    device: torch.device,
    *,
    size: int = 2,
) -> Iterator[Tuple[Any, Dict[str, torch.Tensor]]]:
    """Copy stage: keep ``size`` batches in flight to ``device``.

    Yields ``(state, device_batch)`` pairs.  With ``size`` >= 2 the copy of
    batch N+1 is queued before batch N is handed over, so it overlaps the
    device step; ``size`` <= 1 copies each batch when it is taken.
    """
    tracer = get_tracer()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(host_batch: Dict[str, np.ndarray]) -> _Copy:
        # runs on the consumer thread, so it nests inside its data.wait span
        t0 = time.monotonic()
        out = _start_copy(host_batch, device, copy_stream)
        tracer.record_span("data.h2d", "h2d", t0, time.monotonic())
        return out

    buf: collections.deque = collections.deque()
    for state, host_batch in pairs:
        buf.append((state, start(host_batch)))
        if len(buf) >= max(size, 1):
            state0, copy = buf.popleft()
            yield state0, copy.take()
    while buf:
        state0, copy = buf.popleft()
        yield state0, copy.take()


class EpochFeed:
    """Overlapped feed over one finite pass (a validation sweep): the same
    host-prefetch and copy stages as ``InputPipeline``, minus the
    resume-state commit (``iter_epoch`` never touches sampler state)."""

    def __init__(
        self,
        host_iter: Iterable[Dict[str, np.ndarray]],
        device: torch.device,
        *,
        prefetch_depth: int = 2,
        device_buffer: int = 2,
    ) -> None:
        # prefetch_depth 0: the host fetch runs on the consumer's thread
        self._host_stage: Optional[PrefetchingIterator] = None
        if prefetch_depth > 0:
            host_iter = self._host_stage = PrefetchingIterator(
                host_iter, depth=prefetch_depth, name="dtt-prefetch-epoch"
            )
        self._it = device_prefetch(((None, hb) for hb in host_iter), device, size=device_buffer)

    def __iter__(self) -> "EpochFeed":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return next(self._it)[1]

    def close(self) -> None:
        if self._host_stage is not None:
            self._host_stage.close()

    def __enter__(self) -> "EpochFeed":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class InputPipeline:
    """The full three-stage feed bound to one resumable DataLoader.

    ``__next__`` returns a device batch (stacked ``[agg, batch, ...]``
    microbatches when ``agg`` > 1) and commits the loader's resume state to
    the position *after* the consumed batch.
    """

    def __init__(
        self,
        loader: Any,
        device: torch.device,
        *,
        agg: int = 1,
        prefetch_depth: int = 2,
        device_buffer: int = 2,
    ) -> None:
        self.loader = loader
        self._host_stage: Optional[PrefetchingIterator] = None
        source: Iterable[Tuple[Any, Dict[str, np.ndarray]]] = loader.iter_pairs(agg=agg)
        if prefetch_depth > 0:
            source = self._host_stage = PrefetchingIterator(source, depth=prefetch_depth)
        self._it = device_prefetch(source, device, size=device_buffer)

    def __iter__(self) -> "InputPipeline":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        state, batch = next(self._it)
        self.loader.commit_state(state)
        return batch

    def close(self) -> None:
        if self._host_stage is not None:
            self._host_stage.close()

    def __enter__(self) -> "InputPipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
