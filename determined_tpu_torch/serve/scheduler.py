"""Continuous-batching scheduler: requests, the bounded admission queue,
and the decode-lane table.  A copy of ``determined_tpu/serve/scheduler.py``.

Iteration-level (continuous) batching as in Orca (Yu et al., OSDI '22):
the unit of scheduling is one decode STEP, not one request.  New sequences
join the running batch between steps the moment a lane and cache blocks
are free, and finished sequences retire immediately — a short completion
never waits for a long neighbor the way static batching forces it to.

The admission queue is the bounded-queue backpressure pattern of
``data/_prefetch.py`` turned outward: when the queue is full the HTTP
layer answers 429 instead of buffering unboundedly, so overload degrades
into fast rejections rather than latency collapse.  FIFO order through
the queue is the fairness contract — the engine never reorders admissions,
it only delays them when the cache cannot fit the head request yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

_req_ids = itertools.count(1)


@dataclasses.dataclass
class GenRequest:
    """One generation request riding through admission -> decode -> retire.

    The HTTP handler thread blocks on ``done``; the engine thread fills the
    result fields before setting it.  No lock: each field has exactly one
    writer (the engine) and readers only look after ``done`` is set.
    """

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: Optional[int] = None
    stop_token: Optional[int] = None  # generation ends early on this token
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    arrival: float = dataclasses.field(default_factory=time.monotonic)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # -- results (engine-written) -------------------------------------------
    output: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    first_token_at: Optional[float] = None  # monotonic, for TTFT
    finished_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        self.finished_at = time.monotonic()
        self.done.set()


class AdmissionRejected(Exception):
    """Request refused at the door; ``status`` is the HTTP code to answer."""

    def __init__(self, status: int, reason: str) -> None:
        super().__init__(reason)
        self.status = status
        self.reason = reason


class AdmissionQueue:
    """Bounded FIFO between the HTTP threads and the engine loop.

    ``submit`` never blocks: a full queue raises :class:`AdmissionRejected`
    (429), a draining queue rejects everything new (503).  The engine side
    uses ``get``/``requeue_head``; ``requeue_head`` preserves FIFO when the
    head request could not be admitted yet (cache full) — it goes back to
    the FRONT, so later arrivals cannot starve it.
    """

    def __init__(self, depth: int) -> None:
        self._q: "queue.Queue[GenRequest]" = queue.Queue(maxsize=depth)
        self._head_lock = threading.Lock()
        self._head: Optional[GenRequest] = None  # requeued front-of-line item
        self._draining = False  # plain-bool flag; set once, GIL-atomic

    # -- producer side (HTTP threads) ---------------------------------------

    def submit(self, req: GenRequest) -> None:
        if self._draining:
            raise AdmissionRejected(503, "draining")
        try:
            self._q.put(req, block=False)
        except queue.Full:
            raise AdmissionRejected(429, "admission queue full") from None

    # -- consumer side (engine thread) --------------------------------------

    def get(self, timeout: float = 0.0) -> Optional[GenRequest]:
        with self._head_lock:
            if self._head is not None:
                head, self._head = self._head, None
                return head
        try:
            if timeout <= 0:
                return self._q.get(block=False)
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def requeue_head(self, req: GenRequest) -> None:
        with self._head_lock:
            if self._head is not None:
                raise RuntimeError("only one head request may be parked")
            self._head = req

    # -- drain / inspection --------------------------------------------------

    def start_drain(self) -> None:
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        with self._head_lock:
            head = 1 if self._head is not None else 0
        return self._q.qsize() + head

    def empty(self) -> bool:
        return self.depth() == 0


@dataclasses.dataclass
class ActiveSeq:
    """One decode lane's state: request + cache bookkeeping."""

    request: GenRequest
    blocks: List[int]               # physical block ids owned by this seq
    block_table: List[int]          # padded to blocks_per_seq with scratch 0
    pos: int                        # position of the NEXT token to feed
    next_token: int                 # token to feed at `pos`
    rng: Any = None                 # np.random.Generator for sampling

    @property
    def generated(self) -> int:
        return len(self.request.output)


class LaneTable:
    """The fixed array of decode lanes the decode step batches over.

    Mutated only by the engine thread; the lock exists for the ``/stats``
    reader and for tests, not for engine-vs-engine races.
    """

    def __init__(self, max_batch: int) -> None:
        self._lock = threading.Lock()
        self._lanes: List[Optional[ActiveSeq]] = [None] * max_batch
        self.joined = 0
        self.retired = 0

    def join(self, seq: ActiveSeq) -> int:
        """Place ``seq`` into the lowest free lane; raises if none free
        (the engine checks ``has_free_lane`` first)."""
        with self._lock:
            for i, lane in enumerate(self._lanes):
                if lane is None:
                    self._lanes[i] = seq
                    self.joined += 1
                    return i
        raise RuntimeError("no free decode lane")

    def retire(self, lane: int) -> ActiveSeq:
        with self._lock:
            seq = self._lanes[lane]
            if seq is None:
                raise RuntimeError(f"lane {lane} already empty")
            self._lanes[lane] = None
            self.retired += 1
            return seq

    def has_free_lane(self) -> bool:
        with self._lock:
            return any(lane is None for lane in self._lanes)

    def active(self) -> List[int]:
        """Indices of occupied lanes."""
        with self._lock:
            return [i for i, lane in enumerate(self._lanes) if lane is not None]

    def get(self, lane: int) -> Optional[ActiveSeq]:
        with self._lock:
            return self._lanes[lane]

    def snapshot(self) -> Sequence[Optional[ActiveSeq]]:
        with self._lock:
            return list(self._lanes)

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for lane in self._lanes if lane is not None)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "lanes": len(self._lanes),
                "active": sum(1 for lane in self._lanes if lane is not None),
                "joined": self.joined,
                "retired": self.retired,
            }
