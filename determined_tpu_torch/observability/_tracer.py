"""Experiment-wide tracer: thread-safe, non-blocking spans and counters.

Port of ``determined_tpu/observability/_tracer.py`` (the same classes,
methods and event format; it touches no JAX, so only the names of the
profiler beside it change).  Every concurrent subsystem of the port (the
trainer loop, the prefetch worker, the journal, checkpoint writers, the
restart supervisor, the serving engine) reports spans and counters here,
and a run becomes one Chrome trace-event timeline viewable in Perfetto
plus a goodput ledger (``_goodput.py``).

Design constraints, in order:

1. **Never a host sync or a lock in the hot loop.**  Each thread records
   into its OWN fixed-size ring buffer (single producer).  Recording is a
   ``time.monotonic()`` delta plus one tuple append: no allocation beyond
   the tuple, no lock, no I/O, and never a CUDA call.  A full ring DROPS
   the event and counts the drop; it never blocks training.
2. **~0 cost when off.**  ``enabled`` is a single attribute check;
   ``span()`` returns a shared no-op context manager.
3. **Draining is someone else's problem.**  A shipper thread drains all
   rings on a short interval, converts tuples to Chrome trace events, and
   (when export is configured) appends them as JSONL under
   ``<out_dir>/events.jsonl`` so even a SIGKILLed run leaves a readable
   timeline.  ``export_chrome_trace`` writes the standard
   ``{"traceEvents": [...]}`` JSON that Perfetto/chrome://tracing load.

Clocks: span timestamps are ``time.monotonic()`` relative to a per-process
epoch; the matching ``time.time()`` wall epoch is stored in the trace
metadata so a ``torch.profiler`` window (``core/_profiler.py``) can be
lined up with the span timeline.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("determined_tpu_torch.observability")

# Event tuples pushed into the per-thread rings (the hot-path format; the
# drain side converts to Chrome trace-event dicts):
#   ("X", name, cat, t0, dur_s, args)    complete span (monotonic seconds)
#   ("I", name, cat, t, args)            instant event
#   ("C", name, t, value, kind, args)    counter (kind "c": accumulates)
#                                        or gauge (kind "g": last wins)

DEFAULT_RING_CAPACITY = 8192
DEFAULT_FLUSH_INTERVAL = 0.5
DEFAULT_MAX_EVENTS = 1_000_000


class _Ring:
    """Single-producer / single-consumer ring of event tuples.

    Lock-free under the GIL: the producer (the owning thread) writes the
    slot and then publishes it by incrementing ``tail`` — an int store the
    GIL makes atomic; the consumer (the tracer's drain, serialized by the
    tracer lock) snapshots ``tail`` and reads only slots below it.  A full
    ring drops (counted in ``dropped``) instead of blocking: observability
    must never back-pressure training.
    """

    __slots__ = ("items", "capacity", "head", "tail", "dropped", "tid",
                 "thread_name", "thread")

    def __init__(self, capacity: int, owner: threading.Thread) -> None:
        self.items: List[Any] = [None] * capacity
        self.capacity = capacity
        self.head = 0  # consumer cursor: only drain() advances it
        self.tail = 0  # producer cursor: only push() advances it
        self.dropped = 0
        self.tid = owner.ident or id(owner)
        self.thread_name = owner.name
        self.thread = owner  # drained-empty rings of dead threads get pruned

    def push(self, item: Tuple) -> bool:
        # producer-only state; see class docstring for the SPSC argument
        if self.tail - self.head >= self.capacity:
            self.dropped += 1
            return False
        self.items[self.tail % self.capacity] = item
        self.tail += 1
        return True

    def drain(self) -> List[Tuple]:
        # consumer-only; callers serialize via the tracer lock
        out: List[Tuple] = []
        tail = self.tail  # snapshot: everything below is fully written
        head = self.head
        while head < tail:
            i = head % self.capacity
            out.append(self.items[i])
            self.items[i] = None
            head += 1
        self.head = head
        return out


class _Span:
    """Context-manager span bound to one tracer."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Optional[Dict]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self._tracer.record_span(
            self._name, self._cat, self._t0, time.monotonic(), self._args
        )
        return False


class _NullSpan:
    """Shared do-nothing span: what ``span()`` returns when disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide span/counter sink with per-thread ring buffers.

    All recording methods are safe from any thread and never block; the
    drain/export side serializes on one internal lock.  One tracer serves
    the whole process (``get_tracer()``) — concurrent trials distinguish
    themselves by thread and by the ``trial`` span argument.
    """

    def __init__(
        self,
        *,
        ring_capacity: int = DEFAULT_RING_CAPACITY,
        flush_interval: float = DEFAULT_FLUSH_INTERVAL,
        max_events: int = DEFAULT_MAX_EVENTS,
    ) -> None:
        self.enabled = True
        self._epoch = time.monotonic()
        self._epoch_wall = time.time()
        self._ring_capacity = ring_capacity
        self._flush_interval = flush_interval
        self._max_events = max_events
        self._local = threading.local()
        # guards everything below (registry, drained events, counters,
        # export handle, shipper lifecycle)
        self._lock = threading.Lock()
        self._rings: Dict[int, _Ring] = {}
        self._events: List[Dict[str, Any]] = []
        self._events_dropped = 0
        self._counters: Dict[str, float] = {}
        self._named_tids: set = set()
        self._out_dir: Optional[str] = None
        self._jsonl: Optional[Any] = None
        self._shipper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pid = os.getpid()

    # -- configuration -----------------------------------------------------

    def configure(
        self,
        *,
        out_dir: Optional[str] = None,
        ring_capacity: Optional[int] = None,
        flush_interval: Optional[float] = None,
        max_events: Optional[int] = None,
        enabled: Optional[bool] = None,
    ) -> "Tracer":
        """(Re)configure the tracer: called by the experiment runner before
        any trial thread starts.  ``out_dir`` turns on JSONL
        export (``<out_dir>/events.jsonl``, append: resumed runs extend
        the same timeline)."""
        with self._lock:
            if ring_capacity is not None:
                self._ring_capacity = int(ring_capacity)
            if flush_interval is not None:
                self._flush_interval = float(flush_interval)
            if max_events is not None:
                self._max_events = int(max_events)
            if enabled is not None:
                self.enabled = bool(enabled)
            if out_dir != self._out_dir:
                if self._jsonl is not None:
                    self._jsonl.close()
                    self._jsonl = None
                self._out_dir = out_dir
                if out_dir is not None:
                    os.makedirs(out_dir, exist_ok=True)
                    self._jsonl = open(
                        os.path.join(out_dir, "events.jsonl"), "a", encoding="utf-8"
                    )
                    meta = {
                        "ph": "M",
                        "name": "clock_sync",
                        "pid": self._pid,
                        "tid": 0,
                        "ts": 0,
                        "args": {
                            "epoch_unix_s": self._epoch_wall,
                            "epoch_monotonic_s": self._epoch,
                        },
                    }
                    self._jsonl.write(json.dumps(meta) + "\n")
                    self._jsonl.flush()
        return self

    def reset(self) -> None:
        """Drop drained events/counters (a new experiment's clean slate).
        Ring registrations survive — live threads keep their buffers."""
        self.drain()
        with self._lock:
            self._events = []
            self._events_dropped = 0
            self._counters = {}
            self._named_tids = set()
            for ring in self._rings.values():
                # the clean slate covers drop counts too, or a new run
                # would warn about the previous run's ring overflows
                ring.dropped = 0

    # -- hot-path recording ------------------------------------------------

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None or ring.capacity != self._ring_capacity:
            ring = _Ring(self._ring_capacity, threading.current_thread())
            self._local.ring = ring
            with self._lock:
                # keyed by object id: a recycled thread ident must not
                # replace a dead thread's ring before its tail is drained
                self._rings[id(ring)] = ring
        return ring

    def record_span(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record an already-timed span (``time.monotonic()`` endpoints).
        The hot-loop form: two clock reads + one tuple push."""
        if not self.enabled:
            return
        self._ring().push(("X", name, cat, t0, t1 - t0, args))

    def span(self, name: str, cat: str = "misc", **args: Any) -> Any:
        """Context-manager span; ~free when the tracer is disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "misc", **args: Any) -> None:
        if not self.enabled:
            return
        self._ring().push(("I", name, cat, time.monotonic(), args or None))

    def counter(self, name: str, value: float = 1.0, **args: Any) -> None:
        """Accumulating counter (drain sums values)."""
        if not self.enabled:
            return
        self._ring().push(("C", name, time.monotonic(), value, "c", args or None))

    def gauge(self, name: str, value: float, **args: Any) -> None:
        """Point-in-time gauge (drain keeps the last value)."""
        if not self.enabled:
            return
        self._ring().push(("C", name, time.monotonic(), value, "g", args or None))

    def ingest(self, events: List[Dict[str, Any]], epoch: float) -> None:
        """Re-record another process's drained events (``chrome_events``;
        ``epoch`` its tracer's ``time.monotonic()`` origin, one clock on a
        host) on the calling thread, as if they had happened here: a
        gang's chief ships its spans and counters to the experiment's
        tracer this way (``experiment/_gang.py``)."""
        if not self.enabled:
            return
        ring = self._ring()
        for ev in events:
            t = epoch + float(ev.get("ts", 0.0)) / 1e6
            args = dict(ev.get("args") or {}) or None
            ph = ev.get("ph")
            if ph == "X":
                ring.push(("X", ev["name"], ev.get("cat"), t, float(ev["dur"]) / 1e6, args))
            elif ph == "i":
                ring.push(("I", ev["name"], ev.get("cat"), t, args))
            elif ph == "C":
                value = args.pop("value") if args else 0.0
                kind = "g" if ev.get("cat") == "gauge" else "c"
                ring.push(("C", ev["name"], t, value, kind, args or None))

    @property
    def epoch(self) -> float:
        """The ``time.monotonic()`` origin of the events' ``ts``."""
        return self._epoch

    # -- drain / shipper ---------------------------------------------------

    def _to_us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 1)

    def _convert(self, ring: _Ring, item: Tuple) -> Dict[str, Any]:
        kind = item[0]
        if kind == "X":
            _, name, cat, t0, dur, args = item
            ev = {
                "ph": "X",
                "name": name,
                "cat": cat or "misc",
                "ts": self._to_us(t0),
                "dur": round(dur * 1e6, 1),
                "pid": self._pid,
                "tid": ring.tid,
            }
            if args:
                ev["args"] = args
            return ev
        if kind == "I":
            _, name, cat, t, args = item
            ev = {
                "ph": "i",
                "s": "t",
                "name": name,
                "cat": cat or "misc",
                "ts": self._to_us(t),
                "pid": self._pid,
                "tid": ring.tid,
            }
            if args:
                ev["args"] = args
            return ev
        # "C"
        _, name, t, value, ckind, args = item
        ev = {
            "ph": "C",
            "name": name,
            "ts": self._to_us(t),
            "pid": self._pid,
            "tid": ring.tid,
            "args": {"value": value},
        }
        if args:
            ev["args"].update(args)
        ev["cat"] = "counter" if ckind == "c" else "gauge"
        return ev

    def drain(self) -> int:
        """Move every ring's pending events into the drained list (and the
        JSONL export when configured).  Returns how many events moved.
        Safe from any thread; serialized internally."""
        moved = 0
        with self._lock:
            lines: List[str] = []
            for key, ring in list(self._rings.items()):
                items = ring.drain()
                if not items:
                    # fully drained ring of a dead thread: prune it, or a
                    # long search's finished trial/worker threads would
                    # accumulate 8192-slot buffers for the process lifetime
                    # (its drop count must survive the prune)
                    if ring.head == ring.tail and not ring.thread.is_alive():
                        self._events_dropped += ring.dropped
                        del self._rings[key]
                    continue
                if ring.tid not in self._named_tids:
                    self._named_tids.add(ring.tid)
                    name_ev = {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": self._pid,
                        "tid": ring.tid,
                        "ts": 0,
                        "args": {"name": ring.thread_name},
                    }
                    self._append_event(name_ev, lines)
                for item in items:
                    ev = self._convert(ring, item)
                    if ev["ph"] == "C":
                        val = float(ev["args"]["value"])
                        if ev.get("cat") == "gauge":
                            self._counters[ev["name"]] = val
                        else:
                            self._counters[ev["name"]] = (
                                self._counters.get(ev["name"], 0.0) + val
                            )
                    self._append_event(ev, lines)
                    moved += 1
            if lines and self._jsonl is not None:
                try:
                    self._jsonl.write("".join(lines))
                    self._jsonl.flush()
                except OSError:
                    logger.exception("trace export write failed; export disabled")
                    self._jsonl = None
        return moved

    def _append_event(self, ev: Dict[str, Any], lines: List[str]) -> None:
        # every caller (drain) already holds self._lock
        if len(self._events) < self._max_events:
            self._events.append(ev)
        else:
            self._events_dropped += 1
        if self._jsonl is not None:
            lines.append(json.dumps(ev, default=str) + "\n")

    def _run(self) -> None:
        while not self._stop.wait(self._flush_interval):
            try:
                self.drain()
            except Exception:  # noqa: BLE001 - the shipper must survive
                logger.exception("trace drain failed")

    def start(self) -> "Tracer":
        """Start the background shipper (idempotent)."""
        with self._lock:
            if self._shipper is not None:
                return self
            self._stop.clear()
            self._shipper = threading.Thread(
                target=self._run, name="dtt-obs-shipper", daemon=True
            )
            self._shipper.start()
        return self

    def stop(self) -> None:
        """Stop the shipper and perform a final drain.  Idempotent."""
        with self._lock:
            shipper, self._shipper = self._shipper, None
        if shipper is not None:
            self._stop.set()
            shipper.join(timeout=10)
        self.drain()

    # -- inspection / export -----------------------------------------------

    @property
    def epoch_wall(self) -> float:
        return self._epoch_wall

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Snapshot of all drained events (drains first)."""
        self.drain()
        with self._lock:
            return list(self._events)

    def counters(self) -> Dict[str, float]:
        self.drain()
        with self._lock:
            return dict(self._counters)

    def stats(self) -> Dict[str, Any]:
        self.drain()
        with self._lock:
            ring_dropped = sum(r.dropped for r in self._rings.values())
            return {
                "events": len(self._events),
                "dropped": ring_dropped + self._events_dropped,
                "ring_dropped": ring_dropped,
                "threads": len(self._rings),
                "counters": dict(self._counters),
            }

    def dropped(self) -> int:
        with self._lock:
            return sum(r.dropped for r in self._rings.values()) + self._events_dropped

    def export_chrome_trace(self, path: str) -> str:
        """Write a self-contained ``{"traceEvents": [...]}`` JSON file
        (the format Perfetto / chrome://tracing load directly)."""
        events = self.chrome_events()
        with self._lock:
            named = set()
            meta: List[Dict[str, Any]] = []
            for ring in self._rings.values():
                if ring.tid in named:
                    continue
                named.add(ring.tid)
                meta.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": self._pid,
                        "tid": ring.tid,
                        "ts": 0,
                        "args": {"name": ring.thread_name},
                    }
                )
            payload = {
                "traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "epoch_unix_s": self._epoch_wall,
                    "epoch_monotonic_s": self._epoch,
                    "dropped_events": self._events_dropped
                    + sum(r.dropped for r in self._rings.values()),
                },
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        self.stop()
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
            self._out_dir = None


# Process-global tracer: trainer, prefetch worker, journal, supervisor and
# serving engine all record here; the experiment runner owns its lifecycle.
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
