"""Process-wide spans, gauges and counters for the port's serving and
training paths.

The part of ``determined_tpu/observability/_tracer.py`` the port uses:
``get_tracer()``, ``Tracer.span``/``record_span``, ``instant``, ``gauge``,
``counter`` and ``enabled``, under the same names.  Serving
spans ``serve.admit``, ``serve.prefill``, ``serve.decode``,
``serve.kv_alloc`` and gauges ``serve.queue_depth``,
``serve.kv_utilization``; training spans ``data.wait``, ``step.dispatch``,
``step.boundary_block``, ``validate``, ``data.fetch``, ``data.h2d`` and
counters ``train.steps``, ``train.samples``, ``train.tokens`` (summed);
search spans ``trial.run``, ``trial.clone``, the instant
``searcher.pbt.generation`` and counters ``searcher.pbt.clones``,
``searcher.clones_materialized``.
Spans land in a bounded buffer (the oldest drop first) that ``spans()``
reads; ``chip_smoke.py`` takes the decode-step time from it.  Span times are
host wall-clock; a training step's span ends when its work is queued on the
device, and ``step.boundary_block`` is where the host waits for the device.
With ``enabled`` False every recording call returns at once.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

DEFAULT_MAX_SPANS = 65536

#: (name, cat, t0 monotonic seconds, duration seconds, args)
SpanRecord = Tuple[str, str, float, float, Optional[Dict[str, Any]]]


class _Span:
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
        self._tracer.record_span(self._name, self._cat, self._t0, time.monotonic(), self._args)
        return False


class Tracer:
    """Thread-safe span and gauge sink."""

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS) -> None:
        self.enabled = True
        self._lock = threading.Lock()
        self._spans: Deque[SpanRecord] = collections.deque(maxlen=max_spans)
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, float] = {}

    def record_span(
        self, name: str, cat: str, t0: float, t1: float, args: Optional[Dict[str, Any]] = None
    ) -> None:
        """Record an already-timed span (``time.monotonic()`` endpoints)."""
        if not self.enabled:
            return
        with self._lock:
            self._spans.append((name, cat, t0, t1 - t0, args))

    def span(self, name: str, cat: str = "misc", **args: Any) -> "_Span":
        """Context-manager span."""
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "misc", **args: Any) -> None:
        """A point event: a span of zero duration (``searcher.pbt.generation``)."""
        if not self.enabled:
            return
        t = time.monotonic()
        self.record_span(name, cat, t, t, args or None)

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time gauge (the last value wins)."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def counter(self, name: str, value: float = 1.0) -> None:
        """Accumulating counter (values sum)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + float(value)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        with self._lock:
            return [s for s in self._spans if name is None or s[0] == name]

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._gauges.clear()
            self._counters.clear()


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
