"""Process-wide spans and gauges for the port's serving path.

The part of ``determined_tpu/observability/_tracer.py`` the serving engine
uses: ``get_tracer()``, ``Tracer.span`` and ``Tracer.gauge``, under the same
names (``serve.admit``, ``serve.prefill``, ``serve.decode``,
``serve.kv_alloc``; gauges ``serve.queue_depth``, ``serve.kv_utilization``).
Spans land in a bounded buffer (the oldest drop first) that
``spans()`` reads; ``chip_smoke.py`` takes the decode-step time from it.
Span times are host wall-clock around work that ends in a copy to the host.
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
        self._lock = threading.Lock()
        self._spans: Deque[SpanRecord] = collections.deque(maxlen=max_spans)
        self._gauges: Dict[str, float] = {}

    def record_span(
        self, name: str, cat: str, t0: float, t1: float, args: Optional[Dict[str, Any]] = None
    ) -> None:
        with self._lock:
            self._spans.append((name, cat, t0, t1 - t0, args))

    def span(self, name: str, cat: str = "misc", **args: Any) -> "_Span":
        """Context-manager span."""
        return _Span(self, name, cat, args or None)

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time gauge (the last value wins)."""
        with self._lock:
            self._gauges[name] = float(value)

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


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
