"""Heartbeat + log shipping for trials under the master: a copy of
``determined_tpu/core/_heartbeat.py``.

``HeartbeatReporter`` POSTs ``/api/v1/trials/{id}/heartbeat`` every
``INTERVAL`` seconds and latches ``master_unreachable`` after a streak of
failures; the first beat the master answers is logged once, so the
trial's own log says that its heartbeats land.  ``LogShipper`` intercepts
stdout/stderr and ships batched lines to the master's task-log route,
``POST /api/v1/logs`` with the task id (the JAX shipper posts to
``/api/v1/task_logs``, a route the native master does not have, so its
batches are refused there).
"""

from __future__ import annotations

import io
import logging
import queue
import sys
import threading
from typing import Any, List, Optional

logger = logging.getLogger("determined_tpu_torch.core.heartbeat")


class HeartbeatReporter:
    INTERVAL = 30.0
    # consecutive failures before the master is declared unreachable; a
    # single dropped POST is routine, a streak means a partition/outage
    FAILURE_THRESHOLD = 5

    def __init__(
        self, session: Any, trial_id: int, failure_threshold: Optional[int] = None
    ) -> None:
        self._session = session
        self._trial_id = trial_id
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="heartbeat")
        self._failure_threshold = failure_threshold or self.FAILURE_THRESHOLD
        self._failure_streak = 0
        self._unreachable = threading.Event()
        #: heartbeats the master answered
        self.beats = 0

    @property
    def failure_streak(self) -> int:
        """Consecutive heartbeat failures (0 after any success)."""
        return self._failure_streak

    @property
    def master_unreachable(self) -> bool:
        """Latched after ``failure_threshold`` consecutive failures; the
        supervisor / preemption path observes this to make local decisions
        instead of treating a partition as business as usual.  Cleared
        when a heartbeat lands again."""
        return self._unreachable.is_set()

    def start(self) -> "HeartbeatReporter":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.INTERVAL):
            self._beat()

    def _beat(self) -> bool:
        """One heartbeat attempt; returns success.  Split from the thread
        loop so the failure-streak accounting is directly testable."""
        try:
            self._session.post(f"/api/v1/trials/{self._trial_id}/heartbeat")
        except Exception:  # noqa: BLE001 - counted, not swallowed silently
            # single writer (the reporter thread); the main thread only
            # reads the streak, and an int store is GIL-atomic
            self._failure_streak += 1
            if self._failure_streak >= self._failure_threshold and not self._unreachable.is_set():
                self._unreachable.set()
                logger.warning(
                    "master unreachable: %d consecutive heartbeat failures "
                    "(threshold %d); latching master_unreachable",
                    self._failure_streak,
                    self._failure_threshold,
                )
            else:
                logger.warning(
                    "heartbeat failed (streak %d/%d)",
                    self._failure_streak,
                    self._failure_threshold,
                    exc_info=True,
                )
            return False
        if self._unreachable.is_set():
            logger.warning(
                "master reachable again after %d missed heartbeats", self._failure_streak
            )
        self._failure_streak = 0
        self._unreachable.clear()
        self.beats += 1
        if self.beats == 1:
            logger.info("heartbeat: trial %s beat acknowledged by the master", self._trial_id)
        return True

    def close(self) -> None:
        self._stop.set()


class _Interceptor(io.TextIOBase):
    """Tee for a text stream that also enqueues lines for shipping."""

    def __init__(self, underlying, sink: "queue.Queue[Optional[str]]", stream_name: str) -> None:
        self._underlying = underlying
        self._sink = sink
        self._name = stream_name
        self._buf = ""

    def write(self, s: str) -> int:
        n = self._underlying.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._sink.put(f"[{self._name}] {line}")
        return n

    def flush(self) -> None:
        self._underlying.flush()

    @property
    def underlying(self):
        return self._underlying


class LogShipper:
    """Intercepts stdout/stderr and ships batched log lines to the master
    task-logs API (or drops them off-cluster)."""

    FLUSH_INTERVAL = 1.0
    MAX_BATCH = 500

    def __init__(self, session: Optional[Any], task_id: Optional[str]) -> None:
        self._session = session
        self._task_id = task_id
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="log-shipper")
        self._installed = False

    def start(self) -> "LogShipper":
        if self._session is None:
            return self  # nothing to ship to
        sys.stdout = _Interceptor(sys.stdout, self._queue, "stdout")
        sys.stderr = _Interceptor(sys.stderr, self._queue, "stderr")
        self._installed = True
        self._thread.start()
        return self

    def _run(self) -> None:
        done = False
        while not done:
            batch: List[str] = []
            try:
                item = self._queue.get(timeout=self.FLUSH_INTERVAL)
                if item is None:
                    done = True
                else:
                    batch.append(item)
            except queue.Empty:
                pass
            while len(batch) < self.MAX_BATCH:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    done = True
                    break
                batch.append(item)
            if batch and self._session is not None:
                try:
                    self._session.post(
                        "/api/v1/logs", json={"task_id": self._task_id, "lines": batch}
                    )
                except Exception:  # noqa: BLE001
                    pass

    def close(self) -> None:
        if not self._installed:
            return
        if isinstance(sys.stdout, _Interceptor):
            sys.stdout = sys.stdout.underlying
        if isinstance(sys.stderr, _Interceptor):
            sys.stderr = sys.stderr.underlying
        self._queue.put(None)
        self._thread.join(timeout=10)
        self._installed = False
