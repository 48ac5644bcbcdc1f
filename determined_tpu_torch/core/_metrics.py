"""Background metric shipper: a copy of ``determined_tpu/core/_metrics.py``.

Training code must never block on metric I/O, so reports are enqueued and
a daemon thread batches them to the sink: the master's metrics API
(``POST /api/v1/trials/metrics``) when a session exists, else a local JSONL
file.  Every row is also kept in memory (``rows``), which is how a run
reads its own reports back (``TrainContext.metrics``, the profiler's
``profile`` row).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("determined_tpu_torch.core.metrics")

SHIP_INTERVAL = 1.0  # seconds between batch flushes
MAX_BATCH = 1000


class MetricsContext:
    def __init__(
        self,
        session: Optional[Any] = None,
        trial_id: Optional[int] = None,
        run_id: int = 0,
        local_path: Optional[str] = None,
    ) -> None:
        self._session = session
        self._trial_id = trial_id
        self._run_id = run_id
        self._local_path = local_path
        self._lock = threading.Lock()
        #: (group, steps_completed, metrics) in report order
        self._rows: List[Tuple[str, Optional[int], Dict[str, Any]]] = []
        self._queue: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsContext":
        """Start the shipper; with no master and no file there is nothing
        to ship, and no thread starts."""
        if self._thread is None and (self._session is not None or self._local_path is not None):
            self._thread = threading.Thread(target=self._run, daemon=True, name="metrics-shipper")
            self._thread.start()
        return self

    def report(
        self,
        group: str,
        steps_completed: Optional[int],
        metrics: Dict[str, Any],
        report_time: Optional[float] = None,
    ) -> None:
        if self._error is not None:
            raise RuntimeError("metrics shipper thread died") from self._error
        with self._lock:
            self._rows.append((group, steps_completed, dict(metrics)))
        if self._thread is None:
            return
        self._queue.put(
            {
                "group": group,
                "steps_completed": steps_completed,
                "metrics": metrics,
                "report_time": report_time if report_time is not None else time.time(),
                "trial_id": self._trial_id,
                "trial_run_id": self._run_id,
            }
        )

    def rows(self, group: Optional[str] = None) -> List[Tuple[str, Optional[int], Dict[str, Any]]]:
        """The reported rows (all, or one group's) in report order."""
        with self._lock:
            return [r for r in self._rows if group is None or r[0] == group]

    def close(self) -> None:
        """Flush what is queued and stop the shipper."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._queue.put(None)
        thread.join(timeout=30)

    # -- shipper thread ----------------------------------------------------

    def _run(self) -> None:
        try:
            done = False
            while not done:
                batch: List[Dict[str, Any]] = []
                try:
                    item = self._queue.get(timeout=SHIP_INTERVAL)
                    if item is None:
                        done = True
                    else:
                        batch.append(item)
                except queue.Empty:
                    pass
                while len(batch) < MAX_BATCH:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:
                        done = True
                        break
                    batch.append(item)
                if batch:
                    try:
                        self._ship(batch)
                    except Exception:  # noqa: BLE001
                        # Metric shipping must never kill training: drop the
                        # batch, keep the thread alive for the next one.
                        logger.exception("failed to ship %d metrics; dropped", len(batch))
        except BaseException as e:  # noqa: BLE001
            # terminal single write as the shipper dies; report() raises
            # it on the next call
            self._error = e
            logger.exception("metrics shipper thread failed")

    def _ship(self, batch: List[Dict[str, Any]]) -> None:
        if self._session is not None:
            self._session.post("/api/v1/trials/metrics",
                               json={"metrics": json.loads(json.dumps(batch, default=_json_default))})
            return
        os.makedirs(os.path.dirname(self._local_path) or ".", exist_ok=True)
        with open(self._local_path, "a") as f:
            for m in batch:
                f.write(json.dumps(m, default=_json_default) + "\n")


def _json_default(o: Any) -> Any:
    try:
        import numpy as np

        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return str(o)
