"""TrainContext: metric, progress and status reports (a copy of
``determined_tpu/core/_train.py``).

Reports go through the metrics shipper (``MetricsContext``: to the master
when it has a session, else a local file or memory), and every row stays
readable in memory (``metrics``).  With a session the chief also posts its
progress, an early exit and its status to the trial's routes, and reads the
experiment's best validation from the master.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.core._metrics import MetricsContext

logger = logging.getLogger("determined_tpu_torch.core.train")

TRAINING = "training"
VALIDATION = "validation"


class EarlyExitReason:
    INVALID_HP = "EXITED_REASON_INVALID_HP"
    USER_REQUESTED_STOP = "EXITED_REASON_USER_REQUESTED_STOP"


class TrainContext:
    def __init__(
        self,
        dist: Any,
        metrics: MetricsContext,
        session: Optional[Any] = None,
        trial_id: Optional[int] = None,
        experiment_id: Optional[int] = None,
    ) -> None:
        self._dist = dist
        self._metrics = metrics
        self._session = session
        self._trial_id = trial_id
        self._experiment_id = experiment_id
        self.searcher_metric_name: Optional[str] = None
        self.progress: float = 0.0

    def _is_chief(self) -> bool:
        return self._dist is None or self._dist.is_chief

    # -- reporting ---------------------------------------------------------

    def report_training_metrics(
        self, steps_completed: int, metrics: Dict[str, Any],
        batch_metrics: Optional[list] = None,
    ) -> None:
        body = dict(metrics)
        if batch_metrics is not None:
            body["batch_metrics"] = batch_metrics
        self.report_metrics(TRAINING, steps_completed, body)

    def report_validation_metrics(self, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.report_metrics(VALIDATION, steps_completed, metrics)

    def report_metrics(self, group: str, steps_completed: int, metrics: Dict[str, Any]) -> None:
        """Arbitrary metric groups, chief only."""
        if not self._is_chief():
            raise RuntimeError("report_metrics must only be called on the chief")
        self._metrics.report(group, int(steps_completed), metrics)
        logger.info("%s metrics at step %d: %s", group, steps_completed, metrics)

    def report_progress(self, progress: float) -> None:
        if not self._is_chief():
            return
        self.progress = float(progress)
        if self._session is not None and self._trial_id is not None:
            try:
                # progress is a last-writer-wins scalar: idempotent, opt in
                self._session.post(
                    f"/api/v1/trials/{self._trial_id}/progress",
                    json={"progress": self.progress},
                    retry=True,
                )
            except Exception:  # noqa: BLE001
                logger.exception("failed to report progress")

    def report_early_exit(self, reason: str) -> None:
        if self._session is not None and self._trial_id is not None:
            try:
                self._session.post(
                    f"/api/v1/trials/{self._trial_id}/early_exit", json={"reason": reason}
                )
            except Exception:  # noqa: BLE001
                logger.exception("failed to report early exit")

    def set_status(self, status: str) -> None:
        if self._session is not None and self._trial_id is not None:
            try:
                self._session.post(
                    f"/api/v1/trials/{self._trial_id}/runner_metadata",
                    json={"state": status},
                )
            except Exception:  # noqa: BLE001
                pass

    def get_experiment_best_validation(self) -> Optional[float]:
        if self._session is None or self._experiment_id is None:
            return None
        try:
            resp = self._session.get(
                f"/api/v1/experiments/{self._experiment_id}/searcher_metric_best"
            )
            return resp.json().get("best")
        except Exception:  # noqa: BLE001
            return None

    def metrics(self, group: str) -> List[Tuple[Optional[int], Dict[str, Any]]]:
        """The rows of one group as (steps_completed, metrics), the
        profiler's ``profile`` and ``system_metrics`` rows included."""
        return [(step, m) for _g, step, m in self._metrics.rows(group)]


class DummyTrainContext(TrainContext):
    """Off-cluster reports: kept in memory (and in the shipper's file, when
    it has one) and logged."""

    def __init__(self, metrics: MetricsContext) -> None:
        super().__init__(None, metrics)
