"""The off-cluster core context: the part of
``determined_tpu/core/_context.py`` (``_dummy_init``) that a single-process
trial needs.  One rank, reports kept in memory and logged, no preemption,
no profiler.  Cluster services (master session, checkpoint storage,
heartbeats) come with a later slice of the port."""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

logger = logging.getLogger("determined_tpu_torch.core")

TRAINING = "training"
VALIDATION = "validation"


class DummyDistributedContext:
    """Single-rank context for off-cluster runs."""

    rank = 0
    size = 1
    is_chief = True


class DummyTrainContext:
    """Metric and progress reports, kept in memory (``reports``) and logged."""

    def __init__(self) -> None:
        #: (group, steps_completed, metrics) in report order
        self.reports: List[Tuple[str, int, Dict[str, Any]]] = []
        self.progress: float = 0.0

    def report_metrics(self, group: str, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.reports.append((group, int(steps_completed), dict(metrics)))
        logger.info("%s metrics at step %d: %s", group, steps_completed, metrics)

    def report_training_metrics(self, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.report_metrics(TRAINING, steps_completed, metrics)

    def report_validation_metrics(self, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.report_metrics(VALIDATION, steps_completed, metrics)

    def report_progress(self, progress: float) -> None:
        self.progress = float(progress)

    def metrics(self, group: str) -> List[Tuple[int, Dict[str, Any]]]:
        """The reports of one group as (steps_completed, metrics)."""
        return [(step, m) for g, step, m in self.reports if g == group]


class DummyPreemptContext:
    """Off-cluster nothing preempts a trial."""

    def should_preempt(self, auto_ack: bool = True) -> bool:
        return False


class DummyProfilerContext:
    """No profiler off-cluster: never tracing."""

    tracing = False


class Context:
    """Composed handle: ``.distributed``, ``.train``, ``.preempt``,
    ``.profiler``."""

    def __init__(
        self,
        distributed: DummyDistributedContext,
        train: DummyTrainContext,
        preempt: DummyPreemptContext,
        profiler: DummyProfilerContext,
    ) -> None:
        self.distributed = distributed
        self.train = train
        self.preempt = preempt
        self.profiler = profiler


def _dummy_init() -> Context:
    """Fully local Context with zero services."""
    return Context(
        distributed=DummyDistributedContext(),
        train=DummyTrainContext(),
        preempt=DummyPreemptContext(),
        profiler=DummyProfilerContext(),
    )
