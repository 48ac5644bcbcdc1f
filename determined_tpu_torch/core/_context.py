"""The off-cluster core context: the part of
``determined_tpu/core/_context.py`` (``_dummy_init``) that a single-process
trial needs.  One rank, checkpoints in a local directory
(``DummyCheckpointContext``), reports kept in memory and logged, preemption
by ``simulate()``, no profiler.  Cluster services (master
session, heartbeats, log shipping, cloud storage) come with a later slice of
the port."""

from __future__ import annotations

import logging
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.core._checkpoint import CheckpointContext, DummyCheckpointContext
from determined_tpu_torch.core._preempt import PreemptContext

logger = logging.getLogger("determined_tpu_torch.core")

TRAINING = "training"
VALIDATION = "validation"


class DummyDistributedContext:
    """Single-rank context for off-cluster runs (the JAX package's size-1
    star).  The port trains on one device, so nothing of it exchanges
    values between ranks."""

    rank = 0
    size = 1
    is_chief = True

    def close(self) -> None:
        return None


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


class DummyProfilerContext:
    """No profiler off-cluster: never tracing."""

    tracing = False

    def off(self) -> None:
        return None


class Context:
    """Composed handle: ``.distributed``, ``.checkpoint``, ``.train``,
    ``.preempt``, ``.profiler``."""

    def __init__(
        self,
        distributed: DummyDistributedContext,
        checkpoint: CheckpointContext,
        train: DummyTrainContext,
        preempt: PreemptContext,
        profiler: DummyProfilerContext,
    ) -> None:
        self.distributed = distributed
        self.checkpoint = checkpoint
        self.train = train
        self.preempt = preempt
        self.profiler = profiler

    def start(self) -> "Context":
        self.preempt.start()
        return self

    def close(self) -> None:
        self.profiler.off()
        self.preempt.close()
        self.distributed.close()

    def __enter__(self) -> "Context":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _dummy_init(
    *,
    distributed: Optional[DummyDistributedContext] = None,
    checkpoint_dir: Optional[str] = None,
) -> Context:
    """Fully local Context with zero services; checkpoints go under
    ``checkpoint_dir`` (a fresh temporary directory when None)."""
    distributed = distributed or DummyDistributedContext()
    checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(prefix="dtt-dummy-ckpt-")
    ctx = Context(
        distributed=distributed,
        checkpoint=DummyCheckpointContext(distributed, checkpoint_dir),
        train=DummyTrainContext(),
        preempt=PreemptContext(distributed),
        profiler=DummyProfilerContext(),
    )
    return ctx.start()
