"""The off-cluster core context: the part of
``determined_tpu/core/_context.py`` (``init``, ``_dummy_init``) that a
trial needs without a master.  ``init`` takes a ``DistributedContext`` over
torch.distributed when torchrun's environment names more than one rank
(``DistributedContext.from_torch``), the single-rank one otherwise;
checkpoints in a local directory
(``DummyCheckpointContext``), reports through the local metrics shipper
(``MetricsContext``: kept in memory and logged), preemption by ``simulate()``, and the profiler
(``ProfilerContext``: a system sampler and a ``torch.profiler`` window).
Cluster services (master session, heartbeats, log shipping, cloud storage)
come with a later slice of the port."""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.core._checkpoint import CheckpointContext, DummyCheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext, DummyDistributedContext
from determined_tpu_torch.core._metrics import MetricsContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext

logger = logging.getLogger("determined_tpu_torch.core")

TRAINING = "training"
VALIDATION = "validation"


class DummyTrainContext:
    """Metric and progress reports, through the metrics shipper (which
    keeps every row in memory) and logged."""

    def __init__(self, metrics: MetricsContext) -> None:
        self._metrics = metrics
        self.progress: float = 0.0

    def report_metrics(self, group: str, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self._metrics.report(group, int(steps_completed), metrics)
        logger.info("%s metrics at step %d: %s", group, steps_completed, metrics)

    def report_training_metrics(self, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.report_metrics(TRAINING, steps_completed, metrics)

    def report_validation_metrics(self, steps_completed: int, metrics: Dict[str, Any]) -> None:
        self.report_metrics(VALIDATION, steps_completed, metrics)

    def report_progress(self, progress: float) -> None:
        self.progress = float(progress)

    def metrics(self, group: str) -> List[Tuple[Optional[int], Dict[str, Any]]]:
        """The rows of one group as (steps_completed, metrics), the
        profiler's ``profile`` and ``system_metrics`` rows included."""
        return [(step, m) for _g, step, m in self._metrics.rows(group)]


class Context:
    """Composed handle: ``.distributed``, ``.checkpoint``, ``.train``,
    ``.preempt``, ``.profiler``."""

    def __init__(
        self,
        distributed: DistributedContext,
        checkpoint: CheckpointContext,
        train: DummyTrainContext,
        preempt: PreemptContext,
        profiler: ProfilerContext,
        metrics: MetricsContext,
    ) -> None:
        self.distributed = distributed
        self.checkpoint = checkpoint
        self.train = train
        self.preempt = preempt
        self.profiler = profiler
        self._metrics = metrics

    def start(self) -> "Context":
        self._metrics.start()
        self.preempt.start()
        return self

    def close(self) -> None:
        self.profiler.off()
        self.preempt.close()
        self._metrics.close()
        self.distributed.close()

    def __enter__(self) -> "Context":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _dummy_init(
    *,
    distributed: Optional[DistributedContext] = None,
    checkpoint_dir: Optional[str] = None,
    trace_dir: Optional[str] = None,
) -> Context:
    """Fully local Context with zero services; checkpoints go under
    ``checkpoint_dir`` (a fresh temporary directory when None), metrics
    are kept in memory, and a profiler window's trace goes under
    ``trace_dir`` (``<checkpoint_dir>/traces/torch_profiler`` when None)."""
    distributed = distributed or DummyDistributedContext()
    checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(prefix="dtt-dummy-ckpt-")
    metrics = MetricsContext()
    ctx = Context(
        distributed=distributed,
        checkpoint=DummyCheckpointContext(distributed, checkpoint_dir),
        train=DummyTrainContext(metrics),
        preempt=PreemptContext(distributed),
        profiler=ProfilerContext(
            distributed, metrics,
            trace_dir=trace_dir or os.path.join(checkpoint_dir, "traces", "torch_profiler"),
        ),
        metrics=metrics,
    )
    return ctx.start()


def init(
    *,
    distributed: Optional[DistributedContext] = None,
    checkpoint_dir: Optional[str] = None,
    trace_dir: Optional[str] = None,
    device: Any = None,
) -> Context:
    """The core context of a trial launched without a master.  Under
    torchrun (``WORLD_SIZE`` > 1) the distributed context is
    ``DistributedContext.from_torch(device=device)``, else the single-rank
    one; checkpoints go under ``checkpoint_dir`` (``./checkpoints`` when
    None, shared by every rank as the JAX ``init``'s default)."""
    if distributed is None:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            distributed = DistributedContext.from_torch(device=device)
        else:
            distributed = DummyDistributedContext()
    return _dummy_init(
        distributed=distributed,
        checkpoint_dir=checkpoint_dir or os.path.join(os.getcwd(), "checkpoints"),
        trace_dir=trace_dir,
    )
