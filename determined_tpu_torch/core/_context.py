"""The core context of a trial: ``init`` and ``_dummy_init`` of
``determined_tpu/core/_context.py``.

Under the master (``get_cluster_info()`` finds the ``DTPU_*`` launch
environment, or ``info=`` gives one) ``init`` builds the cluster context: a
``Session`` to the master with the allocation's token, the distributed
context from the master's rendezvous (``DistributedContext.from_rendezvous``),
checkpoint storage from the experiment's ``checkpoint_storage`` with each
checkpoint recorded at the master, metrics shipped to the master's metrics
API, progress and status reports, the preemption watcher and the SIGTERM
latch, the heartbeat reporter, the log shipper (when the launch names a
task id) and a profiler trace directory under shared storage.

Off the cluster it is what it was: under torchrun (``WORLD_SIZE`` > 1) a
``DistributedContext.from_torch``, else the single-rank one; checkpoints in
a local directory (``DummyCheckpointContext``), reports kept in memory and
logged, preemption by ``simulate()``, and the profiler (a system sampler and
a ``torch.profiler`` window).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any, Optional

from determined_tpu_torch.core._checkpoint import CheckpointContext, DummyCheckpointContext
from determined_tpu_torch.core._cluster_info import ClusterInfo, get_cluster_info
from determined_tpu_torch.core._distributed import DistributedContext, DummyDistributedContext
from determined_tpu_torch.core._heartbeat import HeartbeatReporter, LogShipper
from determined_tpu_torch.core._metrics import MetricsContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext
from determined_tpu_torch.core._train import DummyTrainContext, TrainContext

logger = logging.getLogger("determined_tpu_torch.core")


class Context:
    """Composed handle: ``.distributed``, ``.checkpoint``, ``.train``,
    ``.preempt``, ``.profiler``, ``.info``."""

    def __init__(
        self,
        distributed: DistributedContext,
        checkpoint: CheckpointContext,
        train: TrainContext,
        preempt: PreemptContext,
        profiler: ProfilerContext,
        metrics: MetricsContext,
        info: Optional[ClusterInfo] = None,
        session: Optional[Any] = None,
        heartbeat: Optional[HeartbeatReporter] = None,
        log_shipper: Optional[LogShipper] = None,
    ) -> None:
        self.distributed = distributed
        self.checkpoint = checkpoint
        self.train = train
        self.preempt = preempt
        self.profiler = profiler
        self._metrics = metrics
        self.info = info
        self._session = session
        self._heartbeat = heartbeat
        self._log_shipper = log_shipper

    @property
    def metrics(self) -> MetricsContext:
        """Public handle for out-of-band reporters (e.g. the trial
        supervisor's restart counts)."""
        return self._metrics

    @property
    def master_unreachable(self) -> bool:
        """True while the heartbeat reporter has latched a failure streak;
        False off-cluster."""
        return bool(self._heartbeat is not None and self._heartbeat.master_unreachable)

    def start(self) -> "Context":
        self._metrics.start()
        self.preempt.start()
        if self._heartbeat:
            self._heartbeat.start()
        if self._log_shipper:
            self._log_shipper.start()
        return self

    def close(self) -> None:
        self.profiler.off()
        self.preempt.close()
        self._metrics.close()
        if self._heartbeat:
            self._heartbeat.close()
        if self._log_shipper:
            self._log_shipper.close()
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
        preempt=PreemptContext(distributed, register_signal_handler=False),
        profiler=ProfilerContext(
            distributed, metrics,
            trace_dir=trace_dir or os.path.join(checkpoint_dir, "traces", "torch_profiler"),
        ),
        metrics=metrics,
    )
    return ctx.start()


def _cluster_init(
    info: ClusterInfo,
    *,
    distributed: Optional[DistributedContext],
    checkpoint_dir: Optional[str],
    device: Any,
) -> Context:
    """The context of a trial the master launched (module docstring)."""
    from determined_tpu_torch.storage.base import from_string

    session = None
    if info.master_url:
        from determined_tpu_torch.api.session import Session

        session = Session(info.master_url, token=info.session_token or None)
    if distributed is None:
        if info.rendezvous:
            distributed = DistributedContext.from_rendezvous(device=device)
        else:
            distributed = DummyDistributedContext()

    url = checkpoint_dir or (info.exp_config or {}).get("checkpoint_storage")
    if url is None:
        url = os.path.join(os.getcwd(), "checkpoints")
    if isinstance(url, dict):
        # expconf dict form ({"type": "shared_fs", "host_path": ...})
        from determined_tpu_torch.config.experiment import CheckpointStorageConfig

        storage_manager = from_string(CheckpointStorageConfig.parse(dict(url)).to_url())
    else:
        storage_manager = from_string(url)

    checkpoint = CheckpointContext(
        distributed,
        storage_manager,
        session=session,
        trial_id=info.trial_id,
        staging_dir=tempfile.mkdtemp(prefix="dtt-ckpt-"),
    )
    metrics = MetricsContext(
        session=session,
        trial_id=info.trial_id,
        run_id=info.trial_run_id,
        local_path=None if session else os.path.join(os.getcwd(), "metrics.jsonl"),
    )
    train = TrainContext(
        distributed,
        metrics,
        session=session,
        trial_id=info.trial_id,
        experiment_id=info.experiment_id,
    )
    preempt = PreemptContext(
        distributed,
        session=session,
        allocation_id=info.allocation_id,
    )
    # profiler traces land in shared checkpoint storage when it has a local
    # path, so a viewer on any host can read them
    base = getattr(storage_manager, "base_path", None) or os.getcwd()
    trace_dir = os.path.join(base, "traces", f"trial_{info.trial_id or 0}")
    profiler = ProfilerContext(distributed, metrics, trace_dir=trace_dir)
    hb_threshold = ((info.exp_config or {}).get("fault_tolerance") or {}).get(
        "heartbeat_failure_threshold"
    )
    heartbeat = (
        HeartbeatReporter(session, info.trial_id, failure_threshold=hb_threshold)
        if session is not None and info.trial_id is not None
        else None
    )
    log_shipper = LogShipper(session, info.task_id) if session is not None and info.task_id else None
    ctx = Context(
        distributed=distributed,
        checkpoint=checkpoint,
        train=train,
        preempt=preempt,
        profiler=profiler,
        metrics=metrics,
        info=info,
        session=session,
        heartbeat=heartbeat,
        log_shipper=log_shipper,
    )
    return ctx.start()


def init(
    *,
    distributed: Optional[DistributedContext] = None,
    checkpoint_dir: Optional[str] = None,
    trace_dir: Optional[str] = None,
    device: Any = None,
    info: Optional[ClusterInfo] = None,
) -> Context:
    """The core context of a trial: the cluster context when ``info`` (or
    the ``DTPU_*`` environment) names a master launch, else the local one.
    Under the master, ``checkpoint_dir`` (when given) overrides the
    experiment's ``checkpoint_storage``.

    Off the cluster, under torchrun (``WORLD_SIZE`` > 1) the distributed
    context is ``DistributedContext.from_torch(device=device)``, else the
    single-rank one; checkpoints go under ``checkpoint_dir``
    (``./checkpoints`` when None, shared by every rank as the JAX
    ``init``'s default)."""
    info = info or get_cluster_info()
    if info is not None:
        return _cluster_init(info, distributed=distributed, checkpoint_dir=checkpoint_dir,
                             device=device)
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
