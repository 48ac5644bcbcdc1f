"""Core services of the port: ``init`` (the cluster context under the
master, the local one elsewhere) and ``_dummy_init`` with their
distributed, checkpoint, preemption, metrics, train and profiler contexts
(the names follow ``determined_tpu/core``)."""

from determined_tpu_torch.core._checkpoint import (
    MANIFEST_FILE,
    METADATA_FILE,
    CheckpointContext,
    DummyCheckpointContext,
    build_manifest,
    file_stats,
    merge_metadata,
    merge_resources,
    verify_manifest,
)
from determined_tpu_torch.core._cluster_info import ClusterInfo, get_cluster_info
from determined_tpu_torch.core._context import Context, _dummy_init, init
from determined_tpu_torch.core._distributed import (
    DistributedContext,
    DummyDistributedContext,
    allocate_port,
)
from determined_tpu_torch.core._heartbeat import HeartbeatReporter, LogShipper
from determined_tpu_torch.core._metrics import MetricsContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext
from determined_tpu_torch.core._train import DummyTrainContext, EarlyExitReason, TrainContext

__all__ = [
    "MANIFEST_FILE",
    "METADATA_FILE",
    "CheckpointContext",
    "ClusterInfo",
    "Context",
    "DistributedContext",
    "DummyCheckpointContext",
    "DummyDistributedContext",
    "DummyTrainContext",
    "EarlyExitReason",
    "HeartbeatReporter",
    "LogShipper",
    "MetricsContext",
    "PreemptContext",
    "ProfilerContext",
    "TrainContext",
    "_dummy_init",
    "allocate_port",
    "build_manifest",
    "file_stats",
    "get_cluster_info",
    "init",
    "merge_metadata",
    "merge_resources",
    "verify_manifest",
]
