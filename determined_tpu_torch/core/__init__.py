"""Core services of the port: ``init`` and the off-cluster ``_dummy_init``
with their distributed, checkpoint, preemption, metrics and profiler
contexts (the names follow ``determined_tpu/core``)."""

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
from determined_tpu_torch.core._context import Context, DummyTrainContext, _dummy_init, init
from determined_tpu_torch.core._distributed import (
    DistributedContext,
    DummyDistributedContext,
    allocate_port,
)
from determined_tpu_torch.core._metrics import MetricsContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext

__all__ = [
    "MANIFEST_FILE",
    "METADATA_FILE",
    "CheckpointContext",
    "Context",
    "DistributedContext",
    "DummyCheckpointContext",
    "DummyDistributedContext",
    "DummyTrainContext",
    "MetricsContext",
    "PreemptContext",
    "ProfilerContext",
    "_dummy_init",
    "allocate_port",
    "build_manifest",
    "file_stats",
    "init",
    "merge_metadata",
    "merge_resources",
    "verify_manifest",
]
