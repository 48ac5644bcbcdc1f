"""Core services of the port: the off-cluster ``_dummy_init`` with its
checkpoint, preemption, metrics and profiler contexts (the names follow
``determined_tpu/core``)."""

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
from determined_tpu_torch.core._context import (
    Context,
    DummyDistributedContext,
    DummyTrainContext,
    _dummy_init,
)
from determined_tpu_torch.core._metrics import MetricsContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext

__all__ = [
    "MANIFEST_FILE",
    "METADATA_FILE",
    "CheckpointContext",
    "Context",
    "DummyCheckpointContext",
    "DummyDistributedContext",
    "DummyTrainContext",
    "MetricsContext",
    "PreemptContext",
    "ProfilerContext",
    "_dummy_init",
    "build_manifest",
    "file_stats",
    "merge_metadata",
    "merge_resources",
    "verify_manifest",
]
