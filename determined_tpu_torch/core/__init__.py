"""Core services of the port: only the off-cluster ``_dummy_init`` the
Trainer uses (the names follow ``determined_tpu/core/_context.py``)."""

from determined_tpu_torch.core._context import (
    Context,
    DummyDistributedContext,
    DummyPreemptContext,
    DummyProfilerContext,
    DummyTrainContext,
    _dummy_init,
)

__all__ = [
    "Context",
    "DummyDistributedContext",
    "DummyPreemptContext",
    "DummyProfilerContext",
    "DummyTrainContext",
    "_dummy_init",
]
