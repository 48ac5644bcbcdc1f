"""Hyperparameter search of the port: single, random and grid (the
``determined_tpu/searcher`` methods; ASHA, adaptive ASHA, Hyperband, PBT and
the simulation harness come with a later slice)."""

from determined_tpu_torch.searcher._base import (
    Action,
    Create,
    ExitedReason,
    RequestID,
    SearcherContext,
    SearchMethod,
    Shutdown,
    Stop,
)
from determined_tpu_torch.searcher._searcher import Searcher, TrialRecord, method_from_config
from determined_tpu_torch.searcher.methods import GridSearch, RandomSearch, SingleSearch

__all__ = [
    "Action",
    "Create",
    "ExitedReason",
    "RequestID",
    "SearcherContext",
    "SearchMethod",
    "Shutdown",
    "Stop",
    "Searcher",
    "TrialRecord",
    "method_from_config",
    "GridSearch",
    "RandomSearch",
    "SingleSearch",
]
