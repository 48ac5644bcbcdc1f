"""Hyperparameter search of the port: single/random/grid/ASHA/adaptive-ASHA/
Hyperband/PBT + a trial-free simulation harness (searcher/simulate.py), with
the public names of ``determined_tpu/searcher``."""

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
from determined_tpu_torch.searcher._searcher import (
    Searcher,
    TrialRecord,
    method_from_config,
    simulate,
)
from determined_tpu_torch.searcher.adaptive import TournamentSearch, make_adaptive_asha
from determined_tpu_torch.searcher.asha import ASHASearch
from determined_tpu_torch.searcher.methods import GridSearch, RandomSearch, SingleSearch
from determined_tpu_torch.searcher._hyperband import Bracket, HyperbandSearch, hyperband_brackets
from determined_tpu_torch.searcher._pbt import PBTSearch, perturb_hparams
from determined_tpu_torch.searcher.simulate import (
    JournalCurveModel,
    SimulationReport,
    SyntheticCurveModel,
    compare_methods,
    format_comparison,
    simulate_method,
)
# importing the simulate SUBMODULE above rebinds the package attribute
# ``simulate`` to the module; the public name stays the legacy function
from determined_tpu_torch.searcher._searcher import simulate  # noqa: E402,F811

__all__ = [
    "Bracket",
    "HyperbandSearch",
    "hyperband_brackets",
    "PBTSearch",
    "perturb_hparams",
    "JournalCurveModel",
    "SimulationReport",
    "SyntheticCurveModel",
    "compare_methods",
    "format_comparison",
    "simulate_method",
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
    "simulate",
    "TournamentSearch",
    "make_adaptive_asha",
    "ASHASearch",
    "GridSearch",
    "RandomSearch",
    "SingleSearch",
]
