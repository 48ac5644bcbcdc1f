"""Experiment orchestration of the port: the local searcher-driven runner
and its crash-recovery journal (``determined_tpu/experiment`` without the
cluster runner and the gang scheduler)."""

from determined_tpu_torch.experiment.journal import (
    ExperimentJournal,
    ExperimentJournalError,
    JournaledSearcher,
    experiment_status,
    journal_path,
    read_journal,
)
from determined_tpu_torch.experiment.local import (
    PREEMPTED_EXIT_CODE,
    LocalExperiment,
    TrialResult,
)

__all__ = [
    "ExperimentJournal",
    "ExperimentJournalError",
    "JournaledSearcher",
    "LocalExperiment",
    "PREEMPTED_EXIT_CODE",
    "TrialResult",
    "experiment_status",
    "journal_path",
    "read_journal",
]
