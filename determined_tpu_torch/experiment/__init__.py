"""Experiment orchestration of the port: the local searcher-driven runner,
its crash-recovery journal, the concurrent trial scheduler and the gang
launch of a trial on several devices (``determined_tpu/experiment``
without the cluster runner)."""

from determined_tpu_torch.experiment._gang import Gang, TrialNotImportableError
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
from determined_tpu_torch.experiment.scheduler import (
    SchedulerOutcome,
    SlotAllocation,
    SlotPool,
    TrialScheduler,
)

__all__ = [
    "ExperimentJournal",
    "ExperimentJournalError",
    "Gang",
    "JournaledSearcher",
    "LocalExperiment",
    "PREEMPTED_EXIT_CODE",
    "SchedulerOutcome",
    "SlotAllocation",
    "SlotPool",
    "TrialNotImportableError",
    "TrialResult",
    "TrialScheduler",
    "experiment_status",
    "journal_path",
    "read_journal",
]
