"""Experiment orchestration of the port: the local searcher-driven runner,
the cluster driver that submits the searcher's trials to the master, their
crash-recovery journal, the concurrent trial scheduler, the gang launch of
a trial on several devices and the model-registry client
(``determined_tpu/experiment``)."""

from determined_tpu_torch.experiment._gang import Gang, TrialNotImportableError
from determined_tpu_torch.experiment.cluster import (
    ClusterExperiment,
    MasterUnreachableError,
    run_cluster_experiment,
)
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
    "ClusterExperiment",
    "MasterUnreachableError",
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
    "run_cluster_experiment",
]
