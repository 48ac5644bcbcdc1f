"""Experiment orchestration of the port: the local searcher-driven runner,
the cluster driver that submits the searcher's trials to the master, their
crash-recovery journal, the concurrent trial scheduler, the gang launch of
a trial on several devices and the model-registry client
(``determined_tpu/experiment``).  Each name is imported from its module
when first read."""

import importlib
from typing import Any

#: each public name and the submodule that defines it: imported when first
#: read, so that ``experiment.registry`` (the CLI's master verbs, the SDK)
#: loads no torch
_EXPORTS = {
    "Gang": "_gang",
    "TrialNotImportableError": "_gang",
    "ClusterExperiment": "cluster",
    "MasterUnreachableError": "cluster",
    "run_cluster_experiment": "cluster",
    "ExperimentJournal": "journal",
    "ExperimentJournalError": "journal",
    "JournaledSearcher": "journal",
    "experiment_status": "journal",
    "journal_path": "journal",
    "read_journal": "journal",
    "PREEMPTED_EXIT_CODE": "local",
    "LocalExperiment": "local",
    "TrialResult": "local",
    "SchedulerOutcome": "scheduler",
    "SlotAllocation": "scheduler",
    "SlotPool": "scheduler",
    "TrialScheduler": "scheduler",
}


def __getattr__(name: str) -> Any:
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(_EXPORTS))


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
