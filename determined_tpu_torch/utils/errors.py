"""Exception hierarchy and failure taxonomy: a copy of
``determined_tpu/utils/errors.py`` (the port imports nothing of the JAX
package).

The taxonomy drives the supervised-restart layer (``train/_restart.py``):
every trial failure is classified as PREEMPTED (exit cleanly, the scheduler
re-places the allocation), TRANSIENT (restart from the latest good
checkpoint, counted against ``max_restarts``), or FATAL (no restart will
help).
"""

from __future__ import annotations

import enum


class DeterminedTPUError(Exception):
    """Base class for all determined_tpu_torch errors."""


class InvalidConfigError(DeterminedTPUError):
    """An experiment / cluster config failed validation."""


class CheckpointNotFoundError(DeterminedTPUError):
    """Requested checkpoint does not exist in storage."""


class PreemptedError(DeterminedTPUError):
    """Raised inside a trial when preemption was requested and the
    training loop chose to unwind via exception."""


class ShardMergeConflictError(DeterminedTPUError):
    """Two ranks uploaded conflicting files/metadata for one sharded
    checkpoint (analog of the reference's md5 conflict detection in
    ``core/_checkpoint.py`` merge_resources/merge_metadata)."""


class StoppedError(DeterminedTPUError):
    """The searcher / master requested this trial stop early."""


class TransientError(DeterminedTPUError):
    """A failure that a restart from checkpoint is expected to cure
    (network partition, lost gang peer, storage hiccup, injected crash)."""


class FatalTrialError(DeterminedTPUError):
    """A failure no restart will cure (bad config, deterministic user-code
    bug, exhausted restart budget)."""


class RestartBudgetExhaustedError(FatalTrialError):
    """``max_restarts`` transient failures in a row: the supervisor gives
    up and the trial goes terminal (reference: restarts column on the
    trial record; the master stops re-launching past the budget)."""


class PeerLostError(TransientError):
    """A control-plane gang peer stopped responding inside the collective
    deadline.  Raised by ``core/_distributed.py`` instead of hanging the
    gang; classified transient — a supervised restart re-forms the gang."""


class CheckpointCorruptError(DeterminedTPUError):
    """A checkpoint failed manifest verification (missing manifest,
    truncated or bit-flipped file).  Deterministic, so FATAL for retry
    purposes — the resume path falls back to an older checkpoint instead
    (``Trainer._restore_checkpoint``)."""


class FailureKind(enum.Enum):
    """Supervisor-facing classification of a trial failure."""

    PREEMPTED = "preempted"
    TRANSIENT = "transient"
    FATAL = "fatal"


# Deterministic Python "bug" exceptions: re-running the same user code on
# the same checkpoint hits them again, so restarting only burns budget.
_FATAL_BUILTINS = (
    TypeError,
    AttributeError,
    NameError,
    ImportError,
    SyntaxError,
    ZeroDivisionError,
    AssertionError,
    NotImplementedError,
)


def classify_failure(exc: BaseException) -> FailureKind:
    """Map an exception from a trial attempt onto the restart taxonomy.

    Ordering matters: explicit taxonomy classes first, then the
    deterministic-bug builtins, then the reference's default of "any other
    failure is restartable" (``master/internal/trial.go`` restarts every
    non-cancel exit up to max_restarts).
    """
    if isinstance(exc, PreemptedError):
        return FailureKind.PREEMPTED
    if isinstance(exc, TransientError):
        return FailureKind.TRANSIENT
    if isinstance(
        exc,
        (
            FatalTrialError,
            InvalidConfigError,
            CheckpointCorruptError,
            ShardMergeConflictError,
            StoppedError,
        ),
    ):
        return FailureKind.FATAL
    # config parse errors raised as InvalidExperimentConfig (a ValueError
    # subclass defined in config/experiment.py; imported lazily to avoid a
    # utils -> config dependency cycle)
    if type(exc).__name__ == "InvalidExperimentConfig":
        return FailureKind.FATAL
    if isinstance(exc, _FATAL_BUILTINS):
        return FailureKind.FATAL
    return FailureKind.TRANSIENT
