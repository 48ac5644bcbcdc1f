"""Searcher core: events, actions, the SearchMethod interface.

A copy of ``determined_tpu/searcher/_base.py``: the experiment engine
forwards trial lifecycle events and the method returns actions
(Create/Stop/Shutdown).  ``SearcherContext`` draws from
``np.random.default_rng(seed)`` as there, so the same seed creates the same
hyperparameters in both packages.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from determined_tpu_torch.config.hyperparameters import sample_hyperparameters

# stable ids for trials created by the searcher
RequestID = int


@dataclasses.dataclass
class Create:
    request_id: RequestID
    hparams: Dict[str, Any]
    # PBT exploit provenance: clone the new trial's initial state from the
    # named trial's newest usable checkpoint (the driver resolves the uuid
    # through the manifest lineage walk; the searcher only names the trial)
    source_trial_id: Optional[RequestID] = None


@dataclasses.dataclass
class Stop:
    request_id: RequestID


@dataclasses.dataclass
class Shutdown:
    cancel: bool = False
    failure: bool = False


Action = Any  # Create | Stop | Shutdown


class ExitedReason:
    ERRORED = "errored"
    USER_CANCELED = "user_canceled"
    INVALID_HP = "invalid_hp"
    INIT_INVALID_HP = "init_invalid_hp"


class SearcherContext:
    """What a method needs to act: the hp space and a seeded rng."""

    def __init__(self, hparams: Dict[str, Any], seed: int = 0) -> None:
        self.hparams = hparams
        self.rand = np.random.default_rng(seed)
        self._next_id = 1

    def next_request_id(self) -> RequestID:
        rid = self._next_id
        self._next_id += 1
        return rid

    # snapshot/restore: id counter + rng must survive resumes or replacement
    # creates after a restore would reuse live request ids
    def state_dict(self) -> Dict[str, Any]:
        return {"next_id": self._next_id, "rng_state": self.rand.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._next_id = int(state["next_id"])
        self.rand.bit_generator.state = state["rng_state"]

    def sample(self) -> Dict[str, Any]:
        return sample_hyperparameters(self.hparams, self.rand)

    def create(
        self,
        hparams: Optional[Dict[str, Any]] = None,
        source_trial_id: Optional[RequestID] = None,
    ) -> Create:
        return Create(
            self.next_request_id(),
            hparams if hparams is not None else self.sample(),
            source_trial_id,
        )


class SearchMethod(abc.ABC):
    """Event-driven search algorithm (reference ``SearchMethod`` iface)."""

    @abc.abstractmethod
    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        ...

    def trial_created(self, ctx: SearcherContext, request_id: RequestID) -> List[Action]:
        return []

    @abc.abstractmethod
    def validation_completed(
        self, ctx: SearcherContext, request_id: RequestID, metrics: Dict[str, Any]
    ) -> List[Action]:
        ...

    def trial_exited(self, ctx: SearcherContext, request_id: RequestID) -> List[Action]:
        return []

    def trial_exited_early(
        self, ctx: SearcherContext, request_id: RequestID, reason: str
    ) -> List[Action]:
        return []

    @abc.abstractmethod
    def progress(
        self,
        trial_progress: Dict[RequestID, float],
        trials_closed: Dict[RequestID, bool],
    ) -> float:
        ...

    def clone_source_trials(self) -> List[RequestID]:
        """Trials whose checkpoints are LIVE clone sources.

        A method that clones from checkpoints (PBT exploit) names here
        every trial a future ``Create.source_trial_id`` may still point
        at; checkpoint GC must not delete those trials' latest checkpoints
        mid-generation even when top-k-by-metric retention would.
        """
        return []

    # snapshot/restore (reference Snapshot/Restore json round-trip)
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        ...
