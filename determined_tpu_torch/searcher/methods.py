"""Basic search methods: single, random, grid (a copy of
``determined_tpu/searcher/methods.py``)."""

from __future__ import annotations

from typing import Any, Dict, List

from determined_tpu_torch.config.hyperparameters import grid_points
from determined_tpu_torch.searcher._base import (
    Action,
    SearcherContext,
    SearchMethod,
    Shutdown,
)


class SingleSearch(SearchMethod):
    """One trial with directly-sampled hyperparameters."""

    def __init__(self) -> None:
        self._closed = 0

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        return [ctx.create()]

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        return []

    def trial_exited(self, ctx, request_id) -> List[Action]:
        self._closed += 1
        return [Shutdown()]

    def progress(self, trial_progress, trials_closed) -> float:
        if self._closed:
            return 1.0
        return next(iter(trial_progress.values()), 0.0)

    def state_dict(self):
        return {"closed": self._closed}

    def load_state_dict(self, state):
        self._closed = state["closed"]


class RandomSearch(SearchMethod):
    """max_trials independently-sampled trials."""

    def __init__(self, max_trials: int, max_concurrent_trials: int = 16) -> None:
        self.max_trials = max_trials
        self.max_concurrent = max(1, min(max_concurrent_trials, max_trials))
        self._created = 0
        self._closed = 0

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        n = min(self.max_concurrent, self.max_trials)
        actions = [ctx.create() for _ in range(n)]
        self._created += n
        return actions

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        return []

    def trial_exited(self, ctx, request_id) -> List[Action]:
        self._closed += 1
        if self._created < self.max_trials:
            self._created += 1
            return [ctx.create()]
        if self._closed >= self.max_trials:
            return [Shutdown()]
        return []

    def progress(self, trial_progress, trials_closed) -> float:
        done = self._closed + sum(trial_progress.values())
        return min(1.0, done / self.max_trials)

    def state_dict(self):
        return {"created": self._created, "closed": self._closed}

    def load_state_dict(self, state):
        self._created, self._closed = state["created"], state["closed"]


class GridSearch(SearchMethod):
    """Cartesian expansion of the hp space (reference ``grid.go``)."""

    def __init__(self, hparams: Dict[str, Any], max_concurrent_trials: int = 16) -> None:
        self.points = grid_points(hparams)
        self.max_concurrent = max(1, max_concurrent_trials)
        self._next_point = 0
        self._closed = 0

    def _create_next(self, ctx: SearcherContext) -> List[Action]:
        if self._next_point >= len(self.points):
            return []
        p = self.points[self._next_point]
        self._next_point += 1
        return [ctx.create(p)]

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        out: List[Action] = []
        for _ in range(min(self.max_concurrent, len(self.points))):
            out.extend(self._create_next(ctx))
        return out

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        return []

    def trial_exited(self, ctx, request_id) -> List[Action]:
        self._closed += 1
        actions = self._create_next(ctx)
        if not actions and self._closed >= len(self.points):
            return [Shutdown()]
        return actions

    def progress(self, trial_progress, trials_closed) -> float:
        done = self._closed + sum(trial_progress.values())
        return min(1.0, done / max(len(self.points), 1))

    def state_dict(self):
        return {"next_point": self._next_point, "closed": self._closed}

    def load_state_dict(self, state):
        self._next_point, self._closed = state["next_point"], state["closed"]
