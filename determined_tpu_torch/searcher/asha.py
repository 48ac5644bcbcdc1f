"""ASHA early-stopping search.

Reference: ``master/pkg/searcher/asha_stopping.go:21-291``.  Asynchronous
successive halving in its *stopping* formulation: every reported validation
metric is ranked within its rung; runs outside the top 1/divisor are
stopped, survivors continue toward the next rung.  Rung r needs
``max_time / divisor**(num_rungs-r-1)`` time units.

Port of ``determined_tpu/searcher/asha.py`` (a copy: the same actions,
progress and state JSON for the same events).
"""

from __future__ import annotations

import bisect
import logging
import math
from typing import Any, Dict, List, Optional

from determined_tpu_torch.searcher._base import (
    Action,
    RequestID,
    SearcherContext,
    SearchMethod,
    Shutdown,
    Stop,
    ExitedReason,
)

logger = logging.getLogger(__name__)

ASHA_EXITED_METRIC = math.inf


class _Rung:
    def __init__(self, units_needed: int) -> None:
        self.units_needed = units_needed
        self.metrics: List[tuple] = []  # sorted [(metric, request_id)]

    def insert(self, request_id: RequestID, metric: float) -> int:
        idx = bisect.bisect_left([m for m, _ in self.metrics], metric)
        self.metrics.insert(idx, (metric, request_id))
        return idx

    def remove(self, request_id: RequestID) -> None:
        self.metrics = [(m, r) for m, r in self.metrics if r != request_id]


def make_rungs(num_rungs: int, divisor: float, max_units: int) -> List[_Rung]:
    return [
        _Rung(max(int(max_units / divisor ** (num_rungs - i - 1)), 1))
        for i in range(num_rungs)
    ]


class ASHASearch(SearchMethod):
    """Async-halving stopping search (one bracket)."""

    def __init__(
        self,
        *,
        metric: str,
        smaller_is_better: bool = True,
        max_time: int,
        time_metric: str = "batches",
        num_rungs: int = 5,
        divisor: float = 4.0,
        max_trials: int = 16,
        max_concurrent_trials: int = 0,
    ) -> None:
        self.metric = metric
        self.smaller_is_better = smaller_is_better
        self.time_metric = time_metric
        self.num_rungs = num_rungs
        self.divisor = divisor
        self.max_trials = max_trials
        self.max_concurrent_trials = max_concurrent_trials
        self.rungs = make_rungs(num_rungs, divisor, max_time)
        self.trial_rungs: Dict[RequestID, int] = {}
        self.early_exit_trials: Dict[RequestID, bool] = {}
        self.stopped_trials: set = set()
        self.trials_completed = 0
        self.invalid_trials = 0

    # -- events ------------------------------------------------------------

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        if self.max_concurrent_trials > 0:
            n = min(self.max_concurrent_trials, self.max_trials)
        else:
            # enough parallelism that at least one run reaches the top rung
            n = max(1, min(int(self.divisor ** (self.num_rungs - 1)), self.max_trials))
        return [ctx.create() for _ in range(n)]

    def trial_created(self, ctx, request_id) -> List[Action]:
        self.trial_rungs[request_id] = 0
        return []

    def trial_exited(self, ctx, request_id) -> List[Action]:
        self.trials_completed += 1
        return []

    def _get_metric(self, metrics: Dict[str, Any]):
        value = metrics.get(self.metric)
        if not isinstance(value, (int, float)):
            raise ValueError(f"searcher metric {self.metric!r} missing from {metrics}")
        if not self.smaller_is_better:
            value = -value
        step = metrics.get(self.time_metric)
        if not isinstance(step, (int, float)):
            raise ValueError(
                f"searcher time metric {self.time_metric!r} missing from {metrics}"
            )
        return int(step), float(value)

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        if request_id in self.stopped_trials:
            # a stopped trial may report one or two more validations before
            # teardown; re-inserting would duplicate rung entries and burn
            # the trial budget on spurious replacement creates
            return []
        try:
            time_step, value = self._get_metric(metrics)
        except ValueError as e:
            # A malformed report (missing searcher/time metric) must not
            # abort the whole search; ignore it and let the trial keep
            # running — matching the reference's graceful degradation.
            logger.warning("ignoring unusable validation report for trial %s: %s",
                           request_id, e)
            return []
        actions = self._do_early_stopping(request_id, time_step, value)
        if any(isinstance(a, Stop) for a in actions):
            self.stopped_trials.add(request_id)
        all_trials = len(self.trial_rungs) - self.invalid_trials
        if actions and all_trials < self.max_trials:
            actions.append(ctx.create())
        return actions

    def _do_early_stopping(
        self, request_id: RequestID, time_step: int, metric: float
    ) -> List[Action]:
        actions: List[Action] = []
        for r in range(self.trial_rungs[request_id], self.num_rungs):
            rung = self.rungs[r]
            self.trial_rungs[request_id] = r
            if time_step < rung.units_needed:
                return actions
            insert_index = rung.insert(request_id, metric)
            if r == self.num_rungs - 1:
                actions.append(Stop(request_id))
                return actions
            # top 1/divisor continue; with < divisor entries only the best
            num_continue = max(int(len(rung.metrics) / self.divisor), 1)
            if insert_index >= num_continue:
                actions.append(Stop(request_id))
                return actions
        return actions

    def trial_exited_early(self, ctx, request_id, reason: str) -> List[Action]:
        if reason in (ExitedReason.INVALID_HP, ExitedReason.INIT_INVALID_HP):
            self.early_exit_trials[request_id] = True
            self.invalid_trials += 1
            for r in range(self.trial_rungs.get(request_id, 0) + 1):
                self.rungs[r].remove(request_id)
            return [Stop(request_id), ctx.create()]
        self.early_exit_trials[request_id] = True
        rung = self.rungs[self.trial_rungs.get(request_id, 0)]
        rung.insert(request_id, ASHA_EXITED_METRIC)
        actions: List[Action] = []
        if len(self.trial_rungs) - self.invalid_trials < self.max_trials:
            actions.append(ctx.create())
        return actions

    def progress(self, trial_progress, trials_closed) -> float:
        all_trials = len(self.rungs[0].metrics)
        # 20% overhead allowance while trials are still being created
        progress = all_trials / (1.2 * self.max_trials)
        if all_trials == self.max_trials:
            valid = self.trials_completed - self.invalid_trials
            progress = max(valid / self.max_trials, progress)
        return min(progress, 1.0)

    # -- snapshot ----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "rungs": [
                {"units_needed": r.units_needed, "metrics": list(r.metrics)}
                for r in self.rungs
            ],
            "trial_rungs": dict(self.trial_rungs),
            "early_exit_trials": dict(self.early_exit_trials),
            "trials_completed": self.trials_completed,
            "invalid_trials": self.invalid_trials,
            "stopped_trials": sorted(self.stopped_trials),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.rungs = []
        for r in state["rungs"]:
            rung = _Rung(r["units_needed"])
            rung.metrics = [tuple(m) for m in r["metrics"]]
            self.rungs.append(rung)
        self.trial_rungs = {int(k): v for k, v in state["trial_rungs"].items()}
        self.early_exit_trials = {
            int(k): v for k, v in state["early_exit_trials"].items()
        }
        self.trials_completed = state["trials_completed"]
        self.invalid_trials = state["invalid_trials"]
        self.stopped_trials = set(state.get("stopped_trials", []))
