"""Adaptive ASHA: bracket allocation + tournament of ASHA sub-searches.

Reference: ``master/pkg/searcher/adaptive_asha.go:84-154`` (brackets, modes
conservative/standard/aggressive, budget-weighted trial allocation) and
``tournament.go:25`` (event routing to the owning sub-search).

Port of ``determined_tpu/searcher/adaptive.py`` (a copy: the same actions,
progress and state JSON for the same events).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from determined_tpu_torch.searcher._base import (
    Action,
    Create,
    RequestID,
    SearcherContext,
    SearchMethod,
    Shutdown,
)
from determined_tpu_torch.searcher.asha import ASHASearch


def bracket_rungs_for_mode(mode: str, max_rungs: int) -> List[int]:
    if mode == "conservative":
        return list(range(1, max_rungs + 1))
    if mode == "standard":
        return list(range((max_rungs - 1) // 2 + 1, max_rungs + 1))
    if mode == "aggressive":
        return [max_rungs]
    raise ValueError(f"unknown adaptive mode {mode!r}")


def bracket_max_trials(max_trials: int, divisor: float, brackets: List[int]) -> List[int]:
    """Budget-weighted split: each bracket gets trials inversely proportional
    to its per-trial cost so total step budget is roughly equal."""
    weights = [divisor ** (n - 1) / n for n in brackets]
    total = sum(weights)
    out = [max(int(w / total * max_trials), 1) for w in weights]
    out[0] += max(max_trials - sum(out), 0)
    # the per-bracket minimum of 1 can overshoot when max_trials < #brackets:
    # trim from the least-aggressive (last) brackets down to the cap
    excess = sum(out) - max_trials
    for i in range(len(out) - 1, 0, -1):
        if excess <= 0:
            break
        take = min(excess, out[i])
        out[i] -= take
        excess -= take
    return out


def bracket_max_concurrent(
    max_concurrent_trials: int, divisor: float, max_trials: List[int]
) -> List[int]:
    n = len(max_trials)
    if max_concurrent_trials == 0:
        base = max(max_trials[-1], int(divisor))
        return [base] * n
    max_concurrent_trials = max(max_concurrent_trials, n)
    base, rem = divmod(max_concurrent_trials, n)
    out = [base] * n
    for i in range(rem):
        out[i] += 1
    return out


class TournamentSearch(SearchMethod):
    """Routes each trial's events to the sub-search that created it."""

    def __init__(self, subs: List[SearchMethod]) -> None:
        self.subs = subs
        self.owner: Dict[RequestID, int] = {}
        self.closed = [False] * len(subs)

    def _mark(self, sub_id: int, actions: List[Action]) -> List[Action]:
        out: List[Action] = []
        for a in actions:
            if isinstance(a, Create):
                self.owner[a.request_id] = sub_id
                out.append(a)
            elif isinstance(a, Shutdown):
                self.closed[sub_id] = True
                if all(self.closed):
                    out.append(a)
            else:
                out.append(a)
        return out

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        out: List[Action] = []
        for i, sub in enumerate(self.subs):
            out.extend(self._mark(i, sub.initial_trials(ctx)))
        return out

    def trial_created(self, ctx, request_id) -> List[Action]:
        i = self.owner[request_id]
        return self._mark(i, self.subs[i].trial_created(ctx, request_id))

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        i = self.owner[request_id]
        return self._mark(i, self.subs[i].validation_completed(ctx, request_id, metrics))

    def trial_exited(self, ctx, request_id) -> List[Action]:
        i = self.owner[request_id]
        return self._mark(i, self.subs[i].trial_exited(ctx, request_id))

    def trial_exited_early(self, ctx, request_id, reason) -> List[Action]:
        i = self.owner[request_id]
        return self._mark(i, self.subs[i].trial_exited_early(ctx, request_id, reason))

    def progress(self, trial_progress, trials_closed) -> float:
        per_sub_progress: List[Dict[RequestID, float]] = [
            {} for _ in self.subs
        ]
        per_sub_closed: List[Dict[RequestID, bool]] = [{} for _ in self.subs]
        for rid, p in trial_progress.items():
            if rid in self.owner:
                per_sub_progress[self.owner[rid]][rid] = p
        for rid, c in trials_closed.items():
            if rid in self.owner:
                per_sub_closed[self.owner[rid]][rid] = c
        if not self.subs:
            return 1.0
        return sum(
            s.progress(p, c)
            for s, p, c in zip(self.subs, per_sub_progress, per_sub_closed)
        ) / len(self.subs)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "subs": [s.state_dict() for s in self.subs],
            "owner": dict(self.owner),
            "closed": list(self.closed),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for sub, s in zip(self.subs, state["subs"]):
            sub.load_state_dict(s)
        self.owner = {int(k): v for k, v in state["owner"].items()}
        self.closed = list(state["closed"])


def make_adaptive_asha(
    *,
    metric: str,
    smaller_is_better: bool = True,
    max_time: int,
    time_metric: str = "batches",
    max_trials: int = 16,
    max_rungs: int = 5,
    divisor: float = 4.0,
    mode: str = "standard",
    max_concurrent_trials: int = 0,
    bracket_rungs: Optional[List[int]] = None,
) -> TournamentSearch:
    if not bracket_rungs:
        capped = min(
            max_rungs,
            int(math.log(max(max_time, 2)) / math.log(divisor)) + 1,
            int(math.log(max(max_trials, 2)) / math.log(divisor)) + 1,
        )
        bracket_rungs = bracket_rungs_for_mode(mode, max(capped, 1))
    # most-aggressive (deepest) brackets first
    bracket_rungs = sorted(bracket_rungs, reverse=True)
    trials = bracket_max_trials(max_trials, divisor, bracket_rungs)
    concurrent = bracket_max_concurrent(max_concurrent_trials, divisor, trials)
    subs: List[SearchMethod] = [
        ASHASearch(
            metric=metric,
            smaller_is_better=smaller_is_better,
            max_time=max_time,
            time_metric=time_metric,
            num_rungs=nr,
            divisor=divisor,
            max_trials=nt,
            max_concurrent_trials=nc,
        )
        for nr, nt, nc in zip(bracket_rungs, trials, concurrent)
        if nt > 0  # brackets trimmed to honor a small max_trials cap
    ]
    return TournamentSearch(subs)
