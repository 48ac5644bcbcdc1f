"""Hyperband (Li et al., 2018): the full successive-halving bracket schedule.

Canonical bracket math over a per-trial budget ``R`` (``max_time``) and an
elimination rate ``eta`` (``divisor``): with ``s_max = floor(log_eta R)``,
brackets ``s = s_max .. 0`` each run successive halving starting from

    n_s = ceil((s_max + 1) / (s + 1) * eta**s)   configs
    r_s = R / eta**s                             initial resource

so every bracket spends roughly the same total budget while trading off
"many configs, early stopping" (s = s_max) against "few configs, full
budget" (s = 0).

Execution maps each bracket onto the rung machinery ASHA already uses
(``asha.ASHASearch`` with ``num_rungs = s + 1`` produces exactly the
``r_s * eta**i`` rung schedule), promoted/stopped through the same event
vocabulary: a trial that ranks in the top ``1/eta`` of its rung continues
(is promoted to train toward the next rung), the rest receive ``Stop``.
Rung decisions are made as metrics arrive rather than at a synchronous
barrier — the *asynchronous* Hyperband formulation the ASHA paper
motivates, which never parks a trial waiting for rung stragglers.

Events route through ``TournamentSearch``, so snapshot/restore and journal
replay reuse the bracket-tested adaptive-ASHA paths.

Port of ``determined_tpu/searcher/_hyperband.py`` (a copy: the same actions,
progress and state JSON for the same events).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from determined_tpu_torch.searcher.adaptive import TournamentSearch
from determined_tpu_torch.searcher.asha import ASHASearch


@dataclasses.dataclass(frozen=True)
class Bracket:
    """One Hyperband bracket, as the canonical schedule defines it."""

    s: int                 # aggressiveness: rungs below the top one
    n_trials: int          # configs the bracket starts with
    min_resource: int      # units a trial trains before its first rung
    num_rungs: int         # s + 1

    def rung_schedule(self, max_time: int, eta: float) -> List[int]:
        return [
            max(int(max_time / eta ** (self.num_rungs - i - 1)), 1)
            for i in range(self.num_rungs)
        ]


def hyperband_brackets(max_time: int, divisor: float) -> List[Bracket]:
    """The canonical (s, n_s, r_s) schedule, most aggressive bracket first."""
    if max_time < 1:
        raise ValueError("hyperband needs max_time >= 1")
    if divisor <= 1:
        raise ValueError("hyperband needs divisor > 1")
    # epsilon before truncating: log(1000)/log(10) is 2.9999999999999996
    # in floats, and losing the most aggressive bracket silently breaks
    # the published schedule for every R that is an exact power of eta
    s_max = int(math.log(max_time) / math.log(divisor) + 1e-9)
    out = []
    for s in range(s_max, -1, -1):
        n = math.ceil((s_max + 1) / (s + 1) * divisor ** s)
        out.append(
            Bracket(
                s=s,
                n_trials=int(n),
                min_resource=max(int(max_time / divisor ** s), 1),
                num_rungs=s + 1,
            )
        )
    return out


class HyperbandSearch(TournamentSearch):
    """All Hyperband brackets run concurrently as a tournament.

    ``max_trials`` (when > 1) caps the canonical schedule: brackets are
    trimmed from the least-aggressive end, the same policy adaptive ASHA's
    budget split uses.  ``max_trials <= 1`` (the config default) means "run
    the canonical schedule as published".
    """

    def __init__(
        self,
        *,
        metric: str,
        smaller_is_better: bool = True,
        max_time: int,
        time_metric: str = "batches",
        divisor: float = 3.0,
        max_trials: int = 0,
        max_concurrent_trials: int = 0,
    ) -> None:
        self.metric = metric
        self.max_time = max_time
        self.divisor = divisor
        brackets = hyperband_brackets(max_time, divisor)
        if max_trials > 1:
            budget = max_trials
            trimmed = []
            for b in brackets:
                take = min(b.n_trials, budget)
                budget -= take
                if take > 0:
                    trimmed.append(dataclasses.replace(b, n_trials=take))
            brackets = trimmed
        self.brackets = brackets
        subs = [
            ASHASearch(
                metric=metric,
                smaller_is_better=smaller_is_better,
                max_time=max_time,
                time_metric=time_metric,
                num_rungs=b.num_rungs,
                divisor=divisor,
                max_trials=b.n_trials,
                # the whole bracket is created up front (the canonical
                # schedule's n_s); actual parallelism is still capped by
                # the experiment's device-derived concurrency
                max_concurrent_trials=(
                    min(max_concurrent_trials, b.n_trials)
                    if max_concurrent_trials > 0
                    else b.n_trials
                ),
            )
            for b in brackets
        ]
        super().__init__(subs)

    def describe(self) -> List[Dict[str, Any]]:
        """Bracket table for reports (`dtpu searcher simulate`, docs)."""
        return [
            {
                "s": b.s,
                "trials": b.n_trials,
                "min_resource": b.min_resource,
                "rungs": b.rung_schedule(self.max_time, self.divisor),
            }
            for b in self.brackets
        ]

    def bracket_of(self, request_id: int) -> Optional[int]:
        """Bracket ``s`` owning a trial (None before its create lands)."""
        i = self.owner.get(request_id)
        return self.brackets[i].s if i is not None else None
