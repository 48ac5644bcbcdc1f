"""Population-based training (Jaderberg et al., 2017).

A fixed-size population trains in generations.  Every member runs for one
generation budget (``searcher.max_length`` — the same per-trial budget every
other method uses) and exits; when the whole generation has exited the
method ranks members by their last reported metric and turns the population
over:

- **exploit**: the bottom ``truncate_fraction`` of the population is
  replaced by children cloned from uniformly-drawn top-``truncate_fraction``
  survivors.  The method only *names* the parent trial
  (``Create.source_trial_id``); resolving which checkpoint uuid that means
  — newest usable in the parent's manifest lineage — and materializing it
  into the child's namespace is the experiment runner's job (``experiment/local.py``),
  the same verified-parent machinery crash-resumes already use.
- **explore**: each exploited child's hyperparameters are perturbed —
  numeric hps multiply by ``perturb_factor`` or its inverse (clamped to the
  declared range), any hp resamples outright with
  ``resample_probability`` — all drawn from the journaled SearcherContext
  rng, so a replayed search perturbs identically.
- survivors continue as fresh trials cloned from their OWN latest
  checkpoint with unchanged hyperparameters (the reference PBT's
  "ready -> next interval" step, expressed in the create/stop event
  vocabulary the rest of the searcher zoo uses).

Trials that error out (or report no usable metric) rank worst: they are
never exploit parents and are always replaced.

Port of ``determined_tpu/searcher/_pbt.py`` (a copy: the same actions,
progress and state JSON for the same events).  The port's steps are eager,
so a perturbed hyperparameter costs no recompilation; a restored child
trains with its own hyperparameters because the port's optimizers keep the
learning rate in the schedule the trial builds from them, never in the
checkpointed state (``train/_trainer.py``, ``_reinject_runtime_hparams``).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional

from determined_tpu_torch.config.hyperparameters import (
    Categorical,
    Const,
    Double,
    Int,
    Log,
    _set_nested,
    _walk,
)
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.searcher._base import (
    Action,
    RequestID,
    SearcherContext,
    SearchMethod,
    Shutdown,
)

logger = logging.getLogger(__name__)


def _get_nested(d: Dict[str, Any], path) -> Any:
    for k in path:
        d = d[k]
    return d


def perturb_hparams(
    space: Dict[str, Any],
    hparams: Dict[str, Any],
    rand,
    *,
    perturb_factor: float = 1.2,
    resample_probability: float = 0.25,
) -> Dict[str, Any]:
    """One PBT explore step over a concrete hparam dict.

    Numeric hps (int/double/log) multiply by ``perturb_factor`` or its
    inverse (fair coin) and clamp to the declared range; categorical/const
    hps can only change by resampling.  Every hp independently resamples
    outright with ``resample_probability``.  All draws come from ``rand``
    (the SearcherContext rng), which keeps explore deterministic under
    journal replay.
    """
    out: Dict[str, Any] = {}
    for path, hp in _walk(space):
        try:
            val = _get_nested(hparams, path)
        except (KeyError, TypeError):
            val = hp.sample(rand)
        if rand.random() < resample_probability:
            val = hp.sample(rand)
        elif isinstance(hp, (Int, Double, Log)):
            factor = perturb_factor if rand.random() < 0.5 else 1.0 / perturb_factor
            new = float(val) * factor
            if isinstance(hp, Log):
                lo, hi = hp.base ** hp.minval, hp.base ** hp.maxval
                val = min(max(new, lo), hi)
            elif isinstance(hp, Int):
                val = int(round(min(max(new, hp.minval), hp.maxval)))
            else:
                val = min(max(new, hp.minval), hp.maxval)
        elif isinstance(hp, (Categorical, Const)):
            pass  # keep; only the resample branch changes these
        _set_nested(out, path, val)
    return out


class PBTSearch(SearchMethod):
    """Generation-synchronous population-based training."""

    def __init__(
        self,
        *,
        metric: str,
        smaller_is_better: bool = True,
        population_size: int = 8,
        num_generations: int = 4,
        truncate_fraction: float = 0.25,
        perturb_factor: float = 1.2,
        resample_probability: float = 0.25,
        time_metric: str = "batches",
    ) -> None:
        if population_size < 1:
            raise ValueError("pbt population_size must be >= 1")
        if num_generations < 1:
            raise ValueError("pbt num_generations must be >= 1")
        if not 0.0 <= truncate_fraction <= 0.5:
            raise ValueError("pbt truncate_fraction must be in [0, 0.5]")
        if perturb_factor <= 1.0:
            raise ValueError("pbt perturb_factor must be > 1")
        self.metric = metric
        self.smaller_is_better = smaller_is_better
        self.population_size = population_size
        self.num_generations = num_generations
        self.truncate_fraction = truncate_fraction
        self.perturb_factor = perturb_factor
        self.resample_probability = resample_probability
        self.time_metric = time_metric
        # slot-ordered members of the CURRENT generation
        self.generation = 0
        self.members: List[Dict[str, Any]] = []  # {rid, metric, exited}
        self.prev_rids: List[RequestID] = []     # last generation (clone srcs)
        self.hparams: Dict[RequestID, Dict[str, Any]] = {}
        self.lineage: Dict[RequestID, Optional[RequestID]] = {}
        self.trials_completed = 0

    # -- events ------------------------------------------------------------

    def initial_trials(self, ctx: SearcherContext) -> List[Action]:
        actions: List[Action] = []
        for _ in range(self.population_size):
            a = ctx.create()
            self.hparams[a.request_id] = a.hparams
            self.lineage[a.request_id] = None
            self.members.append({"rid": a.request_id, "metric": None, "exited": False})
            actions.append(a)
        return actions

    def _member(self, request_id: RequestID) -> Optional[Dict[str, Any]]:
        for m in self.members:
            if m["rid"] == request_id:
                return m
        return None

    def validation_completed(self, ctx, request_id, metrics) -> List[Action]:
        m = self._member(request_id)
        if m is None or m["exited"]:
            return []
        value = metrics.get(self.metric)
        # NaN/inf must rank WORST, not sort-first: a diverged member that
        # reported nan would otherwise become everyone's exploit parent
        if isinstance(value, (int, float)) and math.isfinite(value):
            m["metric"] = float(value)  # last report wins: end-of-generation fitness
        else:
            # and it INVALIDATES earlier finite reports: the member's
            # latest state is what a clone would inherit
            m["metric"] = None
            logger.warning(
                "pbt: trial %s reported no usable %r (%r); it will rank worst",
                request_id, self.metric, value,
            )
        return []

    def trial_exited(self, ctx, request_id) -> List[Action]:
        m = self._member(request_id)
        if m is None or m["exited"]:
            return []
        m["exited"] = True
        self.trials_completed += 1
        if not all(mm["exited"] for mm in self.members):
            return []
        return self._turnover(ctx)

    def trial_exited_early(self, ctx, request_id, reason: str) -> List[Action]:
        # an errored/invalid member ranks worst (metric None) and is always
        # replaced at turnover; the generation must not deadlock on it
        m = self._member(request_id)
        if m is None or m["exited"]:
            return []
        m["metric"] = None
        return self.trial_exited(ctx, request_id)

    # -- the generation boundary -------------------------------------------

    def _rank(self) -> List[Dict[str, Any]]:
        """Members best-first; metric-less members always rank last."""
        sign = 1.0 if self.smaller_is_better else -1.0
        return sorted(
            self.members,
            key=lambda m: (m["metric"] is None,
                           sign * (m["metric"] if m["metric"] is not None else 0.0)),
        )

    def _turnover(self, ctx: SearcherContext) -> List[Action]:
        if self.generation + 1 >= self.num_generations:
            return [Shutdown()]
        ranked = self._rank()
        n = self.population_size
        # truncate_fraction == 0 means pure continuation (no exploitation);
        # any positive fraction replaces at least one member
        if n < 2 or self.truncate_fraction == 0.0:
            k = 0
        else:
            k = max(1, int(n * self.truncate_fraction))
        # exploit parents must have REPORTED the searcher metric: cloning a
        # crashed/silent member would seed children from a config with no
        # usable fitness (and possibly no checkpoint)
        reporting = [m for m in ranked if m["metric"] is not None]
        top = reporting[: max(k, 1)] if reporting else []
        bottom = ranked[n - k:] if k else []
        replaced = {m["rid"] for m in bottom}
        actions: List[Action] = []
        next_members: List[Dict[str, Any]] = []
        clones = 0
        for m in self.members:
            rid = m["rid"]
            if rid in replaced and top:
                # exploit: clone a uniformly-drawn top survivor, explore its hps
                parent = top[int(ctx.rand.integers(0, len(top)))]["rid"]
                child_hp = perturb_hparams(
                    ctx.hparams,
                    self.hparams.get(parent, {}),
                    ctx.rand,
                    perturb_factor=self.perturb_factor,
                    resample_probability=self.resample_probability,
                )
                a = ctx.create(child_hp, source_trial_id=parent)
                clones += 1
            elif rid in replaced:
                # nobody reported a metric this generation: nothing worth
                # exploiting — replace with a fresh independent sample
                a = ctx.create()
            else:
                # survivor: continue from its own checkpoint, hps unchanged
                a = ctx.create(dict(self.hparams.get(rid, {})), source_trial_id=rid)
            self.hparams[a.request_id] = a.hparams
            self.lineage[a.request_id] = a.source_trial_id
            next_members.append({"rid": a.request_id, "metric": None, "exited": False})
            actions.append(a)
        self.prev_rids = [m["rid"] for m in self.members]
        self.members = next_members
        self.generation += 1
        best = ranked[0]
        get_tracer().instant(
            "searcher.pbt.generation",
            cat="searcher",
            generation=self.generation,
            best_trial=best["rid"],
            best_metric=best["metric"],
            exploited=len(replaced),
        )
        get_tracer().counter("searcher.pbt.clones", float(clones))
        logger.info(
            "pbt: generation %d -> %d: best trial %d (%s=%s), %d of %d exploited",
            self.generation - 1, self.generation, best["rid"], self.metric,
            best["metric"], len(replaced), n,
        )
        return actions

    # -- bookkeeping -------------------------------------------------------

    def clone_source_trials(self) -> List[RequestID]:
        # every current member is a candidate exploit parent until the NEXT
        # turnover, and the previous generation stays referenced until its
        # children have materialized their clones and checkpointed
        return sorted({m["rid"] for m in self.members} | set(self.prev_rids))

    def progress(self, trial_progress, trials_closed) -> float:
        total = self.population_size * self.num_generations
        done = self.trials_completed + sum(
            trial_progress.get(m["rid"], 0.0)
            for m in self.members
            if not m["exited"]
        )
        return min(done / total, 1.0)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "generation": self.generation,
            "members": [dict(m) for m in self.members],
            "prev_rids": list(self.prev_rids),
            "hparams": {str(r): hp for r, hp in self.hparams.items()},
            "lineage": {str(r): p for r, p in self.lineage.items()},
            "trials_completed": self.trials_completed,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.generation = int(state["generation"])
        self.members = [dict(m) for m in state["members"]]
        self.prev_rids = [int(r) for r in state.get("prev_rids", [])]
        self.hparams = {int(r): hp for r, hp in state["hparams"].items()}
        self.lineage = {
            int(r): (None if p is None else int(p))
            for r, p in state["lineage"].items()
        }
        self.trials_completed = int(state["trials_completed"])
