"""The searcher: event dispatch, state tracking, simulation harness.

A copy of ``determined_tpu/searcher/_searcher.py``: ``method_from_config``
builds every method (single, grid, random, asha, adaptive_asha, hyperband,
pbt); ``Searcher`` is the stateful wrapper the experiment drives;
``simulate`` is the legacy dry run over a synthetic trial function
(``searcher/simulate.py`` holds the full harness).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional

from determined_tpu_torch.config.experiment import (
    ExperimentConfig,
    InvalidExperimentConfig,
    SearcherConfig,
)
from determined_tpu_torch.searcher._base import (
    Action,
    Create,
    RequestID,
    SearcherContext,
    SearchMethod,
    Shutdown,
    Stop,
)
from determined_tpu_torch.searcher._hyperband import HyperbandSearch
from determined_tpu_torch.searcher._pbt import PBTSearch
from determined_tpu_torch.searcher.adaptive import make_adaptive_asha
from determined_tpu_torch.searcher.asha import ASHASearch
from determined_tpu_torch.searcher.methods import GridSearch, RandomSearch, SingleSearch


def method_from_config(
    cfg: SearcherConfig, hparams: Dict[str, Any]
) -> SearchMethod:
    """Build the SearchMethod an experiment config asks for."""
    max_time = cfg.max_time
    if max_time is None and cfg.max_length is not None:
        max_time = cfg.max_length.units
    if cfg.name == "driver":
        # the master-side stub for cluster-driven searches: the config the
        # master stores has its searcher REWRITTEN to this name; a driver
        # cannot reconstruct the original search method from it
        raise InvalidExperimentConfig(
            "searcher 'driver' is execution-only (the master-side stub for "
            "cluster experiments); run the search with the ORIGINAL config "
            "— the one holding the real method (asha/random/...) — not the "
            "rewritten config fetched from the master"
        )
    if cfg.name == "single":
        return SingleSearch()
    if cfg.name == "random":
        return RandomSearch(cfg.max_trials, cfg.max_concurrent_trials)
    if cfg.name == "grid":
        return GridSearch(hparams, cfg.max_concurrent_trials)
    if cfg.name == "asha":
        return ASHASearch(
            metric=cfg.metric,
            smaller_is_better=cfg.smaller_is_better,
            max_time=max_time or 100,
            time_metric=cfg.time_metric or "batches",
            num_rungs=cfg.num_rungs,
            divisor=cfg.divisor,
            max_trials=cfg.max_trials,
            max_concurrent_trials=cfg.max_concurrent_trials,
        )
    if cfg.name == "hyperband":
        return HyperbandSearch(
            metric=cfg.metric,
            smaller_is_better=cfg.smaller_is_better,
            max_time=max_time or 100,
            time_metric=cfg.time_metric or "batches",
            divisor=cfg.divisor,
            max_trials=cfg.max_trials,
            max_concurrent_trials=cfg.max_concurrent_trials,
        )
    if cfg.name == "pbt":
        return PBTSearch(
            metric=cfg.metric,
            smaller_is_better=cfg.smaller_is_better,
            population_size=cfg.population_size or max(cfg.max_trials, 2),
            num_generations=cfg.num_generations,
            truncate_fraction=cfg.truncate_fraction,
            perturb_factor=cfg.perturb_factor,
            resample_probability=cfg.resample_probability,
            time_metric=cfg.time_metric or "batches",
        )
    if cfg.name == "adaptive_asha":
        return make_adaptive_asha(
            metric=cfg.metric,
            smaller_is_better=cfg.smaller_is_better,
            max_time=max_time or 100,
            time_metric=cfg.time_metric or "batches",
            max_trials=cfg.max_trials,
            max_rungs=cfg.num_rungs,
            divisor=cfg.divisor,
            mode=cfg.mode,
            max_concurrent_trials=cfg.max_concurrent_trials,
            bracket_rungs=cfg.bracket_rungs,
        )
    raise ValueError(f"unknown searcher {cfg.name!r}")


@dataclasses.dataclass
class TrialRecord:
    request_id: RequestID
    hparams: Dict[str, Any]
    running: bool = True
    stopped_by_searcher: bool = False
    exited: bool = False
    metrics: Optional[Dict[str, Any]] = None  # last validation
    # clone provenance (PBT exploit): initial state comes from this trial's
    # newest usable checkpoint instead of a fresh init
    source_trial_id: Optional[RequestID] = None


class Searcher:
    """Stateful wrapper the experiment engine drives.

    Event entry points serialize on an internal lock: the concurrent trial
    scheduler fires ``on_validation``/``set_trial_progress`` from trial
    threads while the dispatcher thread drives exits and reads pending
    creates, and SearchMethod implementations are written single-threaded
    (rung lists, rng draws, id counters).
    """

    def __init__(
        self, method: SearchMethod, hparams: Dict[str, Any], seed: int = 0
    ) -> None:
        self.method = method
        self.ctx = SearcherContext(hparams, seed)
        self.trials: Dict[RequestID, TrialRecord] = {}
        self.shutdown: Optional[Shutdown] = None
        self._trial_progress: Dict[RequestID, float] = {}
        self._started = False
        # RLock: _absorb recurses through trial_created events
        self._lock = threading.RLock()

    # -- event entry points (called by the experiment engine) --------------

    def _absorb(self, actions: List[Action]) -> List[Action]:
        for a in actions:
            if isinstance(a, Create):
                self.trials[a.request_id] = TrialRecord(
                    a.request_id, a.hparams, source_trial_id=a.source_trial_id
                )
            elif isinstance(a, Stop):
                if a.request_id in self.trials:
                    self.trials[a.request_id].stopped_by_searcher = True
            elif isinstance(a, Shutdown):
                self.shutdown = a
        # trial_created events fire for newly absorbed creates
        extra: List[Action] = []
        for a in actions:
            if isinstance(a, Create):
                extra.extend(self.method.trial_created(self.ctx, a.request_id))
        if extra:
            actions = actions + self._absorb(extra)
        return actions

    def start(self) -> List[Action]:
        with self._lock:
            if self._started:
                # a restored (or restarted) searcher must not re-run
                # initial_trials: the creates it would emit already exist,
                # and the duplicate draws would burn request ids / rng state
                return []
            self._started = True
            return self._absorb(self.method.initial_trials(self.ctx))

    def on_validation(
        self, request_id: RequestID, metrics: Dict[str, Any]
    ) -> List[Action]:
        with self._lock:
            if request_id in self.trials:
                self.trials[request_id].metrics = dict(metrics)
            return self._absorb(
                self.method.validation_completed(self.ctx, request_id, metrics)
            )

    def on_trial_exited(self, request_id: RequestID) -> List[Action]:
        with self._lock:
            if request_id in self.trials:
                rec = self.trials[request_id]
                rec.running = False
                rec.exited = True
            return self._absorb(self.method.trial_exited(self.ctx, request_id))

    def on_trial_exited_early(self, request_id: RequestID, reason: str) -> List[Action]:
        with self._lock:
            if request_id in self.trials:
                self.trials[request_id].running = False
                self.trials[request_id].exited = True
            return self._absorb(
                self.method.trial_exited_early(self.ctx, request_id, reason)
            )

    def set_trial_progress(self, request_id: RequestID, progress: float) -> None:
        with self._lock:
            self._trial_progress[request_id] = progress

    def progress(self) -> float:
        with self._lock:
            closed = {rid: t.exited for rid, t in self.trials.items()}
            return self.method.progress(self._trial_progress, closed)

    # -- thread-safe views (the concurrent scheduler's read surface) -------

    def runnable_trials(self) -> List[TrialRecord]:
        """Snapshot of trials that are created and not yet exited."""
        with self._lock:
            return [t for t in self.trials.values() if t.running and not t.exited]

    def trial_records(self) -> List[TrialRecord]:
        """Locked snapshot of ALL trial records (e.g. for GC metric
        ranking); iterating ``self.trials`` directly races concurrent
        creates."""
        with self._lock:
            return list(self.trials.values())

    def is_stopped(self, request_id: RequestID) -> bool:
        """Whether the method has asked this trial to stop early."""
        with self._lock:
            rec = self.trials.get(request_id)
            return bool(rec is not None and rec.stopped_by_searcher)

    def clone_source_trials(self) -> List[RequestID]:
        """Trials whose latest checkpoints are live clone sources: the
        method's own candidates (PBT's current population) plus the named
        source of every trial that has not finished cloning from it yet.
        Checkpoint GC must keep these even when metric-ranked retention
        would rotate them out."""
        with self._lock:
            out = set(self.method.clone_source_trials())
            for rec in self.trials.values():
                if rec.source_trial_id is not None and not rec.exited:
                    out.add(rec.source_trial_id)
            return sorted(out)

    # -- snapshot ----------------------------------------------------------

    def state_json(self) -> str:
        with self._lock:
            return self._state_json_locked()

    def _state_json_locked(self) -> str:
        return json.dumps(
            {
                "method": self.method.state_dict(),
                "ctx": self.ctx.state_dict(),
                "started": self._started,
                "trials": {
                    str(rid): dataclasses.asdict(t) for rid, t in self.trials.items()
                },
                "trial_progress": {str(k): v for k, v in self._trial_progress.items()},
                "shutdown": (
                    None
                    if self.shutdown is None
                    else {"cancel": self.shutdown.cancel, "failure": self.shutdown.failure}
                ),
            }
        )

    def restore_json(self, text: str) -> None:
        with self._lock:
            self._restore_json_locked(text)

    def _restore_json_locked(self, text: str) -> None:
        state = json.loads(text)
        self.method.load_state_dict(state["method"])
        if "ctx" in state:
            self.ctx.load_state_dict(state["ctx"])
        # any snapshot implies the search had started (older snapshots
        # predate the flag)
        self._started = bool(state.get("started", True))
        self.trials = {
            int(rid): TrialRecord(**t) for rid, t in state["trials"].items()
        }
        self._trial_progress = {
            int(k): v for k, v in state.get("trial_progress", {}).items()
        }
        sd = state["shutdown"]
        if sd:
            self.shutdown = Shutdown(**sd) if isinstance(sd, dict) else Shutdown()


def simulate(
    config: ExperimentConfig,
    trial_fn: Callable[[Dict[str, Any], int], float],
    *,
    seed: int = 0,
    report_period: int = 0,
) -> Dict[str, Any]:
    """Run a whole search synchronously against a synthetic trial function.

    ``trial_fn(hparams, time_step) -> metric`` models a trial's validation
    metric at a given step.  Back-compat wrapper over the full harness in
    ``searcher/simulate.py`` (curve models, clone inheritance,
    best-vs-budget reports); clone-based methods see ``time_step`` as the
    trial's EFFECTIVE units including inherited progress.

    Reference: ``master/pkg/searcher/simulate.go:65``.
    """
    from determined_tpu_torch.searcher.simulate import simulate_method

    class _FnModel:
        def metric(self, hparams: Dict[str, Any], units: float) -> float:
            return trial_fn(hparams, int(units))

    report = simulate_method(
        config, _FnModel(), seed=seed, report_period=report_period
    )
    return {
        "trials_created": report.trials_created,
        "total_units": report.total_units,
        "best_metric": report.best_metric,
        "max_time": report.max_time,
        "trial_units": dict(report.trial_units),
    }
