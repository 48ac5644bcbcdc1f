"""Cluster experiment driver: one searcher, trials on the master's agents
(a copy of ``determined_tpu/experiment/cluster.py``).

``LocalExperiment`` runs the whole search — searcher loop AND trials —
inside one process over the host's devices.  This driver keeps the same
journaled searcher (``JournaledSearcher`` with the write-ahead journal as
the durable source of truth) but hands trial EXECUTION to the native
control plane: every trial the searcher creates is submitted to the master
over the port's session, the master gang-fits its slots across agents
(``native/master/master.cpp`` find_fit/place_gang), each rank's agent execs
the trial process with rendezvous env (``DTPU_RENDEZVOUS``: coordinator =
rank-0's host:port, num_nodes, node_rank) — the port's ``run_trial`` when
the agent's ``--python`` is the port's launcher (``exec/launcher.py``) —
and the ranks join one torch process group before training.

Split of responsibilities:

- driver (here): hparam sampling, ASHA rungs/early-stops, the journal,
  results, tracing (``gang.dispatch`` scheduling waits, ``gang.teardown``
  restart instants).
- master: gang placement (all-or-nothing slot allocation, ``single_slice``
  enforcement), gang fault tolerance (one rank dies -> the whole gang is
  torn down and rescheduled, counted against ``max_restarts``), rendezvous
  endpoints, preemption signals, logs/metrics/checkpoint records.

The master side of the contract is the ``driver`` searcher
(``native/master/searcher.hpp`` DriverSearch): a master experiment whose
searcher creates nothing — trials arrive via
``POST /api/v1/experiments/{id}/trials {request_id, hparams}`` (idempotent
per request_id, so driver retries and resumes re-attach instead of
double-creating), early stops via ``POST /api/v1/trials/{id}/stop``, and
the terminal transition via ``POST .../searcher/shutdown``.

Crash recovery mirrors ``LocalExperiment``: the journal's
``cluster_attached`` record pins the master url + experiment id, so
``resume()`` restores the searcher, re-attaches every in-flight trial (the
master kept them running — or queued — while the driver was down), and
continues the search without re-submitting anything.  With ``registry:
{model, auto_promote: true}`` the finished search registers its winner's
final checkpoint as the model's next version (``experiment/registry.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.api.session import TRANSPORT_ERRORS, APIError, NotFoundError, Session
from determined_tpu_torch.api.session import login as api_login
from determined_tpu_torch.config.experiment import ExperimentConfig, InvalidExperimentConfig
from determined_tpu_torch.experiment.journal import (
    ExperimentJournal,
    ExperimentJournalError,
    JournaledSearcher,
    journal_path,
    read_journal,
)
from determined_tpu_torch.experiment.local import PREEMPTED_EXIT_CODE, TrialResult, _PreemptFlag
from determined_tpu_torch.observability import export_experiment_trace, get_tracer
from determined_tpu_torch.searcher import method_from_config

__all__ = [
    "ClusterExperiment",
    "MasterUnreachableError",
    "PREEMPTED_EXIT_CODE",
    "run_cluster_experiment",
]

logger = logging.getLogger("determined_tpu_torch.experiment.cluster")

# master trial states
_TERMINAL = ("COMPLETED", "STOPPED", "ERROR")


class MasterUnreachableError(Exception):
    """The master stayed unreachable past
    ``fault_tolerance.master_unreachable_grace_s``: the watcher declares its
    trial lost (the search continues, mirroring trial-ERROR tolerance)."""


class _DriverDetached(Exception):
    """Internal: preemption flipped while a watcher was waiting out a
    master outage — detach instead of declaring the trial lost."""


@dataclasses.dataclass
class _Watch:
    """Driver-side view of one submitted trial."""

    request_id: int
    master_trial_id: Optional[int] = None
    validations_seen: int = 0
    # last `validations` count seen on the trial JSON: the /metrics fetch
    # (an O(metrics-file) scan master-side) only runs when this changes
    last_vcount: int = -1
    restarts_seen: int = 0
    # elastic reshard counter last seen on the trial JSON: a bump means the
    # master shrank/grew the gang (capacity event, restart budget untouched)
    resizes_seen: int = 0
    stop_posted: bool = False
    # resume filter: validation reports at or below this step were already
    # absorbed by the restored searcher and must not be re-fed (journal
    # compaction drops the per-event records, so the offset alone cannot
    # tell; ASHA rung state is not safely re-entrant for stale reports)
    min_steps_seen: int = -1


class ClusterExperiment:
    """Drive an ``ExperimentConfig``'s search through the master.

    ``entrypoint`` is the ``pkg.module:TrialClass`` string agents exec (the
    trial class itself never has to be importable on the driver).  The
    session is any authenticated ``api.session.Session``; ``master_url``
    is sugar that logs in as the default user.
    """

    def __init__(
        self,
        config: ExperimentConfig,
        entrypoint: Optional[str] = None,
        *,
        session: Optional[Session] = None,
        master_url: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        seed: Optional[int] = None,
        poll_interval: float = 0.5,
    ) -> None:
        if session is None:
            if master_url is None:
                raise ValueError("ClusterExperiment requires session= or master_url=")
            session = api_login(master_url)
        self.session = session
        self.config = config
        self.entrypoint = entrypoint or config.entrypoint
        if not self.entrypoint or ":" not in self.entrypoint:
            raise InvalidExperimentConfig(
                "cluster experiments need an entrypoint of the form "
                "pkg.module:TrialClass (config `entrypoint:` or the "
                "entrypoint argument)"
            )
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "cluster_experiment_driver"
        )
        self.seed = seed if seed is not None else config.reproducibility.experiment_seed
        self.poll_interval = poll_interval
        self.searcher = JournaledSearcher(
            method_from_config(config.searcher, config.hyperparameters),
            config.hyperparameters,
            seed=self.seed,
        )
        self.journal: Optional[ExperimentJournal] = None
        self.master_experiment_id: Optional[int] = None
        self.results: Dict[int, TrialResult] = {}
        self.status = "pending"  # pending|running|completed|preempted|error
        # watcher-shared state: watcher threads append results/errors and
        # read/update their own _Watch entries; the dispatcher reads all
        self._state_lock = threading.Lock()
        self._watches: Dict[int, _Watch] = {}
        self._errors: List[Tuple[int, BaseException]] = []
        self._threads: Dict[int, threading.Thread] = {}
        self._preempt = _PreemptFlag()
        self._prev_handlers: Dict[int, Any] = {}

    # -- master API --------------------------------------------------------

    def _master_config(self) -> Dict[str, Any]:
        """The master-side experiment config: the submitted config with the
        searcher swapped for the master's ``driver`` stub (the real search
        method runs HERE).  Hparam sampling is driver-side too, so the
        hyperparameter space rides along only for the record."""
        raw = dict(self.config.raw or {})
        if not raw:
            # programmatically-built config (no YAML source): reconstruct
            # every section the master consults — placement reads
            # resources.single_slice/resource_pool/priority from the
            # SUBMITTED JSON (not the driver's dataclass), and the ranks'
            # harness reads checkpoint_storage + environment out of
            # DTPU_EXP_CONFIG.  Hparam sampling stays driver-side, so the
            # hyperparameter space itself need not ride along.
            cfg = self.config
            raw = {
                "resources": {
                    "mesh": dataclasses.asdict(cfg.resources.mesh),
                    "resource_pool": cfg.resources.resource_pool,
                    "priority": cfg.resources.priority,
                    "weight": cfg.resources.weight,
                    "single_slice": cfg.resources.single_slice,
                },
                "checkpoint_storage": {
                    k: v
                    for k, v in dataclasses.asdict(cfg.checkpoint_storage).items()
                    if v is not None
                },
                "max_restarts": cfg.max_restarts,
            }
            if cfg.resources.elastic is not None:
                # master-side elasticity policy: max_slots sizes the gang,
                # min_* floors the shrink, cooldown gates the hysteresis
                raw["resources"]["elastic"] = {
                    k: v
                    for k, v in dataclasses.asdict(cfg.resources.elastic).items()
                    if v is not None
                }
            if cfg.environment:
                raw["environment"] = dict(cfg.environment)
            if cfg.min_validation_period is not None:
                raw["min_validation_period"] = {
                    cfg.min_validation_period.unit: cfg.min_validation_period.units
                }
            if cfg.min_checkpoint_period is not None:
                raw["min_checkpoint_period"] = {
                    cfg.min_checkpoint_period.unit: cfg.min_checkpoint_period.units
                }
        scfg = self.config.searcher
        raw["name"] = self.config.name
        raw["entrypoint"] = self.entrypoint
        raw["searcher"] = {
            "name": "driver",
            "metric": scfg.metric,
            "smaller_is_better": scfg.smaller_is_better,
            "time_metric": scfg.time_metric or "batches",
            "max_length": {"batches": int(
                scfg.max_time
                or (scfg.max_length.units if scfg.max_length else 100)
            )},
        }
        raw["max_restarts"] = self.config.max_restarts
        return raw

    def _submit_master_experiment(self) -> int:
        try:
            resp = self.session.post(
                "/api/v1/experiments",
                json={"config": self._master_config()},
                retry=True,  # creation is keyed by nothing, but a dup
                # experiment is visible and killable; availability wins
            )
        except APIError as e:
            if e.status == 400 and "single_slice" in e.message:
                # the master's gang allocator refused the placement shape
                raise InvalidExperimentConfig(e.message) from e
            raise
        return int(resp.json()["id"])

    def _submit_trial(
        self,
        rid: int,
        hparams: Dict[str, Any],
        source_checkpoint: Optional[str] = None,
    ) -> int:
        payload: Dict[str, Any] = {"request_id": rid, "hparams": hparams}
        if source_checkpoint:
            # PBT exploit clone: the master seeds the trial's resume point
            # with this uuid and the allocation restores it THROUGH the
            # shared checkpoint storage (DTPU_LATEST_CHECKPOINT) — clone
            # sources never travel as driver-local paths
            payload["source_checkpoint"] = source_checkpoint
        resp = self.session.post(
            f"/api/v1/experiments/{self.master_experiment_id}/trials",
            json=payload,
            retry=True,  # idempotent per request_id (master keeps the map)
        )
        return int(resp.json()["id"])

    def _source_checkpoint_for(self, source_rid: Optional[int]) -> Optional[str]:
        """The clone source's newest master-known checkpoint uuid."""
        if source_rid is None:
            return None
        with self._state_lock:
            result = self.results.get(source_rid)
            watch = self._watches.get(source_rid)
        if result is not None and result.checkpoint:
            return result.checkpoint
        tid = watch.master_trial_id if watch is not None else None
        if tid is not None:
            try:
                return self._get_trial(tid).get("latest_checkpoint") or None
            except (APIError, *TRANSPORT_ERRORS):
                return None
        return None

    def _get_trial(self, tid: int) -> Dict[str, Any]:
        return self.session.get(f"/api/v1/trials/{tid}").json()

    def _get_validations(self, tid: int, offset: int) -> List[Dict[str, Any]]:
        return self.session.get(
            f"/api/v1/trials/{tid}/metrics",
            params={"group": "validation", "offset": offset},
        ).json()

    # -- preflight ---------------------------------------------------------

    def _single_slice_preflight(self) -> None:
        """Fail fast, before anything is journaled or submitted, when a
        ``single_slice`` gang can never fit one registered host.  The
        master re-checks at submit (trust boundary), but the driver-side
        check turns a remote 400 into the same ``InvalidExperimentConfig``
        a malformed local config raises."""
        if not self.config.resources.single_slice:
            return
        slots = self.config.resources.slots_per_trial
        pool = self.config.resources.resource_pool
        try:
            agents = self.session.get("/api/v1/agents").json()
        except APIError:
            return  # the master's own gate still applies
        pool_agents = [a for a in agents if a.get("pool", "default") == pool]
        if not pool_agents:
            return  # empty pool queues; a provisioner may add capacity
        biggest = max(int(a.get("slots", 0)) for a in pool_agents)
        # Mirror the master's topology-aware gate: hosts sharing a
        # slice_id label form one ICI domain, so the gang may span hosts
        # within the largest labeled slice.  Without labels, one host is
        # the conservative capacity bound.
        slice_slots: Dict[str, int] = {}
        for a in pool_agents:
            label = a.get("slice_id") or ""
            if label:
                slice_slots[label] = slice_slots.get(label, 0) + int(
                    a.get("slots", 0)
                )
        if slice_slots:
            biggest_slice, biggest_slice_slots = max(
                slice_slots.items(), key=lambda kv: kv[1]
            )
            if slots > max(biggest, biggest_slice_slots):
                raise InvalidExperimentConfig(
                    f"resources.single_slice: the {slots}-slot gang does not "
                    f"fit any slice in pool {pool!r} (largest slice "
                    f"{biggest_slice!r}: {biggest_slice_slots} slots); "
                    "a DCN-spanning split is forbidden by single_slice"
                )
        elif slots > biggest:
            raise InvalidExperimentConfig(
                f"resources.single_slice: the {slots}-slot gang does not fit "
                f"any host in pool {pool!r} (largest agent: {biggest} slots), "
                "and agents report no topology labels (agent --slice-id), so "
                "single_slice is enforced per host; a DCN-spanning split is "
                "forbidden by single_slice"
            )

    # -- trial watchers ----------------------------------------------------

    def _watch_trial(
        self, rid: int, hparams: Dict[str, Any], source_rid: Optional[int] = None
    ) -> None:
        # same attribution unit as LocalExperiment: everything this thread
        # records inside trial.run is this trial's wall-clock in the ledger
        with get_tracer().span("trial.run", cat="trial", trial=rid):
            try:
                outcome = self._watch_trial_inner(rid, hparams, source_rid)
            except BaseException as e:  # noqa: BLE001 - drained by run()
                logger.exception("trial %d watcher failed", rid)
                with self._state_lock:
                    self._errors.append((rid, e))
                return
        if outcome is None:
            return  # preempted drain: trial stays in-flight on the master
        result, state = outcome
        with self._state_lock:
            self.results[rid] = result
        if self.journal is not None:
            # Safe unlocked: ExperimentJournal.append serializes on the
            # journal's own internal lock; self.journal is only rebound
            # before watchers start / after they are joined.
            self.journal.append(
                "trial_result",
                rid=rid,
                result={
                    "hparams": result.hparams,
                    "steps_completed": result.steps_completed,
                    "metrics": result.metrics,
                    "checkpoint": result.checkpoint,
                    "stopped_early": result.stopped_early,
                },
            )
        if state == "ERROR":
            self.searcher.on_trial_exited_early(rid, "errored")
        else:
            self.searcher.on_trial_exited(rid)

    def _poll_master(self, rid: int, what: str, fn: Any) -> Any:
        """Run one master call, riding out a master outage.

        Connection failures and 5xx/429 during a master restart are NOT a
        trial failure: the master WAL makes restarts re-attachable, so the
        watcher retries with capped exponential backoff (the PR-1
        failure-streak pattern: the grace clock starts at the first failure
        of a streak and resets on any success) for up to
        ``fault_tolerance.master_unreachable_grace_s`` before declaring the
        trial lost.  Client errors (bad request, 404) still raise
        immediately — those are contract violations, not outages.
        """
        grace = self.config.fault_tolerance.master_unreachable_grace_s
        deadline: Optional[float] = None
        delay = max(self.poll_interval, 0.1)
        while True:
            try:
                return fn()
            except NotFoundError:
                raise
            except (APIError, *TRANSPORT_ERRORS) as e:
                retryable = not isinstance(e, APIError) or (
                    e.status == 429 or e.status >= 500 or e.status == 0
                )
                if not retryable:
                    raise
                now = time.monotonic()
                if deadline is None:
                    deadline = now + grace
                    logger.warning(
                        "trial %d: master unreachable during %s (%s); "
                        "retrying for up to %.0fs",
                        rid, what, e, grace,
                    )
                if now >= deadline:
                    raise MasterUnreachableError(
                        f"master unreachable for {grace:.0f}s during {what}: {e}"
                    ) from e
                if self._preempt.is_set():
                    raise _DriverDetached() from e
                time.sleep(min(delay, max(deadline - now, 0.05)))
                delay = min(delay * 2, 10.0)

    def _watch_trial_inner(
        self, rid: int, hparams: Dict[str, Any], source_rid: Optional[int] = None
    ) -> Optional[Tuple[TrialResult, str]]:
        try:
            return self._watch_trial_poll(rid, hparams, source_rid)
        except _DriverDetached:
            # preempted mid-outage: the trial stays in flight on the master
            return None
        except MasterUnreachableError as e:
            # grace exhausted: declare THIS trial lost and let the search
            # continue — the same tolerance a terminally-errored trial gets
            logger.error("trial %d: %s; declaring the trial lost", rid, e)
            rec = self.searcher.trials.get(rid)
            metrics = dict((rec.metrics if rec is not None else None) or {})
            steps = int(
                metrics.get(self.config.searcher.time_metric or "batches", 0) or 0
            )
            return (
                TrialResult(
                    request_id=rid,
                    hparams=hparams,
                    steps_completed=steps,
                    metrics=metrics,
                    checkpoint=None,
                    stopped_early=True,
                ),
                "ERROR",
            )

    def _watch_trial_poll(
        self, rid: int, hparams: Dict[str, Any], source_rid: Optional[int] = None
    ) -> Optional[Tuple[TrialResult, str]]:
        tracer = get_tracer()
        scfg = self.config.searcher
        with self._state_lock:
            watch = self._watches[rid]
        tid = watch.master_trial_id
        if tid is None:
            source_ckpt = self._source_checkpoint_for(source_rid)
            if source_rid is not None and source_ckpt is None:
                logger.warning(
                    "trial %d: exploit source trial %d has no master-known "
                    "checkpoint; the child starts from scratch", rid, source_rid,
                )
            tid = self._poll_master(
                rid, "trial submit",
                lambda: self._submit_trial(rid, hparams, source_checkpoint=source_ckpt),
            )
            watch.master_trial_id = tid
            if self.journal is not None:
                # Safe unlocked: append holds the journal's internal lock.
                self.journal.append("trial_running", rid=rid, master_trial_id=tid)
            logger.info(
                "trial %d submitted to master as trial %d (hparams %s)",
                rid, tid, hparams,
            )

        # gang.dispatch: scheduling delay between submit and the gang
        # actually holding slots — keyed to the trial so `dtpu experiment
        # profile` attributes multi-host queueing instead of lumping it
        # into "other"
        dispatch_t0 = time.monotonic()
        dispatched = False
        remote_t0: Optional[float] = None
        trial = self._poll_master(rid, "state poll", lambda: self._get_trial(tid))
        last_state = trial.get("state")
        latest_ckpt: Optional[str] = None

        def record_remote() -> None:
            # the gang's actual execution window, driver-side: the ledger
            # cannot see the ranks' step spans (those live in each rank's
            # own trace), so name the wait honestly instead of letting it
            # read as 98% "other" in `dtpu experiment profile`
            if remote_t0 is not None:
                tracer.record_span(
                    "gang.remote", "remote", remote_t0, time.monotonic(),
                    {"trial": rid, "master_trial": tid},
                )

        while True:
            state = trial.get("state")
            if not dispatched and state != "PENDING":
                tracer.record_span(
                    "gang.dispatch", "scheduler", dispatch_t0, time.monotonic(),
                    {"trial": rid, "master_trial": tid},
                )
                dispatched = True
                remote_t0 = time.monotonic()
            if state != last_state:
                logger.info("trial %d (master %d): %s", rid, tid, state)
                last_state = state

            # gang fault tolerance surfaced: the master tore a gang down
            # and rescheduled it (one rank died / an agent was lost)
            restarts = int(trial.get("restarts") or 0)
            if restarts > watch.restarts_seen:
                tracer.instant(
                    "gang.teardown", cat="gang", trial=rid,
                    master_trial=tid, restarts=restarts,
                )
                logger.warning(
                    "trial %d (master %d): gang torn down and rescheduled "
                    "(restart %d/%d)",
                    rid, tid, restarts, self.config.max_restarts,
                )
                watch.restarts_seen = restarts

            # elastic reshard surfaced: the master resized the gang through
            # checkpoint-restore-reshard.  Journaled so a resumed driver
            # knows the trial runs on the CURRENT mesh, not the submitted one
            resizes = int(trial.get("resizes") or 0)
            if resizes > watch.resizes_seen:
                cur_slots = int(trial.get("cur_slots") or 0)
                tracer.instant(
                    "trial.resize", cat="gang", trial=rid,
                    master_trial=tid, resizes=resizes, cur_slots=cur_slots,
                )
                logger.warning(
                    "trial %d (master %d): elastic resize #%d -> %d slot(s) "
                    "(capacity event; restart budget untouched)",
                    rid, tid, resizes, cur_slots,
                )
                if self.journal is not None:
                    # Safe unlocked: append holds the journal's internal lock.
                    self.journal.append(
                        "trial_resized", rid=rid,
                        resizes=resizes, cur_slots=cur_slots,
                    )
                watch.resizes_seen = resizes

            # feed NEW validation reports to the searcher, oldest first.
            # The /metrics read is an O(file) scan master-side, so it only
            # runs when the trial's in-memory validation count moved (or
            # the master predates the field, or the trial went terminal —
            # the final drain must always consume the tail)
            vcount = trial.get("validations")
            if (
                vcount is None
                or int(vcount) != watch.last_vcount
                or state in _TERMINAL
            ):
                if vcount is not None:
                    watch.last_vcount = int(vcount)
                for rec in self._poll_master(
                    rid, "validation fetch",
                    lambda: self._get_validations(tid, watch.validations_seen),
                ):
                    watch.validations_seen += 1
                    metrics = dict(rec.get("metrics") or {})
                    steps = int(rec.get("steps_completed") or 0)
                    if steps <= watch.min_steps_seen:
                        continue  # restored searcher already absorbed this one
                    watch.min_steps_seen = steps
                    metrics.setdefault(scfg.time_metric or "batches", steps)
                    self.searcher.on_validation(rid, metrics)
                    self.searcher.set_trial_progress(
                        rid, float(trial.get("progress") or 0.0)
                    )
            ckpt = trial.get("latest_checkpoint") or None
            if ckpt and ckpt != latest_ckpt:
                latest_ckpt = ckpt
                if self.journal is not None:
                    # Safe unlocked: append holds the journal's internal lock.
                    self.journal.append("trial_checkpoint", rid=rid, uuid=ckpt)

            if not watch.stop_posted and self.searcher.is_stopped(rid):
                # ASHA rung cut: ask the master to stop the gang gracefully
                # (preempt -> checkpoint -> exit 0 -> STOPPED)
                self._poll_master(
                    rid, "early-stop request",
                    lambda: self.session.post(f"/api/v1/trials/{tid}/stop", retry=True),
                )
                watch.stop_posted = True
                logger.info("trial %d (master %d): early stop requested", rid, tid)

            if state in _TERMINAL:
                record_remote()
                break
            if self._preempt.is_set():
                # driver drain: the master keeps the gang running; the
                # journal's cluster record lets a resumed driver re-attach
                record_remote()
                return None
            time.sleep(self.poll_interval)
            trial = self._poll_master(rid, "state poll", lambda: self._get_trial(tid))

        state = str(trial.get("state"))
        rec = self.searcher.trials.get(rid)
        metrics = dict((rec.metrics if rec is not None else None) or {})
        steps = int(metrics.get(scfg.time_metric or "batches", 0) or 0)
        if state == "ERROR":
            # exhausted its gang restart budget: report what it achieved
            # and let the search continue — one poisoned hparam point must
            # not kill the whole multi-host search
            logger.error(
                "trial %d (master %d) failed terminally after %d restart(s)",
                rid, tid, int(trial.get("restarts") or 0),
            )
        return (
            TrialResult(
                request_id=rid,
                hparams=hparams,
                steps_completed=steps,
                metrics=metrics,
                checkpoint=trial.get("latest_checkpoint") or None,
                stopped_early=state != "COMPLETED",
            ),
            state,
        )

    # -- the dispatch loop -------------------------------------------------

    def run(self, *, resume: bool = False) -> Dict[str, Any]:
        """Run the search to completion (or to a resumable preemption).

        The dispatcher thread turns searcher creates into master trial
        submissions; one watcher thread per in-flight trial polls its
        state/metrics and feeds the searcher.  Concurrency control is the
        search method's own pacing (ASHA creates at most
        ``max_concurrent_trials`` at a time) plus the master's gang
        allocator — trials that do not fit queue there, visible in
        ``dtpu agent list`` / the job queue.
        """
        obs = self.config.observability
        tracer = get_tracer()
        tracer.reset()
        tracer.configure(
            enabled=obs.enabled,
            ring_capacity=obs.ring_capacity,
            flush_interval=obs.flush_interval_s,
            max_events=obs.max_events,
            out_dir=(
                os.path.join(self.checkpoint_dir, "traces")
                if obs.enabled and obs.trace_export
                else None
            ),
        )
        exp_t0 = None
        if obs.enabled:
            tracer.start()
            exp_t0 = time.monotonic()

        self._single_slice_preflight()

        ft = self.config.fault_tolerance
        if ft.journal:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            # Safe unlocked: rebound before any watcher thread exists.
            self.journal = ExperimentJournal(
                journal_path(self.checkpoint_dir),
                compact_interval=ft.journal_compact_interval,
            ).open(fresh=not resume)
            # Safe unlocked: attached before any watcher thread exists.
            self.searcher.journal = self.journal
        try:
            if resume:
                self._load_resume_state()
            else:
                if self.journal is not None:
                    # Safe unlocked: no watcher threads yet; append holds
                    # the journal's internal lock anyway.
                    self.journal.append(
                        "experiment_started",
                        name=self.config.name,
                        entrypoint=self.entrypoint,
                        config=self.config.raw or None,
                        seed=self.seed,
                    )
                # Safe unlocked: written before any watcher thread exists.
                self.master_experiment_id = self._submit_master_experiment()
                logger.info(
                    "search %r attached to master experiment %d at %s",
                    self.config.name,
                    self.master_experiment_id,
                    self.session.master_url,
                )
                if self.journal is not None:
                    # Safe unlocked: no watcher threads yet.
                    self.journal.append(
                        "cluster_attached",
                        master_url=self.session.master_url,
                        experiment_id=self.master_experiment_id,
                    )

            self.status = "running"
            self._install_signal_handlers()
            try:
                self._dispatch_loop()
            finally:
                self._restore_signal_handlers()

            with self._state_lock:
                errors = list(self._errors)
            if errors:
                self.status = "error"
                raise errors[0][1]
            self.status = "preempted" if self._preempt.is_set() else "completed"
            if self.status == "completed":
                self._shutdown_master_experiment()
            if self.journal is not None:
                if self.status == "preempted":
                    with self._state_lock:
                        in_flight = sorted(
                            r for r in self._watches if r not in self.results
                        )
                    # Safe unlocked: drain-abandoned stragglers may still
                    # append concurrently, but append serializes on the
                    # journal's internal lock.
                    self.journal.append("experiment_preempted", in_flight=in_flight)
                else:
                    self.journal.append("experiment_completed")
            summary = self.summary()
            if self.status == "completed":
                self.on_search_complete(summary)
            return summary
        finally:
            if self.journal is not None:
                # Safe unlocked: watcher threads are joined by this point.
                self.searcher.journal = None
                self.journal.close()
            if exp_t0 is not None:
                tracer.record_span(
                    "experiment.run", "experiment", exp_t0, time.monotonic(),
                    {"name": self.config.name, "status": self.status,
                     "master": self.session.master_url},
                )
                tracer.stop()
                if obs.trace_export:
                    try:
                        export_experiment_trace(
                            tracer, os.path.join(self.checkpoint_dir, "traces")
                        )
                    except Exception:  # noqa: BLE001 - export must not mask the run
                        logger.exception("trace export failed")

    def _dispatch_loop(self) -> None:
        self.searcher.start()
        while True:
            if not self._preempt.is_set():
                for rec in self.searcher.runnable_trials():
                    rid = rec.request_id
                    # _threads is dispatcher-private (this thread only);
                    # _watches entries are created/read under _state_lock
                    if rid in self._threads:
                        continue
                    with self._state_lock:
                        if rid in self.results:
                            continue
                        # resume pre-seeds _watches with master ids/offsets
                        self._watches.setdefault(rid, _Watch(request_id=rid))
                    t = threading.Thread(
                        target=self._watch_trial,
                        args=(rid, rec.hparams, rec.source_trial_id),
                        name=f"dtpu-cluster-{rid}",
                        daemon=True,
                    )
                    self._threads[rid] = t
                    t.start()
            alive = [t for t in self._threads.values() if t.is_alive()]
            if not alive:
                with self._state_lock:
                    errors = bool(self._errors)
                pending = [
                    t for t in self.searcher.runnable_trials()
                    if t.request_id not in self.results
                ]
                if errors or self.searcher.shutdown is not None or not pending:
                    break
                if self._preempt.is_set():
                    break
            time.sleep(min(self.poll_interval, 0.3))
        drain_deadline = time.time() + self.config.fault_tolerance.preempt_drain_seconds
        for t in self._threads.values():
            t.join(timeout=max(drain_deadline - time.time(), 0.1))

    def _shutdown_master_experiment(self) -> None:
        if self.master_experiment_id is None:
            return
        try:
            self.session.post(
                f"/api/v1/experiments/{self.master_experiment_id}/searcher/shutdown",
                retry=True,
            )
        except (APIError, *TRANSPORT_ERRORS) as e:
            # a down master must not turn a finished search into a crash:
            # the searcher-shutdown is re-posted by any future resume()
            logger.warning("master searcher shutdown failed: %s", e)

    # -- preemption --------------------------------------------------------

    def request_preemption(self) -> None:
        """Drain the DRIVER: watchers detach, the journal records what was
        in flight, and the run returns "preempted".  The master keeps the
        gangs training — ``resume()`` re-attaches to them."""
        if self._preempt.is_set():
            return
        logger.warning(
            "preemption requested: detaching from in-flight trials "
            "(the master keeps them running; resume re-attaches)"
        )
        self._preempt.set()

    def _request_preemption_from_signal(self) -> None:
        if self._preempt.is_set():
            return
        os.write(
            2,
            b"determined-tpu: preemption signal received, detaching cluster "
            b"driver (trials keep running on the master)\n",
        )
        self._preempt.set()

    def _install_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev = signal.getsignal(sig)

            def handler(signum: int, frame: Any, _prev: Any = prev) -> None:
                self._request_preemption_from_signal()
                if callable(_prev) and _prev is not signal.default_int_handler:
                    _prev(signum, frame)

            self._prev_handlers[sig] = prev
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                self._prev_handlers.pop(sig, None)
                return

    def _restore_signal_handlers(self) -> None:
        for sig, prev in list(self._prev_handlers.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError, OSError):
                pass
        self._prev_handlers.clear()

    # -- resume ------------------------------------------------------------

    def _load_resume_state(self) -> None:
        """Restore the searcher + results from the journal and re-attach to
        the journaled master experiment."""
        if self.journal is None:
            raise ExperimentJournalError("resume requires fault_tolerance.journal: true")
        replay = read_journal(journal_path(self.checkpoint_dir))
        if replay.cluster is None:
            raise ExperimentJournalError(
                f"journal under {self.checkpoint_dir} records no cluster "
                "attachment; this directory belongs to a LocalExperiment — "
                "resume it without --cluster"
            )
        # Safe unlocked (here through the _watches seed below): resume
        # state is restored before any watcher thread exists.
        self.master_experiment_id = int(replay.cluster["experiment_id"])
        if replay.searcher_state is not None:
            self.searcher.restore_json(json.dumps(replay.searcher_state))
        for ev in replay.tail_events:
            rid = int(ev["rid"])
            rec = self.searcher.trials.get(rid)
            if rec is None or rec.exited:
                continue
            if ev["type"] == "trial_validated":
                self.searcher.on_validation(rid, ev.get("metrics") or {})
            elif ev["type"] == "trial_exited":
                self.searcher.on_trial_exited(rid)
            else:
                self.searcher.on_trial_exited_early(rid, ev.get("reason") or "errored")
        for rid, payload in replay.results.items():
            self.results[rid] = TrialResult(
                request_id=rid,
                hparams=payload.get("hparams") or replay.created.get(rid, {}),
                steps_completed=int(payload.get("steps_completed") or 0),
                metrics=payload.get("metrics") or {},
                checkpoint=payload.get("checkpoint"),
                stopped_early=bool(payload.get("stopped_early")),
            )
            rec = self.searcher.trials.get(rid)
            if rec is not None and not rec.exited:
                self.searcher.on_trial_exited(rid)
        # the master experiment must still exist; a deleted one cannot be
        # re-attached and silently starting a fresh one would desync ids
        exp = self.session.get(
            f"/api/v1/experiments/{self.master_experiment_id}"
        ).json()
        # skip validation reports the searcher already absorbed: watcher
        # offsets restart at the count the restored searcher has seen.
        # The journal's trial_validated counts per rid ARE that number.
        seen: Dict[int, int] = {}
        resized: Dict[int, int] = {}
        for rec_j in replay.records:
            if rec_j.get("type") == "trial_validated":
                seen[int(rec_j["rid"])] = seen.get(int(rec_j["rid"]), 0) + 1
            elif rec_j.get("type") == "trial_resized":
                # highest journaled resize count per rid: the resumed watcher
                # must not re-announce (or re-journal) resizes it already saw
                resized[int(rec_j["rid"])] = max(
                    resized.get(int(rec_j["rid"]), 0),
                    int(rec_j.get("resizes") or 0),
                )
        rid_to_tid = {
            int(t["request_id"]): int(t["id"]) for t in exp.get("trials", [])
        }
        for rid in replay.in_flight:
            if rid in self.results:
                continue
            rec = self.searcher.trials.get(rid)
            last = (rec.metrics or {}) if rec is not None else {}
            self._watches[rid] = _Watch(
                request_id=rid,
                master_trial_id=rid_to_tid.get(rid),
                validations_seen=seen.get(rid, 0),
                resizes_seen=resized.get(rid, 0),
                min_steps_seen=int(
                    last.get(self.config.searcher.time_metric or "batches", -1) or -1
                ),
            )
        logger.info(
            "resume: re-attached to master experiment %d (%s): %d completed "
            "trial(s) restored, %d in flight",
            self.master_experiment_id,
            exp.get("state"),
            len(self.results),
            len(self._watches),
        )

    def resume(self) -> Dict[str, Any]:
        """Replay the driver journal and continue the search."""
        return self.run(resume=True)

    # -- registry promotion (docs/registry.md) -----------------------------

    def on_search_complete(self, summary: Dict[str, Any]) -> None:
        """End-of-search hook: with ``registry: {model, auto_promote}``
        configured, register the best trial's final checkpoint as the
        model's next version through the master we already hold a session
        to.  The checkpoint uuid is the master-tracked one, so the master
        fills the rest of the lineage itself (source experiment, storage
        path, metrics snapshot at the checkpoint's step) and its GC pins
        the checkpoint.  Promotion failure is reported in the summary
        (``registry_error``), never raised — it must not fail a finished
        search."""
        rcfg = self.config.registry
        if not (rcfg.model and rcfg.auto_promote):
            return
        from determined_tpu_torch.experiment import registry as registry_mod

        def report(msg: str) -> None:
            summary["registry_error"] = msg
            logger.warning("registry: %s", msg)

        try:
            best_rid = summary.get("best_trial")
            if best_rid is None:
                return report("search produced no best trial to promote")
            result = self.results[best_rid]
            if not result.checkpoint:
                return report(
                    f"best trial {best_rid} reported no checkpoint to promote"
                )
            with self._state_lock:
                watch = self._watches.get(best_rid)
            promoted = registry_mod.promote_search_winner(
                self.session,
                model=rcfg.model,
                labels=rcfg.labels,
                checkpoint_uuid=result.checkpoint,
                storage_path=None,  # master derives it from its own record
                source_trial_id=watch.master_trial_id if watch else None,
                source_experiment_id=self.master_experiment_id,
                metrics=dict(result.metrics or {}),
            )
            summary["registry"] = promoted
            if self.journal is not None:
                # Safe unlocked: watcher threads are joined by this point.
                self.journal.append(
                    "model_registered",
                    name=promoted["model"],
                    version=promoted["version"],
                    uuid=result.checkpoint,
                )
        except Exception as e:  # noqa: BLE001 - promotion must not kill the run
            logger.exception("registry: auto-promotion failed")
            summary["registry_error"] = str(e)

    # -- summary -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        scfg = self.config.searcher
        best: Optional[TrialResult] = None
        for r in self.results.values():
            val = (r.metrics or {}).get(scfg.metric)
            if val is None:
                continue
            if best is None or (
                (val < best.metrics.get(scfg.metric)) == scfg.smaller_is_better
            ):
                best = r
        out = {
            "trials": len(self.results),
            "best_trial": best.request_id if best else None,
            "best_hparams": best.hparams if best else None,
            "best_metrics": best.metrics if best else None,
            "total_steps": sum(r.steps_completed for r in self.results.values()),
            "progress": self.searcher.progress(),
            "status": self.status,
            "resumable": self.status == "preempted",
            "master_url": self.session.master_url,
            "master_experiment_id": self.master_experiment_id,
        }
        if self.status == "preempted":
            with self._state_lock:
                out["in_flight"] = sorted(
                    r for r in self._watches if r not in self.results
                )
        return out


def run_cluster_experiment(
    config: ExperimentConfig, entrypoint: str, **kwargs: Any
) -> Dict[str, Any]:
    return ClusterExperiment(config, entrypoint, **kwargs).run()
