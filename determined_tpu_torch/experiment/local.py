"""Local experiment runner: a searcher-driven search on the host's devices.

Port of ``determined_tpu/experiment/local.py``: the same ``Searcher`` /
``SearchMethod`` machinery drives trials through the Trainer, with
checkpoints and metrics flowing through the dummy core contexts, a
write-ahead journal (``experiment/journal.py``) under ``checkpoint_dir``
that ``resume()`` replays after a crash or a preemption, SIGTERM/SIGINT
handlers that drain the running trial to a checkpoint, in-flight trials
re-queued from their newest VERIFIED checkpoint, and checkpoint retention at
journal-compaction points.  Every search method runs here: an ASHA or
Hyperband ``Stop`` reaches the running trial as a preemption (the Trainer
saves and exits at its next boundary), and a PBT child (``Create`` with a
``source_trial_id``) starts from its parent's newest verified checkpoint,
copied into its own namespace through the storage manager and journaled as
``trial_cloned``, with its budget extended past the inherited steps
(``config.experiment.clone_extended_length``); a resume replays the clones.
Live clone sources are kept by the retention pass.

The trials run on the host's devices (``devices=``; None: every visible
CUDA device, or the one ``device=`` names, CUDA unless named), as the JAX
runner packs them: each trial takes a block of ``resources.mesh``'s size
(a wildcard ``-1`` axis takes every device), and with
``searcher.max_concurrent_trials`` over 1 (at most one trial a block; 0 or
less: bounded by the devices alone) the blocks run at once under
``experiment/scheduler.py``'s ``TrialScheduler`` (``_run_concurrent``),
else one trial after another (``_run_serial``).  A trial on one device
trains on its own thread with that device given to its Trainer (its CUDA
calls made under ``torch.cuda.device``, which holds for the thread alone;
nothing sets a process-wide device); a trial whose block holds several
devices runs as a gang of rank processes, one a device
(``experiment/_gang.py``), restarted by ``exec.run_trial.TrialSupervisor``
from its newest finalized checkpoint after a rank fails.
With ``observability.trace_export`` the tracer's events stream to
``checkpoint_dir/traces/events.jsonl`` while the run goes, and the run ends
by writing ``traces/trace.json`` (Perfetto) and ``traces/goodput.json``
(the ledger that ``experiment profile`` prints); a trial's profiler window
(``profiling.trace``) writes its ``torch.profiler`` trace under
``traces/torch_profiler/trial_<id>/``.

With ``registry: {model, auto_promote: true}`` a finished search registers
its winner's final verified checkpoint as the model's next version through
the master (``session=``, else a login to ``$DTPU_MASTER``); without a
master the summary carries ``registry_error``.  Waiting for a later slice
of the port, raising ``NotImplementedError`` when asked for: the strict
lint and the sentinels; with ``lint.preflight`` on (the default) the runner
logs once that the preflight lint is not ported and goes on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import shutil
import signal
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple, Type

import torch

from determined_tpu_torch import core
from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.config.experiment import (
    ExperimentConfig,
    InvalidExperimentConfig,
    Length,
    clone_extended_length,
)
from determined_tpu_torch.experiment._gang import Gang, trial_entrypoint
from determined_tpu_torch.experiment.journal import (
    ExperimentJournal,
    ExperimentJournalError,
    JournaledSearcher,
    journal_path,
    read_journal,
)
from determined_tpu_torch.observability import export_experiment_trace, get_tracer
from determined_tpu_torch.searcher import Create, method_from_config
from determined_tpu_torch.train import Trainer, init as train_init
from determined_tpu_torch.exec.run_trial import TrialSupervisor
from determined_tpu_torch.train._restart import RestartPolicy
from determined_tpu_torch.train._trial import TorchTrial
from determined_tpu_torch.utils.errors import CheckpointCorruptError

logger = logging.getLogger("determined_tpu_torch.experiment")

# exit code for "preempted, resumable" (EX_TEMPFAIL: rerun later)
PREEMPTED_EXIT_CODE = 75

_LATER = "it comes with a later slice of the port (ROADMAP.md, Queue 1)"


class _PreemptFlag:
    """Event-shaped flag that is safe to SET from a signal handler: a plain
    attribute write holds no lock (``threading.Event.set`` takes one, and
    the handler may interrupt the very frame that holds it)."""

    __slots__ = ("_flag",)

    def __init__(self) -> None:
        self._flag = False

    def set(self) -> None:
        self._flag = True

    def is_set(self) -> bool:
        return self._flag


class _GangPreempt:
    """What a gang trial registers as its active context: ``preempt.
    simulate()`` sets a plain flag (safe from a signal handler) that the
    gang's supervising thread forwards to the chief."""

    def __init__(self) -> None:
        self.preempt = self
        self.requested = False

    def simulate(self) -> None:
        self.requested = True


@dataclasses.dataclass
class TrialResult:
    request_id: int
    hparams: Dict[str, Any]
    steps_completed: int
    metrics: Dict[str, float]
    checkpoint: Optional[str]
    stopped_early: bool
    # the trial exited because the EXPERIMENT is draining for preemption;
    # its latest checkpoint is a resume point, not a final result
    preempted: bool = False


class LocalExperiment:
    """Runs an ExperimentConfig's search against a TorchTrial class."""

    def __init__(
        self,
        config: ExperimentConfig,
        trial_cls: Type[TorchTrial],
        *,
        checkpoint_dir: Optional[str] = None,
        seed: Optional[int] = None,
        device: DeviceLike = None,
        devices: Optional[List[Any]] = None,
        preflight: Optional[bool] = None,
        session: Optional[Any] = None,
    ) -> None:
        lint = config.lint
        if lint.strict or lint.thread_sentinel or lint.collective_sentinel:
            raise NotImplementedError(
                "lint.strict / thread_sentinel / collective_sentinel need the lint "
                f"package, which is not ported to determined_tpu_torch yet; {_LATER}"
            )
        self.config = config
        self.trial_cls = trial_cls
        self.device = resolve_device(device if device is not None or not devices
                                     else devices[0])
        # None = every visible CUDA device (or the one ``device`` names) at
        # run time
        self.devices = [torch.device(d) for d in devices] if devices is not None else None
        # None = follow config.lint.preflight (on by default)
        self.preflight = preflight
        # master session for registry promotion (config `registry:`); a
        # masterless run logs in to $DTPU_MASTER when promoting, or skips
        self._session = session
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "local_experiment_checkpoints"
        )
        self.seed = seed if seed is not None else config.reproducibility.experiment_seed
        self.searcher = JournaledSearcher(
            method_from_config(config.searcher, config.hyperparameters),
            config.hyperparameters,
            seed=self.seed,
        )
        self.results: Dict[int, TrialResult] = {}
        self.scheduler_stats: Optional[Dict[str, Any]] = None
        # rid -> the kernel launch counts a gang's chief relayed (its last
        # attempt)
        self.trial_launches: Dict[int, Dict[str, Any]] = {}
        self.journal: Optional[ExperimentJournal] = None
        self.status = "pending"  # pending|running|completed|preempted
        self._resume_checkpoints: Dict[int, Optional[str]] = {}
        # rid -> (storage_id, file_stats) of the resume point whose manifest
        # _verified_resume_checkpoint checked: handed to the trial's
        # checkpoint context, so the restore does not take a second md5
        self._resume_verdicts: Dict[int, Tuple[str, Dict[str, Tuple[int, int]]]] = {}
        self._journaled_ckpts: Dict[int, str] = {}
        # rid -> steps_completed at its clone point (PBT exploit): the
        # child's training budget is the generation length ON TOP of the
        # inherited steps, and a crash-resume must re-derive the same
        # horizon, so the value rides in the journal's trial_cloned record
        self._clone_base_steps: Dict[int, int] = {}
        # registry-promoted checkpoint uuids (journaled by the JAX package's
        # runner): pinned against the retention pass
        self._registry_pinned: Set[str] = set()
        # guards the checkpoint maps above: the GC thread iterates them
        self._ckpt_lock = threading.Lock()
        self._gc_thread: Optional[threading.Thread] = None
        # rid -> core Context.  COPY-ON-WRITE: writers rebind a fresh dict
        # under _active_lock; readers (the SIGTERM handler included, which
        # must not block on any lock) iterate the current binding
        self._active_trials: Dict[int, Any] = {}
        self._active_lock = threading.Lock()
        self._preempt = _PreemptFlag()
        self._prev_handlers: Dict[int, Any] = {}

    # -- single-trial execution -------------------------------------------

    def _trial_checkpoint_dir(self, request_id: int) -> str:
        """Per-trial namespace: a search's checkpoints stay attributable to
        their trial."""
        return os.path.join(self.checkpoint_dir, f"trial_{request_id}")

    def _traces_dir(self) -> str:
        return os.path.join(self.checkpoint_dir, "traces")

    def _run_trial(self, create: Create, devices: Optional[List[Any]] = None) -> TrialResult:
        """Train one trial on ``devices`` (its block; None: the experiment's
        device); report validations into the searcher as they happen.  A
        block of several devices runs the trial as a gang."""
        with get_tracer().span("trial.run", cat="trial", trial=create.request_id):
            if devices is not None and len(devices) > 1:
                return self._run_gang(create, devices)
            return self._run_trial_inner(create, devices[0] if devices else self.device)

    def _register(self, rid: int, ctx: Any) -> None:
        with self._active_lock:
            actives = dict(self._active_trials)
            actives[rid] = ctx
            self._active_trials = actives  # COW: readers never lock
        if self._preempt.is_set():
            # the drain request landed before this trial registered
            ctx.preempt.simulate()

    def _unregister(self, rid: int) -> None:
        with self._active_lock:
            actives = dict(self._active_trials)
            actives.pop(rid, None)
            self._active_trials = actives

    def _resume_point(self, create: Create) -> Tuple[Optional[str], Any]:
        """The checkpoint the trial resumes from (its journaled one, or a
        PBT parent's materialized into its namespace), and the manifest
        check already made of it, for the restore to reuse (None: none)."""
        rid = create.request_id
        with self._ckpt_lock:
            resume_ckpt = self._resume_checkpoints.get(rid)
            verdict = self._resume_verdicts.pop(rid, None)
        if verdict is not None and verdict[0] != resume_ckpt:
            verdict = None
        if resume_ckpt is None and create.source_trial_id is not None:
            # PBT exploit: materialize the parent's newest usable
            # checkpoint into this trial's namespace and resume from it
            resume_ckpt = self._materialize_clone(rid, create.source_trial_id)
        return resume_ckpt, verdict

    def _on_validation(self, rid: int, steps_completed: int, metrics: Dict[str, Any],
                       latest: Optional[str], progress: float) -> bool:
        """A trial's validation into the searcher; whether the searcher
        stopped the trial."""
        payload = dict(metrics)
        payload.setdefault(self.config.searcher.time_metric or "batches", steps_completed)
        self.searcher.on_validation(rid, payload)
        # WAL the newest FINALIZED checkpoint so a driver crash knows this
        # trial's resume point
        self._journal_trial_checkpoint(rid, latest)
        stopped = self.searcher.is_stopped(rid)
        self.searcher.set_trial_progress(rid, progress)
        return stopped

    def _fit_kwargs(self, max_length: Length) -> Dict[str, Any]:
        cfg = self.config
        validation_period = cfg.min_validation_period or Length.batches(
            max(1, (max_length.units if max_length.unit == "batches" else 100) // 4)
        )
        return dict(
            validation_period=validation_period,
            checkpoint_period=cfg.min_checkpoint_period,
            report_period=validation_period,
            checkpoint_policy=cfg.checkpoint_policy,
        )

    def _max_length(self, rid: int) -> Length:
        scfg = self.config.searcher
        max_length = scfg.max_length or Length.batches(scfg.max_time or 100)
        return self._clone_extended_length(max_length, rid)

    def _run_trial_inner(self, create: Create, device: torch.device) -> TrialResult:
        rid = create.request_id
        core_ctx = core._dummy_init(
            checkpoint_dir=self._trial_checkpoint_dir(rid),
            trace_dir=os.path.join(self._traces_dir(), "torch_profiler", f"trial_{rid}"),
        )
        orig_report = core_ctx.train.report_validation_metrics
        runner = self
        self._register(rid, core_ctx)
        resume_ckpt, verdict = self._resume_point(create)
        if verdict is not None:
            core_ctx.checkpoint.accept_verified(*verdict)
        max_length = self._max_length(rid)
        # the trial's CUDA calls go to its device on this thread alone
        on_device = (torch.cuda.device(device) if device.type == "cuda"
                     else contextlib.nullcontext())
        try:
            if self.journal is not None:
                self.journal.append(
                    "trial_running", rid=rid, devices=[str(device)],
                    resume_checkpoint=resume_ckpt,
                )
            with on_device:
                ctx = train_init(
                    hparams=create.hparams,
                    core_context=core_ctx,
                    exp_config=self.config,
                    seed=self.seed + rid,
                    device=device,
                )
                trial = self.trial_cls(ctx)
                trainer = Trainer(trial)

                def report_validation(steps_completed: int, metrics: Dict[str, Any]) -> None:
                    orig_report(steps_completed, metrics)
                    progress = min(steps_completed / runner._max_steps(trainer, max_length), 1.0)
                    if runner._on_validation(rid, steps_completed, metrics,
                                             trainer.latest_checkpoint, progress):
                        # cooperative stop through the preemption path
                        core_ctx.preempt.simulate()

                core_ctx.train.report_validation_metrics = report_validation
                summary = trainer.fit(
                    max_length, latest_checkpoint=resume_ckpt, **self._fit_kwargs(max_length)
                )
        finally:
            # the hook must not outlive the trial, and a failed build must
            # still close the context it was handed
            core_ctx.train.report_validation_metrics = orig_report
            core_ctx.close()
            self._unregister(rid)
        return self._trial_result(create, summary)

    def _run_gang(self, create: Create, devices: List[Any]) -> TrialResult:
        """The trial as a gang of rank processes on ``devices``, under the
        supervisor's restarts (``experiment/_gang.py``)."""
        rid = create.request_id
        cfg = self.config
        # a class the ranks cannot import fails here, before any process
        entrypoint = trial_entrypoint(self.trial_cls)
        if not cfg.raw:
            raise ValueError("a gang trial needs an ExperimentConfig made by parse/from_yaml "
                             "(its ranks parse the same raw configuration)")
        handle = _GangPreempt()
        self._register(rid, handle)
        try:
            resume_ckpt, verdict = self._resume_point(create)
            max_length = self._max_length(rid)
            names = [str(d) for d in devices]
            if self.journal is not None:
                self.journal.append("trial_running", rid=rid, devices=names,
                                    resume_checkpoint=resume_ckpt)
            spec = dict(
                entrypoint=entrypoint, config=cfg.raw, hparams=create.hparams,
                seed=self.seed + rid, checkpoint_dir=self._trial_checkpoint_dir(rid),
                trace_dir=os.path.join(self._traces_dir(), "torch_profiler", f"trial_{rid}"),
                # the resume point's manifest check, for every rank's restore
                # to reuse (the ranks see the same files)
                verdict=verdict,
            )
            gang = Gang(
                spec, names, os.path.join(self.checkpoint_dir, "gangs", f"trial_{rid}"),
                on_validation=lambda *a: self._on_validation(rid, *a),
                preempt_requested=lambda: handle.requested,
            )
            supervisor = TrialSupervisor(lambda: gang, policy=RestartPolicy.from_exp_config(cfg))
            try:
                summary = supervisor.run(max_length, latest_checkpoint=resume_ckpt,
                                         **self._fit_kwargs(max_length))
            finally:
                self.trial_launches[rid] = gang.launches
        finally:
            self._unregister(rid)
        return self._trial_result(create, summary)

    def _trial_result(self, create: Create, summary: Dict[str, Any]) -> TrialResult:
        """A trial's result from its fit summary; journaled unless the
        trial was drained for preemption."""
        rid = create.request_id
        preempted = bool(
            self._preempt.is_set() and summary["stopped_early"]
            and not self.searcher.is_stopped(rid)
        )
        result = TrialResult(
            request_id=rid,
            hparams=create.hparams,
            steps_completed=summary["steps_completed"],
            metrics=summary["validation_metrics"],
            checkpoint=summary["latest_checkpoint"],
            stopped_early=summary["stopped_early"],
            preempted=preempted,
        )
        # a drained trial's checkpoint is its resume point; a finished
        # trial's is its final one
        self._journal_trial_checkpoint(rid, result.checkpoint)
        if not preempted:
            with self._ckpt_lock:
                self._resume_checkpoints.pop(rid, None)
            if self.journal is not None:
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
        return result

    def _max_steps(self, trainer: Trainer, max_length: Length) -> int:
        """Optimizer-step horizon for progress reporting."""
        try:
            return trainer._to_batches(max_length) or 1
        except InvalidExperimentConfig:
            raise
        except (AttributeError, TypeError, ZeroDivisionError):
            return max(max_length.units, 1)

    # -- preflight ---------------------------------------------------------

    def _preflight_check(self) -> None:
        enabled = self.preflight if self.preflight is not None else self.config.lint.preflight
        if enabled:
            logger.warning(
                "preflight lint of %s skipped: the lint package is not ported to "
                "determined_tpu_torch yet (ROADMAP.md, Queue 1)",
                self.trial_cls.__qualname__,
            )

    # -- the search loop ---------------------------------------------------

    def _host_devices(self) -> List[torch.device]:
        """The devices trials run on: ``devices``, else every visible CUDA
        device (``device`` without an ordinal), else ``device`` alone."""
        if self.devices is not None:
            return list(self.devices)
        if self.device.type == "cuda" and self.device.index is None:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [self.device]

    def _slots_per_trial(self, n_devices: int) -> int:
        """Devices one trial's mesh occupies; a wildcard (-1) axis means
        'the whole host', which forces serial execution."""
        mesh_cfg = self.config.resources.mesh
        if -1 in mesh_cfg.sizes():
            return n_devices
        return mesh_cfg.num_devices

    def run(
        self,
        max_trials: Optional[int] = None,
        *,
        resume: bool = False,
    ) -> Dict[str, Any]:
        """Run the search to completion (or to a resumable preemption).

        Trials run concurrently on disjoint device blocks when
        ``searcher.max_concurrent_trials`` (> 1), the block size and the
        device count allow.  With ``fault_tolerance.journal`` (default on) every
        searcher event and trial transition is journaled under
        ``checkpoint_dir``; ``resume=True`` replays that journal instead of
        starting fresh.  SIGTERM/SIGINT (or ``request_preemption()``) drain
        the running trials to checkpoints and the summary comes back with
        ``status="preempted"`` (resumable).
        """
        self._preflight_check()
        # observability: spans are on by default (obs.enabled) at ~zero
        # hot-loop cost; the shipper thread drains the per-thread rings, and
        # trace export (obs.trace_export) also writes Chrome trace events
        # under checkpoint_dir/traces/ for Perfetto and `experiment profile`
        obs = self.config.observability
        tracer = get_tracer()
        # reset BEFORE configure opens the export file: reset's drain must
        # discard any stale pre-run events, not append them to this run's
        # events.jsonl (the ledger prefers the JSONL over trace.json)
        tracer.reset()
        tracer.configure(
            enabled=obs.enabled,
            ring_capacity=obs.ring_capacity,
            flush_interval=obs.flush_interval_s,
            max_events=obs.max_events,
            out_dir=self._traces_dir() if obs.enabled and obs.trace_export else None,
        )
        exp_t0 = None
        if obs.enabled:
            tracer.start()
            exp_t0 = time.monotonic()

        ft = self.config.fault_tolerance
        if ft.journal:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            self.journal = ExperimentJournal(
                journal_path(self.checkpoint_dir),
                compact_interval=ft.journal_compact_interval,
                on_compact=self._schedule_gc_retention if ft.gc_on_compaction else None,
            ).open(fresh=not resume)
            self.searcher.journal = self.journal
        try:
            if resume:
                self._load_resume_state()
            elif self.journal is not None:
                self.journal.append(
                    "experiment_started",
                    name=self.config.name,
                    entrypoint=f"{self.trial_cls.__module__}:{self.trial_cls.__qualname__}",
                    config=self.config.raw or None,
                    seed=self.seed,
                )
            devices = self._host_devices()
            slots = self._slots_per_trial(len(devices))
            if slots > len(devices):
                raise InvalidExperimentConfig(
                    f"resources.mesh wants {slots} devices per trial, "
                    f"only {len(devices)} visible"
                )
            limit = self.config.searcher.max_concurrent_trials
            if limit <= 0:
                # 0 = no explicit cap (the adaptive searcher's "auto" value):
                # bound by device capacity alone
                limit = len(devices)
            concurrency = min(limit, max(1, len(devices) // slots))

            self.status = "running"
            self._install_signal_handlers()
            try:
                if concurrency <= 1:
                    self._run_serial(max_trials, devices[:slots])
                else:
                    self._run_concurrent(max_trials, devices, slots, concurrency)
            finally:
                self._restore_signal_handlers()
            self.status = "preempted" if self._preempt.is_set() else "completed"
            if self.journal is not None:
                if self.status == "preempted":
                    with self._ckpt_lock:
                        in_flight = sorted(self._resume_checkpoints)
                    self.journal.append("experiment_preempted", in_flight=in_flight)
                else:
                    self.journal.append("experiment_completed")
            summary = self.summary()
            if self.status == "completed":
                self.on_search_complete(summary)
            return summary
        finally:
            gc_thread = self._gc_thread
            if gc_thread is not None:
                gc_thread.join(timeout=60)
            if self.journal is not None:
                self.searcher.journal = None
                self.journal.close()
            if exp_t0 is not None:
                tracer.record_span(
                    "experiment.run", "experiment", exp_t0, time.monotonic(),
                    {"name": self.config.name, "status": self.status},
                )
                tracer.stop()
                if obs.trace_export:
                    try:
                        ledger = export_experiment_trace(tracer, self._traces_dir())
                        logger.info(
                            "trace exported to %s (goodput: %.1f%% attributed, "
                            "%.1f%% productive)",
                            ledger.get("trace_path"),
                            ledger["experiment"]["attributed_pct"],
                            ledger["experiment"]["productive_pct"],
                        )
                    except Exception:  # noqa: BLE001 - export must not mask the run
                        logger.exception("trace export failed")
            # the drain thread stops and the export file closes with the run;
            # the drained events stay readable (chrome_events, counters)
            tracer.close()

    def resume(self, max_trials: Optional[int] = None) -> Dict[str, Any]:
        """Replay the experiment journal and continue the search."""
        return self.run(max_trials, resume=True)

    # -- preemption drain --------------------------------------------------

    def request_preemption(self) -> None:
        """Begin a graceful drain: the running trial's PreemptContext is
        flagged so its Trainer checkpoints and exits at the next boundary;
        no new trial starts; the run returns "preempted".  For callers on
        normal threads (tests, callbacks, embedding orchestrators); the
        signal handlers use ``_request_preemption_from_signal``."""
        if self._preempt.is_set():
            return
        logger.warning(
            "preemption requested: draining in-flight trials to checkpoints "
            "(deadline %.0fs)",
            self.config.fault_tolerance.preempt_drain_seconds,
        )
        self._flag_active_trials()

    def _request_preemption_from_signal(self) -> None:
        """Handler-safe drain trigger: flag writes and an ``os.write`` only
        (the logging lock is not reentrant)."""
        if self._preempt.is_set():
            return
        os.write(
            2,
            b"determined-tpu-torch: preemption signal received, draining in-flight "
            b"trials to checkpoints\n",
        )
        self._flag_active_trials()

    def _flag_active_trials(self) -> None:
        self._preempt.set()
        # COW snapshot: iterating the current binding needs no lock
        for ctx in list(self._active_trials.values()):
            ctx.preempt.simulate()

    def _install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain, chaining any prior handler.
        Main-thread only; callers on other threads use
        ``request_preemption``."""
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev = signal.getsignal(sig)

            def handler(signum: int, frame: Any, _prev: Any = prev) -> None:
                self._request_preemption_from_signal()
                # chain a real prior handler; never the default SIGINT
                # KeyboardInterrupt raiser, which would abort the drain
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
        """Rebuild searcher + results + resume points from the journal."""
        if self.journal is None:
            raise ExperimentJournalError("resume requires fault_tolerance.journal: true")
        replay = read_journal(journal_path(self.checkpoint_dir))
        if replay.searcher_state is not None:
            self.searcher.restore_json(json.dumps(replay.searcher_state))
        # redeliver events orphaned between their append and the follow-up
        # snapshot (at most the journal's final event)
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
        # completed trials are skipped, not re-run; a result whose searcher
        # exit event was lost in the crash gets the event redelivered
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
        # clone provenance: a resumed child's budget horizon must extend
        # past its inherited steps exactly as the original run's did
        for rid, clone in replay.clones.items():
            with self._ckpt_lock:
                self._clone_base_steps[rid] = int(clone.get("steps") or 0)
        with self._ckpt_lock:
            self._registry_pinned.update(
                reg["uuid"] for reg in replay.registered_models if reg.get("uuid")
            )
        # in-flight trials re-queue from their latest VERIFIED checkpoint
        # (manifest check + parent-lineage fallback); with no usable
        # checkpoint they restart from scratch
        for rid in replay.in_flight:
            sid = self._verified_resume_checkpoint(rid, replay.checkpoints.get(rid))
            if sid:
                with self._ckpt_lock:
                    self._resume_checkpoints[rid] = sid
                    self._journaled_ckpts[rid] = sid
        # a trial the searcher had STOPPED but whose exit event was lost
        # needs no re-training: its last reported state is its result
        scfg = self.config.searcher
        for rec in list(self.searcher.runnable_trials()):
            rid = rec.request_id
            if rid in self.results or not rec.stopped_by_searcher:
                continue
            metrics = dict(rec.metrics or {})
            steps = int(metrics.get(scfg.time_metric or "batches", 0) or 0)
            with self._ckpt_lock:
                ckpt = self._resume_checkpoints.pop(rid, None)
            result = TrialResult(
                request_id=rid, hparams=rec.hparams, steps_completed=steps,
                metrics=metrics, checkpoint=ckpt, stopped_early=True,
            )
            self.results[rid] = result
            if self.journal is not None:
                self.journal.append(
                    "trial_result",
                    rid=rid,
                    result={
                        "hparams": result.hparams,
                        "steps_completed": result.steps_completed,
                        "metrics": result.metrics,
                        "checkpoint": result.checkpoint,
                        "stopped_early": True,
                    },
                )
            self.searcher.on_trial_exited(rid)
        logger.info(
            "resume: %d completed trial(s) restored, %d in-flight re-queued "
            "(%d with verified checkpoints)",
            len(self.results),
            len([r for r in replay.in_flight if r not in self.results]),
            len(self._resume_checkpoints),
        )

    def _verified_resume_checkpoint(self, rid: int, sid: Optional[str]) -> Optional[str]:
        """Newest usable checkpoint in the trial's lineage, or None: walks
        parent pointers rejecting any checkpoint that fails manifest
        verification, then falls back to scanning the trial directory for
        the newest checkpoint that verifies."""
        trial_dir = self._trial_checkpoint_dir(rid)
        verify = self.config.fault_tolerance.verify_checkpoints
        tried: set = set()
        while sid and sid not in tried:
            tried.add(sid)
            path = os.path.join(trial_dir, sid)
            if os.path.isdir(path):
                if not verify or self._verify_resume_point(rid, sid, path):
                    return sid
            sid = self._checkpoint_parent(path)

        candidates = []
        if os.path.isdir(trial_dir):
            for uuid in os.listdir(trial_dir):
                path = os.path.join(trial_dir, uuid)
                if uuid in tried or not os.path.isdir(path):
                    continue
                try:
                    with open(os.path.join(path, "metadata.json")) as f:
                        steps = int(json.load(f).get("steps_completed") or 0)
                except (OSError, ValueError, TypeError):
                    continue
                candidates.append((steps, uuid, path))
        for steps, uuid, path in sorted(candidates, reverse=True):
            if not verify or self._verify_resume_point(rid, uuid, path):
                if verify:
                    logger.info(
                        "resume: trial %d using on-disk checkpoint %s (step %d) found "
                        "outside the journaled lineage", rid, uuid, steps,
                    )
                return uuid
        return None

    def _verify_resume_point(self, rid: int, sid: str, path: str) -> bool:
        """Whether the checkpoint at ``path`` passes manifest verification
        (a manifest required).  A pass is kept with the files' sizes and
        mtimes from before the check, for the trial's restore to reuse."""
        stats = core.file_stats(path)
        try:
            with get_tracer().span("checkpoint.verify", cat="restore", trial=rid, storage_id=sid):
                core.verify_manifest(path, require_manifest=True)
        except CheckpointCorruptError as e:
            logger.warning("resume: checkpoint %s of trial %d unusable (%s)", sid, rid, e)
            return False
        with self._ckpt_lock:
            self._resume_verdicts[rid] = (sid, stats)
        return True

    # -- PBT clone materialization -----------------------------------------

    def _clone_source_checkpoint(self, src_rid: int) -> Optional[str]:
        """The exploit parent's newest USABLE checkpoint uuid: its recorded
        result/journal checkpoint, walked through the manifest lineage the
        same way crash-resume walks it."""
        res = self.results.get(src_rid)
        sid = res.checkpoint if res is not None else None
        if sid is None:
            with self._ckpt_lock:
                sid = self._journaled_ckpts.get(src_rid)
        return self._verified_resume_checkpoint(src_rid, sid)

    def _materialize_clone(self, rid: int, src_rid: int) -> Optional[str]:
        """Copy the clone source's checkpoint into trial ``rid``'s namespace
        (same uuid) THROUGH the storage manager, and journal the provenance.
        Returns the uuid to resume from, or None (the child then starts from
        scratch, which is degraded but legal: a GC'd or corrupt parent must
        not kill the search)."""
        from determined_tpu_torch.storage import from_string

        with get_tracer().span("trial.clone", cat="searcher", trial=rid, source=src_rid):
            sid = self._clone_source_checkpoint(src_rid)
            if sid is None:
                logger.warning(
                    "trial %d: exploit source trial %d has no usable checkpoint; the "
                    "child starts from scratch", rid, src_rid,
                )
                return None
            dst = os.path.join(self._trial_checkpoint_dir(rid), sid)
            steps = 0
            try:
                manager = from_string(self.checkpoint_dir)
                with tempfile.TemporaryDirectory(prefix="dtt-clone-") as staging:
                    local = os.path.join(staging, sid)
                    if os.path.isdir(dst) and self._clone_dir_usable(dst):
                        local = dst  # already materialized (resume re-run)
                    else:
                        # a dir that exists but fails verification is a
                        # half-written copy from a crash mid-materialize:
                        # re-copy rather than resume the child from poison
                        if os.path.isdir(dst):
                            shutil.rmtree(dst, ignore_errors=True)
                        manager.download(f"trial_{src_rid}/{sid}", local)
                        manager.upload(local, f"trial_{rid}/{sid}")
                    try:
                        with open(os.path.join(local, "metadata.json")) as f:
                            steps = int(json.load(f).get("steps_completed") or 0)
                    except (OSError, ValueError, TypeError):
                        steps = 0
            except Exception:  # noqa: BLE001 - degrade to fresh init
                logger.exception(
                    "trial %d: failed to materialize clone of trial %d checkpoint %s; the "
                    "child starts from scratch", rid, src_rid, sid,
                )
                return None
            with self._ckpt_lock:
                self._clone_base_steps[rid] = steps
                already = self._journaled_ckpts.get(rid) == sid
                self._journaled_ckpts[rid] = sid
            if self.journal is not None and not already:
                self.journal.append("trial_cloned", rid=rid, source=src_rid, uuid=sid, steps=steps)
            get_tracer().counter("searcher.clones_materialized", 1.0)
            logger.info(
                "trial %d: cloned from trial %d checkpoint %s (step %d)", rid, src_rid, sid, steps,
            )
            return sid

    def _clone_dir_usable(self, path: str) -> bool:
        """Manifest-verify an already-materialized clone, same contract as
        the resume paths (a crash mid-copy leaves a manifest-less or
        digest-failing dir)."""
        if not self.config.fault_tolerance.verify_checkpoints:
            return True
        try:
            core.verify_manifest(path, require_manifest=True)
            return True
        except CheckpointCorruptError as e:
            logger.warning("clone at %s unusable (%s); re-copying", path, e)
            return False

    def _clone_extended_length(self, max_length: Length, rid: int) -> Length:
        with self._ckpt_lock:
            base = self._clone_base_steps.get(rid)
        return clone_extended_length(max_length, base or 0, logger, context=f"trial {rid}: ")

    @staticmethod
    def _checkpoint_parent(path: str) -> Optional[str]:
        from determined_tpu_torch.core._checkpoint import MANIFEST_FILE, METADATA_FILE

        for name, key in ((MANIFEST_FILE, "parent"), (METADATA_FILE, "parent_storage_id")):
            try:
                with open(os.path.join(path, name)) as f:
                    parent = json.load(f).get(key)
                if parent:
                    return parent
            except (OSError, ValueError):
                continue
        return None

    # -- journal helpers ---------------------------------------------------

    def _journal_trial_checkpoint(self, rid: int, sid: Optional[str]) -> None:
        if not sid:
            return
        with self._ckpt_lock:
            if self._journaled_ckpts.get(rid) == sid:
                return
            self._journaled_ckpts[rid] = sid
        if self.journal is not None:
            self.journal.append("trial_checkpoint", rid=rid, uuid=sid)

    def _schedule_gc_retention(self) -> None:
        """Journal on_compact hook: the retention pass runs on its own
        short-lived thread (seconds of file I/O must not stall searcher
        calls); a pass still running is not doubled up."""
        t = self._gc_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._apply_gc_retention, name="dtt-exp-gc", daemon=True)
        self._gc_thread = t
        t.start()

    def _apply_gc_retention(self) -> None:
        """Keep latest-per-trial + top-k by searcher metric; parents of kept
        checkpoints, journaled resume points, and manifest-less (possibly
        mid-write) directories are never deleted."""
        try:
            if self.config.checkpoint_policy == "none":
                return
            from determined_tpu_torch.exec import gc_checkpoints

            scfg = self.config.searcher
            store = self.config.checkpoint_storage
            metric_by_trial: Dict[int, float] = {}
            for rec in self.searcher.trial_records():
                val = (rec.metrics or {}).get(scfg.metric)
                if isinstance(val, (int, float)):
                    metric_by_trial[rec.request_id] = float(val)
            with self._ckpt_lock:
                protected = set(self._journaled_ckpts.values()) | self._registry_pinned
            outcome = gc_checkpoints.apply_retention(
                self.checkpoint_dir,
                policy=gc_checkpoints.RetentionPolicy(
                    keep_trial_latest=max(store.save_trial_latest, 1),
                    keep_experiment_best=store.save_experiment_best,
                    smaller_is_better=scfg.smaller_is_better,
                ),
                metric_by_trial=metric_by_trial,
                protected=protected,
                protected_trials=set(self.searcher.clone_source_trials()),
            )
            if outcome["deleted"]:
                logger.info(
                    "checkpoint gc: deleted %d, kept %d",
                    len(outcome["deleted"]), len(outcome["kept"]),
                )
        except Exception:  # noqa: BLE001 - GC must never kill the search
            logger.exception("checkpoint gc pass failed")

    def _run_serial(self, max_trials: Optional[int], block: List[Any]) -> None:
        """Sequential execution in the reference event order, every trial on
        ``block``."""
        self.searcher.start()
        executed = 0
        while self.searcher.shutdown is None and not self._preempt.is_set():
            pending = [
                t for t in self.searcher.runnable_trials() if t.request_id not in self.results
            ]
            if not pending:
                break
            rec = min(pending, key=lambda t: t.request_id)
            if max_trials is not None and executed >= max_trials:
                break
            logger.info("trial %d starting with hparams %s", rec.request_id, rec.hparams)
            result = self._run_trial(Create(rec.request_id, rec.hparams, rec.source_trial_id),
                                     block)
            if result.preempted:
                # drained, not done: the trial stays in flight, its
                # checkpoint (None if no boundary was reached) is the
                # resume point
                with self._ckpt_lock:
                    self._resume_checkpoints[rec.request_id] = result.checkpoint
                break
            self.results[rec.request_id] = result
            executed += 1
            self.searcher.on_trial_exited(rec.request_id)

    def _run_concurrent(self, max_trials: Optional[int], devices: List[Any], slots: int,
                        concurrency: int) -> None:
        from determined_tpu_torch.experiment.scheduler import SlotPool, TrialScheduler

        logger.info(
            "concurrent search: %d devices / %d per trial -> up to %d trials in parallel",
            len(devices), slots, concurrency,
        )
        scheduler = TrialScheduler(
            self.searcher,
            SlotPool(devices),
            self._run_trial,
            slots_per_trial=slots,
            max_concurrent=concurrency,
            stop_event=self._preempt,
            drain_timeout=self.config.fault_tolerance.preempt_drain_seconds,
        )
        outcome = scheduler.run(max_trials=max_trials)
        self.results.update(outcome.results)
        self.scheduler_stats = outcome.stats
        with self._ckpt_lock:
            for rid, res in outcome.preempted.items():
                if res is not None:
                    self._resume_checkpoints[rid] = res.checkpoint
        if outcome.errors:
            rid, exc = outcome.errors[0]
            # the original exception type, as on the serial path
            logger.error("trial %d failed during concurrent search", rid)
            raise exc

    # -- registry promotion ------------------------------------------------

    def on_search_complete(self, summary: Dict[str, Any]) -> None:
        """End-of-search hook: with ``registry: {model, auto_promote}``
        configured, register the best trial's final manifest-verified
        checkpoint as the model's next version (``name@vN``) with lineage
        back to this trial.  Promotion failure must not fail a finished
        search — it lands in ``summary["registry_error"]`` and the logs,
        never as an exception; success lands in ``summary["registry"]``
        and a ``model_registered`` journal record that pins the promoted
        checkpoint against the retention pass (also across resume)."""
        rcfg = self.config.registry
        if not (rcfg.model and rcfg.auto_promote):
            return
        from determined_tpu_torch.experiment import registry as registry_mod

        def report(msg: str) -> None:
            summary["registry_error"] = msg
            logger.warning("registry: %s", msg)

        try:
            session = registry_mod.registry_session(self._session)
            if session is None:
                return report(
                    "registry.auto_promote set but no master configured "
                    "(pass session= or set DTPU_MASTER)"
                )
            best_rid = summary.get("best_trial")
            if best_rid is None:
                return report("search produced no best trial to promote")
            result = self.results[best_rid]
            sid = self._verified_resume_checkpoint(best_rid, result.checkpoint)
            if sid is None:
                return report(
                    f"best trial {best_rid} has no manifest-verified checkpoint"
                )
            promoted = registry_mod.promote_search_winner(
                session,
                model=rcfg.model,
                labels=rcfg.labels,
                checkpoint_uuid=sid,
                storage_path=os.path.abspath(
                    os.path.join(self._trial_checkpoint_dir(best_rid), sid)
                ),
                source_trial_id=best_rid,
                metrics=dict(result.metrics or {}),
            )
            summary["registry"] = promoted
            with self._ckpt_lock:
                self._registry_pinned.add(sid)
            if self.journal is not None:
                self.journal.append(
                    "model_registered",
                    name=promoted["model"],
                    version=promoted["version"],
                    uuid=sid,
                )
        except Exception as e:  # noqa: BLE001 - promotion must not kill the run
            logger.exception("registry: auto-promotion failed")
            summary["registry_error"] = str(e)

    def summary(self) -> Dict[str, Any]:
        scfg = self.config.searcher
        best: Optional[TrialResult] = None
        for r in self.results.values():
            val = (r.metrics or {}).get(scfg.metric)
            if val is None:
                continue
            if best is None:
                best = r
                continue
            bval = best.metrics.get(scfg.metric)
            if (val < bval) == scfg.smaller_is_better:
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
        }
        if self.status == "preempted":
            with self._ckpt_lock:
                out["in_flight"] = sorted(self._resume_checkpoints)
        return out
