"""Concurrent trial scheduler: gang slot allocation and packed execution.

A copy of ``determined_tpu/experiment/scheduler.py`` over the host's CUDA
devices (``torch.device("cuda", i)``), the single-host analog of the
master's fair-share allocator, which gang-assigns ``slots_per_trial``
slots so many trials run at once:

- ``SlotPool`` carves the host's device list into per-trial blocks.
  Allocation is gang (all-or-nothing), contiguous, and aligned to the gang
  size where the pool divides evenly; freed blocks are reused LIFO, so a
  backfilled trial lands on devices whose kernels are already loaded.
- ``TrialScheduler`` drives the ``Searcher`` event loop: it dispatches
  queued ``Create``s onto free blocks up to ``max_concurrent`` (the
  ``searcher.max_concurrent_trials`` knob), runs each trial body on its
  own thread (a one-device trial trains on that thread; a gang's thread
  supervises its rank processes, ``experiment/_gang.py``), releases the
  block the moment a trial exits, ASHA stops included, and backfills from
  the searcher's pending creates.  A trial error stops dispatch and drains
  the running trials (fail-fast); ``stop_event`` drains for preemption
  within ``drain_timeout``.

The tracer's spans and the outcome's ``stats`` keep the JAX names
(``slot.wait``, ``slot.backfill``, ``scheduler.gangs_busy``).  The
scheduler is generic over ``run_trial``: ``LocalExperiment._run_trial``
in production, synthetic trial bodies in the tests.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.searcher import Create, ExitedReason

logger = logging.getLogger("determined_tpu_torch.experiment.scheduler")


@dataclasses.dataclass(frozen=True)
class SlotAllocation:
    """A gang of devices granted to one trial."""

    request_id: int
    offset: int
    devices: Tuple[Any, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


class SlotPool:
    """Gang allocator over an ordered device list.

    Thread-safe.  ``acquire`` returns a contiguous, aligned block or None
    (never a partial gang); ``release`` returns the block and records it for
    LIFO reuse.  Oversubscription is a hard invariant: granting a device
    that is already in use raises instead of corrupting two trials.
    """

    def __init__(self, devices: Sequence[Any]) -> None:
        if not devices:
            raise ValueError("SlotPool needs at least one device")
        self._devices = tuple(devices)
        self._in_use = [False] * len(self._devices)
        self._allocations: Dict[int, SlotAllocation] = {}
        self._recent_offsets: List[int] = []  # released blocks, newest last
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return len(self._devices)

    @property
    def slots_in_use(self) -> int:
        with self._lock:
            return sum(self._in_use)

    @property
    def allocations(self) -> Dict[int, SlotAllocation]:
        with self._lock:
            return dict(self._allocations)

    def _block_free(self, offset: int, slots: int) -> bool:
        return offset + slots <= len(self._devices) and not any(
            self._in_use[offset : offset + slots]
        )

    def acquire(self, request_id: int, slots: int) -> Optional[SlotAllocation]:
        if slots < 1:
            raise ValueError(f"gang size must be >= 1, got {slots}")
        if slots > len(self._devices):
            raise ValueError(
                f"gang of {slots} slots can never fit in a pool of {len(self._devices)}"
            )
        with self._lock:
            if request_id in self._allocations:
                raise RuntimeError(f"trial {request_id} already holds an allocation")
            # offsets stay multiples of the gang size when the pool divides
            # evenly: blocks then tile the device order exactly and a mixed
            # acquire/release history cannot fragment the pool
            align = slots if len(self._devices) % slots == 0 else 1
            offset: Optional[int] = None
            # affinity first: the newest released block of this size
            for recent in reversed(self._recent_offsets):
                if recent % align == 0 and self._block_free(recent, slots):
                    offset = recent
                    break
            if offset is None:
                for cand in range(0, len(self._devices) - slots + 1, align):
                    if self._block_free(cand, slots):
                        offset = cand
                        break
            if offset is None:
                return None
            for i in range(offset, offset + slots):
                if self._in_use[i]:  # invariant, not reachable via _block_free
                    raise RuntimeError(f"device slot {i} is already allocated")
                self._in_use[i] = True
            alloc = SlotAllocation(
                request_id, offset, self._devices[offset : offset + slots]
            )
            self._allocations[request_id] = alloc
            return alloc

    def release(self, alloc: SlotAllocation) -> None:
        with self._lock:
            held = self._allocations.pop(alloc.request_id, None)
            if held is not alloc:
                raise RuntimeError(
                    f"release of allocation not held: trial {alloc.request_id}"
                )
            for i in range(alloc.offset, alloc.offset + alloc.size):
                if not self._in_use[i]:
                    raise RuntimeError(f"double release of device slot {i}")
                self._in_use[i] = False
            self._recent_offsets = [
                o for o in self._recent_offsets if o != alloc.offset
            ] + [alloc.offset]


@dataclasses.dataclass
class SchedulerOutcome:
    """What a scheduler run produced: per-trial results, errors, counters."""

    results: Dict[int, Any]
    errors: List[Tuple[int, BaseException]]
    stats: Dict[str, Any]
    # trials that exited because the experiment is draining for preemption:
    # rid -> the (partial) result carrying the resume checkpoint.  Never in
    # ``results`` — they are unfinished work, not outcomes.
    preempted: Dict[int, Any] = dataclasses.field(default_factory=dict)


class TrialScheduler:
    """Drives a Searcher's Create stream onto a SlotPool.

    One dispatcher loop (the calling thread) owns all searcher lifecycle
    events except ``on_validation``/``set_trial_progress``, which trial
    threads fire mid-run (the ``Searcher`` serializes internally).  Trial
    bodies run on worker threads; completion flows back over a queue so
    slot release, the searcher exit event, and backfill dispatch happen in
    one place, in order.

    On a trial error the scheduler stops dispatching, drains the running
    trials, and surfaces the error in the outcome — matching the serial
    runner's fail-fast semantics without abandoning in-flight work.
    """

    def __init__(
        self,
        searcher: Any,
        pool: SlotPool,
        run_trial: Callable[[Create, List[Any]], Any],
        *,
        slots_per_trial: int,
        max_concurrent: int,
        poll_interval: float = 0.05,
        stop_event: Optional[threading.Event] = None,
        drain_timeout: Optional[float] = None,
    ) -> None:
        if slots_per_trial < 1:
            raise ValueError("slots_per_trial must be >= 1")
        if pool.capacity // slots_per_trial < 1:
            raise ValueError(
                f"slots_per_trial={slots_per_trial} exceeds pool capacity "
                f"{pool.capacity}: no gang can ever be placed"
            )
        self.searcher = searcher
        self.pool = pool
        self.run_trial = run_trial
        self.slots_per_trial = slots_per_trial
        self.max_concurrent = max(
            1, min(max_concurrent, pool.capacity // slots_per_trial)
        )
        self.poll_interval = poll_interval
        # graceful preemption: when ``stop_event`` is set, dispatch halts
        # and the scheduler waits up to ``drain_timeout`` seconds for the
        # running trials to checkpoint-and-exit before abandoning them
        self.stop_event = stop_event
        self.drain_timeout = drain_timeout
        self.results: Dict[int, Any] = {}
        self.errors: List[Tuple[int, BaseException]] = []
        self.preempted: Dict[int, Any] = {}
        self._errored: set = set()
        self._done: "queue.Queue[int]" = queue.Queue()

    def _stopping(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()

    # -- worker ------------------------------------------------------------

    def _worker(self, create: Create, alloc: SlotAllocation) -> None:
        # Lock-free by design: each worker writes only ITS request_id's
        # slots of results/_errored/errors (GIL-atomic container ops), and
        # the dispatcher reads them only after `_done.get()` + `join()` on
        # this thread — the queue handoff establishes the happens-before.
        try:
          
            self.results[create.request_id] = self.run_trial(
                create, list(alloc.devices)
            )
        except BaseException as e:  # noqa: BLE001 - surfaced by the dispatcher
            self._errored.add(create.request_id)
            self.errors.append((create.request_id, e))
            logger.exception("trial %d failed", create.request_id)
        finally:
            self._done.put(create.request_id)

    # -- dispatcher --------------------------------------------------------

    def _dispatchable(self, scheduled: set) -> List[Any]:
        """Searcher trials ready to start, in request-id order (determinism:
        backfill picks the oldest pending create first, like the reference
        scheduler's queue position)."""
        recs = [
            t
            for t in self.searcher.runnable_trials()
            if t.request_id not in scheduled
        ]
        return sorted(recs, key=lambda t: t.request_id)

    def run(self, max_trials: Optional[int] = None) -> SchedulerOutcome:
        self.searcher.start()
        running: Dict[int, Tuple[threading.Thread, SlotAllocation]] = {}
        scheduled: set = set()
        launched = 0
        completed = 0
        backfills = 0
        peak_concurrency = 0
        abandoned: List[int] = []
        drain_deadline: Optional[float] = None
        t0 = time.monotonic()
        tracer = get_tracer()
        # when each pending create was first seen runnable: the gap to its
        # slot acquire is the "slot.wait" span (scheduling delay, not
        # attributed to the trial's own wall-clock — args use rid, not
        # trial, so the goodput ledger keeps it on the dispatcher track)
        first_runnable: Dict[int, float] = {}

        def absorb_completion(rid: int) -> None:
            nonlocal completed
            thread, alloc = running.pop(rid)
            thread.join()
            # release BEFORE the searcher exit event: replacement creates
            # the event produces can immediately take the freed block
            self.pool.release(alloc)
            tracer.gauge("scheduler.gangs_busy", float(len(running)))
            completed += 1
            if rid in self._errored:
                self.searcher.on_trial_exited_early(rid, ExitedReason.ERRORED)
            elif getattr(self.results.get(rid), "preempted", False):
                # drained for preemption, not finished: no searcher exit
                # event (the trial is still logically in-flight and resumes
                # next run); move it out of results.  Safe unlocked: the
                # worker wrote results[rid] before `_done.put`, and this
                # pop runs only after `_done.get()` + `join()` on that
                # thread — the queue handoff is the happens-before.
                self.preempted[rid] = self.results.pop(rid)
            else:
                self.searcher.on_trial_exited(rid)

        while True:
            if self._stopping() and drain_deadline is None and self.drain_timeout is not None:
                drain_deadline = time.monotonic() + self.drain_timeout
            # ---- dispatch: fill every free gang slot -----------------------
            dispatch_blocked = False
            if not self.errors and self.searcher.shutdown is None and not self._stopping():
                for rec in self._dispatchable(scheduled):
                    first_runnable.setdefault(rec.request_id, time.monotonic())
                    if len(running) >= self.max_concurrent:
                        break
                    if max_trials is not None and launched >= max_trials:
                        break
                    alloc = self.pool.acquire(rec.request_id, self.slots_per_trial)
                    if alloc is None:
                        dispatch_blocked = True
                        break
                    waited_since = first_runnable.pop(rec.request_id, None)
                    if waited_since is not None:
                        tracer.record_span(
                            "slot.wait",
                            "scheduler",
                            waited_since,
                            time.monotonic(),
                            {"rid": rec.request_id},
                        )
                    if completed:
                        tracer.instant(
                            "slot.backfill", "scheduler", rid=rec.request_id
                        )
                    create = Create(
                        rec.request_id, rec.hparams, rec.source_trial_id
                    )
                    thread = threading.Thread(
                        target=self._worker,
                        args=(create, alloc),
                        name=f"dtpu-trial-{rec.request_id}",
                        daemon=True,
                    )
                    scheduled.add(rec.request_id)
                    running[rec.request_id] = (thread, alloc)
                    launched += 1
                    if completed:
                        # "backfill" = a launch into capacity freed by an
                        # earlier exit (ASHA stops and natural completions
                        # alike), as opposed to the initial fill
                        backfills += 1
                    peak_concurrency = max(peak_concurrency, len(running))
                    tracer.gauge("scheduler.gangs_busy", float(len(running)))
                    logger.info(
                        "trial %d starting on devices %s (%d/%d gangs busy)",
                        rec.request_id,
                        [str(d) for d in alloc.devices],
                        len(running),
                        self.max_concurrent,
                    )
                    thread.start()

            if not running:
                if dispatch_blocked:
                    # free pool, nothing running, yet no block found: the
                    # pool is fragmented beyond repair (cannot happen with
                    # aligned fixed-size gangs, but fail loudly over hanging)
                    raise RuntimeError(
                        "scheduler stalled: pending trials but no placeable gang"
                    )
                break

            if drain_deadline is not None and time.monotonic() >= drain_deadline:
                # absorb completions already sitting in the queue before
                # declaring abandonment — a trial that finished but wasn't
                # popped yet is done, not abandoned, and its (possibly
                # preempted) result must be classified normally
                while True:
                    try:
                        absorb_completion(self._done.get_nowait())
                    except queue.Empty:
                        break
                if not running:
                    break
                # drain deadline blown: abandon what's still running (the
                # worker threads are daemons) and surface which trials lost
                # their checkpoint-on-preempt window
                abandoned = sorted(running)
                logger.warning(
                    "preemption drain deadline exceeded; abandoning trials %s",
                    abandoned,
                )
                break

            # ---- wait for a completion (short poll so creates that arrive
            # mid-validation while a gang sits free still dispatch promptly)
            try:
                rid = self._done.get(timeout=self.poll_interval)
            except queue.Empty:
                continue
            absorb_completion(rid)

        return SchedulerOutcome(
            results=self.results,
            errors=self.errors,
            preempted=self.preempted,
            stats={
                "launched": launched,
                "completed": completed,
                "backfills": backfills,
                "peak_concurrency": peak_concurrency,
                "max_concurrent": self.max_concurrent,
                "slots_per_trial": self.slots_per_trial,
                "pool_capacity": self.pool.capacity,
                "preempted": len(self.preempted),
                "abandoned": abandoned,
                "wall_clock_s": time.monotonic() - t0,
            },
        )
