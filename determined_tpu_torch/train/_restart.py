"""Supervised restart-from-checkpoint: a copy of
``determined_tpu/train/_restart.py``.

Classify the failure (``utils/errors.py`` taxonomy), back off exponentially
with jitter, and re-enter ``Trainer.fit(latest_checkpoint=...)`` from the
last checkpoint whose integrity manifest verified, up to ``max_restarts``
times.  ``exec/run_trial.py TrialSupervisor`` binds the loop to a trial.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable, Dict, Optional

from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.utils.errors import (
    FailureKind,
    RestartBudgetExhaustedError,
    classify_failure,
)

logger = logging.getLogger("determined_tpu_torch.train.restart")


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How many restarts, and how fast — from the experiment config
    (``max_restarts`` + the ``fault_tolerance`` section)."""

    max_restarts: int = 5
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    jitter: float = 0.25

    @classmethod
    def from_exp_config(cls, exp_config: Optional[Any]) -> "RestartPolicy":
        if exp_config is None:
            return cls()
        ft = getattr(exp_config, "fault_tolerance", None)
        if ft is None:
            return cls(max_restarts=exp_config.max_restarts)
        return cls(
            max_restarts=exp_config.max_restarts,
            backoff_base=ft.restart_backoff_base,
            backoff_cap=ft.restart_backoff_cap,
            jitter=ft.restart_backoff_jitter,
        )

    def delay(self, restarts: int, rng: Optional[random.Random] = None) -> float:
        """Exponential backoff with jitter: base * 2^n, capped, +/- jitter.
        ``restarts`` is the number of restarts already taken (0 before the
        first)."""
        raw = min(self.backoff_base * (2 ** restarts), self.backoff_cap)
        if self.jitter and raw > 0:
            r = rng or random
            raw *= 1 + r.uniform(-self.jitter, self.jitter)
        return max(raw, 0.0)


@dataclasses.dataclass
class Attempt:
    """What the supervisor learned from one failed attempt."""

    restarts: int                       # restarts taken so far (incl. this one)
    kind: FailureKind
    exc: BaseException
    latest_checkpoint: Optional[str]    # resume point for the next attempt
    delay: float                        # backoff the supervisor will sleep


def run_with_restarts(
    attempt: Callable[[Optional[str]], Dict[str, Any]],
    *,
    policy: RestartPolicy,
    initial_checkpoint: Optional[str] = None,
    get_latest_checkpoint: Optional[Callable[[], Optional[str]]] = None,
    on_failure: Optional[Callable[[Attempt], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict[str, Any]:
    """Run ``attempt(latest_checkpoint)`` until it returns, restarting on
    TRANSIENT failures up to ``policy.max_restarts`` times.

    - ``attempt`` returns a fit-style summary dict on success (including a
      clean preemption exit, which is not a failure).
    - ``get_latest_checkpoint`` is polled after every failure to learn the
      newest durable checkpoint the dead attempt left behind (e.g.
      ``trainer.latest_checkpoint`` — finalized saves only; an async save
      that never drained does not count and cannot poison the resume).
    - ``on_failure`` observes every classified failure (metrics/logging).

    PREEMPTED failures return a synthetic ``stopped_early`` summary — the
    scheduler owns re-placement, not this loop.  FATAL failures re-raise.
    Budget exhaustion raises ``RestartBudgetExhaustedError`` (itself
    FATAL) chained to the last transient failure.
    """
    restarts = 0
    latest = initial_checkpoint
    while True:
        try:
            summary = attempt(latest)
            summary.setdefault("restarts", restarts)
            return summary
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - classified below
            if get_latest_checkpoint is not None:
                latest = get_latest_checkpoint() or latest
            kind = classify_failure(e)
            if kind == FailureKind.PREEMPTED:
                logger.info("trial preempted (%s); exiting for rescheduling", e)
                if on_failure is not None:
                    on_failure(Attempt(restarts, kind, e, latest, 0.0))
                return {
                    "stopped_early": True,
                    "restarts": restarts,
                    "latest_checkpoint": latest,
                    "preempted": True,
                }
            if kind == FailureKind.FATAL:
                logger.error("fatal trial failure (no restart): %r", e)
                if on_failure is not None:
                    on_failure(Attempt(restarts, kind, e, latest, 0.0))
                raise
            if restarts >= policy.max_restarts:
                exhausted = RestartBudgetExhaustedError(
                    f"trial failed {restarts + 1} times "
                    f"(max_restarts={policy.max_restarts}); last error: {e!r}"
                )
                if on_failure is not None:
                    on_failure(Attempt(restarts, FailureKind.FATAL, exhausted, latest, 0.0))
                raise exhausted from e
            delay = policy.delay(restarts)
            restarts += 1
            logger.warning(
                "transient trial failure (restart %d/%d in %.1fs, resume=%s): %r",
                restarts,
                policy.max_restarts,
                delay,
                latest or "<from scratch>",
                e,
            )
            if on_failure is not None:
                on_failure(Attempt(restarts, kind, e, latest, delay))
            # supervisor spans: the failure marker + the backoff sleep are
            # restart-recovery time in the goodput ledger (the re-setup and
            # checkpoint-restore of the next attempt land in their own
            # setup/restore buckets)
            tracer = get_tracer()
            tracer.instant("trial.failure", "restart", kind=kind.value, restarts=restarts)
            if delay > 0:
                with tracer.span("restart.backoff", cat="restart", restarts=restarts):
                    sleep(delay)
