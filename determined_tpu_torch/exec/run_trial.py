"""Supervised trial execution: ``TrialSupervisor`` of
``determined_tpu/exec/run_trial.py``.

The rest of that module (the cluster trial process: environment, rendezvous,
log shipping, TLS, the master's exit report) comes with the cluster slice of
the port.
"""

from __future__ import annotations

import logging
import time

from determined_tpu_torch.train._restart import RestartPolicy, run_with_restarts

logger = logging.getLogger("determined_tpu_torch.exec.supervisor")


class TrialSupervisor:
    """Supervised trial execution: one attempt = one fresh ``Trainer``
    driven through ``fit``; failures are classified (``utils/errors.py``)
    and TRANSIENT ones re-enter ``fit(latest_checkpoint=...)`` from the
    newest FINALIZED checkpoint with exponential backoff, up to the
    experiment's ``max_restarts``.

    Restart counts go to ``metrics`` (an object with ``report(group,
    steps_completed, metrics)``, group ``restarts``) when one is given.
    """

    def __init__(
        self,
        trainer_factory,
        *,
        policy=None,
        metrics=None,
        master_unreachable=None,
        sleep=None,
    ) -> None:
        self._trainer_factory = trainer_factory
        self._policy = policy
        self._metrics = metrics
        self._master_unreachable = master_unreachable
        self._sleep = sleep
        self._trainer = None
        self.restarts = 0

    def run(self, max_length, *, latest_checkpoint=None, **fit_kwargs):
        policy = self._policy or RestartPolicy()

        def attempt(latest):
            self._trainer = self._trainer_factory()
            return self._trainer.fit(
                max_length, latest_checkpoint=latest, **fit_kwargs
            )

        def get_latest_checkpoint():
            return self._trainer.latest_checkpoint if self._trainer is not None else None

        def on_failure(att) -> None:
            self.restarts = att.restarts
            unreachable = bool(self._master_unreachable and self._master_unreachable())
            if unreachable:
                logger.warning(
                    "master unreachable (heartbeat streak latched) while handling "
                    "trial failure; restart decisions proceed locally"
                )
            if self._metrics is not None:
                steps = self._trainer.steps_completed if self._trainer is not None else 0
                try:
                    self._metrics.report(
                        "restarts",
                        steps,
                        {
                            "restarts": att.restarts,
                            "failure_kind": att.kind.value,
                            "error": repr(att.exc),
                            "resume_checkpoint": att.latest_checkpoint,
                            "backoff_seconds": att.delay,
                            "master_unreachable": unreachable,
                        },
                    )
                except Exception:  # noqa: BLE001 - reporting must not mask the failure
                    logger.exception("failed to report restart metrics")

        return run_with_restarts(
            attempt,
            policy=policy,
            initial_checkpoint=latest_checkpoint,
            get_latest_checkpoint=get_latest_checkpoint,
            on_failure=on_failure,
            sleep=self._sleep or time.sleep,
        )
