"""Trainer: the boundary-driven training loop.

Port of ``determined_tpu/train/_trainer.py`` (``init``, ``Trainer``,
``_BoundarySchedule``) for one device.  The same contract: ``fit(max_length,
periods)`` with TRAIN/VALIDATE/REPORT boundaries, callbacks, the
``train.step`` fault site and the preemption check at each boundary.  The
step is eager PyTorch where the JAX package jits one: forward, ``backward()``,
the optimizer's ``apply_step`` (the fused AdamW kernel on CUDA), the ``lr``
metric and the on-device metric sums.  The hot loop never waits for the
device; metrics are fetched once per REPORT boundary.

Not in this slice of the port (each raises ``NotImplementedError``):
checkpoint save and restore (``fit`` takes ``checkpoint_policy="none"`` and
no ``latest_checkpoint``), and the experiment configuration (``exp_config``,
hence ``aggregation_frequency`` > 1, the input, overlap, quantisation and
pipeline knobs and the jit-reuse cache).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.config.experiment import Length
from determined_tpu_torch.data._prefetch import EpochFeed, InputPipeline
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.train._reducer import MEAN, get_reducer
from determined_tpu_torch.train._state import TrainState
from determined_tpu_torch.train._trial import Callback, TorchTrial, TrialContext
from determined_tpu_torch.utils import faults

logger = logging.getLogger("determined_tpu_torch.train")

_LATER = "it comes with a later slice of the port (ROADMAP.md, Queue 1)"


def init(
    *,
    hparams: Optional[Dict[str, Any]] = None,
    exp_config: Optional[Any] = None,
    core_context: Optional[Any] = None,
    seed: Optional[int] = None,
    device: DeviceLike = None,
) -> TrialContext:
    """Build a TrialContext on ``device`` (CUDA unless named; raises without
    a GPU).  Off-cluster the core services are ``core._dummy_init()``."""
    if exp_config is not None:
        raise NotImplementedError(
            f"exp_config is not ported to determined_tpu_torch yet; {_LATER}"
        )
    dev = resolve_device(device)
    core = core_context or core_mod._dummy_init()
    return TrialContext(core=core, device=dev, hparams=hparams, seed=seed or 0)


class _BoundarySchedule:
    """Next-boundary arithmetic over a step counter (host-side ints only)."""

    def __init__(self, period: Optional[int], max_steps: int) -> None:
        self.period = period if period and period > 0 else None
        self.max_steps = max_steps

    def next_after(self, step: int) -> int:
        if self.period is None:
            return self.max_steps
        return min(((step // self.period) + 1) * self.period, self.max_steps)

    def is_boundary(self, step: int) -> bool:
        return step >= self.max_steps or (
            self.period is not None and step % self.period == 0
        )


class Trainer:
    """Drives a TorchTrial."""

    def __init__(self, trial: TorchTrial, context: Optional[TrialContext] = None) -> None:
        self.trial = trial
        self.context = context or trial.context
        self.core = self.context.core
        self.device = self.context.device
        # populated by _setup
        self.model: Any = None
        self.tx: Any = None
        self.train_loader: Any = None
        self.val_loader: Any = None
        self.state: Optional[TrainState] = None
        self.callbacks: Dict[str, Callback] = {}
        self.steps_completed = 0
        self._params: Dict[str, torch.nn.Parameter] = {}
        self._reducers: Dict[str, Any] = {}
        self._tokens_per_sample: Optional[int] = None

    # -- setup -------------------------------------------------------------

    def _setup(self) -> None:
        trial = self.trial
        self.model = trial.build_model()
        self.tx = trial.build_optimizer()
        self.train_loader = trial.build_training_data_loader()
        self.val_loader = trial.build_validation_data_loader()
        self.callbacks = dict(trial.build_callbacks())
        self._params = dict(self.model.named_parameters())
        opt_state = self.tx.init(self._params)
        # the metric keys come from the first step's loss (sorted, then
        # "loss" and, with an lr_schedule, "lr", as in the JAX Trainer)
        self.state = TrainState.create(self.model, opt_state, self.device)
        self._reducers = {k: get_reducer(v) for k, v in trial.evaluation_reducers().items()}
        hp_seq = (self.context.hparams or {}).get("seq_len")
        self._tokens_per_sample = getattr(trial, "tokens_per_sample", None) or (
            hp_seq if isinstance(hp_seq, int) else None
        )
        tracer = get_tracer()
        fpt = getattr(trial, "flops_per_token", None)
        if fpt:
            tracer.gauge("train.flops_per_token", float(fpt))

    # -- steps -------------------------------------------------------------

    def _train_step(self, batch: Dict[str, torch.Tensor]) -> None:
        """One optimizer step: forward, backward, update, metric sums; all
        queued on the device, nothing waited for."""
        state, params = self.state, self._params
        for p in params.values():
            p.grad = None
        loss, metrics = self.trial.loss(state.model, batch)
        loss.backward()
        grads = {
            k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        # schedule-state surfacing: a trial exposing `lr_schedule` gets its
        # current learning rate (at the step before the update) reported
        schedule = getattr(self.trial, "lr_schedule", None)
        if schedule is not None:
            metrics["lr"] = schedule(state.step).float()
        _, state.opt_state = self.tx.apply_step(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
        if not state.metric_acc:
            keys = sorted(k for k in metrics if k not in ("loss", "lr")) + ["loss"]
            if "lr" in metrics:
                keys.append("lr")
            state.metric_acc = {
                k: torch.zeros((), dtype=torch.float32, device=self.device) for k in keys
            }
        for k, acc in state.metric_acc.items():
            acc.add_(metrics[k].float())
        state.metric_count.add_(1.0)
        state.step.add_(1)

    @torch.no_grad()
    def _eval_step(
        self, batch: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        metrics = self.trial.evaluate_batch(self.state.model, batch)
        out = dict(acc)
        for k, v in metrics.items():
            red = self._reducers.get(k, MEAN)
            carry = acc.get(k)
            if carry is None:
                carry = torch.full((), red.init, dtype=torch.float32, device=self.device)
            out[k] = red.accumulate(carry, v.float())
        return out

    # -- length arithmetic -------------------------------------------------

    def _to_batches(self, length: Any) -> Optional[int]:
        """A Length in optimizer steps."""
        if length is None:
            return None
        length = Length.parse(length)
        if length.unit == "batches":
            return length.units
        if length.unit == "epochs":
            return max(1, length.units * self.train_loader.batches_per_epoch)
        return max(1, length.units // self.train_loader.sampler.global_batch)

    # -- validation --------------------------------------------------------

    def _validate(self) -> Dict[str, float]:
        for cb in self.callbacks.values():
            cb.on_validation_start()
        acc: Dict[str, torch.Tensor] = {}
        n = 0
        self.model.eval()
        try:
            with EpochFeed(self.val_loader.iter_epoch(0), self.device) as feed:
                for batch in feed:
                    acc = self._eval_step(batch, acc)
                    n += 1
        finally:
            self.model.train()
        metrics: Dict[str, float] = {}
        if n:
            keys = list(acc)
            host = torch.stack([acc[k] for k in keys]).cpu().tolist() if keys else []
            metrics = {
                k: float(self._reducers.get(k, MEAN).finalize(v, float(n)))
                for k, v in zip(keys, host)
            }
        if self.core.distributed.is_chief:
            self.core.train.report_validation_metrics(self.steps_completed, metrics)
        for cb in self.callbacks.values():
            cb.on_validation_end(metrics)
        return metrics

    # -- the loop ----------------------------------------------------------

    def fit(
        self,
        max_length: Any,
        *,
        validation_period: Optional[Any] = None,
        checkpoint_period: Optional[Any] = None,
        report_period: Optional[Any] = None,
        latest_checkpoint: Optional[str] = None,
        checkpoint_policy: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Train until ``max_length``; returns a summary dict.

        ``checkpoint_policy`` defaults to "best", as in the JAX Trainer
        without an experiment configuration; this slice of the port saves
        no checkpoints, so it must be "none", with no ``checkpoint_period``
        and no ``latest_checkpoint``."""
        if checkpoint_policy is None:
            checkpoint_policy = "best"
        if checkpoint_policy != "none" or checkpoint_period is not None or latest_checkpoint:
            raise NotImplementedError(
                "checkpoint save and restore are not ported to determined_tpu_torch "
                f"yet ({_LATER}); pass checkpoint_policy='none', no checkpoint_period "
                "and no latest_checkpoint"
            )
        tracer = get_tracer()
        with tracer.span("trainer.setup", cat="setup"):
            self._setup()

        max_steps = self._to_batches(Length.parse(max_length))
        val_sched = _BoundarySchedule(self._to_batches(validation_period), max_steps)
        rep_period = self._to_batches(report_period)
        if rep_period is None:
            rep_period = min(100, max(1, max_steps // 10))
        rep_sched = _BoundarySchedule(rep_period, max_steps)

        for cb in self.callbacks.values():
            cb.on_training_start(self)

        # overlapped input feed (the JAX Trainer's default depths): host
        # fetch on a background worker two batches ahead, the copy of batch
        # N+1 queued while step N runs; __next__ commits the loader's
        # CONSUMED position
        pipeline = InputPipeline(self.train_loader, self.device)
        gbs = self.train_loader.sampler.global_batch
        try:
            self._fit_loop(pipeline, max_steps, val_sched, rep_sched, gbs)
        finally:
            # the worker must die with the loop, on a clean exit and on a crash
            pipeline.close()

        for cb in self.callbacks.values():
            cb.on_trial_shutdown()

        return {
            "steps_completed": self.steps_completed,
            "latest_checkpoint": None,
            "validation_metrics": self._last_val_metrics,
            "stopped_early": self._stopped_early,
        }

    def _fit_loop(
        self,
        pipeline: InputPipeline,
        max_steps: int,
        val_sched: _BoundarySchedule,
        rep_sched: _BoundarySchedule,
        gbs: int,
    ) -> None:
        tracer = get_tracer()
        hot_time = 0.0  # train-segment wall time since the last report
        steps_since_report = 0
        self._last_val_metrics: Dict[str, float] = {}
        self._stopped_early = False
        epoch_seen = self.train_loader.epoch

        while self.steps_completed < max_steps:
            next_stop = min(
                val_sched.next_after(self.steps_completed),
                rep_sched.next_after(self.steps_completed),
                max_steps,
            )
            # ---- hot segment: no host syncs ------------------------------
            seg_t0 = time.monotonic()
            while self.steps_completed < next_stop:
                # fault-injection hook (no-op unless a test installs one)
                faults.fire("train.step", step=self.steps_completed)
                t0 = time.monotonic()
                batch = next(pipeline)
                t1 = time.monotonic()
                self._train_step(batch)
                if tracer.enabled:
                    tracer.record_span("data.wait", "data", t0, t1)
                    tracer.record_span("step.dispatch", "step", t1, time.monotonic())
                self.steps_completed += 1
                steps_since_report += 1
            hot_time += time.monotonic() - seg_t0
            if self.train_loader.epoch != epoch_seen:
                for e in range(epoch_seen, self.train_loader.epoch):
                    for cb in self.callbacks.values():
                        cb.on_epoch_end(e)
                epoch_seen = self.train_loader.epoch

            at_end = self.steps_completed >= max_steps

            # ---- REPORT ---------------------------------------------------
            if rep_sched.is_boundary(self.steps_completed) or at_end:
                sync_t0 = time.monotonic()
                metrics = self.state.fetch_metrics()  # the one host sync
                sync_t1 = time.monotonic()
                hot_time += sync_t1 - sync_t0
                # where the host waits for every queued step
                tracer.record_span("step.boundary_block", "step", sync_t0, sync_t1)
                if steps_since_report:
                    tracer.counter("train.steps", float(steps_since_report))
                    tracer.counter("train.samples", float(steps_since_report * gbs))
                    if self._tokens_per_sample:
                        tracer.counter(
                            "train.tokens",
                            float(steps_since_report * gbs * self._tokens_per_sample),
                        )
                self.state.reset_metrics()
                metrics["samples_per_second"] = steps_since_report * gbs / max(hot_time, 1e-9)
                hot_time = 0.0
                steps_since_report = 0
                if self.core.distributed.is_chief:
                    self.core.train.report_training_metrics(self.steps_completed, metrics)
                    self.core.train.report_progress(self.steps_completed / max_steps)
                for cb in self.callbacks.values():
                    cb.on_training_workload_end(self.steps_completed, metrics)

            # ---- VALIDATE -------------------------------------------------
            if val_sched.period is not None and (
                val_sched.is_boundary(self.steps_completed) or at_end
            ):
                with tracer.span("validate", cat="validate", step=self.steps_completed):
                    self._last_val_metrics = self._validate()

            # ---- PREEMPT --------------------------------------------------
            if self.core.preempt.should_preempt():
                # no checkpoint to save in this slice: stop at the boundary
                logger.info("preempted at step %d; exiting cleanly", self.steps_completed)
                self._stopped_early = True
                break
