"""Trainer: the boundary-driven training loop.

Port of ``determined_tpu/train/_trainer.py`` (``init``, ``Trainer``,
``_BoundarySchedule``).  The same contract: ``fit(max_length,
periods, latest_checkpoint, checkpoint_policy)`` with TRAIN / VALIDATE /
CHECKPOINT / REPORT boundaries, callbacks, the ``train.step`` fault site, a
preemption check at each boundary that saves a checkpoint and stops, and
checkpoints with integrity manifests that a restore verifies, falling back
along the parent lineage.  The step is eager PyTorch where the JAX package
jits one: forward, ``backward()``, the optimizer's ``apply_step`` (the fused
AdamW kernel on CUDA), the ``lr`` metric and the on-device metric sums.  The
hot loop never waits for the device; metrics are fetched once per REPORT
boundary.

Checkpoints (``train/serialization.py``) hold the step, the params, the
optimizer state and the step generator.  The asynchronous save
(``optimizations.async_checkpointing``, on by default) differs from the JAX
package's in one way: PyTorch updates the params and moments IN PLACE (the
fused AdamW kernel writes p, m and v), where the JAX step donates its input
and returns new buffers.  So the snapshot is a ``clone()`` of every tensor,
queued on the training stream at the boundary before the next step is
queued, and the writer thread reads only the snapshot: it waits on a CUDA
event recorded after the clones and copies the snapshot into pinned host
buffers on a stream of its own, never synchronising the device (which would
wait for the training steps queued behind the clones too).  The pinned
buffers are allocated once, at the first asynchronous save.

On a mesh (``train.init(mesh_config=...)`` or ``resources.mesh``, resolved
against the world of the torch.distributed process group, one process a
device) the Trainer places the model with ``parallel.sharding.shard_model``:
a pipeline stage over ``pipe``, experts over ``expert``, heads, hidden
units and vocabulary over ``tensor``, the sequence over ``seq`` (ring
attention), FSDP2 over ``(data, fsdp, seq)``.  Each rank reads its
``(data, fsdp)`` slice of every global batch (the tensor and seq ranks of
one slice read the same batch; the trial's loss takes its seq part), the
optimizer updates each rank's
local shards (the clip's norm global over the mesh), the reported training
and validation metrics are averaged over the ranks (tensor ranks hold
equal values and seq parts are equal in size, so a mean over examples is
the global mean), and the preemption vote and the checkpoint's storage id
go through the ``DistributedContext``.  In a world of more than one rank
every checkpoint is sharded, as the JAX Trainer writes at ``dist.size >
1``: each rank writes the pieces of its local shards that no lower rank
holds the same (``serialization.build_layout``: a data replica or a
replicated leaf is written once), the chief adds the layout and
``trainer_state.json``, and no rank gathers the state.  A world of one
writes the whole-state format.  ``restore_from_path`` reads either format
on any mesh or on one device, each rank its own box of every leaf; a
restore onto another mesh than the one that wrote it is a ``trial.resize``
span.

Experiment-configuration knobs the JAX Trainer reads are honoured or raise
``NotImplementedError``.  Honoured: ``aggregation_frequency`` (gradient
accumulation: each optimizer step runs forward and ``backward()`` over that
many stacked microbatches, summing the gradients in ``.grad``, then one
update), ``fetch_workers`` (passed to loaders that set none),
``compilation_cache_dir`` (the kernels' build directory,
``utils/compilation_cache.py``) and ``quantized_matmul`` (read by the
trial's model, ``train/_quant.py``), ``overlap_grad_sync`` with
``overlap_bucket_mb`` (``train/_overlap.py``: the plan's buckets become
FSDP2 units, each reduce-scattered as the backward produces it) and
``hierarchical_collectives`` (on ``num_slices`` > 1: HSDP, reduce-scatter
within a slice and the fragment all-reduced over ``dcn``; without it the
sync is one flat shard group over every batch axis).  On every mesh with
gradient-reduction axes the goodput ledger gets the JAX Trainer's
``step.comm`` counters at each report, counted over what the port runs
(``_overlap.fsdp_comm``: FSDP2's units, with the knob on or off).  MoE blocks
run on every axis (``models/moe.py``), and every axis runs beside ``pipe``,
the overlapped sync too (its plan over the stage's own leaves); the retrace
sentinel comes with a later slice of the port.

A trial with a ``pipeline_schedule_spec`` (``LMTrial`` on a ``pipe`` axis,
or on ``train.init(virtual_pipe=P)``) runs its loss through the schedule
(``parallel/pipeline.py``), which runs the backward too, so the step calls
no ``backward()`` of its own; on a mesh each rank reads its part of each
microbatch (all of it where ``M x batch shards`` does not divide the global
batch: JAX's ``pipeline_apply`` then replicates the microbatch over the
batch axes), the stage's whole leaves have their gradients averaged
(``ShardPlan.sync_grads``), and the goodput ledger gets the schedule's
``step.bubble`` rows (``BubbleModel``: the ``step.bubble.exposed_us``
counter a report segment, the fraction and tick gauges at setup), as the
JAX Trainer's.  The preflight's pipeline checks (``pipeline_problems``)
raise ``InvalidExperimentConfig`` in ``check_exp_config``.

``profiling.trace`` bounds a ``torch.profiler`` window that the core
context's profiler opened (``core.profiler.on(trace=True)``) to
``profiling.end_after_batch`` steps,
counted from the resume point.
``jit_cache`` has nothing to share in the port: its steps are eager and
compile nothing per trial, so either value gives the same run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any, Callable as TCallable, Dict, Optional, Tuple

import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.config.experiment import (
    InvalidExperimentConfig,
    Length,
    MeshConfig,
    pipeline_problems,
)
from determined_tpu_torch.data._prefetch import EpochFeed, InputPipeline
from determined_tpu_torch.observability import chip_peak_flops, get_tracer
from determined_tpu_torch.parallel.mesh import resolve_mesh
from determined_tpu_torch.parallel.sharding import batch_shard, cut_pipe, shard_model
from determined_tpu_torch.train import serialization
from determined_tpu_torch.train._reducer import MEAN, get_reducer
from determined_tpu_torch.train._state import TrainState
from determined_tpu_torch.train._trial import Callback, TorchTrial, TrialContext, takes_rng
from determined_tpu_torch.utils import faults
from determined_tpu_torch.utils.compilation_cache import setup_compilation_cache
from determined_tpu_torch.utils.errors import CheckpointCorruptError, CheckpointNotFoundError

logger = logging.getLogger("determined_tpu_torch.train")

_LATER = "it comes with a later slice of the port (ROADMAP.md, Queue 1)"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to determined_tpu_torch yet; {_LATER}")


def check_exp_config(exp_config: Any) -> None:
    """Raise for every knob the JAX Trainer reads that this port does not
    run; what passes is honoured."""
    problems = pipeline_problems(exp_config)
    if problems:
        raise InvalidExperimentConfig("; ".join(problems))
    if exp_config.lint.retrace_sentinel:
        raise _later("lint.retrace_sentinel")


def init(
    *,
    hparams: Optional[Dict[str, Any]] = None,
    exp_config: Optional[Any] = None,
    core_context: Optional[Any] = None,
    seed: Optional[int] = None,
    device: DeviceLike = None,
    mesh_config: Optional[MeshConfig] = None,
    virtual_pipe: Optional[int] = None,
) -> TrialContext:
    """Build a TrialContext on ``device`` (CUDA unless named; raises without
    a GPU).  Off-cluster the core services are ``core._dummy_init()``.  With
    ``exp_config`` the hyperparameters (Consts collapsed), the seed and the
    mesh default to the configuration's.  The kernels' build cache is set up
    from ``optimizations.compilation_cache_dir`` (or
    ``DTPU_COMPILATION_CACHE``) as the JAX ``init`` sets up XLA's.

    ``mesh_config`` (or ``resources.mesh``) is resolved against the world
    of the process group (``core.init`` under torchrun opens it; each rank
    then runs on its own device, the core context's ``distributed.device``).
    Without a process group a mesh of one device is the single-device path.

    ``virtual_pipe`` (P > 1) runs a pipe-parallel trial's P stages in this
    process on its one device (``parallel/pipeline.py``'s ``VirtualPipe``:
    the schedule and the kernel launches of P pipe ranks), never with a
    mesh of more than one device."""
    if exp_config is not None:
        check_exp_config(exp_config)
        if hparams is None:
            hparams = {
                k: _collapse(v) if isinstance(v, dict) else getattr(v, "val", v)
                for k, v in exp_config.hyperparameters.items()
            }
        if seed is None:
            seed = exp_config.reproducibility.experiment_seed
    setup_compilation_cache(
        exp_config.optimizations.compilation_cache_dir if exp_config is not None else None
    )
    core = core_context or core_mod._dummy_init()
    rank_device = getattr(core.distributed, "device", None)
    dev = resolve_device(device if device is not None or rank_device is None else rank_device)
    if mesh_config is None and exp_config is not None:
        mesh_config = exp_config.resources.mesh
    mesh = resolve_mesh(mesh_config, dev.type)
    vpipe = None
    if virtual_pipe is not None and virtual_pipe > 1:
        from determined_tpu_torch.parallel.pipeline import VirtualPipe

        if mesh is not None:
            raise ValueError("virtual_pipe runs every stage on one device: it takes no mesh")
        vpipe = VirtualPipe(virtual_pipe)
    return TrialContext(
        core=core, device=dev, hparams=hparams, seed=seed or 0, exp_config=exp_config,
        mesh=mesh, virtual_pipe=vpipe,
    )


def _collapse(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {
        k: _collapse(v) if isinstance(v, dict) else getattr(v, "val", v)
        for k, v in tree.items()
    }


def _mesh_axes(axes: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """A mesh's axes over 1 (none: one device)."""
    return {k: int(v) for k, v in (axes or {}).items() if int(v) > 1}


def _fmt_axes(axes: Dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in axes.items()) or "data=1"


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


@dataclasses.dataclass
class _PendingSave:
    """An in-flight background checkpoint: the writer thread serialises the
    snapshot; ``finish`` (merge/manifest/report) runs on the main thread at
    the next drain point."""

    thread: Optional[threading.Thread]
    finish: TCallable[[], None]
    storage_id: str
    step: int
    errors: list


def _snapshot(tree: Any) -> Any:
    """Clone of every tensor (a generator becomes its state bytes), queued
    on the current stream."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_snapshot(v) for v in tree))
    raise TypeError(f"cannot snapshot a {type(tree).__name__}")


def _merge(a: Any, b: Any) -> Any:
    """``a`` with the leaves of ``b`` it lacks (dicts merged by key, named
    tuples field by field): pipeline stages' states joined."""
    if isinstance(a, dict):
        return {**b, **{k: _merge(v, b[k]) if k in b else v for k, v in a.items()}}
    if hasattr(a, "_fields"):
        return type(a)(*(_merge(x, y) for x, y in zip(a, b)))
    return a


def _pinned_like(tree: Any) -> Any:
    """Pinned host buffers shaped like a snapshot's CUDA tensors (None for
    the leaves already on the host)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cuda":
            return None
        return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
    if isinstance(tree, dict):
        return {k: _pinned_like(v) for k, v in tree.items()}
    return type(tree)(*(_pinned_like(v) for v in tree))


def _to_host(tree: Any, pinned: Any) -> Any:
    """The snapshot on the host: each CUDA tensor copied into its pinned
    buffer by a non-blocking copy queued on the current stream (a
    copy-engine transfer the caller waits for on that stream alone)."""
    if isinstance(tree, torch.Tensor):
        return tree if pinned is None else pinned.copy_(tree, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_host(v, pinned[k]) for k, v in tree.items()}
    return type(tree)(*(_to_host(v, b) for v, b in zip(tree, pinned)))


class Trainer:
    """Drives a TorchTrial."""

    def __init__(self, trial: TorchTrial, context: Optional[TrialContext] = None) -> None:
        self.trial = trial
        self.context = context or trial.context
        self.core = self.context.core
        self.device = self.context.device
        self.mesh = self.context.mesh
        # where the parameters live on the mesh (parallel/sharding.py), None
        # without one; set by _setup
        self._plan: Any = None
        # populated by _setup
        self.model: Any = None
        self.tx: Any = None
        self.train_loader: Any = None
        self.val_loader: Any = None
        self.state: Optional[TrainState] = None
        self.callbacks: Dict[str, Callback] = {}
        self.steps_completed = 0
        self.best_validation: Optional[float] = None
        self._searcher_metric: Optional[str] = None
        self._smaller_is_better = True
        self._params: Dict[str, torch.nn.Parameter] = {}
        # what the optimizer updates in place: the params, or on a mesh
        # each one's local shard
        self._opt_params: Dict[str, torch.Tensor] = {}
        self._reducers: Dict[str, Any] = {}
        self._tokens_per_sample: Optional[int] = None
        # microbatches per optimizer step (optimizations.aggregation_frequency)
        self.agg = 1
        self._average_grads = True
        # the step at which the profiler's trace window closes (None: no
        # bounded window)
        self._trace_stop_step: Optional[int] = None
        # the trial's pipeline schedule and its goodput model
        # (parallel/pipeline.py), None without a pipe axis; set by _setup
        self._pipe_schedule: Any = None
        self._bubble_model: Any = None
        # the overlapped sync's plan and its comm model (train/_overlap.py),
        # None without gradient-reduction axes; set by _setup
        self._overlap_plan: Any = None
        self._comm_model: Any = None
        self._pending_save: Optional[_PendingSave] = None
        # pinned host buffers the async writer copies the snapshot into,
        # allocated at the first async save on CUDA and kept (at most one
        # save is in flight): pinning memory stalls every thread's CUDA
        # calls while it runs, so it happens once, inside the dispatch
        self._pinned: Any = None
        self._last_ckpt_sid: Optional[str] = None
        # a sharded checkpoint's layout and the keys this rank writes, the
        # same at every save (the leaves' shapes do not change)
        self._shard_layout: Any = None
        self._last_val_metrics: Dict[str, float] = {}
        self._stopped_early = False
        # Newest FINALIZED checkpoint (manifest written).  An async save
        # still in flight is excluded: until its drain-point finalize runs
        # it has no manifest and must never be offered as a resume point.
        self.latest_checkpoint: Optional[str] = None

    # -- setup -------------------------------------------------------------

    def _setup(self) -> None:
        trial, cfg = self.trial, self.context.exp_config
        spec_fn = getattr(trial, "pipeline_schedule_spec", None)
        self._pipe_schedule = spec_fn() if spec_fn is not None else None
        if self._pipe_schedule is not None:
            from determined_tpu_torch.parallel.pipeline import BubbleModel

            self._bubble_model = BubbleModel(schedule=self._pipe_schedule)
            logger.info("pipeline schedule %s (bubble fraction %.4f)",
                        self._pipe_schedule.fingerprint(), self._bubble_model.fraction)
        self.model = trial.build_model()
        if self.mesh is not None:
            # the overlapped sync's plan (train/_overlap.py), built whenever
            # the mesh has gradient-reduction axes, as the JAX Trainer's:
            # with the knob on its buckets are FSDP2's units; the comm model
            # of the units FSDP2 runs feeds the goodput ledger's step.comm rows
            from determined_tpu_torch.train import _overlap

            opt = cfg.optimizations if cfg is not None else None
            hier = bool(opt is not None and opt.hierarchical_collectives)
            kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else ""
            # on a pipe axis the plan is the stage's: its own leaves, in
            # JAX's order (JAX syncs the stacked block grads over the batch
            # axes)
            cut_pipe(self.model, self.mesh)
            self._overlap_plan = _overlap.build_plan(
                _overlap.model_leaves(self.model), self.mesh,
                enabled=bool(opt is not None and opt.overlap_grad_sync),
                bucket_bytes=(opt.overlap_bucket_mb if opt is not None else 4) * 1024 * 1024,
                hierarchical=hier, device_kind=kind,
            )
            plan = self._overlap_plan
            units = _overlap.fsdp_units(plan, self.model) if plan and plan.enabled else ()
            # experts over `expert`, FSDP2 over the batch axes; every rank
            # built the same full model from the trial's seed first
            self._plan = shard_model(self.model, self.mesh, hierarchical=hier, units=units)
            if plan is not None:
                self._comm_model = _overlap.fsdp_comm(self._plan, kind)
        self.tx = trial.build_optimizer()
        self.train_loader = trial.build_training_data_loader()
        self.val_loader = trial.build_validation_data_loader()
        if self.mesh is not None:
            # each rank reads its (data, fsdp) slice of every global batch;
            # under a pipeline schedule its slice of each microbatch, as
            # JAX's shard_map lays the microbatch rows over the batch axes,
            # or where the microbatch does not split over them the whole
            # microbatch (JAX's batch_axes = (): every batch rank runs the
            # same tokens, and FSDP2's mean of equal gradients is each one)
            rank, shards = batch_shard(self.mesh)
            blocks = self._pipe_schedule.num_microbatches if self._pipe_schedule else 1
            for ld in (self.train_loader, self.val_loader):
                if ld is None:
                    continue
                gbs = ld.sampler.global_batch
                if blocks > 1 and gbs % blocks == 0 and (gbs // blocks) % shards:
                    logger.info("pipeline: a microbatch of %d rows does not split over %d "
                                "batch shards; every batch rank runs the whole microbatch",
                                gbs // blocks, shards)
                    ld.shard(0, 1, blocks)
                else:
                    ld.shard(rank, shards, blocks)
        self.callbacks = dict(trial.build_callbacks())
        if cfg is not None:
            self._searcher_metric = cfg.searcher.metric
            self._smaller_is_better = cfg.searcher.smaller_is_better
            opt = cfg.optimizations
            self.agg = opt.aggregation_frequency
            self._average_grads = opt.average_aggregated_gradients
            if opt.fetch_workers:
                # config-level fetch_workers applies to loaders the trial
                # built without a per-loader setting
                for ld in (self.train_loader, self.val_loader):
                    if ld is not None and not ld.fetch_workers:
                        ld.fetch_workers = opt.fetch_workers
        self._params = dict(self.model.named_parameters())
        self._opt_params = self._plan.local(self._params) if self._plan else self._params
        # a trial whose loss takes a third argument gets the step's generator
        # (the JAX trial's rng); one taking (model, batch) gets none
        self._step_gen = torch.Generator(device=self.device) if takes_rng(trial) else None
        opt_state = self.tx.init(self._opt_params)
        # the metric keys come from the first step's loss (sorted, then
        # "loss" and, with an lr_schedule, "lr", as in the JAX Trainer)
        self.state = TrainState.create(self.model, opt_state, self.device, self.context.seed)
        self._reducers = {k: get_reducer(v) for k, v in trial.evaluation_reducers().items()}
        hp_seq = (self.context.hparams or {}).get("seq_len")
        self._tokens_per_sample = getattr(trial, "tokens_per_sample", None) or (
            hp_seq if isinstance(hp_seq, int) else None
        )
        # goodput-ledger context (observability/_goodput.py): tokens/MFU
        # need the device's peak and the trial's FLOPs a token
        tracer = get_tracer()
        if tracer.enabled:
            kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else ""
            # default=0: an unknown device (the CPU) reports no roofline
            # rather than an MFU against some other card's peak
            peak = chip_peak_flops(kind, default=0.0)
            if peak:
                tracer.gauge("device.peak_flops_total", peak)
            fpt = getattr(trial, "flops_per_token", None)
            if fpt:
                tracer.gauge("train.flops_per_token", float(fpt))
            if self._bubble_model is not None:
                # the schedule's facts for the ledger: its modeled idle
                # fraction and the tick counts behind it
                sched = self._bubble_model.schedule
                tracer.gauge("step.bubble.fraction", float(self._bubble_model.fraction))
                tracer.gauge("step.bubble.ticks_total", float(sched.total_ticks))
                tracer.gauge("step.bubble.ticks_idle", float(sched.bubble_ticks))

    def _input_opts(self):
        """(prefetch_depth, device_prefetch) from the configuration,
        defaulting to the overlapped pipeline (2/2)."""
        cfg = self.context.exp_config
        if cfg is None:
            return 2, 2
        return cfg.optimizations.prefetch_depth, cfg.optimizations.device_prefetch

    # -- steps -------------------------------------------------------------

    def _train_step(self, batch: Dict[str, torch.Tensor]) -> None:
        """One optimizer step: forward, backward, update, metric sums; all
        queued on the device, nothing waited for.

        Under gradient accumulation (``agg`` > 1) the batch holds ``agg``
        stacked microbatches ``[agg, batch, ...]``: each one's forward and
        ``backward()`` add its gradients into the f32 ``.grad`` in order, as
        the JAX step's scan sums them; ``loss`` and the trial's metrics are
        the microbatch sums over ``agg``, the gradients too when
        ``average_aggregated_gradients`` is set, and then one update runs
        (its clip on those gradients).  A trial whose ``loss`` takes a
        generator gets the step's (``_loss``), every microbatch the same."""
        state, params = self.state, self._params
        for p in params.values():
            p.grad = None
        if self.agg == 1:
            loss, metrics = self._loss(batch)
            self._backward(loss)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
        else:
            metrics = self._accumulate(batch)
        if self._plan is not None:
            # a pipeline stage's replicated leaves: their gradients averaged
            self._plan.sync_grads(params)
        grads = {
            k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()
        }
        norm_kw = {}
        if self._plan is not None:
            # the update runs on each rank's shards; the clip's norm is
            # global over the mesh
            grads = self._plan.local(grads)
            norm_kw = {"norm": self._plan.global_norm}
        # schedule-state surfacing: a trial exposing `lr_schedule` gets its
        # current learning rate (at the step before the update) reported
        schedule = getattr(self.trial, "lr_schedule", None)
        if schedule is not None:
            metrics["lr"] = schedule(state.step).float()
        _, state.opt_state = self.tx.apply_step(
            grads, state.opt_state, self._opt_params, **norm_kw
        )
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

    def _backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()``; under a pipeline schedule the trial's loss
        has run its backward already (``parallel/pipeline.py``: the
        schedule interleaves it with the forward)."""
        if self._pipe_schedule is None:
            loss.backward()

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """The trial's loss on ``batch``; with the step's generator, reseeded
        here (``TrainState.step_seed``), where the trial's loss takes one."""
        if self._step_gen is None:
            return self.trial.loss(self.state.model, batch)
        self._step_gen.manual_seed(self.state.step_seed(self.steps_completed))
        return self.trial.loss(self.state.model, batch, self._step_gen)

    def _accumulate(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward and backward over each stacked microbatch, gradients
        summed in ``.grad``; returns the step's metrics (``loss`` and the
        trial's, averaged over the microbatches)."""
        agg = self.agg
        loss_sum = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(agg):
            if self._plan is not None:
                # one gradient reduction a step: FSDP syncs on the last
                # microbatch only, over the summed gradients
                self.model.set_requires_gradient_sync(i == agg - 1)
            loss, m = self._loss({k: v[i] for k, v in batch.items()})
            self._backward(loss)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in m.items():
                v = v.detach().float()
                sums[k] = v if k not in sums else sums[k] + v
        if self._average_grads:
            for p in self._params.values():
                if p.grad is not None:
                    p.grad.div_(agg)
        metrics = {k: v / agg for k, v in sums.items()}
        metrics["loss"] = loss_sum / agg
        return metrics

    @torch.no_grad()
    def _eval_step(
        self, batch: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        metrics = self.trial.evaluate_batch(self.state.model, batch)
        if self.mesh is not None:
            # each batch's metrics over the whole global batch: the ranks'
            # means averaged (the expert group's ranks hold equal values)
            keys = list(metrics)
            metrics = dict(zip(keys, self._mean_over_ranks(
                torch.stack([metrics[k].float() for k in keys]))))
        out = dict(acc)
        for k, v in metrics.items():
            red = self._reducers.get(k, MEAN)
            carry = acc.get(k)
            if carry is None:
                carry = torch.full((), red.init, dtype=torch.float32, device=self.device)
            out[k] = red.accumulate(carry, v.float())
        return out

    def _mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over every rank of the mesh (one all-reduce)."""
        import torch.distributed as tdist

        t = t.clone()
        tdist.all_reduce(t)
        return t / self.mesh.size

    # -- length arithmetic -------------------------------------------------

    def _to_batches(self, length: Any) -> Optional[int]:
        """A Length in OPTIMIZER steps.  With gradient accumulation each
        step consumes ``agg`` loader batches, so epoch and record lengths
        divide by it (a 1-epoch run is one data pass whatever agg is)."""
        if length is None:
            return None
        length = Length.parse(length)
        if length.unit == "batches":
            return length.units
        if length.unit == "epochs":
            return max(1, length.units * self.train_loader.batches_per_epoch // self.agg)
        return max(1, length.units // (self.train_loader.sampler.global_batch * self.agg))

    # -- checkpoint --------------------------------------------------------

    def _array_state(self) -> Dict[str, Any]:
        return {
            "step": self.state.step,
            "params": self._opt_params,
            "opt_state": self.state.opt_state,
            "rng": self.state.rng,
        }

    def _full_array_state(self) -> Dict[str, Any]:
        """The whole array state of a mesh, gathered leaf by leaf (every
        rank takes part) onto the chief's host; None leaves elsewhere.  No
        checkpoint uses it: it is what a check of a sharded run compares
        with one device."""
        plan, dist = self._plan, self.core.distributed
        # a pipeline stage's leaves land on its first rank, which sends
        # them to the chief
        pipe = plan.pipe_size > 1
        chief = all(self.mesh.coordinate(a) == 0 for a in self.mesh.shape
                    if a != "pipe" and self.mesh.shape[a] > 1) if pipe else dist.is_chief

        def gather(name: str, local: torch.Tensor) -> Optional[torch.Tensor]:
            full = plan.full(name, local)
            return full.detach().to("cpu", copy=True) if chief else None

        names = set(self._params)

        def walk(node: Any) -> Any:
            if isinstance(node, dict):
                if node and set(node) <= names:
                    return {k: gather(k, v) for k, v in node.items()}
                return {k: walk(v) for k, v in node.items()}
            if hasattr(node, "_fields"):
                return type(node)(*(walk(v) for v in node))
            if isinstance(node, torch.Tensor):
                return node.detach().to("cpu", copy=True)
            return node

        out = {
            "step": self.state.step.detach().cpu(),
            "params": walk(self._opt_params),
            "opt_state": walk(self.state.opt_state),
            "rng": self.state.rng.get_state(),
        }
        if not pipe:
            return out
        stages = dist.gather(out if chief else None)
        if not dist.is_chief:
            return out
        for stage in stages[1:]:
            if stage is not None:
                out = _merge(out, stage)
        return out

    def _place(self, part: str, name: str, leaf: Any) -> Optional[Tuple[Tuple[int, ...], Any]]:
        """(whole shape, this rank's box) of a leaf the mesh splits: a
        parameter, or a moment shaped like its local shard; None for a
        leaf every rank holds whole (``serialization``'s ``place``)."""
        if self._plan is None or part not in ("params", "opt_state"):
            return None
        key = name if part == "params" else name.split(serialization.SEP, 1)[-1]
        local = self._opt_params.get(key)
        if (local is None or not isinstance(leaf, torch.Tensor) or not leaf.dim()
                or leaf.shape != local.shape):
            return None
        whole = self._plan.full_shape(key)
        return whole, self._plan.box(key, whole)

    def _sharded_keys(self) -> Any:
        """The layout of this mesh's checkpoints and the keys this rank
        writes (a collective at the first save, cached)."""
        if self._shard_layout is None:
            dist = self.core.distributed
            mine = serialization.describe(
                self._array_state(), self._place if self._plan is not None else None)
            layout, writes = serialization.build_layout(dist.allgather(mine))
            self._shard_layout = (layout, writes[dist.rank])
        return self._shard_layout

    def _writer(self, shard: bool, trainer_state: Dict[str, Any]) -> TCallable[[str, Any], None]:
        """What writes a checkpoint's files into ``path`` from the arrays
        to store: the whole state, or this rank's pieces (``select``'d
        flat) with the chief's layout; the chief's trainer state."""
        dist = self.core.distributed
        chief, rank = dist.is_chief, dist.rank
        layout = self._sharded_keys()[0] if shard else None

        def write(path: str, arrays: Any) -> None:
            if shard:
                serialization.save_shard(path, rank, arrays)
                if chief:
                    serialization.save_layout(path, layout)
            else:
                serialization.save_arrays(path, arrays)
            if chief:
                serialization.save_trainer_state(path, trainer_state)

        return write

    def _write_sync(self, metadata: Dict[str, Any], arrays: Dict[str, Any],
                    write: TCallable[[str, Any], None], shard: bool) -> str:
        """Write a checkpoint now (collective with ``shard``); returns its
        storage id."""
        with get_tracer().span(
            "checkpoint.save", cat="checkpoint", mode="sync", step=self.steps_completed,
            rank=self.core.distributed.rank,
        ):
            with self.core.checkpoint.store_path(metadata, shard=shard) as (path, sid):
                for cb in self.callbacks.values():
                    cb.on_checkpoint_write_start(path)
                write(path, arrays)
        return sid

    def _saved(self, sid: str) -> str:
        """Record a finished synchronous save."""
        self.latest_checkpoint = sid
        for cb in self.callbacks.values():
            cb.on_checkpoint_write_end(sid)
        logger.info("checkpoint %s at step %d", sid, self.steps_completed)
        return sid

    def _start_writer(self, path: str, sid: str, finish: TCallable[[], None],
                      host_arrays: TCallable[[], Any],
                      write: TCallable[[str, Any], None]) -> _PendingSave:
        """The background writer of an overlapped save: ``write``s
        ``host_arrays()`` into ``path``; a failure is surfaced at the drain
        point."""
        errors: list = []
        rank = self.core.distributed.rank

        def work() -> None:
            try:
                with get_tracer().span("checkpoint.write", cat="checkpoint", storage_id=sid,
                                       rank=rank):
                    write(path, host_arrays())
            except BaseException as e:  # surfaced at the drain point
                errors.append(e)

        thread = threading.Thread(target=work, name="dtt-ckpt-writer", daemon=True)
        thread.start()
        return _PendingSave(thread=thread, finish=finish, storage_id=sid,
                            step=self.steps_completed, errors=errors)

    def _async_checkpointing(self) -> bool:
        cfg = self.context.exp_config
        return cfg.optimizations.async_checkpointing if cfg is not None else True

    def _drain_pending_save(self) -> Optional[str]:
        """Wait for the in-flight background save (if any) and run its
        finalize.  Called on the main thread at the next save, preemption or
        exit; a writer's failure raises here."""
        p = self._pending_save
        if p is None:
            return None
        self._pending_save = None
        tracer = get_tracer()
        stall_t0 = time.monotonic()
        if p.thread is not None:
            p.thread.join()
        tracer.record_span(
            "checkpoint.stall", "checkpoint", stall_t0, time.monotonic(),
            {"storage_id": p.storage_id, "failed": bool(p.errors)},
        )
        if self.core.distributed.size > 1:
            # every rank's writer must have landed before the collective
            # finalize writes the manifest
            if not all(self.core.distributed.allgather(not p.errors)) and not p.errors:
                p.errors.append(RuntimeError("another rank's checkpoint writer failed"))
        if p.errors:
            raise RuntimeError(f"async checkpoint {p.storage_id} failed") from p.errors[0]
        with tracer.span("checkpoint.finalize", cat="checkpoint", storage_id=p.storage_id):
            p.finish()
        self.latest_checkpoint = p.storage_id
        for cb in self.callbacks.values():
            cb.on_checkpoint_write_end(p.storage_id)
        logger.info("checkpoint %s at step %d", p.storage_id, p.step)
        return p.storage_id

    def _save_checkpoint(self, asynchronous: bool = True) -> str:
        self._drain_pending_save()  # at most one save in flight
        trainer_state = {
            "steps_completed": self.steps_completed,
            "train_loader": self.train_loader.state_dict(),
            "callbacks": {k: cb.state_dict() for k, cb in self.callbacks.items()},
            "best_validation": self.best_validation,
            # enough to rebuild the trial without the experiment
            # (train.load_trial_from_checkpoint)
            "trial_class": f"{type(self.trial).__module__}:{type(self.trial).__qualname__}",
            "hparams": dict(self.context.hparams),
            "exp_config": self.context.exp_config.raw if self.context.exp_config else None,
            "seed": self.context.seed,
            "mesh_axes": dict(self.mesh.shape) if self.mesh is not None else {"data": 1},
        }
        metadata = {
            "steps_completed": self.steps_completed,
            "framework": "determined_tpu_torch",
            # lineage pointer: a resume that finds THIS checkpoint corrupt
            # falls back to the previous good one
            "parent_storage_id": self.latest_checkpoint,
        }
        tracer = get_tracer()
        # a world of several ranks writes sharded, each rank its own pieces
        shard = self.core.distributed.size > 1
        write = self._writer(shard, trainer_state)
        arrays = self._array_state()
        if shard:
            arrays = serialization.select(arrays, self._sharded_keys()[1])
        if not (asynchronous and self._async_checkpointing()):
            return self._saved(self._write_sync(metadata, arrays, write, shard))

        # overlapped save: snapshot on the device, serialise on a background
        # thread, finalize at the next drain point
        with tracer.span("checkpoint.dispatch", cat="checkpoint", step=self.steps_completed):
            path, sid, finish = self.core.checkpoint.store_path_async(metadata, shard=shard)
            for cb in self.callbacks.values():
                cb.on_checkpoint_write_start(path)
            snapshot = _snapshot(arrays)
            ready = pinned = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
                if self._pinned is None:
                    self._pinned = _pinned_like(snapshot)
                pinned = self._pinned
        device = self.device

        def host_arrays() -> Any:
            if ready is None:
                return snapshot
            # a stream of its own: the copy waits for the clones only, never
            # for the steps queued after them
            with get_tracer().span("checkpoint.copy", cat="checkpoint"):
                side = torch.cuda.Stream(device)
                with torch.cuda.stream(side):
                    side.wait_event(ready)
                    host = _to_host(snapshot, pinned)
                side.synchronize()
            return host

        self._pending_save = self._start_writer(path, sid, finish, host_arrays, write)
        logger.info("async checkpoint %s started at step %d", sid, self.steps_completed)
        return sid

    def _verify_on_restore(self) -> bool:
        cfg = self.context.exp_config
        return cfg.fault_tolerance.verify_checkpoints if cfg is not None else True

    def _restore_checkpoint(self, storage_id: str) -> None:
        """Restore with manifest verification, walking the parent lineage
        on corruption: a checkpoint whose writer died before its manifest,
        or a truncated or bit-flipped file, is rejected and its recorded
        parent tried instead."""
        verify = self._verify_on_restore()
        sid: Optional[str] = storage_id
        tried = []
        while sid:
            try:
                with self.core.checkpoint.restore_path(
                    sid, verify=verify, require_manifest=verify
                ) as path:
                    self.restore_from_path(path)
                self.latest_checkpoint = sid
                if tried:
                    logger.warning(
                        "resumed from fallback checkpoint %s (rejected: %s)", sid, ", ".join(tried)
                    )
                logger.info("restored checkpoint %s at step %d", sid, self.steps_completed)
                return
            except (CheckpointCorruptError, CheckpointNotFoundError) as e:
                logger.warning("checkpoint %s unusable for resume: %s", sid, e)
                tried.append(sid)
                parent = self.core.checkpoint.get_checkpoint_parent(sid)
                if parent in tried:
                    break  # a lineage cycle must not loop forever
                sid = parent
        raise CheckpointCorruptError(
            f"no usable checkpoint in lineage of {storage_id} (tried: {', '.join(tried)}); "
            "checkpoints without a manifest can be resumed by setting "
            "fault_tolerance.verify_checkpoints: false"
        )

    def _restore_checkpoint_traced(self, storage_id: str) -> None:
        with get_tracer().span("checkpoint.restore", cat="restore", storage_id=storage_id):
            self._restore_checkpoint(storage_id)

    def restore_from_path(self, path: str, parts: Optional[Any] = None) -> None:
        """Load the array state and the trainer state from a local
        checkpoint directory, in place (also the tail of
        ``train.load_trial_from_checkpoint``).  Either format, written on
        any mesh: each rank reads its box of every leaf.  A checkpoint
        written on another mesh is restored inside a ``trial.resize``
        span, as the JAX Trainer's elastic reshard is.  ``parts`` restores
        those parts of the array state alone (serving reads ``params``)."""
        tstate = serialization.load_trainer_state(path)
        stored = _mesh_axes(tstate.get("mesh_axes"))
        live = _mesh_axes(self.mesh.shape if self.mesh is not None else None)
        resize = contextlib.nullcontext()
        if stored != live:
            logger.info("elastic reshard: restoring a checkpoint of mesh (%s) onto mesh (%s)",
                        _fmt_axes(stored), _fmt_axes(live))
            resize = get_tracer().span("trial.resize", cat="restore",
                                       from_mesh=_fmt_axes(stored), to_mesh=_fmt_axes(live))
        with resize, get_tracer().span("checkpoint.load", cat="restore"):
            live = self._array_state()
            serialization.restore_arrays(
                path, live if parts is None else {p: live[p] for p in parts},
                place=self._place if self._plan is not None else None,
                # a pipeline rank holds its stage's leaves of the stored ones
                partial=self._plan is not None and self._plan.pipe_size > 1,
            )
        # The JAX Trainer grafts freshly built optax ``hyperparams`` over the
        # restored opt_state here (``_reinject_runtime_hparams``), so that a
        # PBT child trains with its own perturbed lr, not its parent's.  The
        # port's optimizer state is (count, mu, nu) alone: the lr lives in
        # the schedule ``build_optimizer`` made from THIS trial's hparams,
        # which a restore never touches, so there is nothing to graft.
        self.state.reset_metrics()
        self.steps_completed = int(tstate["steps_completed"])
        self.train_loader.load_state_dict(tstate["train_loader"])
        for k, cb in self.callbacks.items():
            cb.load_state_dict(tstate.get("callbacks", {}).get(k, {}))
        self.best_validation = tstate.get("best_validation")
        for cb in self.callbacks.values():
            cb.on_checkpoint_load(path)

    # -- validation --------------------------------------------------------

    def _validate(self) -> Dict[str, float]:
        for cb in self.callbacks.values():
            cb.on_validation_start()
        acc: Dict[str, torch.Tensor] = {}
        n = 0
        prefetch_depth, device_buffer = self._input_opts()
        self.model.eval()
        try:
            with EpochFeed(
                self.val_loader.iter_epoch(0), self.device,
                prefetch_depth=prefetch_depth, device_buffer=device_buffer,
            ) as feed:
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

    def _is_best(self, metrics: Dict[str, float]) -> bool:
        name = self._searcher_metric or "validation_loss"
        if name not in metrics:
            return True  # nothing to compare on; treat as best
        val = metrics[name]
        if self.best_validation is None:
            self.best_validation = val
            return True
        better = val < self.best_validation if self._smaller_is_better else val > self.best_validation
        if better:
            self.best_validation = val
        return better

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

        ``checkpoint_policy`` ("best", "all" or "none") defaults to the
        experiment configuration's, else "best".  A final checkpoint is
        saved unless the policy is "none"; ``latest_checkpoint`` resumes
        from a stored checkpoint (verified, with the lineage fallback)."""
        tracer = get_tracer()
        with tracer.span("trainer.setup", cat="setup"):
            self._setup()
        if checkpoint_policy is None:
            cfg = self.context.exp_config
            checkpoint_policy = cfg.checkpoint_policy if cfg is not None else "best"

        max_steps = self._to_batches(Length.parse(max_length))
        val_sched = _BoundarySchedule(self._to_batches(validation_period), max_steps)
        ckpt_sched = _BoundarySchedule(self._to_batches(checkpoint_period), max_steps)
        rep_period = self._to_batches(report_period)
        if rep_period is None:
            rep_period = min(100, max(1, max_steps // 10))
        rep_sched = _BoundarySchedule(rep_period, max_steps)

        if latest_checkpoint:
            self._restore_checkpoint_traced(latest_checkpoint)

        # bounded trace window: a whole-run capture grows without limit, so
        # tracing stops after profiling.end_after_batch steps, counted from
        # the RESUME point (after the restore, so a restart traces its own
        # window, not an already-expired one)
        prof_cfg = (self.context.exp_config.profiling
                    if self.context.exp_config else None) or {}
        self._trace_stop_step = (
            self.steps_completed + int(prof_cfg.get("end_after_batch", 10))
            if prof_cfg.get("trace")
            else None
        )

        for cb in self.callbacks.values():
            cb.on_training_start(self)

        # overlapped input feed (the JAX Trainer's default depths): host
        # fetch on a background worker two batches ahead, the copy of batch
        # N+1 queued while step N runs; __next__ commits the loader's
        # CONSUMED position, so the state a checkpoint captures is exact
        prefetch_depth, device_buffer = self._input_opts()
        pipeline = InputPipeline(
            self.train_loader, self.device, agg=self.agg,
            prefetch_depth=prefetch_depth, device_buffer=device_buffer,
        )
        gbs = self.train_loader.sampler.global_batch * self.agg
        try:
            self._fit_loop(
                pipeline, max_steps, val_sched, ckpt_sched, rep_sched, checkpoint_policy, gbs
            )
        finally:
            # the worker and the fetch pools must die with the loop, on a
            # clean exit and on a crash: a restart builds a fresh Trainer
            pipeline.close()
            for ld in (self.train_loader, self.val_loader):
                if ld is not None:
                    ld.close()

        # a save still in flight must land before we exit or report completion
        self._drain_pending_save()

        # final: always leave at least one checkpoint unless policy is none
        if checkpoint_policy != "none" and self._last_ckpt_sid is None:
            self._last_ckpt_sid = self._save_checkpoint(asynchronous=False)

        for cb in self.callbacks.values():
            cb.on_trial_shutdown()

        return {
            "steps_completed": self.steps_completed,
            "latest_checkpoint": self._last_ckpt_sid,
            "validation_metrics": self._last_val_metrics,
            "stopped_early": self._stopped_early,
            "best_validation": self.best_validation,
        }

    def _trace_window_open(self) -> bool:
        return self._trace_stop_step is not None and self.core.profiler.tracing

    def _fit_loop(
        self,
        pipeline: InputPipeline,
        max_steps: int,
        val_sched: _BoundarySchedule,
        ckpt_sched: _BoundarySchedule,
        rep_sched: _BoundarySchedule,
        checkpoint_policy: str,
        gbs: int,
    ) -> None:
        tracer = get_tracer()
        hot_time = 0.0  # train-segment wall time since the last report
        steps_since_report = 0
        self._last_ckpt_sid = None
        self._last_val_metrics = {}
        self._stopped_early = False
        epoch_seen = self.train_loader.epoch

        while self.steps_completed < max_steps:
            next_stop = min(
                val_sched.next_after(self.steps_completed),
                ckpt_sched.next_after(self.steps_completed),
                rep_sched.next_after(self.steps_completed),
                max_steps,
            )
            if self._trace_window_open() and self._trace_stop_step > self.steps_completed:
                # break the hot segment at the trace boundary so the window
                # is end_after_batch steps, not rounded up to a report
                next_stop = min(next_stop, self._trace_stop_step)
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
            if self._trace_window_open() and self.steps_completed >= self._trace_stop_step:
                self.core.profiler.stop_trace()

            # ---- REPORT ---------------------------------------------------
            if rep_sched.is_boundary(self.steps_completed) or at_end:
                sync_t0 = time.monotonic()
                # the one host sync (and on a mesh the one all-reduce)
                metrics = self.state.fetch_metrics(
                    self._mean_over_ranks if self.mesh is not None else None
                )
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
                    if self._comm_model is not None:
                        # step.comm rows: FSDP2's bytes, exposed and
                        # hidden by the bucket model on the segment's mean
                        # step, a row a hop that moves bytes (counters: the
                        # spans' nesting stays as it was)
                        n = float(steps_since_report)
                        hops = self._comm_model.split_hops(hot_time / steps_since_report)
                        tracer.counter("step.comm.bytes",
                                       float(self._comm_model.total_bytes_per_step) * n)
                        tracer.counter("step.comm.exposed_us",
                                       sum(e for e, _ in hops.values()) * 1e6 * n)
                        tracer.counter("step.comm.hidden_us",
                                       sum(h for _, h in hops.values()) * 1e6 * n)
                        hop_bytes = {"ici": self._comm_model.bytes_per_step,
                                     "dcn": self._comm_model.dcn_bytes_per_step}
                        for hop, (he, hh) in hops.items():
                            if hop_bytes[hop]:
                                tracer.counter(f"step.comm.{hop}.bytes",
                                               float(hop_bytes[hop]) * n)
                                tracer.counter(f"step.comm.{hop}.exposed_us", he * 1e6 * n)
                                tracer.counter(f"step.comm.{hop}.hidden_us", hh * 1e6 * n)
                    if self._bubble_model is not None:
                        # step.bubble rows: pipe-axis idle time by the
                        # schedule's tick model, on the segment's mean step
                        bubble_s, _ = self._bubble_model.split(hot_time / steps_since_report)
                        tracer.counter("step.bubble.exposed_us",
                                       bubble_s * 1e6 * float(steps_since_report))
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
            validated = False
            if val_sched.period is not None and (
                val_sched.is_boundary(self.steps_completed) or at_end
            ):
                with tracer.span("validate", cat="validate", step=self.steps_completed):
                    self._last_val_metrics = self._validate()
                validated = True

            # ---- CHECKPOINT -----------------------------------------------
            want_ckpt = ckpt_sched.period is not None and ckpt_sched.is_boundary(
                self.steps_completed
            )
            if validated and checkpoint_policy == "all":
                want_ckpt = True
            if validated and checkpoint_policy == "best" and self._is_best(self._last_val_metrics):
                want_ckpt = True
            # ---- PREEMPT --------------------------------------------------
            preempted = self.core.preempt.should_preempt()
            if preempted:
                want_ckpt = True
            if want_ckpt:
                pending = self._pending_save
                if (
                    preempted
                    and pending is not None
                    and pending.step == self.steps_completed
                    # one rank's writer error must not split the ranks
                    # between two collectives: on several, the drain's vote
                    # raises it everywhere
                    and (not pending.errors or self.core.distributed.size > 1)
                ):
                    # a save of this exact step is already in flight:
                    # wait for it instead of writing a duplicate
                    self._last_ckpt_sid = self._drain_pending_save()
                else:
                    # on preemption the save must be durable before exit,
                    # so skip the overlap and write synchronously
                    self._last_ckpt_sid = self._save_checkpoint(asynchronous=not preempted)
            if preempted:
                logger.info("preempted at step %d; exiting cleanly", self.steps_completed)
                self._stopped_early = True
                break
