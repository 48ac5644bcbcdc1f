"""TorchTrial: the user-facing trial ABC and its TrialContext.

Port of ``determined_tpu/train/_trial.py`` (``JaxTrial``).  Users subclass,
implement the data/model/optimizer builders and a per-batch loss; the
Trainer owns the loop.  Where the JAX trial's ``loss`` is a pure function of
a param tree traced under ``jit``, here it is an eager forward of the
trial's ``nn.Module`` that returns a differentiable scalar; the Trainer runs
the backward and the optimizer step.  The context holds the ``torch.device``
this rank runs on and, on a mesh, the port's ``parallel.Mesh`` (one process
a device: the trial's loss sees this rank's shard of each global batch).
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, Dict, Optional, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def takes_rng(trial: "TorchTrial") -> bool:
    """Whether ``trial.loss`` declares the generator parameter."""
    return len(inspect.signature(trial.loss).parameters) >= 3


class TrialContext:
    """Per-trial handle: hyperparameters, device, seed and core services."""

    def __init__(
        self,
        core: Any,
        device: torch.device,
        hparams: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        exp_config: Optional[Any] = None,
        mesh: Optional[Any] = None,
        virtual_pipe: Optional[Any] = None,
    ) -> None:
        self.core = core
        self.device = device
        self.mesh = mesh
        # a pipeline whose stages all live in this process
        # (parallel/pipeline.py VirtualPipe), only ever the caller's choice
        self.virtual_pipe = virtual_pipe
        self.hparams = dict(hparams or {})
        self.seed = seed
        self.exp_config = exp_config

    # -- hyperparameters ---------------------------------------------------

    def get_hparam(self, name: str, default: Any = ...) -> Any:
        if name in self.hparams:
            v = self.hparams[name]
            return getattr(v, "val", v)
        if default is ...:
            raise KeyError(f"hyperparameter {name!r} not set and no default given")
        return default

    # -- topology ----------------------------------------------------------

    @property
    def batch_axis_size(self) -> int:
        """Product of the batch-carrying axes (data x fsdp): 1 without a
        mesh."""
        if self.mesh is None:
            return 1
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    @property
    def pipe_stages(self) -> int:
        """Pipeline stages: the virtual pipe's, else the mesh's ``pipe``
        axis (1 without either)."""
        if self.virtual_pipe is not None:
            return self.virtual_pipe.size
        return self.mesh.shape["pipe"] if self.mesh is not None else 1

    def get_global_batch_size(self) -> int:
        return int(self.get_hparam("global_batch_size", 32))

    def generator(self) -> torch.Generator:
        """A generator on the trial's device seeded with the trial's seed
        (model weights are drawn from it)."""
        return torch.Generator(device=self.device).manual_seed(self.seed)


class Callback:
    """Training lifecycle hooks, all host-side, run at boundaries."""

    def on_training_start(self, trainer: Any) -> None: ...

    def on_epoch_start(self, epoch: int) -> None: ...

    def on_epoch_end(self, epoch: int) -> None: ...

    def on_validation_start(self) -> None: ...

    def on_validation_end(self, metrics: Dict[str, float]) -> None: ...

    def on_checkpoint_write_start(self, path: str) -> None: ...

    def on_checkpoint_write_end(self, storage_id: str) -> None: ...

    def on_checkpoint_load(self, path: str) -> None: ...

    def on_training_workload_end(
        self, steps_completed: int, metrics: Dict[str, float]
    ) -> None: ...

    def on_trial_shutdown(self) -> None: ...

    # extra state carried through checkpoints (JSON-serialisable)
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


class TorchTrial(abc.ABC):
    """Subclass this; the Trainer drives everything else."""

    def __init__(self, context: TrialContext) -> None:
        self.context = context

    # -- builders ----------------------------------------------------------

    @abc.abstractmethod
    def build_model(self) -> torch.nn.Module:
        """The model, with its weights, on ``context.device``."""

    @abc.abstractmethod
    def build_optimizer(self) -> Any:
        """An optimizer with ``init(params)`` and ``apply_step(grads, state,
        params)`` over dicts of tensors keyed like ``named_parameters()``."""

    @abc.abstractmethod
    def build_training_data_loader(self) -> Any:
        ...

    @abc.abstractmethod
    def build_validation_data_loader(self) -> Any:
        ...

    def build_callbacks(self) -> Dict[str, Callback]:
        return {}

    # -- compute -----------------------------------------------------------

    @abc.abstractmethod
    def loss(self, model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Metrics]:
        """Scalar loss (differentiable) + auxiliary metric dict for one
        training batch.  A trial that draws random numbers declares a third
        parameter, ``loss(model, batch, rng)``: the Trainer then passes the
        step's ``torch.Generator`` (the JAX trial's per-step rng), seeded
        from the state's generator and the step."""

    def evaluate_batch(self, model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> Metrics:
        """Validation metrics for one batch; defaults to the loss (with a
        generator seeded with 0 where the loss takes one, as the JAX trial's
        ``jax.random.key(0)``).  Runs under ``torch.no_grad()``."""
        if takes_rng(self):
            rng = torch.Generator(device=self.context.device).manual_seed(0)
            loss, metrics = self.loss(model, batch, rng)
        else:
            loss, metrics = self.loss(model, batch)
        return {"validation_loss": loss, **{f"val_{k}": v for k, v in metrics.items()}}

    def evaluation_reducers(self) -> Dict[str, Any]:
        """Per-metric across-batch reducers: builtin names
        ("mean"/"sum"/"min"/"max"/"last") or ``MetricReducer`` instances.
        Unlisted metrics reduce by mean."""
        return {}
