"""Training engine of the port: TorchTrial, the Trainer's boundary loop,
checkpoint serialization, restart supervision and reloading a trial from a
checkpoint (``determined_tpu/train`` for one device)."""

from determined_tpu_torch.train import serialization
from determined_tpu_torch.train._load import load_trial_from_checkpoint
from determined_tpu_torch.train._reducer import MetricReducer, get_reducer
from determined_tpu_torch.train._restart import Attempt, RestartPolicy, run_with_restarts
from determined_tpu_torch.train._state import TrainState
from determined_tpu_torch.train._trainer import Trainer, init
from determined_tpu_torch.train._trial import Callback, TorchTrial, TrialContext

__all__ = [
    "Attempt",
    "Callback",
    "MetricReducer",
    "RestartPolicy",
    "TorchTrial",
    "TrainState",
    "Trainer",
    "TrialContext",
    "get_reducer",
    "init",
    "load_trial_from_checkpoint",
    "run_with_restarts",
    "serialization",
]
