"""Training engine of the port: TorchTrial + the Trainer's boundary loop
(``determined_tpu/train`` for one device; checkpoints and the experiment
configuration come with a later slice)."""

from determined_tpu_torch.train._reducer import MetricReducer, get_reducer
from determined_tpu_torch.train._state import TrainState
from determined_tpu_torch.train._trainer import Trainer, init
from determined_tpu_torch.train._trial import Callback, TorchTrial, TrialContext

__all__ = [
    "Callback",
    "MetricReducer",
    "TorchTrial",
    "TrainState",
    "Trainer",
    "TrialContext",
    "get_reducer",
    "init",
]
