"""MNIST models + trial: the search path's small trial.

Port of ``determined_tpu/models/mnist.py``: ``MnistMLP`` and ``MnistCNN``
compute what the flax modules compute (``convert.mnist_state_dict`` maps a
flax param tree onto them), and ``MnistTrial`` keeps the JAX trial's
hyperparameters (``model``, ``hidden``, ``lr``, ``global_batch_size``,
``dataset_size``) and data seeds (train 0, validation 1).  Images arrive
NHWC ``[b, 28, 28, 1]`` as in the JAX package; the CNN runs its convolutions
in NCHW and flattens NHWC, so its ``fc1`` rows keep the flax order.  Adam is
the port's fused AdamW with no weight decay and no clip: ``optax.adam`` step
for step, and on CUDA every leaf goes through the ``fused_adamw`` kernel.
The weights are random from the trial's generator (normal with std
``fan_in ** -0.5``, biases zero), where flax draws a truncated normal.

On a ``tensor`` mesh axis (``shard_tensor``, called by
``parallel.sharding.shard_model``) both models split their hidden dense
layer as the flax modules' ``mlp`` annotation asks: ``fc1`` keeps this
rank's output units (rows and bias), ``fc2`` the matching input columns,
its output all-reduced before its bias (``parallel/tensor_parallel.py``).
The convolutions stay whole.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.data import DataLoader, mnist_like
from determined_tpu_torch.models._layers import init_weights
from determined_tpu_torch.parallel.tensor_parallel import (
    copy_to,
    keep_slice,
    reduce_from,
    split_range,
)
from determined_tpu_torch.train._trial import TorchTrial


class _HiddenSplit:
    """``fc1 -> relu -> fc2``, column- then row-parallel on a tensor group."""

    tensor = None  # (group, size, rank) once sharded

    def shard_tensor(self, group, size: int, rank: int) -> Dict[str, int]:
        lo, hi = split_range(self.fc1.weight.shape[0], size, rank, "the hidden width")
        keep_slice(self.fc1, "weight", 0, lo, hi)
        keep_slice(self.fc1, "bias", 0, lo, hi)
        keep_slice(self.fc2, "weight", 1, lo, hi)
        self.tensor = (group, size, rank)
        return {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}

    def _hidden_to_out(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return self.fc2(F.relu(self.fc1(x)))
        h = F.relu(self.fc1(copy_to(x, self.tensor[0])))
        return reduce_from(F.linear(h, self.fc2.weight), self.tensor[0]) + self.fc2.bias


class MnistMLP(_HiddenSplit, nn.Module):
    """Two-layer MLP: 784 -> hidden -> 10."""

    def __init__(
        self,
        hidden: int = 128,
        num_classes: int = 10,
        *,
        device: DeviceLike = None,
        generator: torch.Generator = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.fc1 = nn.Linear(28 * 28, hidden, device=dev)
        self.fc2 = nn.Linear(hidden, num_classes, device=dev)
        init_weights(self, generator or torch.Generator(device=dev).manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._hidden_to_out(x.reshape(x.shape[0], -1))


class MnistCNN(_HiddenSplit, nn.Module):
    """Conv net of the reference tutorial's shape (2 conv + 2 dense): 3x3
    convolutions with SAME padding (flax's default), 2x2 max pools."""

    def __init__(
        self,
        num_classes: int = 10,
        *,
        device: DeviceLike = None,
        generator: torch.Generator = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1, device=dev)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=dev)
        self.fc1 = nn.Linear(7 * 7 * 64, 128, device=dev)
        self.fc2 = nn.Linear(128, num_classes, device=dev)
        init_weights(self, generator or torch.Generator(device=dev).manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        # flatten in NHWC order, as the flax model does
        return self._hidden_to_out(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class MnistTrial(TorchTrial):
    """The "tutorial" trial: hyperparameters mirror the reference mnist
    example (lr, hidden size, global_batch_size)."""

    def build_model(self) -> nn.Module:
        dev, gen = self.context.device, self.context.generator()
        if self.context.get_hparam("model", "mlp") == "cnn":
            return MnistCNN(device=dev, generator=gen)
        return MnistMLP(int(self.context.get_hparam("hidden", 128)), device=dev, generator=gen)

    def build_optimizer(self) -> Any:
        from determined_tpu_torch.ops.fused_adamw import fused_adamw

        # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, no decay, no clip
        lr = float(self.context.get_hparam("lr", 1e-3))
        return fused_adamw(lr, weight_decay=0.0, clip_norm=None)

    def _dataset(self, train: bool):
        size = int(self.context.get_hparam("dataset_size", 4096))
        return mnist_like(size=size, seed=0 if train else 1)

    def build_training_data_loader(self) -> DataLoader:
        return DataLoader(
            self._dataset(train=True), self.context.get_global_batch_size(),
            shuffle=True, seed=self.context.seed,
        )

    def build_validation_data_loader(self) -> DataLoader:
        return DataLoader(
            self._dataset(train=False), self.context.get_global_batch_size(),
            shuffle=False, seed=self.context.seed,
        )

    def loss(
        self, model: nn.Module, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = model(batch["image"])
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}

    def evaluate_batch(self, model: nn.Module, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, metrics = self.loss(model, batch)
        return {"validation_loss": loss, "validation_accuracy": metrics["accuracy"]}
