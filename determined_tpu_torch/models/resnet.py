"""ResNet for 32x32 image classification and its trial (``examples/cifar10``).

Port of ``determined_tpu/models/resnet.py``: ``ResidualBlock``, ``ResNet``
and ``CifarTrial`` compute what the flax modules and the JAX trial compute
(``convert.resnet_state_dict_from_flax`` maps a flax param tree onto them).
GroupNorm with 8 groups in place of BatchNorm, as there: the step stays a
function of the weights and the batch.  Parameters are f32 and the network
computes in bf16 unless ``bf16`` is false; the head is an f32 dense layer
over the pooled mean.  Images arrive NHWC ``[b, 32, 32, 3]`` as in the JAX
package and are permuted to NCHW once.  Every convolution pads as flax's
``padding="SAME"``, which pads 0 before and 1 after when a stride-2 stage
halves 32 to 16 (``_layers.Conv``).  ``CifarTrial`` keeps the JAX trial's
hyperparameters (``lr``, ``momentum``, ``global_batch_size``,
``dataset_size``, ``depth_per_stage``, ``widths``, ``num_classes``,
``bf16``), data seeds (train 0, validation 1) and metrics; its optimizer is
``train/_optim.py``'s ``sgd``, ``optax.sgd`` step for step.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.data import DataLoader, cifar_like
from determined_tpu_torch.models._layers import Conv, GroupNorm, init_weights
from determined_tpu_torch.train._trial import TorchTrial


class ResidualBlock(nn.Module):
    """conv-GN-relu, conv-GN, plus the input (or its strided conv-GN
    projection where the shape changes), relu."""

    def __init__(self, cin: int, channels: int, stride: int = 1, *, device=None) -> None:
        super().__init__()
        self.conv1 = Conv(cin, channels, 3, stride, bias=False, device=device)
        self.gn1 = GroupNorm(8, channels, device=device)
        self.conv2 = Conv(channels, channels, 3, bias=False, device=device)
        self.gn2 = GroupNorm(8, channels, device=device)
        # flax adds the projection when the residual's shape differs
        self.has_proj = stride != 1 or cin != channels
        if self.has_proj:
            self.proj = Conv(cin, channels, 3, stride, bias=False, device=device)
            self.gn_proj = GroupNorm(8, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        residual = self.gn_proj(self.proj(x)) if self.has_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-(6n+2): stages of ``widths`` x ``depth_per_stage`` blocks over
    32x32 NHWC inputs; every stage after the first halves the map."""

    def __init__(
        self,
        num_classes: int = 10,
        widths: Sequence[int] = (16, 32, 64),
        depth_per_stage: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        *,
        device: DeviceLike = None,
        generator: torch.Generator = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.stem = Conv(3, widths[0], 3, bias=False, device=dev)
        self.gn_stem = GroupNorm(8, widths[0], device=dev)
        # blocks named as flax names them: s{stage}b{block}
        self.block_names = []
        cin = widths[0]
        for stage, width in enumerate(widths):
            for block in range(depth_per_stage):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.block_names.append(f"s{stage}b{block}")
                self.add_module(self.block_names[-1], ResidualBlock(cin, width, stride, device=dev))
                cin = width
        self.head = nn.Linear(cin, num_classes, device=dev)
        init_weights(self, generator or torch.Generator(device=dev).manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW
        x = F.relu(self.gn_stem(self.stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        # global average pool: summed in f32 and rounded to the compute
        # dtype (jnp.mean of bf16), then the f32 head
        return self.head(x.mean(dim=(2, 3)).float())


class CifarTrial(TorchTrial):
    """hparams: lr, momentum, global_batch_size, dataset_size,
    depth_per_stage, widths, num_classes, bf16."""

    def build_model(self) -> ResNet:
        g = self.context.get_hparam
        return ResNet(
            num_classes=int(g("num_classes", 10)),
            widths=tuple(g("widths", (16, 32, 64))),
            depth_per_stage=int(g("depth_per_stage", 3)),
            dtype=torch.bfloat16 if bool(g("bf16", True)) else torch.float32,
            device=self.context.device,
            generator=self.context.generator(),
        )

    def build_optimizer(self) -> Any:
        from determined_tpu_torch.train._optim import sgd

        g = self.context.get_hparam
        return sgd(float(g("lr", 0.1)), momentum=float(g("momentum", 0.9)))

    def _dataset(self, train: bool):
        g = self.context.get_hparam
        return cifar_like(
            size=int(g("dataset_size", 4096)),
            num_classes=int(g("num_classes", 10)),
            seed=0 if train else 1,
        )

    def build_training_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(True), self.context.get_global_batch_size(),
                          shuffle=True, seed=self.context.seed)

    def build_validation_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(False), self.context.get_global_batch_size(),
                          shuffle=False, seed=self.context.seed)

    def loss(
        self, model: nn.Module, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = model(batch["image"])
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}

    def evaluate_batch(
        self, model: nn.Module, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        loss, metrics = self.loss(model, batch)
        return {"validation_loss": loss, "validation_accuracy": metrics["accuracy"]}
