"""Layers that compute as flax's ``nn.Conv``, ``nn.Dense`` and ``nn.GroupNorm``
do under ``param_dtype=float32`` and a compute ``dtype``: the parameters stay
f32 and are cast to the input's dtype in the forward, so gradients reach the
f32 leaves.  Tensors are NCHW.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(n: int, k: int, s: int) -> List[int]:
    """(before, after) padding of flax's ``padding="SAME"`` along a dim of
    size ``n``: the output has ``ceil(n / s)`` positions and the extra pad
    goes after, so a stride 2 over an even size pads 0 before and 1 after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return [total // 2, total - total // 2]


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` with ``padding="SAME"`` over NCHW input."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, *,
                 bias: bool = True, device=None) -> None:
        super().__init__(cin, cout, kernel, stride=stride, padding=0, bias=bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph, pw = _same_pads(x.shape[2], k, s), _same_pads(x.shape[3], k, s)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, b, s, padding=(ph[0], pw[0]))
        return F.conv2d(F.pad(x, pw + ph), w, b, s)


class Dense(nn.Linear):
    """``flax.linen.Dense``: computes in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    """``flax.linen.GroupNorm`` (epsilon 1e-6): statistics, normalisation,
    scale and bias in f32, the result rounded once to the input's dtype."""

    def __init__(self, groups: int, channels: int, *, device=None) -> None:
        super().__init__(groups, channels, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights: each conv and dense kernel normal with std
    ``fan_in ** -0.5`` (flax draws lecun normal, truncated), biases zero,
    GroupNorm scale one and bias zero."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
