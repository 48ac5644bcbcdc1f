"""Tensor parallelism: Megatron's conjugate pair of autograd Functions, the
vocab-parallel embedding, and the parameter splits the models' ``shard_tensor``
methods make.

Where the JAX package annotates kernels with the logical axes ``heads``,
``mlp`` and ``vocab`` (``parallel/sharding.py``'s rules map them to the
``tensor`` mesh axis) and XLA inserts the collectives, the port splits the
parameters itself and puts the collectives in the forward:

- ``copy_to(x, group)`` before the column-parallel products (q, k, v; gate,
  up; the lm head): identity forward, all-reduce of the gradient backward;
- ``reduce_from(x, group)`` after the row-parallel products (wo, w_down):
  all-reduce forward, identity backward (every rank holds the same loss).

A parameter split over ``tensor`` stays a plain parameter of its module,
holding this rank's rows or columns (``keep_slice``); ``shard_tensor``
returns the names it split with their dims, and ``sharding.ShardPlan``
gathers and cuts them along those dims for checkpoints and sums their
squares over the group for the clip's norm.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduce(torch.autograd.Function):
    """All-reduce (sum) over ``group``; every rank holds the same loss, so
    the backward passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's ``f``: x enters this rank's slice of a product whole;
    the partial gradients of the slices are summed over ``group``."""
    return _SumGrad.apply(x, group)


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's ``g``: the partial outputs of the slices summed."""
    return _AllReduce.apply(x, group)


def split_range(total: int, size: int, rank: int, what: str):
    """``[lo, hi)`` of rank ``rank``'s equal part of ``total``."""
    if total % size:
        raise ValueError(f"the tensor axis ({size}) must divide {what} ({total})")
    part = total // size
    return rank * part, (rank + 1) * part


@torch.no_grad()
def keep_slice(module: nn.Module, name: str, dim: int, lo: int, hi: int) -> None:
    """Replace parameter ``name`` of ``module`` by its ``[lo, hi)`` slice
    along ``dim`` (a new, contiguous parameter)."""
    p = getattr(module, name)
    setattr(module, name, nn.Parameter(p.narrow(dim, lo, hi - lo).clone(),
                                       requires_grad=p.requires_grad))


def vocab_parallel_embedding(weight: torch.Tensor, tokens: torch.Tensor, group: Any,
                             lo: int) -> torch.Tensor:
    """Rows of the whole embedding for ``tokens`` when this rank holds rows
    ``[lo, lo + weight.shape[0])``: a masked local lookup, then an
    all-reduce (one rank contributes each row, the rest zeros)."""
    local = tokens - lo
    inside = (local >= 0) & (local < weight.shape[0])
    rows = weight[local.clamp(0, weight.shape[0] - 1)]
    return reduce_from(rows * inside[..., None].to(rows.dtype), group)
