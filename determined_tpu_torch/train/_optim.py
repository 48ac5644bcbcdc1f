"""Learning-rate schedules and the non-fused optimizer of the port.

- ``warmup_cosine_decay_schedule`` and its parts reproduce
  ``optax.warmup_cosine_decay_schedule`` (a linear warmup joined to a cosine
  decay at ``warmup_steps``) in the same f32 arithmetic, on a device step
  counter, so reading the learning rate never waits for the host.
- ``ClipAdamW`` is ``optax.chain(clip_by_global_norm(c), adamw(...))`` in
  plain torch, step for step, and ``optax.adamw(...)`` itself with
  ``clip_norm=None``.  ``LMTrial`` uses it only when a trial asks for
  ``fused_adamw: false``; the main path runs ``ops/fused_adamw.py``.  The HF
  trials (``models/hf_gpt2.py``, ``models/hf_bert.py``) use it unclipped
  by default, as the JAX trials use ``optax.adamw``.
- ``sgd`` is ``optax.sgd(learning_rate, momentum=m)`` (heavy-ball momentum,
  no Nesterov), ``CifarTrial``'s optimizer.  The JAX package computes it
  in optax, outside any Pallas kernel, so here it is plain torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from determined_tpu_torch.ops.fused_adamw import FusedAdamWState, Tree, global_norm

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _count(count) -> torch.Tensor:
    return count if isinstance(count, torch.Tensor) else torch.as_tensor(count, dtype=torch.int32)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init`` to ``end`` over ``transition_steps``."""
    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32,
                                        device=_count(count).device)

    def schedule(count) -> torch.Tensor:
        c = torch.clamp(_count(count), 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(
            f"the cosine_decay_schedule requires positive decay_steps, got {decay_steps=}"
        )
    steps = float(decay_steps)

    def schedule(count) -> torch.Tensor:
        c = torch.clamp(_count(count).float(), max=steps)
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count) -> torch.Tensor:
        count = _count(count)
        return torch.where(count < warmup_steps, warmup(count), decay(count - warmup_steps))

    return schedule


@dataclasses.dataclass(frozen=True)
class ClipAdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(learning_rate, b1,
    b2, eps, weight_decay=weight_decay, mu_dtype=mu_dtype))`` in plain
    torch, updating params and state in place.  The state is optax's
    ``ScaleByAdamState`` (count, mu, nu); the schedule reads the same count.
    With ``clip_norm=None`` it is ``optax.adamw(...)`` alone: no global norm
    is computed, and the decay applies to every leaf (optax's mask is None)."""

    learning_rate: Union[float, Schedule]
    clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Tree) -> FusedAdamWState:
        mu = {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        device = next(iter(params.values())).device
        return FusedAdamWState(torch.zeros((), dtype=torch.int32, device=device), mu, nu)

    @torch.no_grad()
    def apply_step(
        self, grads: Tree, state: FusedAdamWState, params: Tree,
        norm: Optional[Callable[[Tree], torch.Tensor]] = None,
    ) -> Tuple[Tree, FusedAdamWState]:
        if self.clip_norm is not None:
            g_norm = (norm or global_norm)(grads)
            trigger = g_norm < self.clip_norm
        count_inc = state.count + 1
        bc1 = 1 - self.b1 ** count_inc
        bc2 = 1 - self.b2 ** count_inc
        lr = self.learning_rate
        step_size = -(lr(state.count) if callable(lr) else torch.as_tensor(lr))
        for k, p in params.items():
            g = grads[k]
            if self.clip_norm is not None:
                g = torch.where(trigger, g, (g / g_norm) * self.clip_norm)
            # optax multiplies the stored moment by b1 in the moment's dtype
            # (JAX casts the Python scalar to bf16 under mu_dtype=bf16)
            b1 = torch.tensor(self.b1, dtype=state.mu[k].dtype)
            mu = (1 - self.b1) * g + b1 * state.mu[k]
            nu = (1 - self.b2) * g ** 2 + self.b2 * state.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(step_size.to(p.dtype) * u)
            state.mu[k].copy_(mu)
            state.nu[k].copy_(nu)
        return params, FusedAdamWState(count_inc, state.mu, state.nu)


class SGDState(NamedTuple):
    trace: Tree  # the momentum buffers (optax's ``TraceState.trace``), param-shaped


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(learning_rate, momentum)``: ``trace = g + momentum * trace``,
    ``p += -learning_rate * trace``, in place, in the params' dtype."""

    learning_rate: float
    momentum: float = 0.0

    def init(self, params: Tree) -> SGDState:
        return SGDState({k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def apply_step(
        self, grads: Tree, state: SGDState, params: Tree, norm: Any = None
    ) -> Tuple[Tree, SGDState]:
        """``norm`` is unused: plain SGD clips nothing."""
        keys = list(params)
        trace = [state.trace[k] for k in keys]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, [grads[k] for k in keys])
        # optax scales the trace by -lr, then adds: two roundings, not one fma
        updates = torch._foreach_mul(trace, -self.learning_rate)
        torch._foreach_add_([params[k] for k in keys], updates)
        return params, state


def sgd(learning_rate: float, momentum: Optional[float] = None) -> SGD:
    """``optax.sgd(learning_rate, momentum=momentum)`` (``None``: no trace,
    which a zero momentum computes alike)."""
    return SGD(learning_rate=learning_rate, momentum=momentum or 0.0)
