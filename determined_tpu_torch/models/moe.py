"""Mixture-of-Experts layer: top-2 routing with capacity, and expert
parallelism over a process group.

Port of ``determined_tpu/models/moe.py``.  Expert weights are stacked
``[experts, ...]`` tensors in flax's layout (``w_in``/``w_gate`` ``[e, d, f]``,
``w_out`` ``[e, f, d]``, the router ``[d, e]``), so ``convert.py`` maps them
one to one.  Tokens route within fixed-size groups (GShard's formulation):
dispatch and combine are ``[groups, group_size, e, c]`` with ``c ~
2 * group_size / e``, built from the f32 router's softmax by
``_top2_dispatch``, and the expert FFN runs as dense einsums in
``dtype``.  These einsums are plain large products that the JAX package also
computes outside Pallas, so they stay ``torch.einsum``.

Expert parallelism (``shard_experts``) is the JAX ``expert_axis_name``
path: each rank of the expert group keeps ``e / n`` experts and computes
them against the whole token set of its batch shard; routing stays
replicated, each rank keeps its own columns of dispatch and combine, and the
combine is an all-reduce over the group.  In the backward every rank holds
the same loss, so the all-reduce passes its gradient through unchanged,
while the gradients that flow into ``x`` and into the gates through a
rank's slice of the experts are partial and are summed over the group.  The
aux loss's gradient to the gates is whole on every rank and is not summed.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch.parallel.tensor_parallel import copy_to, reduce_from

EXPERT_PARAMS = ("w_in", "w_gate", "w_out")


def _top2_dispatch(
    gates: torch.Tensor, capacity: int, combine_gates: Any = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors for top-2 routing with capacity.

    ``gates`` is ``[..., g, e]`` (the JAX function's ``[g, e]``, which the
    layer vmaps over its groups); tokens beyond an expert's capacity are
    dropped and the combine weights renormalise over the surviving routes.
    ``combine_gates`` maps the gates before they enter the combine weights
    (the expert-parallel layer sums their gradient there).  Returns
    ``(dispatch [..., g, e, c], combine [..., g, e, c], aux [...])``."""
    e = gates.shape[-1]
    dt = gates.dtype
    # top-1 and top-2 expert per token (argmax takes the first maximum, as
    # jnp.argmax does)
    mask1 = F.one_hot(gates.argmax(dim=-1), e).to(dt)              # [g, e]
    gates2 = gates * (1.0 - mask1)
    mask2 = F.one_hot(gates2.argmax(dim=-1), e).to(dt)

    # load-balancing aux loss (Switch eq. 4): e * sum_e(fraction of tokens
    # routed to e * mean router probability of e); 1 at perfect balance
    density = mask1.mean(dim=-2)                                    # [e]
    density_proxy = gates.mean(dim=-2)
    aux = (density * density_proxy).sum(dim=-1) * e

    # position of each token in its expert's queue (top-1 first)
    pos1 = (torch.cumsum(mask1, dim=-2) - 1.0) * mask1              # [g, e]
    used1 = mask1.sum(dim=-2, keepdim=True)                         # [1, e]
    pos2 = ((torch.cumsum(mask2, dim=-2) - 1.0) + used1) * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    cg = gates if combine_gates is None else combine_gates(gates)
    p1 = (cg * keep1).sum(dim=-1)                                   # [g]
    p2 = (cg * keep2).sum(dim=-1)
    denom = torch.clamp(p1 + p2, min=1e-9)
    w1 = p1 / denom
    w2 = p2 / denom

    def slots(keep: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        slot = F.one_hot((pos * keep).sum(dim=-1).long(), capacity).to(dt)  # [g, c]
        return keep[..., :, None] * slot[..., None, :]                       # [g, e, c]

    d1, d2 = slots(keep1, pos1), slots(keep2, pos2)
    dispatch = d1 + d2
    combine = d1 * w1[..., None, None] + d2 * w2[..., None, None]
    return dispatch, combine, aux


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over ``group`` in rank order; the backward
    sums every rank's gradient and returns this rank's rows (each rank's
    loss is its share of a loss averaged over the group)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, size: int, rank: int) -> torch.Tensor:
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None


class MoE(nn.Module):
    """Top-2 SwiGLU experts, a drop-in for a dense MLP block:
    ``[b, s, d] -> ([b, s, d], aux)``.

    f32 parameters, initialised as flax's ``lecun_normal`` scales them (its
    fan-in counts the stacked expert dim: std ``(e * d) ** -0.5`` for
    ``w_in``/``w_gate``, ``(e * f) ** -0.5`` for ``w_out``, ``d ** -0.5``
    for the router).  Routing in f32; the expert products in ``dtype``."""

    def __init__(
        self,
        d_model: int,
        num_experts: int,
        d_ff: int,
        *,
        capacity_factor: float = 1.25,
        group_size: int = 4096,
        dtype: torch.dtype = torch.bfloat16,
        device: Any = None,
    ) -> None:
        super().__init__()
        self.num_experts = num_experts
        self.d_ff = d_ff
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty(d_model, num_experts, **f32))
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, d_ff, **f32))
        self.w_gate = nn.Parameter(torch.empty(num_experts, d_model, d_ff, **f32))
        self.w_out = nn.Parameter(torch.empty(num_experts, d_ff, d_model, **f32))
        # expert parallelism (shard_experts): the group, its size and this
        # rank's index in it
        self.expert_group: Any = None
        self.expert_size = 1
        self.expert_rank = 0
        # the batch shards (shard_batch): the group of the ranks that hold
        # the other slices of the global batch, in batch order
        self.batch_group: Any = None
        self.batch_shards = 1
        self.batch_rank = 0

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        e, d, f = self.w_in.shape
        self.router.normal_(0.0, d ** -0.5, generator=generator)
        self.w_in.normal_(0.0, (e * d) ** -0.5, generator=generator)
        self.w_gate.normal_(0.0, (e * d) ** -0.5, generator=generator)
        self.w_out.normal_(0.0, (e * f) ** -0.5, generator=generator)

    @torch.no_grad()
    def shard_experts(self, group: Any, size: int, rank: int) -> None:
        """Keep experts ``[rank * e / size, (rank + 1) * e / size)`` of the
        stacked weights (the rest live on the group's other ranks) and
        all-reduce the combine over ``group``."""
        e = self.num_experts
        if e % size:
            raise ValueError(f"num_experts={e} not divisible by axis {size}")
        n = e // size
        for name in EXPERT_PARAMS:
            full = getattr(self, name)
            setattr(self, name, nn.Parameter(full[rank * n:(rank + 1) * n].clone()))
        self.expert_group, self.expert_size, self.expert_rank = group, size, rank

    def shard_batch(self, group: Any, size: int, rank: int) -> None:
        """This rank holds slice ``rank`` of ``size`` of every global batch
        (``group``'s ranks hold the others, in batch order).  Groups are cut
        from the global batch's tokens, as the JAX layer cuts them under a
        sharded batch: where a group spans several slices, every rank routes
        the group from the gathered gates and keeps its own rows."""
        self.batch_group, self.batch_shards, self.batch_rank = group, size, rank

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        g = b * s
        e = self.num_experts
        # groups are cut from the global batch's tokens (this rank's slice
        # is tokens [rank * g, (rank + 1) * g) of it); pad up to a group
        # multiple rather than shrinking groups: padded (zero) tokens route
        # uniformly, take at most the pad's share of capacity, and their
        # outputs are sliced away
        group_tokens = min(self.group_size, g * self.batch_shards)
        capacity = max(int(self.capacity_factor * group_tokens * 2 / e), 1)
        spans = g < group_tokens  # a group spans several ranks' slices
        if self.batch_shards > 1 and g % group_tokens and (not spans or group_tokens % g):
            raise NotImplementedError(
                f"MoE groups of {group_tokens} tokens over batch slices of {g} tokens: "
                "a group spans whole slices or none in this port"
            )
        grp = g if spans else group_tokens
        pad = (-g) % grp
        n_groups = (g + pad) // grp

        xf = x.reshape(g, d)
        if pad:
            xf = torch.cat([xf, xf.new_zeros(pad, d)], dim=0)
        xg = xf.reshape(n_groups, grp, d)
        # routing decisions in f32: bf16 softmax ties misroute tokens
        gates = torch.softmax(torch.einsum("ngd,de->nge", xg.float(), self.router), dim=-1)
        if spans:
            # every rank routes the whole global batch from the gathered
            # gates, then keeps its own rows below
            gates = _GatherRows.apply(
                gates.reshape(g, e), self.batch_group, self.batch_shards, self.batch_rank
            )
            pad_all = (-gates.shape[0]) % group_tokens
            if pad_all:  # the last group's zero tokens: uniform gates
                gates = torch.cat([gates, gates.new_full((pad_all, e), 1.0 / e)], dim=0)
            gates = gates.reshape(-1, group_tokens, e)

        group = self.expert_group
        partial = None if group is None else (lambda t: copy_to(t, group))
        dispatch, combine, aux = _top2_dispatch(gates, capacity, partial)
        aux = aux.mean()
        if spans:
            # this rank's rows of its group, as a group of g tokens whose
            # other slots hold the other ranks' tokens
            k, off = divmod(self.batch_rank * g, group_tokens)
            dispatch = dispatch[k:k + 1, off:off + g]
            combine = combine[k:k + 1, off:off + g]
        x_in = xg
        if group is not None:
            # keep only this rank's experts' columns; the partial outputs
            # are summed by the all-reduce below
            lo = self.expert_rank * (e // self.expert_size)
            hi = lo + e // self.expert_size
            dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
            x_in = copy_to(xg, group)

        cd = self.dtype
        expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(cd), x_in.to(cd))
        h = torch.einsum("necd,edf->necf", expert_in, self.w_in.to(cd))
        gate = torch.einsum("necd,edf->necf", expert_in, self.w_gate.to(cd))
        h = F.silu(gate) * h
        expert_out = torch.einsum("necf,efd->necd", h, self.w_out.to(cd))
        y = torch.einsum("ngec,necd->ngd", combine.to(cd), expert_out)
        if group is not None:
            y = reduce_from(y, group)
        y = y.reshape(n_groups * grp, d)[:g]
        return y.reshape(b, s, d), aux.float()
