"""Mixture-of-Experts layer: top-2 routing with capacity, and its splits over
the mesh's expert, tensor, batch and seq ranks.

Port of ``determined_tpu/models/moe.py``.  Expert weights are stacked
``[experts, ...]`` tensors in flax's layout (``w_in``/``w_gate`` ``[e, d, f]``,
``w_out`` ``[e, f, d]``, the router ``[d, e]``), so ``convert.py`` maps them
one to one.  Tokens route within fixed-size groups (GShard's formulation):
dispatch and combine are ``[groups, group_size, e, c]`` with ``c ~
2 * group_size / e``, built from the f32 router's softmax by
``_top2_dispatch``, and the expert FFN runs as dense einsums in
``dtype``.  These einsums are plain large products that the JAX package also
computes outside Pallas, so they stay ``torch.einsum``.

The splits (``parallel/sharding.py``'s ``shard_model`` makes them; the JAX
layer's logical specs ``("expert", "embed", "mlp")`` and ``("expert",
"mlp", "embed")`` with ``expert -> expert`` and ``mlp -> tensor``):

- ``shard_experts`` (the JAX ``expert_axis_name`` path): each rank of the
  expert group keeps ``e / n`` experts and computes them against every
  token of its own; routing stays replicated, each rank keeps its own
  columns of dispatch and combine;
- ``shard_tensor``: each rank of the tensor group keeps ``f / n`` of every
  expert's hidden units (dim 2 of ``w_in``/``w_gate``, dim 1 of
  ``w_out``), Megatron's pair around the products.

With either, a rank's expert output is partial: the combine is summed over
both groups (``reduce_from``).  Every rank of them holds the same loss, so
that sum passes its gradient through unchanged, while the gradients that
flow into ``x`` and into the gates through a rank's part of the experts are
partial and are summed over both groups (``copy_to``).  The aux loss's
gradient to the gates is whole on every rank and is not summed.

Routing groups come in two forms, as the JAX package's two paths cut them:

- GSPMD (outside a pipeline): groups are cut from the flattened ``[B · S]``
  tokens of the global batch.  ``shard_tokens`` tells the layer which part
  of it this rank holds: ``b`` rows of the batch (its batch shard) by a
  contiguous ``s`` of each row (its seq rank), strided in global order.
  Where whole groups lie inside a rank's runs of consecutive tokens, the
  rank routes its own groups, and its aux is its groups' mean (the
  Trainer's mean over the ranks makes it the global one).  Otherwise every
  rank gathers the f32 gates of the ranks that hold the rest of the global
  batch, lays them out in global order, routes the groups its tokens fall
  in and keeps its own rows of their dispatch and combine; the gates'
  gradient is summed back to their owners (``_GatherTokens``).  The aux
  loss is then the global one on every rank.
- A pipeline stage (JAX's ``shard_map``): each rank routes its own tokens,
  groups from ``[microbatch rows · local seq]``; no ``shard_tokens``.  The
  mean over the batch and seq ranks that JAX takes of the aux (``pmean``)
  is the Trainer's mean over the ranks.

With ``group_size`` dividing a rank's run both forms route alike.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch.parallel.tensor_parallel import (
    copy_to,
    keep_slice,
    reduce_from,
    split_range,
)

EXPERT_PARAMS = ("w_in", "w_gate", "w_out")


def _balance_loss(gates: torch.Tensor, mask1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The load-balancing aux loss of each group of ``gates`` [..., g, e]
    (Switch eq. 4): e * sum_e(fraction of tokens routed to e * mean router
    probability of e); 1 at perfect balance.  ``mask1``: the top-1 one-hot,
    taken from the gates when omitted."""
    e = gates.shape[-1]
    if mask1 is None:
        mask1 = F.one_hot(gates.argmax(dim=-1), e).to(gates.dtype)
    density = mask1.mean(dim=-2)                                    # [e]
    density_proxy = gates.mean(dim=-2)
    return (density * density_proxy).sum(dim=-1) * e


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

    aux = _balance_loss(gates, mask1)

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


class _GatherTokens(torch.autograd.Function):
    """The ``[g, e]`` gates of every rank of ``group`` laid out in the global
    batch's token order: group rank ``i * n_s + j`` holds rows ``[i · b, (i
    + 1) · b)`` by positions ``[j · s, (j + 1) · s)``.  The backward sums
    every rank's gradient (each rank's loss is its share of a loss averaged
    over the group) and returns this rank's tokens."""

    @staticmethod
    def forward(ctx, gates: torch.Tensor, group: Any, shards: Tuple[int, int],
                ranks: Tuple[int, int], local: Tuple[int, int]) -> torch.Tensor:
        (n_b, n_s), (b, s), e = shards, local, gates.shape[-1]
        ctx.group, ctx.ranks, ctx.local, ctx.seq_len = group, ranks, local, n_s * s
        parts = [torch.empty_like(gates) for _ in range(n_b * n_s)]
        torch.distributed.all_gather(parts, gates.contiguous(), group=group)
        rows = [torch.cat([parts[i * n_s + j].reshape(b, s, e) for j in range(n_s)], dim=1)
                for i in range(n_b)]
        return torch.cat(rows, dim=0).reshape(-1, e)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad, group=ctx.group)
        (i, j), (b, s) = ctx.ranks, ctx.local
        whole = grad.reshape(-1, ctx.seq_len, grad.shape[-1])
        mine = whole[i * b:(i + 1) * b, j * s:(j + 1) * s]
        return mine.reshape(b * s, -1), None, None, None, None


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
        # the tensor split (shard_tensor): (group, size, rank)
        self.tensor: Optional[Tuple[Any, int, int]] = None
        # this rank's part of the global batch (shard_tokens): the group of
        # the ranks that hold it, (shards, rank) over the batch and the seq
        self.token_group: Any = None
        self.token_batch = (1, 0)
        self.token_seq = (1, 0)
        self._token_index: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}

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
        sum the combine over ``group``."""
        e = self.num_experts
        if e % size:
            raise ValueError(f"num_experts={e} not divisible by axis {size}")
        n = e // size
        for name in EXPERT_PARAMS:
            full = getattr(self, name)
            setattr(self, name, nn.Parameter(full[rank * n:(rank + 1) * n].clone()))
        self.expert_group, self.expert_size, self.expert_rank = group, size, rank

    def shard_tensor(self, group: Any, size: int, rank: int) -> Dict[str, int]:
        """Keep this rank's ``f / size`` hidden units of every expert
        (``w_in``/``w_gate`` dim 2, ``w_out`` dim 1) and sum the combine
        over ``group``; the split leaves and their dims."""
        lo, hi = split_range(self.d_ff, size, rank, "d_ff")
        keep_slice(self, "w_in", 2, lo, hi)
        keep_slice(self, "w_gate", 2, lo, hi)
        keep_slice(self, "w_out", 1, lo, hi)
        self.tensor = (group, size, rank)
        return {"w_in": 2, "w_gate": 2, "w_out": 1}

    def shard_tokens(self, group: Any, batch: Tuple[int, int], seq: Tuple[int, int]) -> None:
        """This rank holds batch shard ``batch[1]`` of ``batch[0]`` of every
        global batch, and of each of its rows the contiguous part
        ``seq[1]`` of ``seq[0]``; ``group``'s ranks hold the other parts,
        ranked batch shard major (module docstring, the GSPMD form)."""
        self.token_group, self.token_batch, self.token_seq = group, tuple(batch), tuple(seq)
        self._token_index = {}

    def _groups(self) -> List[Any]:
        """The groups over which a rank's expert output is partial."""
        return [g for g in (self.expert_group, None if self.tensor is None else self.tensor[0])
                if g is not None]

    def _own_tokens(self, b: int, s: int, grp: int,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the groups this rank's tokens fall in, ascending; each token's
        slot in those groups laid end to end), in ``x.reshape(b * s)``'s
        order."""
        key = (b, s, grp, device)
        if key not in self._token_index:
            (_, i), (n_s, j) = self.token_batch, self.token_seq
            rows = torch.arange(b) + i * b
            idx = (rows[:, None] * (n_s * s) + j * s + torch.arange(s)[None, :]).reshape(-1)
            touched = torch.unique(idx // grp)
            flat = torch.searchsorted(touched, idx // grp) * grp + idx % grp
            self._token_index[key] = (touched.to(device), flat.to(device))
        return self._token_index[key]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        g = b * s
        e = self.num_experts
        (n_b, i), (n_s, j) = self.token_batch, self.token_seq
        # groups are cut from the global batch's tokens; pad up to a group
        # multiple rather than shrinking groups: padded (zero) tokens route
        # uniformly, take at most the pad's share of capacity, and their
        # outputs are sliced away
        total = g * n_b * n_s
        group_tokens = min(self.group_size, total)
        capacity = max(int(self.capacity_factor * group_tokens * 2 / e), 1)
        # this rank's tokens are runs of ``run`` consecutive tokens of the
        # global order: where groups tile them, it routes its own
        run = g if n_s == 1 else s
        gathered = n_b * n_s > 1 and run % group_tokens != 0
        groups = self._groups()

        def partial(t: torch.Tensor) -> torch.Tensor:
            for grp in groups:
                t = copy_to(t, grp)
            return t

        xf = x.reshape(g, d)
        if not gathered:
            pad = (-g) % group_tokens
            if pad:
                xf = torch.cat([xf, xf.new_zeros(pad, d)], dim=0)
            xg = xf.reshape(-1, group_tokens, d)
            # routing decisions in f32: bf16 softmax ties misroute tokens
            gates = torch.softmax(torch.einsum("ngd,de->nge", xg.float(), self.router), dim=-1)
            dispatch, combine, aux = _top2_dispatch(gates, capacity, partial)
            aux = aux.mean()
            own = None
        else:
            gates = torch.softmax(torch.einsum("gd,de->ge", xf.float(), self.router), dim=-1)
            gates = _GatherTokens.apply(gates, self.token_group, (n_b, n_s), (i, j), (b, s))
            pad = (-total) % group_tokens
            if pad:  # the last group's zero tokens: uniform gates
                gates = torch.cat([gates, gates.new_full((pad, e), 1.0 / e)], dim=0)
            gates = gates.reshape(-1, group_tokens, e)
            aux = _balance_loss(gates).mean()
            # the groups this rank's tokens fall in, its tokens at their
            # slots and zeros at the other ranks' (whose outputs are
            # dropped below)
            touched, own = self._own_tokens(b, s, group_tokens, x.device)
            dispatch, combine, _ = _top2_dispatch(gates[touched], capacity, partial)
            xg = xf.new_zeros(len(touched) * group_tokens, d).index_copy(0, own, xf)
            xg = xg.reshape(len(touched), group_tokens, d)
        if self.expert_group is not None:
            # keep only this rank's experts' columns; the partial outputs
            # are summed below
            lo = self.expert_rank * (e // self.expert_size)
            hi = lo + e // self.expert_size
            dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
        x_in = partial(xg)

        cd = self.dtype
        expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(cd), x_in.to(cd))
        h = torch.einsum("necd,edf->necf", expert_in, self.w_in.to(cd))
        gate = torch.einsum("necd,edf->necf", expert_in, self.w_gate.to(cd))
        h = F.silu(gate) * h
        expert_out = torch.einsum("necf,efd->necd", h, self.w_out.to(cd))
        y = torch.einsum("ngec,necd->ngd", combine.to(cd), expert_out)
        for grp in groups:
            y = reduce_from(y, grp)
        y = y.reshape(-1, d)
        y = y[:g] if own is None else y.index_select(0, own)
        return y.reshape(b, s, d), aux.float()
