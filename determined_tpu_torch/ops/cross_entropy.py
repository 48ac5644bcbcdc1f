"""Fused cross-entropy over the lm_head: mean softmax CE of ``hidden @ kernel``
without keeping more than one logits tile for the backward pass.

Port of ``determined_tpu/ops/cross_entropy.py``.  That module is plain jnp
(no Pallas kernel), so the port is plain PyTorch too: the lm_head product is
``torch.matmul`` in the compute dtype with its result taken to f32, and the
loss reduces in f32.  Two modes, as in the JAX package:

- single tile (``chunk_size=0``): one product; autograd keeps the f32
  logits tile as the backward residual (or, with ``bf16_residual``, a bf16
  copy of it through ``_TileCEBf16Residual``);
- chunked (``chunk_size=N``): the tokens are cut into chunks of N (the tail
  padded with targets of -1) and each chunk runs under
  ``torch.utils.checkpoint``, so no logits tensor survives to the backward
  pass.

``chunk_size=None`` picks by the per-shard residual size.  Targets ``< 0``
are ignored and the loss is the mean over valid tokens.  ``kernel`` is
``[d, vocab]``, the JAX layout (``lm_head.weight.t()`` of the port's model).

Vocab-parallel (``group``, the tensor group, and ``vocab_start``): the
kernel holds this rank's columns ``[vocab_start, vocab_start + V/t)``.  The
row max is all-reduced (max) and the sum of exps (sum) over the group, and
the target logit comes from the rank that owns the target's column, so every
rank computes the loss over the whole vocabulary; the gradient of the hidden
states is partial over the vocab shards, and the model's ``copy_to`` before
the head sums it.  ``vocab_parallel_cross_entropy`` is the same loss from
logits (the unfused head).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

# the single tile is kept when its backward residual is at most this many
# bytes (1.5 GiB, the JAX package's pick)
SINGLE_TILE_MAX_BYTES = 3 << 29
AUTO_CHUNK = 4096


def _logits(x: torch.Tensor, kernel: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """[n, vocab] logits in f32 from a product in ``compute_dtype``."""
    return torch.matmul(x.to(compute_dtype), kernel.to(compute_dtype)).float()


def _lse_and_target(
    logits: torch.Tensor, tgt: torch.Tensor, group: Any = None, vocab_start: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of f32 ``logits`` [n, V_local]: the logsumexp over the whole
    vocabulary and the target's logit (0 where the target is < 0).  With a
    ``group`` this rank holds columns ``[vocab_start, vocab_start + V_local)``."""
    valid = tgt >= 0
    if group is None:
        safe_tgt = torch.where(valid, tgt, torch.zeros_like(tgt)).long()
        lse = torch.logsumexp(logits, dim=-1)
        return lse, torch.gather(logits, -1, safe_tgt[:, None])[:, 0]
    import torch.distributed as tdist

    from determined_tpu_torch.parallel.tensor_parallel import reduce_from

    local = tgt.long() - vocab_start
    mine = valid & (local >= 0) & (local < logits.shape[-1])
    with torch.no_grad():  # a constant shift: the loss's gradient to it is 0
        m = logits.amax(dim=-1)
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=group)
    sumexp = reduce_from(torch.exp(logits - m[:, None]).sum(dim=-1), group)
    picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    tgt_logit = reduce_from(torch.where(mine, picked, torch.zeros_like(picked)), group)
    return m + torch.log(sumexp), tgt_logit


def _chunk_loss(
    x: torch.Tensor,
    kernel: torch.Tensor,
    tgt: torch.Tensor,
    compute_dtype: torch.dtype,
    group: Any = None,
    vocab_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of token losses and the valid-token count for one chunk."""
    logits = _logits(x, kernel, compute_dtype)
    valid = tgt >= 0
    lse, tgt_logit = _lse_and_target(logits, tgt, group, vocab_start)
    token_loss = torch.where(valid, lse - tgt_logit, torch.zeros_like(lse))
    return token_loss.sum(), valid.sum().float()


class _TileCEBf16Residual(torch.autograd.Function):
    """Single tile whose backward rebuilds the softmax from a bf16 copy of
    the logits instead of the f32 tile (``_tile_ce_bf16_residual``)."""

    @staticmethod
    def forward(ctx, x, kernel, tgt, group=None, vocab_start=0):
        with torch.no_grad():
            logits = _logits(x, kernel, torch.bfloat16)
            valid = tgt >= 0
            lse, tgt_logit = _lse_and_target(logits, tgt, group, vocab_start)
            loss_sum = torch.where(valid, lse - tgt_logit, torch.zeros_like(lse)).sum()
            count = valid.sum().float()
        # the only tensor-sized residual is the bf16 logits copy
        ctx.save_for_backward(x, kernel, tgt, logits.to(torch.bfloat16), lse)
        ctx.vocab_start = vocab_start
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        x, kernel, tgt, logits16, lse = ctx.saved_tensors
        valid = tgt >= 0
        safe_tgt = torch.where(valid, tgt, torch.zeros_like(tgt)).long()
        cols = ctx.vocab_start + torch.arange(logits16.shape[1], device=logits16.device)
        p = torch.exp(logits16.float() - lse[:, None])
        dlogits = p - (cols[None, :] == safe_tgt[:, None]).float()
        dlogits = torch.where(valid[:, None], dlogits, torch.zeros_like(dlogits)) * g_loss
        d16 = dlogits.to(torch.bfloat16)
        dx = torch.matmul(d16, kernel.to(torch.bfloat16).t()).to(x.dtype)
        dk = torch.matmul(x.to(torch.bfloat16).t(), d16).to(kernel.dtype)
        return dx, dk, None, None, None


def fused_cross_entropy(
    hidden: torch.Tensor,   # [batch, seq, d] (or [tokens, d])
    kernel: torch.Tensor,   # [d, vocab]
    targets: torch.Tensor,  # [batch, seq] (or [tokens]) int; < 0 ignored
    *,
    chunk_size: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    batch_shards: int = 1,
    bf16_residual: bool = False,
    group: Any = None,
    vocab_start: int = 0,
) -> torch.Tensor:
    """Mean softmax cross-entropy over valid tokens of ``hidden @ kernel``;
    vocab-parallel over ``group`` (module docstring)."""
    d = hidden.shape[-1]
    x = hidden.reshape(-1, d)
    tgt = targets.reshape(-1)
    n = x.shape[0]

    # the bf16-residual path is a single-tile variant whose forward product
    # is bf16 by construction; under f32 compute it would change the loss
    bf16_residual = bf16_residual and compute_dtype == torch.bfloat16

    if chunk_size is None:
        vocab = kernel.shape[-1]
        bytes_per = 2 if bf16_residual else 4
        tile_bytes = n * vocab * bytes_per // max(batch_shards, 1)
        chunk_size = 0 if tile_bytes <= SINGLE_TILE_MAX_BYTES else AUTO_CHUNK

    if chunk_size <= 0:
        if bf16_residual:
            loss_sum, count = _TileCEBf16Residual.apply(x, kernel, tgt, group, vocab_start)
        else:
            loss_sum, count = _chunk_loss(x, kernel, tgt, compute_dtype, group, vocab_start)
        return loss_sum / torch.clamp(count, min=1.0)
    chunk_size = min(chunk_size, n)

    pad = (-n) % chunk_size
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))], dim=0)
        tgt = torch.cat([tgt, tgt.new_full((pad,), -1)], dim=0)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], chunk_size):
        s, c = checkpoint(
            _chunk_loss, x[start:start + chunk_size], kernel,
            tgt[start:start + chunk_size], compute_dtype, group, vocab_start,
            use_reentrant=False,
        )
        loss_sum = loss_sum + s
        count = count + c
    return loss_sum / torch.clamp(count, min=1.0)


def vocab_parallel_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, group: Any, vocab_start: int
) -> torch.Tensor:
    """Mean softmax cross-entropy over valid tokens of logits [..., V/t]
    that hold this rank's columns ``[vocab_start, vocab_start + V/t)``."""
    x = logits.reshape(-1, logits.shape[-1]).float()
    tgt = targets.reshape(-1)
    valid = tgt >= 0
    lse, tgt_logit = _lse_and_target(x, tgt, group, vocab_start)
    loss_sum = torch.where(valid, lse - tgt_logit, torch.zeros_like(lse)).sum()
    return loss_sum / torch.clamp(valid.sum().float(), min=1.0)


def naive_cross_entropy(
    hidden: torch.Tensor, kernel: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Reference implementation (materializes the logits); used by tests."""
    logits = torch.matmul(hidden, kernel).float()
    valid = targets >= 0
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_tok = torch.where(valid, lse - tgt, torch.zeros_like(lse))
    return per_tok.sum() / torch.clamp(valid.sum().float(), min=1.0)
