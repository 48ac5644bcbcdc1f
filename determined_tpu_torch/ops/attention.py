"""Attention ops: reference implementation and dispatcher.

Port of ``determined_tpu/ops/attention.py``.

- ``reference_attention``: plain softmax attention, the semantics every
  other implementation must match.
- ``flash_attention``: the hand-written CUDA forward and backward kernels
  under an autograd Function (``ops/flash_attention.py``,
  ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).
- ``ring_attention``: sequence parallelism over a mesh's ``seq`` axis on
  those kernels (``ops/ring_attention.py``).

All take [batch, heads, q_len, head_dim] q and [batch, kv_heads, kv_len,
head_dim] k/v (GQA when kv_heads < heads).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand kv heads for grouped-query attention."""
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention; logits and softmax in f32, probabilities cast
    to v's dtype before the product with v.

    ``q_offset``: global position of q[0] relative to k[0].
    """
    q_len, head_dim = q.shape[-2], q.shape[-1]
    kv_len = k.shape[-2]
    n_rep = q.shape[-3] // k.shape[-3]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = scale if scale is not None else head_dim ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q_len, device=q.device)[:, None]
        k_pos = torch.arange(kv_len, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    scale: Optional[float] = None,
    seq: Optional[Tuple[Any, int]] = None,
) -> torch.Tensor:
    """Dispatcher, the one place of the ring's rule.  ``seq`` is the mesh's
    seq axis as ``(group, size)`` when q, k, v lie on a mesh (this rank's
    shards along it; a size of 1 on a mesh without the axis), None off a
    mesh.  'auto' and 'ring' run the ring over the group when its size is
    over 1, as the JAX ``Attention`` dispatches; with a size of 1 they are
    the whole-sequence 'auto' (JAX's ring falls back without a seq axis):
    flash on CUDA for sequences worth tiling, where the JAX package picks
    it on the TPU (``q_len >= 256``), the plain version on the CPU.  'ring'
    off a mesh raises, as the JAX ``Attention`` does."""
    if impl == "ring" and seq is None:
        raise ValueError("ring attention requires the mesh")
    if impl in ("auto", "ring") and seq is not None and seq[1] > 1:
        from determined_tpu_torch.ops.ring_attention import ring_attention_local

        return ring_attention_local(q, k, v, seq[0], causal=causal, scale=scale)
    if impl in ("auto", "ring"):
        impl = "flash" if q.device.type == "cuda" and q.shape[-2] >= 256 else "reference"
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl == "flash":
        from determined_tpu_torch.ops.flash_attention import flash_attention

        # the kernel reads dense [b, h, s, d] rows
        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, scale=scale
        )
    raise ValueError(f"unknown attention impl {impl!r}")
