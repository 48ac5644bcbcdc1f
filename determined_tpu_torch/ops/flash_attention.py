"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Port of ``determined_tpu/ops/flash_attention.py`` (forward only).  The JAX
package runs the blockwise forward as a Pallas TPU kernel
(``_flash_fwd_call``); here the same function is ``csrc/flash_fwd.cu``,
built with ``nvcc`` for ``sm_90a`` and launched through ``ctypes``.

Layout: q [b, h, Sq, d]; k, v [b, h_kv, Sk, d] (GQA: h_kv divides h).  The
softmax runs in log2 space: scores are ``q.k * scale * log2(e)``, masked to
a finite ``-1e30`` where ``q_pos < k_pos`` (no offset), exponentiated with
``exp2``; ``l`` is floored at ``1e-30``.  ``flash_attention_fwd`` returns
``(out, lse)`` with ``lse = m + log2(l)`` laid out ``[b, h, 1, Sq]`` in f32,
as ``_flash_fwd_call`` returns it (the backward kernels will read it).

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from determined_tpu_torch.ops.attention import NEG_INF, _repeat_kv

LOG2E = 1.4426950408889634

KERNEL_SOURCE = "flash_fwd.cu"
#: head dims and input dtypes the CUDA kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel since the last reset (the CPU path never
#: touches it); ``chip_smoke.py`` reads it to show the serving path ran
#: through the kernel
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: one-pass log2-space softmax
    (the TPU's ``_fwd_kernel_single``), the same masks and floors."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    n_rep = h // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s2 = torch.where(q_pos >= k_pos, s2, torch.full_like(s2, NEG_INF))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log2(l))[..., 0][:, :, None, :]  # [b, h, 1, sq]
    return out, lse


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes 4-d q, k, v [b, heads, seq, head_dim]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(
            f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)} "
            "(batch and head_dim must match, kv heads must divide heads)"
        )
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash attention needs at least one query and one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, not {d}")


def _launch_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from determined_tpu_torch.ops import _build

    _check_kernel_inputs(q, k, v)
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.dtt_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launch goes to q's device
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d,
            float(scale * LOG2E), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    launches += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _launch_kernel(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise flash attention forward; GQA-aware.  Returns ``out``."""
    out, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return out
