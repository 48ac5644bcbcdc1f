"""Flash attention: hand-written CUDA kernels, their plain versions, and the
autograd ``Function`` that joins them.

Port of ``determined_tpu/ops/flash_attention.py``.  The JAX package runs the
blockwise forward and the two backward sweeps as Pallas TPU kernels
(``_flash_fwd_call``, ``_flash_bwd_call``'s ``_dq_kernel`` and
``_dkv_kernel``) under a ``jax.custom_vjp``; here they are
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, built with ``nvcc`` for
``sm_90a`` and launched through ``ctypes``, under a
``torch.autograd.Function``.

Layout: q [b, h, Sq, d]; k, v [b, h_kv, Sk, d] (GQA: h_kv divides h).  The
softmax runs in log2 space: scores are ``q.k * scale * log2(e)``, masked to
a finite ``-1e30`` where ``q_pos < k_pos`` (no offset), exponentiated with
``exp2``; ``l`` is floored at ``1e-30``.  ``flash_attention_fwd`` returns
``(out, lse)`` with ``lse = m + log2(l)`` laid out ``[b, h, 1, Sq]`` in f32,
as ``_flash_fwd_call`` returns it; ``flash_attention_bwd`` rebuilds
``p = exp2(s2 - lse)`` from it and returns ``(dq, dk, dv)`` with dk/dv in
the kv-head shape, summed over each GQA group (what JAX's autodiff does
through ``_repeat_kv``).

On CPU tensors the wrappers compute the plain versions; on CUDA tensors they
launch the kernels or raise.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from determined_tpu_torch.ops.attention import NEG_INF, _repeat_kv

LOG2E = 1.4426950408889634

KERNEL_SOURCE = "flash_fwd.cu"
BWD_KERNEL_SOURCE = "flash_bwd.cu"
#: head dims and input dtypes the CUDA kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: q rows of a bf16 forward CTA: 0 lets the launch pick (128, or 64 where
#: 128-row tiles would leave SMs idle); f32 takes 0 only
FWD_BLOCK_ROWS = (0, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes signatures, set once when each library is loaded
_FWD_SIGNATURES = {
    # q, k, v, out, lse; dtype, B, H, Hkv, Sq, Sk, D; scale_log2, causal, block_m, stream
    "dtt_flash_fwd_rows": ([_P] * 5 + [_I] * 7 + [_F, _I, _I, _P], _I),
}
# q, k, v, do, lse, delta; the outputs; dtype, B, H, Hkv, Sq, Sk, D;
# scale_log2, scale, causal, stream
_BWD_TAIL = [_I] * 7 + [_F, _F, _I, _P]
_BWD_SIGNATURES = {
    "dtt_flash_bwd_dq": ([_P] * 7 + _BWD_TAIL, _I),
    "dtt_flash_bwd_dkv": ([_P] * 8 + _BWD_TAIL, _I),
}

#: launches of each CUDA kernel since the last reset (the CPU path never
#: touches them); ``chip_smoke.py`` reads them to show the serving and
#: training paths ran through the kernels
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
#: the same counts by CUDA device index: trials that run at once, each on
#: its own device, read their own
launches_by_device: Dict[str, Dict[int, int]] = {
    "flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches, launches_bwd_dq, launches_bwd_dkv
    with _count_lock:
        launches = launches_bwd_dq = launches_bwd_dkv = 0
        for per in launches_by_device.values():
            per.clear()


def _count(name: str, device: torch.device) -> None:
    """One launch of kernel ``name`` on ``device`` (threads launch at once)."""
    global launches, launches_bwd_dq, launches_bwd_dkv
    with _count_lock:
        if name == "flash_fwd":
            launches += 1
        elif name == "flash_bwd_dq":
            launches_bwd_dq += 1
        else:
            launches_bwd_dkv += 1
        per = launches_by_device[name]
        per[device.index] = per.get(device.index, 0) + 1


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
    block_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel alone; ``block_rows`` forces the bf16 tile (see
    ``FWD_BLOCK_ROWS``), as ``chip_smoke.py`` does to time both."""
    from determined_tpu_torch.ops import _build

    _check_kernel_inputs(q, k, v)
    if block_rows not in FWD_BLOCK_ROWS or (block_rows and q.dtype != torch.bfloat16):
        raise ValueError(
            f"block_rows {block_rows} not in {FWD_BLOCK_ROWS} (non-zero for bfloat16 only)"
        )
    fn = _build.load(KERNEL_SOURCE, _FWD_SIGNATURES).dtt_flash_fwd_rows
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launch goes to q's device
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d,
            float(scale * LOG2E), int(bool(causal)), block_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    _count("flash_fwd", q.device)
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


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward kernels: the JAX kernels'
    math in one pass (full ``s2``, ``p = exp2(s2 - lse)``, ``ds`` and ``p``
    cast to the input dtype before their products, f32 accumulation), with
    dk/dv summed over each GQA group in f32 and cast once, as
    ``csrc/flash_bwd.cu`` sums them."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    n_rep = h // hkv
    kr, vr = _repeat_kv(k, n_rep).float(), _repeat_kv(v, n_rep).float()
    s2 = torch.matmul(q.float(), kr.transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s2 = torch.where(q_pos >= k_pos, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - lse.transpose(-1, -2))             # [b, h, sq, sk]
    delta = _delta(out, do).transpose(-1, -2)              # [b, h, sq, 1]
    dp = torch.matmul(do.float(), vr.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kr).to(q.dtype)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dk = dk.view(b, hkv, n_rep, sk, d).sum(2).to(k.dtype)
    dv = dv.view(b, hkv, n_rep, sk, d).sum(2).to(v.dtype)
    return dq, dk, dv


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out) in f32, laid out [b, h, 1, Sq] like lse
    (computed outside the kernels, as the JAX wrapper computes it)."""
    return (do.float() * out.float()).sum(dim=-1)[:, :, None, :]


def _check_bwd_inputs(q, k, v, out, lse, do) -> None:
    _check_kernel_inputs(q, k, v)
    b, h, sq, _ = q.shape
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (
        tuple(lse.shape) != (b, h, 1, sq)
        or lse.dtype != torch.float32
        or lse.device != q.device
        or not lse.is_contiguous()
    ):
        raise ValueError(f"lse must be a contiguous f32 [b, h, 1, Sq] tensor on {q.device}")


def _bwd_lib():
    from determined_tpu_torch.ops import _build

    return _build.load(BWD_KERNEL_SOURCE, _BWD_SIGNATURES)


def _bwd_args(q, k, v, do, lse, delta, causal: bool, scale: float):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    dims = [_DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d,
            float(scale * LOG2E), float(scale), int(bool(causal))]
    return ins, dims


def _launch_dq(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    """The dq kernel alone (inputs already checked, delta computed)."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to q's device
        err = _bwd_lib().dtt_flash_bwd_dq(
            *ins, dq.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed: cudaError_t {err}")
    _count("flash_bwd_dq", q.device)
    return dq


def _launch_dkv(
    q, k, v, do, lse, delta, causal: bool, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel alone (inputs already checked, delta computed)."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):  # the launch goes to q's device
        err = _bwd_lib().dtt_flash_bwd_dkv(
            *ins, dk.data_ptr(), dv.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed: cudaError_t {err}")
    _count("flash_bwd_dkv", q.device)
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the
    output gradient ``do``: the CUDA kernels on CUDA tensors, the plain
    version on CPU tensors.  dk/dv come back in k's kv-head shape."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        _check_bwd_inputs(q, k, v, out, lse, do)
        delta = _delta(out, do)
        dq = _launch_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal, scale=scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention_fwd``, backward through
    ``flash_attention_bwd``; the residuals are q, k, v (not repeated), out
    and lse, as ``_flash_fwd`` keeps them in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise flash attention; differentiable; GQA-aware.  Returns ``out``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale)
