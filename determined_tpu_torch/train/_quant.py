"""Quantized matmul arithmetic: int8/fp8 projections with f32 master weights.

Port of ``determined_tpu/train/_quant.py``.  The recipe is the same, with a
PyTorch ``autograd.Function`` in place of the flax ``dot_general``
injection, so the param tree is untouched:

- **f32 master weights**: params and optimizer state stay as they are;
  quantization happens per matmul on the fly, so checkpoints, ``convert.py``
  and the fused-AdamW path are byte-compatible with the unquantized model;
- **per-channel dynamic scaling**: both operands are first cast to the
  compute dtype (flax's ``Dense`` casts the f32 kernel before
  ``dot_general``, so the weight's scale is taken over those values), then
  scaled by their per-output-channel absmax over the contracting dim taken
  in f32 (``max(amax, 1e-12) / qmax``), quantized to int8 (round half to
  even, clipped to +-127) or fp8 e4m3 (448), multiplied with an int32/f32
  accumulator and rescaled as ``acc * s_x * s_w`` before the cast back to
  the input's dtype;
- **straight-through backward**: the gradients are the exact transpose of
  the *unquantized* product over the saved compute-dtype operands, so they
  never see quantization noise.

On a ``tensor`` mesh axis JAX's partitioner sees the whole product, so its
scales are over the whole contracting dim.  A column-parallel product
(q, k, v, gate, up, the vocabulary-split head) holds the whole contracting
dim already; a row-parallel one (o, down) holds its own columns of it, so
``quant_linear(..., group=...)`` first takes each operand's absmax row by
row over its columns, all-reduces the two with MAX over the tensor group
(one collective), quantizes with those scales and leaves the rescaled
partial product for the caller's sum over the group.

On CUDA tensors the products run on the card's integer and fp8 tensor-core
paths: ``torch._int_mm`` (int8 x int8 -> int32) and ``torch._scaled_mm``
(e4m3 x e4m3, f32 accumulate; at a bf16 compute dtype the row-wise f32
scales are applied in its epilogue, at any other the rescale follows an
f32 output).  Both want
the weight as the column-major second operand, which is what the transpose
of an ``nn.Linear`` weight ``[out, in]`` already is, and both refuse shapes
they cannot tile (``_int_mm``: more than 16 rows, K and N multiples of 8;
``_scaled_mm``: K and N multiples of 16): a refused call raises, it never
falls back to a bf16 product.  On CPU tensors the plain version runs:
the quantized operands in f32, one f32 product, the same rescale.

Platform gate: int8 runs everywhere.  fp8 needs a Hopper-class GPU (the
device name carries one of ``_FP8_GPU_MARKERS``); asking for it elsewhere
raises ``InvalidExperimentConfig`` at setup, except under
``DTPU_QUANT_EMULATE=1``, which permits the plain emulated path for tests.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch._device import DeviceLike
from determined_tpu_torch.config.experiment import QUANT_MODES, InvalidExperimentConfig

#: GPU names with native fp8 matmuls (substring match on the device name)
_FP8_GPU_MARKERS = ("H100", "H200", "B100", "B200", "GH200")
_QMAX = {"int8": 127.0, "fp8": 448.0}

#: launches of the card's quantized products since the last reset, by mode
#: (the CPU path never counts); ``chip_smoke.py`` reads them to show the
#: training path ran through the int8 and fp8 tensor cores
launches = {"int8": 0, "fp8": 0}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0


def _backend_and_kind(device: DeviceLike, device_kind: Optional[str]) -> Tuple[str, str]:
    """The JAX names of the platform: backend ``gpu`` or ``cpu`` and the
    device kind (the CUDA device name, ``cpu`` on the host)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return "gpu", device_kind or torch.cuda.get_device_name(dev)
    return dev.type, device_kind or dev.type


def fp8_supported(device: DeviceLike = None, device_kind: Optional[str] = None) -> bool:
    if os.environ.get("DTPU_QUANT_EMULATE", "0") == "1":
        return True
    backend, kind = _backend_and_kind(device, device_kind)
    return backend == "gpu" and any(m in kind for m in _FP8_GPU_MARKERS)


def check_mode(mode: str) -> None:
    """Raise ``InvalidExperimentConfig`` for a mode outside ``QUANT_MODES``."""
    if mode not in QUANT_MODES:
        raise InvalidExperimentConfig(f"quantized_matmul {mode!r} not in {QUANT_MODES}")


def require_platform(
    mode: str, device: DeviceLike = None, device_kind: Optional[str] = None
) -> None:
    """Raise ``InvalidExperimentConfig`` when the requested quantized
    matmul mode cannot run on ``device`` (at setup time, with the JAX
    package's message)."""
    check_mode(mode)
    if mode != "fp8" or fp8_supported(device, device_kind):
        return
    backend, kind = _backend_and_kind(device, device_kind)
    raise InvalidExperimentConfig(
        f"quantized_matmul: fp8 is not supported on this platform "
        f"(backend={backend!r}, device_kind={kind!r}); fp8 needs "
        f"TPU v5p/v6+ or a Hopper-class GPU — use int8 here, or set "
        f"DTPU_QUANT_EMULATE=1 for the slow emulated path in tests"
    )


def quantize(x: torch.Tensor, mode: str,
             amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization of a 2-D operand over its last
    (contracting) dim: ``(q, scale)`` with ``scale`` f32 ``[rows]``; ``amax``
    (f32 ``[rows]``) is each row's absmax where it spans more than ``x``'s
    columns (a row-parallel product's, ``row_parallel_amax``)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-12) / _QMAX[mode]
    scaled = xf / scale[:, None]
    if mode == "int8":
        return scaled.round().clamp_(-127, 127).to(torch.int8), scale
    return scaled.to(torch.float8_e4m3fn), scale


def row_parallel_amax(x2: torch.Tensor, w: torch.Tensor,
                      group: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's absmax of ``x2 [M, K]`` and of ``w [N, K]`` over the whole
    contracting dim whose columns the ranks of ``group`` hold between them:
    the local absmaxes, maxed over the group in one all-reduce."""
    import torch.distributed as tdist

    both = torch.cat([x2.float().abs().amax(dim=-1), w.float().abs().amax(dim=-1)])
    tdist.all_reduce(both, op=tdist.ReduceOp.MAX, group=group)
    return both[:x2.shape[0]], both[x2.shape[0]:]


def quantized_matmul_reference(x2: torch.Tensor, w: torch.Tensor, mode: str,
                               amax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                               ) -> torch.Tensor:
    """The plain version: ``x2 [M, K] @ w[N, K].T`` through the quantized
    operands in f32, rescaled as ``acc * s_x * s_w``, in ``x2``'s dtype;
    ``amax`` the operands' row absmaxes where they span more columns."""
    ax, aw = amax or (None, None)
    qx, sx = quantize(x2, mode, ax)
    qw, sw = quantize(w, mode, aw)
    acc = qx.float() @ qw.float().t()
    return (acc * sx[:, None] * sw[None, :]).to(x2.dtype)


def quantized_matmul(x2: torch.Tensor, w: torch.Tensor, mode: str,
                     amax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``x2 [M, K] @ w[N, K].T`` through quantized operands: on CUDA the
    int8 or fp8 tensor-core product, on the CPU the plain version
    (``amax`` as ``quantized_matmul_reference``'s)."""
    if x2.device.type != "cuda":
        return quantized_matmul_reference(x2, w, mode, amax=amax)
    return _tensor_core_matmul(x2, w, mode, amax=amax)


def _tensor_core_matmul(x2: torch.Tensor, w: torch.Tensor, mode: str,
                        amax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """The card's product.  ``_scaled_mm`` applies row-wise scales in its
    epilogue only with a bf16 output, so any other compute dtype (f32, as
    the JAX package runs it too) takes unit scales and an f32 output, and
    the rescale runs after, as for int8."""
    ax, aw = amax or (None, None)
    qx, sx = quantize(x2, mode, ax)
    qw, sw = quantize(w, mode, aw)
    if mode == "int8":
        acc = torch._int_mm(qx, qw.t()).float()
    elif x2.dtype == torch.bfloat16:
        launches[mode] += 1
        return torch._scaled_mm(
            qx, qw.t(), scale_a=sx[:, None].contiguous(), scale_b=sw[None, :].contiguous(),
            out_dtype=torch.bfloat16,
        )
    else:
        one = torch.ones((), device=x2.device)
        acc = torch._scaled_mm(qx, qw.t(), scale_a=one, scale_b=one, out_dtype=torch.float32)
    launches[mode] += 1
    return (acc * sx[:, None] * sw[None, :]).to(x2.dtype)


class _QuantLinear(torch.autograd.Function):
    """Quantized forward, straight-through backward over the saved
    compute-dtype operands."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, mode: str, group: Any) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        amax = None if group is None else row_parallel_amax(x2, w, group)
        return quantized_matmul(x2, w, mode, amax=amax).view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w).view(x.shape)
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw, None, None


def quant_linear(
    x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype, mode: str, group: Any = None
) -> torch.Tensor:
    """``F.linear(x, weight.to(dtype))`` with the product quantized
    (``mode`` int8 or fp8; ``none`` is the plain product).  ``weight`` is the
    f32 master ``[out, in]``; its gradient flows back through the cast.
    ``group``: a row-parallel product's tensor group (the scales over the
    whole contracting dim; the module docstring); the caller sums the
    partial products over it."""
    w = weight.to(dtype)
    if mode == "none":
        return F.linear(x, w)
    return _QuantLinear.apply(x, w, mode, group)
