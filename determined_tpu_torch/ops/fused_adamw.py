"""Fused AdamW + global-norm clip: one read-modify-write sweep per leaf.

Port of ``determined_tpu/ops/fused_adamw.py``.  The JAX package runs the
sweep as a Pallas TPU kernel (``_leaf_pallas``, kernel ``_adamw_kernel``) on
large leaves and as plain jnp (``_leaf_jnp``) on small ones; here the sweep
is ``csrc/fused_adamw.cu``, built with ``nvcc`` for ``sm_90a`` and launched
through ``ctypes``.  On CUDA every leaf goes through the kernel: the TPU's
size threshold and block planning exist for its VMEM tiling and per-call
cost.  On CPU tensors the plain version ``_leaf_reference`` (a copy of
``_leaf_jnp``) runs; on CUDA tensors the kernel launches or the step raises.

Semantics match ``optax.chain(clip_by_global_norm(c), adamw(lr, b1, b2, eps,
weight_decay=wd, mu_dtype=...))``: the scalars ``[lr, clip_scale, 1 - b1^t,
1 - b2^t]`` at ``t = count + 1`` with lr from the schedule at ``count``, the
clip scale ``min(1, c / max(||g||, 1e-16))`` over the global f32 norm of
every leaf, decoupled weight decay on the old p, and the first moment stored
in ``mu_dtype``.  The scalars stay on the device, so a step never waits for
the host.  Parameters, moments and gradients are dicts of tensors keyed like
``model.named_parameters()`` (the JAX package's param tree); ``apply_step``
updates p, m and v in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

KERNEL_SOURCE = "fused_adamw.cu"
_MU_CODES = {torch.float32: 0, torch.bfloat16: 1}

Tree = Dict[str, torch.Tensor]

#: launches of the CUDA kernel since the last reset (the CPU path never
#: touches it); ``chip_smoke.py`` reads it to show the training path ran
#: through the kernel
launches = 0
#: the same count by CUDA device index: trials that run at once, each on its
#: own device, read their own
launches_by_device: Dict[int, int] = {}
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0
        launches_by_device.clear()


class FusedAdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter, on the params' device
    mu: Tree             # first moment (param dtype or mu_dtype)
    nu: Tree             # second moment (f32)


def _leaf_reference(p, m, v, g, scalars, *, b1, b2, eps, wd):
    """The plain PyTorch version of the kernel (``_leaf_jnp``): returns
    ``(p, m, v)`` new."""
    lr, cs, bc1, bc2 = (scalars[i] for i in range(4))
    gf = g.float() * cs
    m_new = m.float() * b1 + gf * (1.0 - b1)
    v_new = v * b2 + gf * gf * (1.0 - b2)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
    return p - lr * update, m_new.to(m.dtype), v_new


def _check_leaf(p, m, v, g, scalars) -> None:
    for name, t in (("p", p), ("v", v), ("g", g), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_adamw takes an f32 {name}, not {t.dtype}")
    if m.dtype not in _MU_CODES:
        raise ValueError(f"fused_adamw keeps mu in float32 or bfloat16, not {m.dtype}")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if t.shape != p.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match p {tuple(p.shape)}")
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g), ("scalars", scalars)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scalars.numel() != 4:
        raise ValueError("scalars must hold [lr, clip_scale, 1 - b1^t, 1 - b2^t]")


# ctypes signature, set once when the library is loaded: p, m, v, g,
# scalars; n, mu dtype; b1, 1 - b1, b2, 1 - b2, eps, wd; stream
_SIGNATURES = {
    "dtt_fused_adamw": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 6
        + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _launch_kernel(p, m, v, g, scalars, *, b1, b2, eps, wd) -> None:
    global launches
    from determined_tpu_torch.ops import _build

    _check_leaf(p, m, v, g, scalars)
    fn = _build.load(KERNEL_SOURCE, _SIGNATURES).dtt_fused_adamw
    with torch.cuda.device(p.device):  # the launch goes to p's device
        err = fn(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), scalars.data_ptr(),
            p.numel(), _MU_CODES[m.dtype], b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError_t {err}")
    with _count_lock:  # trials on other devices launch at once
        launches += 1
        launches_by_device[p.device.index] = launches_by_device.get(p.device.index, 0) + 1


@torch.no_grad()
def adamw_leaf_(p, m, v, g, scalars, *, b1, b2, eps, wd) -> None:
    """One leaf's step, in place: the CUDA kernel on CUDA tensors, the plain
    version (copied back) on CPU tensors."""
    if p.device.type == "cuda":
        _launch_kernel(p, m, v, g, scalars, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    if p.device.type != "cpu":
        raise ValueError(f"fused_adamw runs on cuda or cpu, not {p.device}")
    new_p, new_m, new_v = _leaf_reference(p, m, v, g, scalars, b1=b1, b2=b2, eps=eps, wd=wd)
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FusedAdamW:
    """Full-step fused optimizer.  ``apply_step`` consumes grads and updates
    params and state in place: no separate "updates" tree."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Tree) -> FusedAdamWState:
        mu = {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        device = next(iter(params.values())).device
        return FusedAdamWState(torch.zeros((), dtype=torch.int32, device=device), mu, nu)

    def scalars(
        self, count: torch.Tensor, grads: Tree,
        norm: Optional[Callable[[Tree], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """``[lr, clip_scale, 1 - b1^t, 1 - b2^t]`` at ``t = count + 1`` as a
        [4] f32 tensor on count's device.  ``norm`` takes the global norm of
        ``grads`` (``global_norm`` when None; on a mesh the Trainer's, over
        every rank's shards)."""
        t = (count + 1).float()
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
        if self.clip_norm is not None:
            gn = (norm or global_norm)(grads)
            cs = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-16), max=1.0)
        else:
            cs = torch.ones((), device=count.device)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        return torch.stack([lr, cs.float(), bc1, bc2])

    @torch.no_grad()
    def apply_step(
        self, grads: Tree, state: FusedAdamWState, params: Tree,
        norm: Optional[Callable[[Tree], torch.Tensor]] = None,
    ) -> Tuple[Tree, FusedAdamWState]:
        scalars = self.scalars(state.count, grads, norm)
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay)
        for k, p in params.items():
            adamw_leaf_(p, state.mu[k], state.nu[k], grads[k], scalars, **kw)
        return params, FusedAdamWState(state.count + 1, state.mu, state.nu)


def fused_adamw(
    learning_rate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    clip_norm: Optional[float] = 1.0,
    mu_dtype: Optional[torch.dtype] = None,
) -> FusedAdamW:
    return FusedAdamW(
        learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, clip_norm=clip_norm, mu_dtype=mu_dtype,
    )
