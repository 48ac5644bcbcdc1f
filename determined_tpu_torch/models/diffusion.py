"""Denoising diffusion (DDPM): the UNet, its schedule and sampler, and the
noise-prediction trial (``examples/diffusion``).

Port of ``determined_tpu/models/diffusion.py``.  ``UNet`` computes what the
flax module computes (``convert.unet_state_dict_from_flax`` maps a flax
param tree onto it, every submodule named as flax names it, the unnamed
GroupNorms ``GroupNorm_0`` and ``GroupNorm_1`` included): a time embedding
through two dense layers, a down path whose levels keep their output as the
skip before a 2x2 average pool, ResBlocks conditioned by FiLM (scale and
shift from the embedding, broadcast over the map), self-attention over the
lowest map, and an up path that concatenates each skip after its input and
doubles the map by nearest-neighbour resize.  ``conv2`` of every ResBlock,
``mid_attn.proj`` and ``head`` start at zero, as in flax.  Parameters are
f32 and the network computes in ``dtype``; the time embedding and the
schedule's tables are f32.  Images are NHWC at the interface, as in the JAX
package, and NCHW inside.

The attention is einsum and softmax in the JAX package, outside any Pallas
kernel, and is ``torch.matmul`` and ``softmax`` here (one non-causal head
over the h*w tokens in row-major order).  The optimizer is the port's fused
AdamW (``ops/fused_adamw.py``), so on CUDA every leaf goes through the
``fused_adamw`` kernel each step.

Randomness comes from explicit ``torch.Generator``s.  ``DiffusionTrial.loss``
draws the step's timesteps and noise from the generator the Trainer hands
each step (``Trainer._step_rng``: the same step draws the same numbers in an
uninterrupted, a resumed and a restarted run, and every microbatch of an
accumulated step the same ones); validation draws from a generator seeded
with 0, as the JAX trial's ``jax.random.key(0)``.  The draws are torch's,
not JAX's: ``noised_loss`` and ``ddpm_sample`` take the timesteps and noise
as arguments, so a test can feed in the ones JAX drew.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.data import DataLoader, mnist_like
from determined_tpu_torch.models._layers import Conv, Dense, GroupNorm, init_weights
from determined_tpu_torch.train._trial import TorchTrial


def _groups(channels: int, want: int = 8) -> int:
    """Largest group count <= want that divides the channel width."""
    g = min(want, channels)
    while channels % g:
        g -= 1
    return g


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[batch, dim]`` in f32: cosines, then
    sines."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _zero(module: nn.Module) -> None:
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()


class ResBlock(nn.Module):
    """GN-silu-conv, FiLM from the time embedding, GN, scale and shift,
    silu-conv (zero init), plus the input (through a 1x1 conv where the
    width changes)."""

    def __init__(self, cin: int, channels: int, temb_dim: int, *, device=None) -> None:
        super().__init__()
        self.GroupNorm_0 = GroupNorm(_groups(cin), cin, device=device)
        self.conv1 = Conv(cin, channels, 3, device=device)
        self.temb_proj = Dense(temb_dim, 2 * channels, device=device)
        self.GroupNorm_1 = GroupNorm(_groups(channels), channels, device=device)
        self.conv2 = Conv(channels, channels, 3, device=device)
        self.skip = Conv(cin, channels, 1, device=device) if cin != channels else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        scale, shift = self.temb_proj(F.silu(temb))[:, :, None, None].chunk(2, dim=1)
        h = self.GroupNorm_1(h) * (1 + scale) + shift
        h = self.conv2(F.silu(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class SelfAttention2D(nn.Module):
    """Full self-attention over the lowest-resolution map: one head of
    width c, scale ``c ** -0.5``, the output projection zero at init."""

    def __init__(self, channels: int, *, device=None) -> None:
        super().__init__()
        self.GroupNorm_0 = GroupNorm(_groups(channels), channels, device=device)
        self.qkv = Dense(channels, 3 * channels, device=device)
        self.proj = Dense(channels, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.GroupNorm_0(x).flatten(2).transpose(1, 2)  # [b, h*w, c], row-major
        q, k, v = self.qkv(y).chunk(3, dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        y = self.proj(torch.matmul(attn, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class UNet(nn.Module):
    """Small DDPM UNet over NHWC images: ``forward(x, t)`` predicts the
    noise, f32 ``[b, h, w, out_channels]``."""

    def __init__(
        self,
        base_channels: int = 32,
        channel_mults: Tuple[int, ...] = (1, 2),
        out_channels: int = 1,
        in_channels: int = 1,
        dtype: torch.dtype = torch.float32,
        *,
        device: DeviceLike = None,
        generator: torch.Generator = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        ch, temb_dim = base_channels, base_channels * 4
        self.base_channels, self.channel_mults, self.dtype = ch, tuple(channel_mults), dtype
        self.temb1 = Dense(temb_dim, temb_dim, device=dev)
        self.temb2 = Dense(temb_dim, temb_dim, device=dev)
        self.stem = Conv(in_channels, ch, 3, device=dev)
        widths = []  # each down level's output width: its skip's
        cin = ch
        for i, mult in enumerate(self.channel_mults):
            self.add_module(f"down{i}", ResBlock(cin, ch * mult, temb_dim, device=dev))
            cin = ch * mult
            widths.append(cin)
        mid = ch * self.channel_mults[-1]
        self.mid1 = ResBlock(cin, mid, temb_dim, device=dev)
        self.mid_attn = SelfAttention2D(mid, device=dev)
        self.mid2 = ResBlock(mid, mid, temb_dim, device=dev)
        cin = mid
        for i, mult in reversed(list(enumerate(self.channel_mults))):
            skip = widths.pop()
            self.add_module(f"up{i}", ResBlock(cin + skip, ch * mult, temb_dim, device=dev))
            cin = ch * mult
        self.GroupNorm_0 = GroupNorm(_groups(cin), cin, device=dev)
        self.head = Conv(cin, out_channels, 3, device=dev)
        init_weights(self, generator or torch.Generator(device=dev).manual_seed(0))
        for name, mod in self.named_modules():
            if name == "mid_attn.proj" or name == "head" or name.endswith(".conv2"):
                _zero(mod)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.base_channels * 4).to(self.dtype)
        temb = self.temb2(F.silu(self.temb1(temb)))
        h = self.stem(x.permute(0, 3, 1, 2).to(self.dtype))  # NHWC -> NCHW
        # the down path keeps each level's output, before pooling, as the
        # skip of the up level at the same resolution
        skips = []
        last = len(self.channel_mults) - 1
        for i in range(len(self.channel_mults)):
            h = getattr(self, f"down{i}")(h, temb)
            skips.append(h)
            if i < last:
                h = F.avg_pool2d(h, 2)
        h = self.mid2(self.mid_attn(self.mid1(h, temb)), temb)
        for i in reversed(range(len(self.channel_mults))):
            h = getattr(self, f"up{i}")(torch.cat([h, skips.pop()], dim=1), temb)
            if i > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = self.head(F.silu(self.GroupNorm_0(h)))
        return h.permute(0, 2, 3, 1).float()  # NCHW -> NHWC


def cosine_schedule(
    timesteps: int, s: float = 0.008, device: DeviceLike = "cpu"
) -> Dict[str, torch.Tensor]:
    """DDPM cosine betas and the alpha-bar tables the loss and the sampler
    read, f32 ``[timesteps]`` each."""
    steps = torch.arange(timesteps + 1, dtype=torch.float32, device=device)
    f = torch.cos(((steps / timesteps) + s) / (1 + s) * math.pi / 2) ** 2
    alpha_bar = f / f[0]
    betas = torch.clamp(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
    alphas = 1 - betas
    alpha_bar = torch.cumprod(alphas, dim=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alpha_bar": alpha_bar,
        "sqrt_ab": torch.sqrt(alpha_bar),
        "sqrt_1mab": torch.sqrt(1 - alpha_bar),
    }


@torch.no_grad()
def ddpm_sample(
    model: UNet,
    shape: Tuple[int, ...],
    timesteps: int = 1000,
    *,
    generator: Optional[torch.Generator] = None,
    x_init: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral sampling over t = T-1 .. 0 on the model's device, NHWC
    ``shape``.  The initial noise is ``x_init`` and step t's noise
    ``step_noise[t]`` where given, else standard normals drawn from
    ``generator``.  Step 0 adds no noise, which the host knows, so no draw is
    made for it and the loop never reads the device."""
    dev = next(model.parameters()).device
    sched = cosine_schedule(timesteps, device=dev)
    if x_init is None:
        x = torch.randn(shape, generator=generator, device=dev)
    else:
        x = x_init.to(dev)
    for t in range(timesteps - 1, -1, -1):
        eps = model(x, torch.full((shape[0],), t, dtype=torch.int32, device=dev))
        beta, alpha, ab = sched["betas"][t], sched["alphas"][t], sched["alpha_bar"][t]
        x = (x - beta / torch.sqrt(1 - ab) * eps) / torch.sqrt(alpha)
        if t > 0:
            noise = (step_noise[t].to(dev) if step_noise is not None
                     else torch.randn(shape, generator=generator, device=dev))
            x = x + torch.sqrt(beta) * noise
    return x


def noised_loss(
    model: UNet,
    img: torch.Tensor,
    t: torch.Tensor,
    eps: torch.Tensor,
    sched: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """The simple DDPM loss at given timesteps ``t`` and noise ``eps``:
    ``x_t = sqrt(ab_t) x + sqrt(1 - ab_t) eps``, the MSE of the model's
    prediction of eps (``img`` in [-1, 1], NHWC)."""
    x_t = (sched["sqrt_ab"][t][:, None, None, None] * img
           + sched["sqrt_1mab"][t][:, None, None, None] * eps)
    return torch.mean((model(x_t, t) - eps) ** 2)


class DiffusionTrial(TorchTrial):
    """Epsilon-prediction DDPM training (Ho et al. simple loss).

    Hyperparameters: lr, base_channels, timesteps, global_batch_size,
    dataset_size, bf16.
    """

    def _hp(self, name: str, default: Any) -> Any:
        return self.context.get_hparam(name, default)

    def build_model(self) -> UNet:
        return UNet(
            base_channels=int(self._hp("base_channels", 32)),
            dtype=torch.bfloat16 if bool(self._hp("bf16", False)) else torch.float32,
            device=self.context.device,
            generator=self.context.generator(),
        )

    def build_optimizer(self) -> Any:
        from determined_tpu_torch.ops.fused_adamw import fused_adamw

        # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4,
        # an f32 first moment, no clip
        return fused_adamw(float(self._hp("lr", 2e-4)), weight_decay=1e-4, clip_norm=None)

    def _dataset(self, train: bool):
        return mnist_like(size=int(self._hp("dataset_size", 4096)), seed=0 if train else 1)

    def build_training_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(train=True), self.context.get_global_batch_size(),
                          shuffle=True, seed=self.context.seed)

    def build_validation_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(train=False), self.context.get_global_batch_size(),
                          shuffle=False, seed=self.context.seed)

    @functools.cached_property
    def schedule(self) -> Dict[str, torch.Tensor]:
        return cosine_schedule(int(self._hp("timesteps", 1000)), device=self.context.device)

    def loss(
        self, model: UNet, batch: Dict[str, torch.Tensor], rng: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        img = batch["image"].float() * 2.0 - 1.0  # [-1, 1]
        timesteps = int(self._hp("timesteps", 1000))
        t = torch.randint(0, timesteps, (img.shape[0],), generator=rng, device=img.device)
        eps = torch.randn(img.shape, generator=rng, device=img.device)
        loss = noised_loss(model, img, t, eps, self.schedule)
        return loss, {"mse": loss}

    def evaluate_batch(
        self, model: UNet, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        # a fixed generator: the same t and noise every validation
        rng = torch.Generator(device=self.context.device).manual_seed(0)
        loss, _ = self.loss(model, batch, rng)
        return {"validation_loss": loss}
