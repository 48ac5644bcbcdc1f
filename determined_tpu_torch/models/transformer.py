"""Flagship model: decoder-only transformer LM, its training trial and its
serving path.

Port of ``determined_tpu/models/transformer.py``: rotary position
embeddings that pair even and odd lanes, GQA, RMSNorm with the variance
taken in f32, SwiGLU, f32 parameters with compute in ``cfg.dtype``; per-block
``torch.utils.checkpoint`` under ``cfg.remat``.  ``LMTrial`` is the JAX
``LMTrial``; its pipeline branches run ``parallel/pipeline.py``.  ``cfg.quantized_matmul`` (int8 or
fp8, ``train/_quant.py``) quantizes the training forward's q, k, v, o,
gate, up and down products and the logits head, as the JAX package's flax
modules do; the fused cross-entropy head keeps its own bf16 contraction,
and the KV-cache serving functions stay unquantized (their plain products
are the JAX serving functions' ``@``).  The KV-cache serving functions (``transformer_prefill``,
``transformer_decode``, ``transformer_prefill_suffix``) take the
``TransformerLM`` module where the JAX functions take its param tree, and
update the paged cache in place where JAX returns a donated copy.

On a mesh, ``parallel.sharding.shard_model`` calls ``shard_tensor`` and
``shard_seq`` (JAX's logical rules, ``heads``/``mlp``/``vocab`` -> tensor,
``length`` -> seq):

- tensor (Megatron's layout): ``wq`` keeps its rank's output heads and
  ``wo`` the matching input columns; ``w_gate``/``w_up`` their
  ``ff / tensor`` output rows and ``w_down`` the input columns; ``embed``
  its vocabulary rows (a masked lookup, then an all-reduce) and ``lm_head``
  its vocabulary rows (the loss is vocab-parallel,
  ``ops/cross_entropy.py``).  ``wk``/``wv`` keep their rank's kv heads
  where the tensor size divides ``kv_heads``; elsewhere (MQA, say) they
  stay whole, every rank computes all kv heads from the block's input and
  takes the ones its q heads read, and their gradient is summed over the
  tensor group before it reaches the weights (JAX's rule ``kv -> None``
  replicates them everywhere).  The column-parallel products take their
  input through ``copy_to`` and the row-parallel ones give theirs through
  ``reduce_from`` (``parallel/tensor_parallel.py``), so norms and every
  replicated parameter get whole gradients.
- seq: each rank holds its contiguous ``S / seq`` tokens through the
  norms, the MLP and the loss; rope takes the global positions ``rank ·
  S/seq + arange(S/seq)`` and attention is the ring
  (``ops/ring_attention.py``) over the seq group.  ``attention_impl`` must
  then be ``auto`` or ``ring``: flash and reference see one shard only.
  With a seq axis of 1, ``ring`` is the whole-sequence ``auto``
  (``ops/attention.py``'s ``dot_product_attention`` holds the rule).

The paged pool is ``[n_layers, num_blocks, block_size, kv_heads, head_dim]``
with keys stored after rope; physical block 0 is scratch (padded prefill
positions and empty decode lanes write there).  Positions of ``-1`` mark
empty decode lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.data import DataLoader, SyntheticDataset
from determined_tpu_torch.models.moe import MoE
from determined_tpu_torch.ops.attention import (
    NEG_INF,
    _repeat_kv,
    dot_product_attention,
)
from determined_tpu_torch.parallel.tensor_parallel import (
    copy_to,
    keep_slice,
    reduce_from,
    split_range,
    vocab_parallel_embedding,
)
from determined_tpu_torch.train._quant import check_mode, quant_linear, require_platform
from determined_tpu_torch.train._trial import TorchTrial

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None          # None -> n_heads (MHA)
    d_ff: Optional[int] = None                # None -> 4 * d_model
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    attention_impl: str = "auto"              # auto|reference|flash|ring
    remat: bool = False                       # checkpoint each block in training
    rope_theta: float = 10000.0
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    quantized_matmul: str = "none"
    partition_params: bool = True             # no effect on one device
    # JAX's manual-SPMD axis names inside a pipeline stage.  The port's
    # stage blocks reach the seq and expert groups the way every block does
    # (``shard_seq``: the ring through ``dot_product_attention``;
    # ``shard_experts``), so these only mark a config as a stage's
    seq_axis_name: Optional[str] = None
    expert_axis_name: Optional[str] = None

    def __post_init__(self):
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError(
                "moe_every must be >= 1 when moe_experts > 0 "
                f"(got moe_every={self.moe_every})"
            )
        if self.attention_impl not in ("auto", "reference", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        check_mode(self.quantized_matmul)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    )
    angles = positions[:, None].float() * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate lane pairs (2i, 2i+1) in f32 and cast back: the JAX layout,
    not the rotate-half layout of HF models."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x1 * sin + x2 * cos
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings on [b, h, s, d] with positions [s]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # [s, d/2]
    return _rotate(x, cos, sin)


def _rope_batched(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings on [b, h, 1, d] with a per-sequence position [b]
    (the decode step: every lane sits at its own offset)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # [b, d/2]
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


def _rms_apply(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: variance in f32, scale cast back to x's dtype."""
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * weight.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device: DeviceLike = None) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_apply(x, self.weight, self.eps)


def _linear(d_in: int, d_out: int, device: torch.device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=torch.float32)


def _check_tensor_parallel(cfg: TransformerConfig) -> None:
    if cfg.quantized_matmul != "none":
        raise NotImplementedError(
            f"quantized_matmul={cfg.quantized_matmul!r} on the 'tensor' mesh axis is not ported "
            "to determined_tpu_torch yet (a row-parallel product would scale its rows over "
            "its own columns only); it comes with a later slice of the port (ROADMAP.md, "
            "Queue 1)"
        )


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _linear(cfg.d_model, cfg.n_heads * hd, device)
        self.wk = _linear(cfg.d_model, cfg.kv_heads * hd, device)
        self.wv = _linear(cfg.d_model, cfg.kv_heads * hd, device)
        self.wo = _linear(cfg.n_heads * hd, cfg.d_model, device)
        # (group, size, rank) of the tensor and seq axes once sharded
        self.tensor: Optional[Tuple[Any, int, int]] = None
        self.seq: Optional[Tuple[Any, int, int]] = None
        self.kv_whole = False  # wk/wv kept whole on a tensor group

    def shard_tensor(self, group: Any, size: int, rank: int) -> Dict[str, int]:
        """Keep this rank's heads (module docstring); the split leaves and
        their dims."""
        cfg = self.cfg
        _check_tensor_parallel(cfg)
        hd = cfg.head_dim
        lo, hi = split_range(cfg.n_heads, size, rank, "n_heads")
        keep_slice(self.wq, "weight", 0, lo * hd, hi * hd)
        keep_slice(self.wo, "weight", 1, lo * hd, hi * hd)
        dims = {"wq.weight": 0, "wo.weight": 1}
        self.kv_whole = cfg.kv_heads % size != 0
        if not self.kv_whole:
            klo, khi = split_range(cfg.kv_heads, size, rank, "kv_heads")
            for lin in (self.wk, self.wv):
                keep_slice(lin, "weight", 0, klo * hd, khi * hd)
            dims.update({"wk.weight": 0, "wv.weight": 0})
        self.tensor = (group, size, rank)
        return dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt, quant = cfg.dtype, cfg.quantized_matmul
        s = x.shape[1]
        hd = cfg.head_dim
        xin = x if self.tensor is None else copy_to(x, self.tensor[0])
        q = _heads(xin, self.wq, hd, dt, quant)
        if self.kv_whole:
            # every kv head from the block's input; the sum over the tensor
            # group makes their gradient (and its share of x's) whole
            group, size, rank = self.tensor
            n_rep = cfg.n_heads // cfg.kv_heads
            h_loc = cfg.n_heads // size
            k, v = (_repeat_kv(copy_to(_heads(x, lin, hd, dt, quant), group),
                               n_rep)[:, rank * h_loc:(rank + 1) * h_loc]
                    for lin in (self.wk, self.wv))
        else:
            k, v = (_heads(xin, lin, hd, dt, quant) for lin in (self.wk, self.wv))
        positions = torch.arange(s, device=x.device)
        if self.seq is not None:
            positions = positions + self.seq[2] * s  # global (contiguous) positions
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        out = dot_product_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                                    seq=None if self.seq is None else self.seq[:2])
        out = _out_proj(self, out, dt, quant)
        return out if self.tensor is None else reduce_from(out, self.tensor[0])


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.w_gate = _linear(cfg.d_model, cfg.ff_dim, device)
        self.w_up = _linear(cfg.d_model, cfg.ff_dim, device)
        self.w_down = _linear(cfg.ff_dim, cfg.d_model, device)
        self.tensor: Optional[Tuple[Any, int, int]] = None

    def shard_tensor(self, group: Any, size: int, rank: int) -> Dict[str, int]:
        """Keep this rank's ``ff / size`` hidden units: gate and up rows,
        down columns."""
        _check_tensor_parallel(self.cfg)
        lo, hi = split_range(self.cfg.ff_dim, size, rank, "d_ff")
        keep_slice(self.w_gate, "weight", 0, lo, hi)
        keep_slice(self.w_up, "weight", 0, lo, hi)
        keep_slice(self.w_down, "weight", 1, lo, hi)
        self.tensor = (group, size, rank)
        return {"w_gate.weight": 0, "w_up.weight": 0, "w_down.weight": 1}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return _mlp_apply(self, x, self.cfg.dtype, self.cfg.quantized_matmul)
        out = _mlp_apply(self, copy_to(x, self.tensor[0]), self.cfg.dtype,
                         self.cfg.quantized_matmul)
        return reduce_from(out, self.tensor[0])


class Block(nn.Module):
    """Attention then the feed-forward: a dense ``mlp``, or with ``use_moe``
    the ``moe`` experts.  Returns ``(x, aux)``, aux None without experts."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, use_moe: bool = False) -> None:
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        if use_moe:
            self.moe = MoE(
                cfg.d_model, cfg.moe_experts, cfg.ff_dim,
                capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype, device=device,
            )
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x + self.attn(self.ln1(x))
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        return x + self.mlp(self.ln2(x)), None


class _Layers(nn.Module):
    """Some layers of the stack under their indices in the whole stack (a
    pipeline rank's chunks), so that their parameters keep the whole
    model's names (``blocks.<i>.``).  Iterates in layer order."""

    def __init__(self, blocks: Dict[int, nn.Module]) -> None:
        super().__init__()
        for i in sorted(blocks):
            self.add_module(str(i), blocks[i])

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]


class TransformerLM(nn.Module):
    """The flagship decoder-only LM.  Parameters are f32 on ``device``
    (CUDA unless named), initialised from ``generator`` (seed 0 when
    omitted): dense kernels normal with std ``fan_in ** -0.5``, the
    embedding normal with std 0.02, norms one, the experts as ``MoE``
    scales them.  Every ``moe_every``-th block (``i % moe_every ==
    moe_every - 1``) takes ``MoE`` experts in place of its MLP when
    ``cfg.moe_experts > 0``."""

    def __init__(
        self,
        cfg: TransformerConfig,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev)
        self.blocks = nn.ModuleList(
            Block(cfg, dev, cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1)
            for i in range(cfg.n_layers)
        )
        self.ln_f = RMSNorm(cfg.d_model, device=dev)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)
        # (group, size, rank) of the tensor and seq axes once sharded
        self.tensor: Optional[Tuple[Any, int, int]] = None
        self.seq: Optional[Tuple[Any, int, int]] = None
        # the pipeline (shard_pipe): the pipe, and the layers of each chunk
        # this process holds
        self.pipe: Any = None
        self.virtual_stages = 1
        self.chunk_layers: Dict[int, List[int]] = {}
        self._grad_sync = True

    def shard_pipe(self, pipe: Any) -> None:
        """Hold this process's chunks of the layer stack for the pipeline
        (``parallel/pipeline.py``; ``pipe`` a ``PipeGroup`` or a
        ``VirtualPipe``, which holds every chunk; ``virtual_stages`` set
        first).  Chunk ``c = v * P + p`` is layers ``[c * L/(P*V), (c + 1) *
        L/(P*V))`` on rank ``p``: JAX's ``split_pipeline_params`` layout,
        the same init as one device.  The rank holding chunk 0 keeps
        ``embed``, the one holding the last chunk ``ln_f`` and ``lm_head``; a
        ``PipeGroup`` rank drops the rest, and what it keeps keeps the whole
        model's names."""
        from determined_tpu_torch.config.experiment import InvalidExperimentConfig

        v, n = self.virtual_stages, pipe.size
        total = n * v
        n_layers = len(self.blocks)
        if n_layers == 0 or n_layers % total:
            raise InvalidExperimentConfig(
                f"n_layers={n_layers} not divisible into {total} pipeline "
                f"chunks (pipe={n} x virtual_stages={v})"
            )
        lpc = n_layers // total
        for j in range(lpc):
            kinds = {hasattr(self.blocks[c * lpc + j], "moe") for c in range(total)}
            if len(kinds) > 1:
                raise InvalidExperimentConfig(
                    f"layer {j} differs in structure across pipeline chunks "
                    "(is the MoE period a divisor of layers-per-chunk?)"
                )
        held = [c for c in range(total) if c % n in pipe.ranks()]
        self.chunk_layers = {c: list(range(c * lpc, (c + 1) * lpc)) for c in held}
        self.pipe = pipe
        if len(held) < total:
            keep = {i: self.blocks[i] for c in held for i in self.chunk_layers[c]}
            self.blocks = _Layers(keep)
            if 0 not in held:
                self.embed = None
            if total - 1 not in held:
                self.ln_f = None
                self.lm_head = None
            # the pipe's communicators, made before anything is timed
            pipe.warm(torch.zeros(1, device=next(self.parameters()).device))

    def stage_chunks(self) -> List[Optional[List[nn.Module]]]:
        """``pipeline_apply``'s stages: each chunk's blocks (None where
        another rank holds it)."""
        total = self.pipe.size * self.virtual_stages
        return [[self.blocks[i] for i in self.chunk_layers[c]] if c in self.chunk_layers
                else None for c in range(total)]

    def set_requires_gradient_sync(self, requires: bool) -> None:
        """Gradient accumulation's switch on a pipeline rank, whose blocks
        are FSDP2 modules of their own: the pipeline reduces the gradients
        at each chunk's last backward unit only when it is on."""
        self._grad_sync = requires

    def pipe_backward_hook(self, chunk: int, last: bool) -> None:
        """Before each backward unit of ``chunk``: its FSDP2 blocks reduce
        and reshard only on the step's last unit of the chunk (with
        ``reshard_after_forward`` off, a step all-gathers each block once and
        reduce-scatters it once, not M times)."""
        from torch.distributed.fsdp import FSDPModule

        for i in self.chunk_layers[chunk]:
            blk = self.blocks[i]
            if isinstance(blk, FSDPModule):
                blk.set_requires_gradient_sync(self._grad_sync and last)
                blk.set_reshard_after_backward(last)

    def shard_tensor(self, group: Any, size: int, rank: int) -> Dict[str, int]:
        """Keep this rank's vocabulary rows of ``embed`` and ``lm_head``
        (the blocks' modules split their own).  MoE blocks do not split."""
        if self.cfg.moe_experts > 0:
            raise NotImplementedError(
                "MoE blocks on the 'tensor' mesh axis are not ported to determined_tpu_torch "
                "yet; they come with a later slice of the port (ROADMAP.md, Queue 1)"
            )
        _check_tensor_parallel(self.cfg)
        lo, hi = split_range(self.cfg.vocab_size, size, rank, "vocab_size")
        keep_slice(self.embed, "weight", 0, lo, hi)
        keep_slice(self.lm_head, "weight", 0, lo, hi)
        self.tensor = (group, size, rank)
        return {"embed.weight": 0, "lm_head.weight": 0}

    @property
    def vocab_start(self) -> int:
        """The first vocabulary row this rank holds (0 unsharded)."""
        return 0 if self.tensor is None else self.tensor[2] * self.lm_head.weight.shape[0]

    def shard_seq(self, group: Any, size: int, rank: int) -> None:
        """Run on this rank's contiguous ``1 / size`` of every sequence,
        attention through the ring over ``group``.  ``shard_model`` calls it
        on every mesh: with ``size`` 1, ``attention_impl='ring'`` is
        whole-sequence attention (flash on CUDA), as JAX's ring falls back
        without a seq axis."""
        if size > 1 and self.cfg.moe_experts > 0:
            raise NotImplementedError(
                "MoE blocks on the 'seq' mesh axis are not ported to determined_tpu_torch yet; "
                "they come with a later slice of the port (ROADMAP.md, Queue 1)"
            )
        if size > 1 and self.cfg.attention_impl not in ("auto", "ring"):
            raise ValueError(
                f"attention_impl={self.cfg.attention_impl!r} on a 'seq' mesh axis: the port "
                "runs ring attention there; use 'auto' or 'ring'"
            )
        self.seq = (group, size, rank)
        for blk in self.blocks:
            blk.attn.seq = self.seq

    def seq_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous part of ``x`` [b, S, ...] along S (all of
        it without a seq axis)."""
        if self.seq is None:
            return x
        _, size, rank = self.seq
        if x.shape[1] % size:
            raise ValueError(f"the seq axis ({size}) must divide the sequence ({x.shape[1]})")
        part = x.shape[1] // size
        return x[:, rank * part:(rank + 1) * part]

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        self.embed.weight.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
            elif isinstance(mod, MoE):
                mod.reset_parameters(generator)

    def forward(
        self, tokens: torch.Tensor, return_hidden: bool = False, return_aux: bool = False
    ) -> Any:
        """Logits [b, s, vocab] in f32, or with ``return_hidden`` the final
        normed hidden states [b, s, d] in ``cfg.dtype``; with ``return_aux``
        also the MoE blocks' aux losses summed (f32 zero without experts).
        On a tensor group the logits are this rank's vocabulary columns; on
        a seq group ``tokens`` are this rank's part of each sequence.  A
        pipeline rank holding part of the stack runs through the trial's
        schedule instead (``LMTrial``)."""
        if self.pipe is not None and len(self.chunk_layers) < self.pipe.size * self.virtual_stages:
            raise RuntimeError("this model holds one pipeline rank's layers: run it through "
                               "parallel.pipeline.pipeline_apply (LMTrial.loss)")
        if self.tensor is None:
            x = self.embed.weight[tokens].to(self.cfg.dtype)
        else:
            x = vocab_parallel_embedding(self.embed.weight, tokens, self.tensor[0],
                                         self.vocab_start).to(self.cfg.dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux_total = None
        for blk in self.blocks:
            # remat: keep only each block's input; the backward reruns it
            x, aux = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        x = self.ln_f(x)
        if self.tensor is not None:
            # the head's columns are this rank's vocabulary: x's gradient
            # from them is partial, summed over the group here
            x = copy_to(x, self.tensor[0])
        if not return_hidden:
            x = quant_linear(
                x, self.lm_head.weight, self.cfg.dtype, self.cfg.quantized_matmul
            ).float()
        if not return_aux:
            return x
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux_total


# ---------------------------------------------------------------------------
# KV-cache serving path
# ---------------------------------------------------------------------------


def kv_cache_shape(cfg: TransformerConfig, num_blocks: int, block_size: int) -> Tuple[int, ...]:
    return (cfg.n_layers, num_blocks, block_size, cfg.kv_heads, cfg.head_dim)


def init_kv_cache(
    cfg: TransformerConfig, num_blocks: int, block_size: int, *, device: DeviceLike = None
) -> Cache:
    """Zeroed paged K/V pool in the compute dtype (keys stored post-rope)."""
    shape = kv_cache_shape(cfg, num_blocks, block_size)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def _heads(
    x: torch.Tensor, lin: nn.Linear, hd: int, dtype: torch.dtype, quant: str = "none"
) -> torch.Tensor:
    """One projection of x [b, s, d] to [b, heads, s, hd].  ``quant`` is
    the training forward's mode; the serving path leaves it ``none``."""
    b, s, _ = x.shape
    return quant_linear(x, lin.weight, dtype, quant).view(b, s, -1, hd).transpose(1, 2)


def _attn_proj(
    attn: Attention, x: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The serving path's q/k/v projections of x [b, s, d] to [b, heads,
    s, head_dim]."""
    hd = attn.cfg.head_dim
    return tuple(_heads(x, lin, hd, dtype) for lin in (attn.wq, attn.wk, attn.wv))


def _out_proj(
    attn: Attention, att: torch.Tensor, dtype: torch.dtype, quant: str = "none"
) -> torch.Tensor:
    """Output projection of attention [b, heads, s, head_dim] to [b, s, d]."""
    b, h, s, hd = att.shape
    return quant_linear(att.transpose(1, 2).reshape(b, s, h * hd), attn.wo.weight, dtype, quant)


def _mlp_apply(mlp: MLP, x: torch.Tensor, dtype: torch.dtype, quant: str = "none") -> torch.Tensor:
    gate = quant_linear(x, mlp.w_gate.weight, dtype, quant)
    up = quant_linear(x, mlp.w_up.weight, dtype, quant)
    return quant_linear(F.silu(gate) * up, mlp.w_down.weight, dtype, quant)


def _check_decodable(cfg: TransformerConfig) -> None:
    if cfg.moe_experts > 0:
        raise ValueError("KV-cache serving does not support MoE configs yet")
    if cfg.seq_axis_name is not None or cfg.expert_axis_name is not None:
        raise ValueError("KV-cache serving runs outside pipeline stages")


def _embed(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed.weight[tokens].to(model.cfg.dtype)


def _head(model: TransformerLM, x: torch.Tensor) -> torch.Tensor:
    x = _rms_apply(x, model.ln_f.weight)
    return F.linear(x, model.lm_head.weight.to(model.cfg.dtype)).float()


def _gather_table(cache_i: torch.Tensor, tables: torch.Tensor, n_rep: int) -> torch.Tensor:
    """The cache rows a block table maps, as [b, heads, T * block_size, hd]."""
    b, t = tables.shape
    _, bs, kvh, hd = cache_i.shape
    rows = cache_i[tables].reshape(b, t * bs, kvh, hd)
    return _repeat_kv(rows.transpose(1, 2), n_rep)


def _masked_softmax_attention(
    q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor, scale: float
) -> torch.Tensor:
    logits = torch.matmul(q.float(), keys.float().transpose(-1, -2)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(vals.dtype), vals)


def transformer_prefill(
    model: TransformerLM,
    tokens: torch.Tensor,
    prompt_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """Full-prompt forward that also writes the paged cache (in place).

    ``tokens`` [B, S] is the prompt padded to a fixed S; ``prompt_lens`` [B]
    the real lengths; ``block_tables`` [B, T] each lane's physical block
    ids.  Returns (logits [B, S, vocab] f32, cache).  The causal attention
    goes through the flash kernel on CUDA and its plain version on the CPU.
    """
    cfg = model.cfg
    _check_decodable(cfg)
    block_size = cache["k"].shape[2]
    b, s = tokens.shape
    dev = tokens.device
    dt = cfg.dtype
    tables = block_tables.long()
    x = _embed(model, tokens)
    positions = torch.arange(s, device=dev)
    # physical destination of every (lane, position): padded tail -> scratch
    col = (positions // block_size)[None, :].expand(b, s)
    phys = torch.where(
        positions[None, :] < prompt_lens.long()[:, None], torch.gather(tables, 1, col), 0
    )
    slots = (positions % block_size)[None, :].expand(b, s)
    k_cache, v_cache = cache["k"], cache["v"]
    for i, blk in enumerate(model.blocks):
        h = _rms_apply(x, blk.ln1.weight)
        q, k, v = _attn_proj(blk.attn, h, dt)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        k_cache[i, phys, slots] = k.transpose(1, 2)
        v_cache[i, phys, slots] = v.transpose(1, 2)
        att = dot_product_attention(q, k, v, causal=True, impl="flash")
        x = x + _out_proj(blk.attn, att, dt)
        x = x + _mlp_apply(blk.mlp, _rms_apply(x, blk.ln2.weight), dt)
    return _head(model, x), cache


def _paged_attention_chunked(
    q: torch.Tensor,
    k_cache_i: torch.Tensor,
    v_cache_i: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    n_rep: int,
    scale: float,
    chunk_blocks: int,
    n_chunks: int,
) -> torch.Tensor:
    """Lazy paged attention for one decode step of one layer: attend over
    only the first ``n_chunks * chunk_blocks`` table columns, the chunks
    the longest active lane reaches, gathered at once.  The JAX function
    folds the same chunks one by one into an online softmax; taking them
    together gives the same softmax in f32 (scores, p and v in f32 as
    there) up to reassociation, in one pass instead of a Python loop of
    small launches.  Masked positions use the finite ``NEG_INF``.  Returns
    [b, n_heads, 1, head_dim] in f32."""
    cols = n_chunks * chunk_blocks
    keys = _gather_table(k_cache_i, block_tables[:, :cols], n_rep)
    vals = _gather_table(v_cache_i, block_tables[:, :cols], n_rep)
    s = torch.matmul(q.float(), keys.float().transpose(-1, -2)) * scale
    k_idx = torch.arange(keys.shape[2], device=q.device)
    msk = ((k_idx[None, :] <= pos[:, None]) & active[:, None])[:, None, None, :]
    s = torch.where(msk, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.matmul(p, vals.float()) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def transformer_decode(
    model: TransformerLM,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    block_tables: torch.Tensor,
    cache: Cache,
    *,
    chunk_blocks: int = 0,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step over the paged cache for every lane at once.

    ``tokens`` [B] the token each lane just consumed; ``positions`` [B] its
    position (-1 marks an empty lane: it writes the scratch block and its
    logits are garbage the caller ignores).  Returns (logits [B, vocab] f32,
    cache), the cache updated in place.  ``chunk_blocks`` > 0 takes the lazy
    chunked path over only the table columns the longest lane needs; 0
    gathers the whole table.
    """
    cfg = model.cfg
    _check_decodable(cfg)
    block_size = cache["k"].shape[2]
    b = tokens.shape[0]
    t = block_tables.shape[1]
    kv_len = t * block_size
    dev = tokens.device
    dt = cfg.dtype
    tables = block_tables.long()
    positions = positions.long()
    active = positions >= 0
    pos = positions.clamp_min(0)
    x = _embed(model, tokens[:, None])
    phys = torch.where(active, torch.gather(tables, 1, (pos // block_size)[:, None])[:, 0], 0)
    slot = pos % block_size
    k_pos = torch.arange(kv_len, device=dev)
    # attend to every cache position up to and including the current token
    mask = ((k_pos[None, :] <= pos[:, None]) & active[:, None])[:, None, None, :]
    k_cache, v_cache = cache["k"], cache["v"]
    n_rep = cfg.n_heads // cfg.kv_heads
    scale = cfg.head_dim ** -0.5
    n_chunks = 0
    if chunk_blocks:
        if t % chunk_blocks:
            raise ValueError(f"chunk_blocks={chunk_blocks} must divide the table width {t}")
        chunk_tokens = chunk_blocks * block_size
        longest = int(torch.where(active, pos, 0).max())
        n_chunks = min(longest // chunk_tokens + 1, t // chunk_blocks)
    for i, blk in enumerate(model.blocks):
        h = _rms_apply(x, blk.ln1.weight)
        q, k, v = _attn_proj(blk.attn, h, dt)  # [b, heads|kv, 1, hd]
        q = _rope_batched(q, pos, cfg.rope_theta)
        k = _rope_batched(k, pos, cfg.rope_theta)
        # write this token's k/v, then attend against the updated pool so
        # the step sees its own key
        k_cache[i, phys, slot] = k[:, :, 0, :]
        v_cache[i, phys, slot] = v[:, :, 0, :]
        if chunk_blocks:
            att = _paged_attention_chunked(
                q, k_cache[i], v_cache[i], tables, pos, active,
                n_rep, scale, chunk_blocks, n_chunks,
            ).to(dt)
        else:
            keys = _gather_table(k_cache[i], tables, n_rep)
            vals = _gather_table(v_cache[i], tables, n_rep)
            att = _masked_softmax_attention(q, keys, vals, mask, scale)
        x = x + _out_proj(blk.attn, att, dt)
        x = x + _mlp_apply(blk.mlp, _rms_apply(x, blk.ln2.weight), dt)
    return _head(model, x)[:, 0, :], cache


def transformer_prefill_suffix(
    model: TransformerLM,
    tokens: torch.Tensor,
    start_lens: torch.Tensor,
    prompt_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """Prefill only the un-cached suffix of each prompt (prefix caching).

    ``tokens`` [B, S] is the full prompt padded to a multiple of the block
    size; ``start_lens`` [B] how many leading tokens already sit in cache
    blocks mapped into ``block_tables`` (block-aligned); ``prompt_lens`` [B]
    the real lengths.  Walks one block of tokens per step from the first
    un-cached block; queries attend to keys read back from the cache, so a
    warm start and a cold ``start=0`` run see the same stored values.
    Returns (logits at ``prompt_len - 1`` [B, vocab] f32, cache).
    """
    cfg = model.cfg
    _check_decodable(cfg)
    block_size = cache["k"].shape[2]
    b, s = tokens.shape
    if s % block_size:
        raise ValueError(
            f"suffix prefill needs tokens padded to the block size "
            f"(got S={s}, block_size={block_size})"
        )
    t = block_tables.shape[1]
    kv_len = t * block_size
    dev = tokens.device
    dt = cfg.dtype
    tables = block_tables.long()
    start_lens, prompt_lens = start_lens.long(), prompt_lens.long()
    n_rep = cfg.n_heads // cfg.kv_heads
    scale = cfg.head_dim ** -0.5
    c_lo = int(start_lens.min()) // block_size
    c_hi = (int(prompt_lens.max()) + block_size - 1) // block_size
    k_pos = torch.arange(kv_len, device=dev)
    lanes = torch.arange(b, device=dev)
    slots = torch.arange(block_size, device=dev)[None, :].expand(b, block_size)
    k_cache, v_cache = cache["k"], cache["v"]
    last_logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
    for c in range(c_lo, c_hi):
        toks = tokens[:, c * block_size : (c + 1) * block_size]
        p = c * block_size + torch.arange(block_size, device=dev)  # absolute positions
        valid = (p[None, :] >= start_lens[:, None]) & (p[None, :] < prompt_lens[:, None])
        phys = torch.where(valid, tables[:, c : c + 1], 0)
        att_mask = (k_pos[None, :] <= p[:, None])[None, None]  # [1, 1, bs, kv_len]
        x = _embed(model, toks)
        for i, blk in enumerate(model.blocks):
            h = _rms_apply(x, blk.ln1.weight)
            q, k, v = _attn_proj(blk.attn, h, dt)  # [b, heads|kv, bs, hd]
            q = _rope(q, p, cfg.rope_theta)
            k = _rope(k, p, cfg.rope_theta)
            # write this block's k/v first, then attend through the cache
            k_cache[i, phys, slots] = k.transpose(1, 2)
            v_cache[i, phys, slots] = v.transpose(1, 2)
            keys = _gather_table(k_cache[i], tables, n_rep)
            vals = _gather_table(v_cache[i], tables, n_rep)
            att = _masked_softmax_attention(q, keys, vals, att_mask, scale)
            x = x + _out_proj(blk.attn, att, dt)
            x = x + _mlp_apply(blk.mlp, _rms_apply(x, blk.ln2.weight), dt)
        logits = _head(model, x)  # [b, bs, vocab]
        sel = prompt_lens - 1 - c * block_size
        contains = (sel >= 0) & (sel < block_size)
        row = logits[lanes, sel.clamp(0, block_size - 1)]
        last_logits = torch.where(contains[:, None], row, last_logits)
    return last_logits, cache


# ---------------------------------------------------------------------------
# training trial
# ---------------------------------------------------------------------------

class LMTrial(TorchTrial):
    """Language-model trial over synthetic token data.

    Hyperparameters, with the JAX ``LMTrial``'s names and defaults: lr,
    global_batch_size, seq_len, vocab_size, d_model, n_layers, n_heads,
    n_kv_heads, d_ff, attention (auto/flash/reference/ring), remat, bf16,
    warmup_steps, decay_steps, dataset_size, fused_ce, ce_chunk,
    ce_bf16_residual, fused_adamw, adam_mu_bf16, weight_decay, grad_clip.
    ``fused_adamw: auto`` is the fused kernel on a CUDA device (the JAX
    trial reads "on a TPU").  ``quantized_matmul`` resolves as in the JAX
    trial (``_quant_mode``).  ``moe_experts``, ``moe_every``,
    ``moe_capacity_factor`` and ``moe_aux_weight`` put MoE blocks in the
    model; the loss then adds ``moe_aux_weight * aux`` and reports
    ``moe_aux_loss``.

    With a ``pipe`` axis of P > 1 (the mesh's, or the ``VirtualPipe`` that
    ``train.init(virtual_pipe=P)`` asks for) the model is cut into stages
    (``TransformerLM.shard_pipe``, the same init as one device) and the
    loss runs through the schedule (``pipeline_schedule`` and
    ``virtual_stages``: a hparam wins, else the experiment's
    ``optimizations``, else gpipe; ``pipe_microbatches``, else 2 a stage
    shrunk to a divisor of the batch), which also runs the backward
    (``parallel/pipeline.py``).  Where the JAX trial runs embed, the final
    norm and the head replicated on every pipe rank, the port runs embed on
    the first stage and the norm, the head and the loss (fused
    cross-entropy included) on the last, once a microbatch; the loss is
    summed over the pipe group, so every rank reports it.
    """

    def _pipe_microbatches(self, batch: int) -> int:
        m = self.context.get_hparam("pipe_microbatches", None)
        if m:
            return int(m)
        # default: 2 microbatches per stage (bubble fraction (P-1)/(M+P-1)),
        # shrunk to the largest divisor of the batch
        m = min(batch, 2 * self.context.pipe_stages)
        while batch % m:
            m -= 1
        return m

    def _pipe_schedule(self) -> Tuple[str, int]:
        """(schedule, virtual_stages): a trial hparam wins, else the
        experiment's ``optimizations`` knobs, else gpipe (``_quant_mode``'s
        precedence)."""
        g = self.context.get_hparam
        opt = (self.context.exp_config.optimizations
               if self.context.exp_config is not None else None)
        name = g("pipeline_schedule", None)
        if name is None:
            name = opt.pipeline_schedule if opt is not None else "gpipe"
        v = g("virtual_stages", None)
        if v is None:
            v = opt.virtual_stages if opt is not None else 1
        return str(name), int(v)

    def pipeline_schedule_spec(self) -> Any:
        """The trial's ``PipelineSchedule`` (None without a pipe axis): the
        Trainer's goodput ``step.bubble`` rows and its batch layout read
        it."""
        pipe = self.context.pipe_stages
        if pipe <= 1:
            return None
        from determined_tpu_torch.parallel.pipeline import PipelineSchedule

        name, v = self._pipe_schedule()
        return PipelineSchedule(
            name=name, n_stages=pipe,
            num_microbatches=self._pipe_microbatches(self.context.get_global_batch_size()),
            virtual_stages=v,
        )

    def _quant_mode(self) -> str:
        """quantized_matmul resolution: a trial hparam wins, else the
        experiment's ``optimizations.quantized_matmul``, else off.
        Platform-gated here, at setup, so fp8 where the device has none
        fails with a clear ``InvalidExperimentConfig``."""
        mode = self.context.get_hparam("quantized_matmul", None)
        if mode is None and self.context.exp_config is not None:
            mode = self.context.exp_config.optimizations.quantized_matmul
        mode = str(mode) if mode else "none"
        require_platform(mode, self.context.device)
        return mode

    def _cfg(self) -> TransformerConfig:
        g = self.context.get_hparam
        pipe = self.context.pipe_stages
        if pipe > 1 and int(g("moe_experts", 0)) > 0:
            # MoE composes with pipe when every chunk sees the same layer
            # pattern: the MoE period must divide layers-per-chunk
            _, vstages = self._pipe_schedule()
            lps = int(g("n_layers", 2)) // (pipe * vstages)
            if lps == 0 or lps % int(g("moe_every", 2)):
                raise ValueError(
                    f"pipe={pipe} with MoE needs moe_every ({g('moe_every', 2)}) "
                    f"to divide layers-per-chunk ({lps})"
                )
        return TransformerConfig(
            vocab_size=int(g("vocab_size", 2048)),
            d_model=int(g("d_model", 256)),
            n_layers=int(g("n_layers", 2)),
            n_heads=int(g("n_heads", 8)),
            n_kv_heads=g("n_kv_heads", None),
            d_ff=g("d_ff", None),
            max_seq_len=int(g("seq_len", 512)),
            attention_impl=str(g("attention", "auto")),
            remat=bool(g("remat", False)),
            dtype=torch.bfloat16 if bool(g("bf16", True)) else torch.float32,
            moe_experts=int(g("moe_experts", 0)),
            moe_every=int(g("moe_every", 2)),
            moe_capacity_factor=float(g("moe_capacity_factor", 1.25)),
            moe_aux_weight=float(g("moe_aux_weight", 0.01)),
            quantized_matmul=self._quant_mode(),
        )

    @property
    def tokens_per_sample(self) -> int:
        """Tokens one sample contributes per step."""
        return int(self.context.get_hparam("seq_len", 512))

    @property
    def flops_per_token(self) -> float:
        """Forward+backward matmul FLOPs per token by the 6N + attention
        convention (the JAX trial's and bench.py's accounting)."""
        cfg = self._cfg()
        d, n_layers, vocab = cfg.d_model, cfg.n_layers, cfg.vocab_size
        n_params = n_layers * (4 * d * d + 12 * d * d) + vocab * d
        return float(6 * n_params + 12 * n_layers * cfg.max_seq_len * d)

    def build_model(self) -> TransformerLM:
        model = TransformerLM(
            self._cfg(), device=self.context.device, generator=self.context.generator()
        )
        if self.context.mesh is None:
            # the JAX Trainer's one device is a mesh of one: attention
            # 'ring' is whole-sequence attention there (shard_model says so
            # on a mesh)
            model.shard_seq(None, 1, 0)
        spec = self.pipeline_schedule_spec()
        if spec is not None:
            # shard_model cuts a mesh's stages; a virtual pipe holds them all
            model.virtual_stages = spec.virtual_stages
            if self.context.virtual_pipe is not None:
                model.shard_pipe(self.context.virtual_pipe)
        return model

    def build_optimizer(self) -> Any:
        from determined_tpu_torch.ops.fused_adamw import fused_adamw
        from determined_tpu_torch.train._optim import ClipAdamW, warmup_cosine_decay_schedule

        g = self.context.get_hparam
        lr = float(g("lr", 3e-4))
        schedule = warmup_cosine_decay_schedule(
            0.0, lr, int(g("warmup_steps", 100)), int(g("decay_steps", 10000))
        )
        self.lr_schedule = schedule  # surfaced as the per-batch `lr` metric
        # adam first-moment dtype: bf16 halves its traffic; the second
        # moment stays f32 for the sqrt's range
        mu_dtype = torch.bfloat16 if bool(g("adam_mu_bf16", False)) else None
        fused = g("fused_adamw", "auto")
        if fused == "auto":
            fused = self.context.device.type == "cuda"
        weight_decay = float(g("weight_decay", 0.01))
        clip = float(g("grad_clip", 1.0))
        if fused:
            return fused_adamw(schedule, weight_decay=weight_decay, clip_norm=clip,
                               mu_dtype=mu_dtype)
        return ClipAdamW(schedule, clip_norm=clip, weight_decay=weight_decay, mu_dtype=mu_dtype)

    def _dataset(self, seed: int) -> SyntheticDataset:
        g = self.context.get_hparam
        seq = int(g("seq_len", 512))
        return SyntheticDataset(
            {"tokens": ((seq + 1,), np.int32, int(g("vocab_size", 2048)))},
            size=int(g("dataset_size", 2048)),
            seed=seed,
        )

    def build_training_data_loader(self) -> DataLoader:
        return DataLoader(
            self._dataset(0), self.context.get_global_batch_size(),
            shuffle=True, seed=self.context.seed,
        )

    def build_validation_data_loader(self) -> DataLoader:
        return DataLoader(
            self._dataset(1), self.context.get_global_batch_size(),
            shuffle=False, seed=self.context.seed,
        )

    def loss(
        self, model: TransformerLM, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"].long()
        # shift over the whole sequence, then each seq rank takes its part
        inputs, targets = (model.seq_slice(t) for t in (tokens[:, :-1], tokens[:, 1:]))
        tp_group = None if model.tensor is None else model.tensor[0]
        g = self.context.get_hparam
        fused = g("fused_ce", "auto")
        if fused == "auto":
            fused = model.cfg.vocab_size >= 8192
        if model.pipe is not None:
            return self._pipeline_loss(model, inputs, targets, fused)
        if fused:
            from determined_tpu_torch.ops.cross_entropy import fused_cross_entropy

            hidden, moe_aux = model(inputs, return_hidden=True, return_aux=True)
            chunk = g("ce_chunk", None)
            loss = fused_cross_entropy(
                hidden,
                model.lm_head.weight.t(),  # [d, vocab], the JAX kernel layout
                targets,
                chunk_size=None if chunk in (None, "auto") else int(chunk),
                compute_dtype=model.cfg.dtype,
                # hidden already holds this rank's shard of the batch (the
                # JAX trial divides the global batch by its shards here)
                batch_shards=1,
                bf16_residual=bool(g("ce_bf16_residual", False)),
                group=tp_group,
                vocab_start=model.vocab_start,
            )
        else:
            logits, moe_aux = model(inputs, return_aux=True)
            if tp_group is None:
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       targets.reshape(-1))
            else:
                from determined_tpu_torch.ops.cross_entropy import (
                    vocab_parallel_cross_entropy,
                )

                loss = vocab_parallel_cross_entropy(logits, targets, tp_group, model.vocab_start)
        metrics = {"perplexity": torch.exp(loss)}
        if model.cfg.moe_experts > 0:
            metrics["moe_aux_loss"] = moe_aux
            loss = loss + model.cfg.moe_aux_weight * moe_aux
        return loss, metrics

    def _head_loss(self, model: TransformerLM, y: torch.Tensor, targets: torch.Tensor,
                   fused: bool) -> torch.Tensor:
        """The final norm, the head and the mean cross-entropy of one
        microbatch's last hidden states."""
        g = self.context.get_hparam
        x = model.ln_f(y)
        if fused:
            from determined_tpu_torch.ops.cross_entropy import fused_cross_entropy

            chunk = g("ce_chunk", None)
            return fused_cross_entropy(
                x, model.lm_head.weight.t(), targets,
                chunk_size=None if chunk in (None, "auto") else int(chunk),
                compute_dtype=model.cfg.dtype, batch_shards=1,
                bf16_residual=bool(g("ce_bf16_residual", False)),
            )
        logits = quant_linear(x, model.lm_head.weight, model.cfg.dtype,
                              model.cfg.quantized_matmul).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    def _pipeline_loss(
        self, model: TransformerLM, inputs: torch.Tensor, targets: torch.Tensor, fused: bool
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss through the schedule, its backward run with grad on
        (the class docstring); a loss that carries no graph."""
        from determined_tpu_torch.parallel.pipeline import pipeline_apply

        cfg = model.cfg
        m = self._pipe_microbatches(self.context.get_global_batch_size())
        schedule, vstages = self._pipe_schedule()
        b, s = inputs.shape
        if model.embed is not None:
            x = model.embed.weight[inputs].to(cfg.dtype)
        else:  # only the shape and dtype reach the pipe
            x = torch.empty((b, s, cfg.d_model), dtype=cfg.dtype, device=inputs.device)
        remat = cfg.remat and torch.is_grad_enabled()

        def stage_fn(blocks: List[nn.Module], h: torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for blk in blocks:
                # remat: keep only each block's input; the backward reruns it
                h, a = checkpoint(blk, h, use_reentrant=False) if remat else blk(h)
                if a is not None:
                    aux = aux + a
            return h, aux

        mb = b // m  # pipeline_apply raises first where m does not divide b

        def loss_fn(y: torch.Tensor, k: int) -> torch.Tensor:
            return self._head_loss(model, y, targets[k * mb:(k + 1) * mb], fused) / m

        moe = cfg.moe_experts > 0
        loss, aux = pipeline_apply(
            stage_fn, model.stage_chunks(), x, model.pipe, m, with_aux=True,
            schedule=schedule, virtual_stages=vstages, loss_fn=loss_fn,
            aux_weight=cfg.moe_aux_weight if moe else 0.0,
            on_backward=model.pipe_backward_hook,
        )
        metrics = {"perplexity": torch.exp(loss)}
        if moe:
            metrics["moe_aux_loss"] = aux
            loss = loss + cfg.moe_aux_weight * aux
        return loss, metrics

    def evaluate_batch(
        self, model: TransformerLM, batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        loss, metrics = self.loss(model, batch)
        return {"validation_loss": loss, "validation_perplexity": metrics["perplexity"]}
