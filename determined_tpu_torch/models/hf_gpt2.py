"""HuggingFace GPT-2 causal-LM fine-tuning trial (``examples/hf_gpt2``).

Port of ``determined_tpu/models/hf_gpt2.py``.  The JAX trial wraps
transformers' ``FlaxGPT2LMHeadModel``; the card's machine has neither
``transformers`` nor ``flax``, so the port has its own ``GPT2LMHeadModel``
under the parameter names of transformers' torch class
(``transformer.wte``, ``wpe``, ``h.{i}.ln_1``, ``attn.c_attn``,
``attn.c_proj``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``, ``ln_f``), which
computes what the flax module computes:

- the embeddings' sum, then pre-LayerNorm blocks (epsilon
  ``layer_norm_epsilon``), then ``ln_f``; ``Conv1D`` computes ``x @ W + b``
  with W (in, out);
- causal attention whose masked scores get ``finfo(f32).min`` added (not
  ``-inf``) and an f32 softmax, as an explicit matmul, softmax and dropout
  (the JAX path runs no Pallas kernel there, and the flash kernel has no
  dropout of the probabilities);
- ``gelu_new`` (tanh GELU) in an MLP of width 4 x ``n_embd`` (the JAX
  trial's ``n_inner``);
- the head tied to ``wte``: one leaf, as in flax (the JAX trial's config
  keeps transformers' ``tie_word_embeddings`` True).

Dropout: embedding, residual and MLP dropouts are elementwise, the
attention probabilities' mask is one ``[q, k]`` mask a layer shared by
batch and heads (``_hf_common``), all drawn from the ``rng`` generator
passed to ``forward`` (none: deterministic).  The random init follows
flax's: ``wte``/``wpe`` normal(``initializer_range``), every ``Conv1D``
kernel normal(0.02) (``FlaxConv1D``'s fixed init), zero biases, LayerNorm
one and zero; the values come from torch's generator.  Parameters and
compute are f32, as in the JAX trial.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.data import InMemoryDataset
from determined_tpu_torch.models._hf_common import (
    ACTIVATIONS,
    HFFinetuneTrial,
    dot_product_attention,
    dropout,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """The fields of transformers' ``GPT2Config`` the model reads, with its
    defaults."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    activation_function: str = "gelu_new"
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

    def __post_init__(self) -> None:
        if self.activation_function not in ACTIVATIONS:
            raise ValueError(f"activation_function {self.activation_function!r} is not one of "
                             f"{sorted(ACTIVATIONS)}")
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is no multiple of n_head {self.n_head}")


class Conv1D(nn.Module):
    """transformers' GPT-2 ``Conv1D``: ``x @ weight + bias``, weight (in, out)."""

    def __init__(self, n_in: int, n_out: int, *, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight) + self.bias


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.c_attn = Conv1D(cfg.n_embd, 3 * cfg.n_embd, device=device)
        self.c_proj = Conv1D(cfg.n_embd, cfg.n_embd, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rng) -> torch.Tensor:
        b, s, d = x.shape
        heads = self.cfg.n_head
        q, k, v = (t.view(b, s, heads, d // heads).transpose(1, 2)
                   for t in self.c_attn(x).split(d, dim=2))
        y = dot_product_attention(q, k, v, bias, self.cfg.attn_pdrop, rng)
        y = self.c_proj(y.transpose(1, 2).reshape(b, s, d))
        return dropout(y, self.cfg.resid_pdrop, rng)


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.c_fc = Conv1D(cfg.n_embd, 4 * cfg.n_embd, device=device)
        self.c_proj = Conv1D(4 * cfg.n_embd, cfg.n_embd, device=device)

    def forward(self, x: torch.Tensor, rng) -> torch.Tensor:
        h = self.c_proj(ACTIVATIONS[self.cfg.activation_function](self.c_fc(x)))
        return dropout(h, self.cfg.resid_pdrop, rng)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None) -> None:
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)
        self.attn = GPT2Attention(cfg, device=device)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)
        self.mlp = GPT2MLP(cfg, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rng) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias, rng)
        return x + self.mlp(self.ln_2(x), rng)


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device=device) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)

    def forward(self, input_ids: torch.Tensor, rng) -> torch.Tensor:
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = dropout(self.wte(input_ids) + self.wpe(pos), self.cfg.embd_pdrop, rng)
        # flax's causal mask as a bias: 0 where a query sees the key,
        # finfo(f32).min above the diagonal
        bias = torch.full((s, s), torch.finfo(torch.float32).min, device=x.device).triu(1)
        for block in self.h:
            x = block(x, bias, rng)
        return self.ln_f(x)


class GPT2LMHeadModel(nn.Module):
    """``forward(input_ids, rng=None)``: f32 logits ``[b, s, vocab]`` from
    the head tied to ``wte``; dropout draws from ``rng`` when one is given (flax's
    ``deterministic=False``), none without."""

    base_model_prefix = "transformer"

    def __init__(
        self,
        cfg: GPT2Config,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.transformer = GPT2Model(cfg, device=dev)
        self._init(generator or torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if name.endswith(("wte.weight", "wpe.weight")):
                p.normal_(0.0, std, generator=gen)
            elif p.ndim == 2:  # Conv1D kernels
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith(".weight"):  # LayerNorm scales
                p.fill_(1.0)
            else:  # biases, LayerNorm shifts
                p.zero_()

    def forward(self, input_ids: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return F.linear(self.transformer(input_ids, rng), self.transformer.wte.weight)


def synthetic_lm(size: int, seq_len: int, vocab: int, seed: int) -> InMemoryDataset:
    """Markov-chain token streams: each token strongly conditions the next
    (one dominant successor per token, from a FIXED permutation shared by
    train/val), so causal-LM loss has real structure to learn and falls
    well below the uniform-vocabulary entropy."""
    fixed = np.random.default_rng(1234)
    successor = fixed.permutation(vocab).astype(np.int32)
    rng = np.random.default_rng(seed)
    ids = np.empty((size, seq_len), np.int32)
    ids[:, 0] = rng.integers(0, vocab, size)
    follow = rng.random((size, seq_len)) < 0.85
    noise = rng.integers(0, vocab, (size, seq_len)).astype(np.int32)
    for t in range(1, seq_len):
        ids[:, t] = np.where(follow[:, t], successor[ids[:, t - 1]], noise[:, t])
    return InMemoryDataset({"input_ids": ids})


def lm_loss(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The causal shift: predict token t+1 from the prefix up to t; the mean
    cross-entropy over the full vocabulary."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), ids[:, 1:].reshape(-1).long())


class GPT2FinetuneTrial(HFFinetuneTrial):
    """hparams: lr, global_batch_size, seq_len, vocab_size, hidden_size,
    num_layers, num_heads, dataset_size, warmup_steps, decay_steps,
    fused_adamw, pretrained_dir."""

    default_lr = 1e-3

    def config(self) -> GPT2Config:
        return GPT2Config(
            vocab_size=int(self._hp("vocab_size", 512)),
            n_positions=max(int(self._hp("seq_len", 64)), 64),
            n_embd=int(self._hp("hidden_size", 128)),
            n_layer=int(self._hp("num_layers", 2)),
            n_head=int(self._hp("num_heads", 4)),
        )

    def build_model(self) -> GPT2LMHeadModel:
        from determined_tpu_torch.convert import gpt2_state_dict_from_flax

        model = GPT2LMHeadModel(self.config(), device=self.context.device,
                                generator=self.context.generator())
        return self._load(model, gpt2_state_dict_from_flax)

    def _dataset(self, train: bool) -> InMemoryDataset:
        return synthetic_lm(
            size=int(self._hp("dataset_size", 1024)),
            seq_len=int(self._hp("seq_len", 64)),
            vocab=int(self._hp("vocab_size", 512)),
            seed=0 if train else 1,
        )

    def loss(
        self, model: GPT2LMHeadModel, batch: Dict[str, torch.Tensor], rng: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss = lm_loss(model(batch["input_ids"], rng), batch["input_ids"])
        return loss, {"perplexity": torch.exp(loss)}

    def evaluate_batch(self, model: GPT2LMHeadModel, batch: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
        loss = lm_loss(model(batch["input_ids"]), batch["input_ids"])
        return {"validation_loss": loss, "validation_perplexity": torch.exp(loss)}
