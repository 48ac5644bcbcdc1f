"""HuggingFace BERT sequence-classification trial (``examples/hf_bert``).

Port of ``determined_tpu/models/hf_bert.py``.  The JAX trial wraps
transformers' ``FlaxBertForSequenceClassification``; the port has its own
``BertForSequenceClassification`` under the parameter names of
transformers' torch class (``bert.embeddings.{word, position,
token_type}_embeddings``, ``bert.embeddings.LayerNorm``,
``bert.encoder.layer.{i}.attention.self.{query, key, value}``,
``attention.output.{dense, LayerNorm}``, ``intermediate.dense``,
``output.{dense, LayerNorm}``, ``bert.pooler.dense``, ``classifier``),
which computes what the flax module computes with the JAX trial's inputs
(every position attended, token type 0, positions 0..s-1):

- word + token-type + position embeddings, LayerNorm (``layer_norm_eps``
  1e-12), dropout;
- post-LayerNorm encoder layers: self-attention (an explicit matmul, f32
  softmax and dropout: the JAX path runs no Pallas kernel there), then
  ``dense``, dropout, LayerNorm of the sum with the input; ``intermediate``
  with erf GELU (``hidden_act`` ``gelu``), ``output.dense``, dropout,
  LayerNorm of the sum;
- the pooler (dense + tanh on token 0), dropout (``classifier_dropout``,
  or ``hidden_dropout_prob`` when None), the classifier.

Dropout as in ``models/hf_gpt2.py``: elementwise, but one ``[q, k]`` mask a
layer for the attention probabilities, shared by batch and heads; drawn
from the ``rng`` generator passed to ``forward``.  The random init follows
flax's: embeddings and every encoder and pooler kernel
normal(``initializer_range``), the classifier's flax default
(``lecun_normal``, truncated), zero biases, LayerNorm one and zero; the
values come from torch's generator.  Parameters and compute are f32.
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
    lecun_normal_,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The fields of transformers' ``BertConfig`` the model reads, with its
    defaults (``num_labels`` 2, as ``PretrainedConfig`` has it)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    classifier_dropout: Optional[float] = None
    num_labels: int = 2

    def __post_init__(self) -> None:
        if self.hidden_act not in ACTIVATIONS:
            raise ValueError(f"hidden_act {self.hidden_act!r} is not one of "
                             f"{sorted(ACTIVATIONS)}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is no multiple of "
                             f"num_attention_heads {self.num_attention_heads}")


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d, device=device)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)

    def forward(self, input_ids: torch.Tensor, rng) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        # token type 0 everywhere, as the JAX trial passes zeros
        x = self.word_embeddings(input_ids) + self.token_type_embeddings.weight[0] \
            + self.position_embeddings(pos)
        return dropout(self.LayerNorm(x), self.cfg.hidden_dropout_prob, rng)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor, rng) -> torch.Tensor:
        b, s, d = x.shape
        heads = self.cfg.num_attention_heads
        q, k, v = (lin(x).view(b, s, heads, d // heads).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        # every position attended: flax's bias is all zeros
        y = dot_product_attention(q, k, v, None, self.cfg.attention_probs_dropout_prob, rng)
        return y.transpose(1, 2).reshape(b, s, d)


class BertAddNorm(nn.Module):
    """``dense``, dropout, then ``LayerNorm`` of the sum with the residual
    (transformers' ``BertSelfOutput`` and ``BertOutput``)."""

    def __init__(self, n_in: int, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(n_in, cfg.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, rng) -> torch.Tensor:
        return self.LayerNorm(dropout(self.dense(x), self.cfg.hidden_dropout_prob, rng)
                              + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.self = BertSelfAttention(cfg, device=device)
        self.output = BertAddNorm(cfg.hidden_size, cfg, device=device)

    def forward(self, x: torch.Tensor, rng) -> torch.Tensor:
        return self.output(self.self(x, rng), x, rng)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.attention = BertAttention(cfg, device=device)
        self.intermediate = BertIntermediate(cfg, device=device)
        self.output = BertAddNorm(cfg.intermediate_size, cfg, device=device)

    def forward(self, x: torch.Tensor, rng) -> torch.Tensor:
        a = self.attention(x, rng)
        return self.output(self.intermediate(a), a, rng)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, device=device)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, rng) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, rng)
        return x


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None) -> None:
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.encoder = BertEncoder(cfg, device=device)
        self.pooler = BertPooler(cfg, device=device)

    def forward(self, input_ids: torch.Tensor, rng) -> torch.Tensor:
        """The pooled output ``[b, hidden]``."""
        return self.pooler(self.encoder(self.embeddings(input_ids, rng), rng))


class BertForSequenceClassification(nn.Module):
    """``forward(input_ids, rng=None)``: f32 logits ``[b, num_labels]``;
    dropout draws from ``rng`` when one is given, none without."""

    base_model_prefix = "bert"

    def __init__(
        self,
        cfg: BertConfig,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=dev)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels, device=dev)
        self._init(generator or torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name == "classifier.weight":
                lecun_normal_(p, gen)
            elif p.ndim == 2:  # embeddings and the encoder's and pooler's kernels
                p.normal_(0.0, self.cfg.initializer_range, generator=gen)
            elif name.endswith("LayerNorm.weight"):
                p.fill_(1.0)
            else:  # biases, LayerNorm shifts
                p.zero_()

    def forward(self, input_ids: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        rate = self.cfg.classifier_dropout
        rate = self.cfg.hidden_dropout_prob if rate is None else rate
        return self.classifier(dropout(self.bert(input_ids, rng), rate, rng))


def synthetic_classification(
    size: int, seq_len: int, vocab: int, num_labels: int, seed: int
) -> InMemoryDataset:
    """Label = which label-specific marker token dominates the sequence."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_labels, size).astype(np.int32)
    ids = rng.integers(num_labels + 1, vocab, (size, seq_len)).astype(np.int32)
    # plant marker tokens (token id == label + 1) in ~25% of positions
    mask = rng.random((size, seq_len)) < 0.25
    ids[mask] = (labels[:, None] + 1).repeat(seq_len, 1)[mask]
    return InMemoryDataset({"input_ids": ids, "label": labels})


def _loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    return loss, (logits.argmax(-1) == labels).float().mean()


class BertClassifyTrial(HFFinetuneTrial):
    """hparams: lr, global_batch_size, seq_len, vocab_size, hidden_size,
    num_layers, num_heads, num_labels, dataset_size, warmup_steps,
    decay_steps, fused_adamw, pretrained_dir."""

    default_lr = 5e-4

    def config(self) -> BertConfig:
        h = int(self._hp("hidden_size", 128))
        return BertConfig(
            vocab_size=int(self._hp("vocab_size", 1024)),
            hidden_size=h,
            num_hidden_layers=int(self._hp("num_layers", 2)),
            num_attention_heads=int(self._hp("num_heads", 4)),
            intermediate_size=4 * h,
            max_position_embeddings=max(int(self._hp("seq_len", 64)), 64),
            num_labels=int(self._hp("num_labels", 4)),
        )

    def build_model(self) -> BertForSequenceClassification:
        from determined_tpu_torch.convert import bert_state_dict_from_flax

        model = BertForSequenceClassification(self.config(), device=self.context.device,
                                              generator=self.context.generator())
        return self._load(model, bert_state_dict_from_flax)

    def _dataset(self, train: bool) -> InMemoryDataset:
        return synthetic_classification(
            size=int(self._hp("dataset_size", 1024)),
            seq_len=int(self._hp("seq_len", 64)),
            vocab=int(self._hp("vocab_size", 1024)),
            num_labels=int(self._hp("num_labels", 4)),
            seed=0 if train else 1,
        )

    def loss(
        self, model: BertForSequenceClassification, batch: Dict[str, torch.Tensor],
        rng: torch.Generator,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss, acc = _loss_and_accuracy(model(batch["input_ids"], rng), batch["label"])
        return loss, {"accuracy": acc}

    def evaluate_batch(self, model: BertForSequenceClassification, batch: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
        loss, acc = _loss_and_accuracy(model(batch["input_ids"]), batch["label"])
        return {"validation_loss": loss, "validation_accuracy": acc}
