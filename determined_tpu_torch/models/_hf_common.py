"""Shared plumbing of the HuggingFace fine-tune trials (GPT-2, BERT).

Port of ``determined_tpu/models/_hf_common.py``.  The JAX package wraps
transformers' Flax classes in an ``HFModuleHolder``; the port has its own
``nn.Module``s under the parameter names of transformers' torch classes
(``models/hf_gpt2.py``, ``models/hf_bert.py``) and imports neither
``transformers`` nor ``flax``.  This module holds what both families share:

- ``load_pretrained``: the offline ``pretrained_dir`` contract.  A local
  Flax ``save_pretrained`` directory's ``flax_model.msgpack`` (read by
  ``_flax_msgpack.read_pretrained_dir``, no ``msgpack`` package) goes
  through the family's converter (``convert.py``) into the model in place
  of its random init.  ``config.json`` is not read: the config comes from
  the hparams, as the JAX holder passes ``config=config``.  As
  ``from_pretrained`` does, a base model's file (no ``transformer.`` /
  ``bert.`` prefix) loads into the head model, keys the file lacks keep the
  port's init, keys the model lacks are ignored, each set is logged, and a
  shape that differs raises.
- ``dropout`` and ``dot_product_attention``: flax's ``nn.Dropout`` (each
  element kept with 1 - rate, kept values scaled by 1 / keep) and
  ``dot_product_attention_weights`` with ``broadcast_dropout=True`` (the
  query divided by sqrt(head dim), the bias added, an f32 softmax, then ONE
  keep mask of shape [q, k] shared by every batch row and head).  Masks are
  drawn from the ``torch.Generator`` passed in (the Trainer's step
  generator), in forward order; ``rng=None`` is flax's
  ``deterministic=True``.
- ``HFFinetuneTrial``: the hparams, optimizer and loaders both JAX trials
  spell out: ``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
  decay_steps)`` into ``optax.adamw(schedule, weight_decay=0.01)``
  (``ClipAdamW`` with no clip) or, with ``fused_adamw: true``, the fused
  AdamW with ``clip_norm=None`` (the ``fused_adamw`` kernel on CUDA).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch.data import DataLoader, InMemoryDataset
from determined_tpu_torch.models._flax_msgpack import read_pretrained_dir
from determined_tpu_torch.train._trial import TorchTrial

logger = logging.getLogger(__name__)

StateDictFromFlax = Callable[[Mapping[str, Any]], Dict[str, np.ndarray]]

#: transformers' ``ACT2FN`` names the configs take: ``gelu`` is erf GELU,
#: ``gelu_new`` the tanh approximation (flax ``nn.gelu(approximate=True)``)
ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


@torch.no_grad()
def load_pretrained(
    model: nn.Module, pretrained_dir: str, to_state_dict: StateDictFromFlax, base_prefix: str
) -> Tuple[List[str], List[str]]:
    """Copy the weights of a Flax ``save_pretrained`` directory into
    ``model`` (on its device); returns (missing, unexpected) keys."""
    tree = read_pretrained_dir(pretrained_dir)
    if base_prefix not in tree:  # a base model's file into the head model
        tree = {base_prefix: tree}
    loaded = to_state_dict(tree)
    own = model.state_dict()
    name = type(model).__name__
    missing = sorted(k for k in own if k not in loaded)
    unexpected = sorted(k for k in loaded if k not in own)
    for k, v in loaded.items():
        if k in own and tuple(own[k].shape) != v.shape:
            raise ValueError(
                f"{k} is {v.shape} in {pretrained_dir} and {tuple(own[k].shape)} in {name}")
    for k, v in loaded.items():
        if k in own:
            own[k].copy_(torch.from_numpy(v))
    if unexpected:
        logger.warning("Some weights of the model checkpoint at %s were not used when "
                       "initializing %s: %s", pretrained_dir, name, unexpected)
    if missing:
        logger.warning("Some weights of %s were not initialized from the model checkpoint at "
                       "%s and are newly initialized: %s", name, pretrained_dir, missing)
    return missing, unexpected


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: each element kept with probability
    1 - rate and scaled by 1 / (1 - rate); no draw when ``rng`` is None or
    the rate is 0."""
    if rng is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    rate: float,
    rng: Optional[torch.Generator],
) -> torch.Tensor:
    """Attention of ``[b, h, s, hd]`` heads as flax computes it, with the
    probabilities' dropout broadcast over batch and heads; returns
    ``[b, h, s, hd]``."""
    w = torch.matmul(q / math.sqrt(q.shape[-1]), k.transpose(-1, -2))
    if bias is not None:
        w = w + bias
    w = torch.softmax(w, dim=-1)
    if rng is not None and rate > 0.0:
        keep_prob = 1.0 - rate
        keep = torch.rand(w.shape[-2:], generator=rng, device=w.device) < keep_prob
        w = w * (keep.to(w.dtype) / keep_prob)
    return torch.matmul(w, v)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default ``nn.Dense`` kernel init (``lecun_normal``: a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in)
    for a torch ``[out, in]`` weight."""
    std = weight.shape[1] ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class HFFinetuneTrial(TorchTrial):
    """What the GPT-2 and BERT trials share: ``_hp``, the optimizer and the
    loaders over ``_dataset(train)`` (seed 0 for training, 1 for
    validation)."""

    #: the family's default ``lr`` hparam
    default_lr = 1e-3

    def _hp(self, name: str, default: Any) -> Any:
        return self.context.get_hparam(name, default)

    def build_optimizer(self) -> Any:
        from determined_tpu_torch.ops.fused_adamw import fused_adamw
        from determined_tpu_torch.train._optim import ClipAdamW, warmup_cosine_decay_schedule

        lr = float(self._hp("lr", self.default_lr))
        schedule = warmup_cosine_decay_schedule(
            0.0, lr, int(self._hp("warmup_steps", 20)), int(self._hp("decay_steps", 2000)))
        if self._hp("fused_adamw", False):
            return fused_adamw(schedule, weight_decay=0.01, clip_norm=None)
        return ClipAdamW(schedule, clip_norm=None, weight_decay=0.01)

    def _dataset(self, train: bool) -> InMemoryDataset:
        raise NotImplementedError

    def build_training_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(True), self.context.get_global_batch_size(),
                          shuffle=True, seed=self.context.seed)

    def build_validation_data_loader(self) -> DataLoader:
        return DataLoader(self._dataset(False), self.context.get_global_batch_size(),
                          shuffle=False, seed=self.context.seed)

    def _load(self, model: nn.Module, to_state_dict: StateDictFromFlax) -> nn.Module:
        """``model`` with the ``pretrained_dir`` hparam's weights, when set."""
        pretrained = str(self._hp("pretrained_dir", ""))
        if pretrained:
            load_pretrained(model, pretrained, to_state_dict, model.base_model_prefix)
        return model
