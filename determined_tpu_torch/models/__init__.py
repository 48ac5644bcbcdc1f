"""Models of the port."""

from determined_tpu_torch.models.mnist import MnistCNN, MnistMLP, MnistTrial
from determined_tpu_torch.models.transformer import (
    LMTrial,
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
    kv_cache_shape,
    transformer_decode,
    transformer_prefill,
    transformer_prefill_suffix,
)

__all__ = [
    "LMTrial",
    "MnistCNN",
    "MnistMLP",
    "MnistTrial",
    "TransformerConfig",
    "TransformerLM",
    "init_kv_cache",
    "kv_cache_shape",
    "transformer_decode",
    "transformer_prefill",
    "transformer_prefill_suffix",
]
