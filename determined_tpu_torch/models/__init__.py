"""Models of the port."""

from determined_tpu_torch.models.diffusion import (
    DiffusionTrial,
    UNet,
    cosine_schedule,
    ddpm_sample,
    timestep_embedding,
)
from determined_tpu_torch.models.hf_bert import (
    BertClassifyTrial,
    BertConfig,
    BertForSequenceClassification,
    synthetic_classification,
)
from determined_tpu_torch.models.hf_gpt2 import (
    GPT2Config,
    GPT2FinetuneTrial,
    GPT2LMHeadModel,
    synthetic_lm,
)
from determined_tpu_torch.models.mnist import MnistCNN, MnistMLP, MnistTrial
from determined_tpu_torch.models.resnet import CifarTrial, ResidualBlock, ResNet
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
    "BertClassifyTrial",
    "BertConfig",
    "BertForSequenceClassification",
    "CifarTrial",
    "DiffusionTrial",
    "GPT2Config",
    "GPT2FinetuneTrial",
    "GPT2LMHeadModel",
    "LMTrial",
    "MnistCNN",
    "MnistMLP",
    "MnistTrial",
    "ResNet",
    "ResidualBlock",
    "TransformerConfig",
    "TransformerLM",
    "UNet",
    "cosine_schedule",
    "ddpm_sample",
    "init_kv_cache",
    "kv_cache_shape",
    "synthetic_classification",
    "synthetic_lm",
    "timestep_embedding",
    "transformer_decode",
    "transformer_prefill",
    "transformer_prefill_suffix",
]
