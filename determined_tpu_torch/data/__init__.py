"""Input pipeline of the port: datasets, the resumable sampler and loader,
and the overlapped prefetch feed (copies of ``determined_tpu/data``, with
``to_device`` in place of ``to_global``)."""

from determined_tpu_torch.data._dataset import (
    Dataset,
    InMemoryDataset,
    SyntheticDataset,
    cifar_like,
    mnist_like,
)
from determined_tpu_torch.data._loader import DataLoader, to_device
from determined_tpu_torch.data._prefetch import (
    EpochFeed,
    InputPipeline,
    PrefetchingIterator,
    device_prefetch,
)
from determined_tpu_torch.data._sampler import IndexSampler, SamplerState

__all__ = [
    "DataLoader",
    "Dataset",
    "EpochFeed",
    "IndexSampler",
    "InMemoryDataset",
    "InputPipeline",
    "PrefetchingIterator",
    "SamplerState",
    "SyntheticDataset",
    "cifar_like",
    "device_prefetch",
    "mnist_like",
    "to_device",
]
