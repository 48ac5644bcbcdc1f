"""DataLoader: deterministic, shard-aware, resumable batch stream.

Port of ``determined_tpu/data/_loader.py``: the same state dict, resume
rules, ``iter_pairs``/``commit_state`` contract and ``iter_epoch`` pass, over
host batches of numpy arrays.  One process feeds the whole batch
(``shard_rank=0``, ``num_shards=1`` by default); ``to_device`` takes the
place of ``to_global`` and copies a host batch to a torch device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from determined_tpu_torch.data._dataset import Dataset, InMemoryDataset
from determined_tpu_torch.data._sampler import IndexSampler, SamplerState


def _fetch(dataset: Dataset, indices: np.ndarray) -> Dict[str, np.ndarray]:
    if isinstance(dataset, InMemoryDataset):
        return dataset.gather(indices)
    # map-style dataset: one item at a time, stacked per key
    items = [dataset[int(i)] for i in indices]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DataLoader:
    """Deterministic batch stream over a map-style Dataset."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        shard_rank: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.dataset = dataset
        self.sampler = IndexSampler(
            len(dataset),
            batch_size,
            shard_rank=shard_rank,
            num_shards=num_shards,
            shuffle=shuffle,
            seed=seed,
        )
        self._state = SamplerState()

    # -- resume state ------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self._state.epoch,
            "batches_in_epoch": self._state.batches_in_epoch,
            "global_batch": self.sampler.global_batch,
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        epoch = int(state["epoch"])
        batches = int(state["batches_in_epoch"])
        stored_gb = int(state.get("global_batch", self.sampler.global_batch))
        if stored_gb != self.sampler.global_batch:
            # re-express the consumed position in new-global-batch units,
            # rounding down: a partly covered batch is trained again rather
            # than skipped
            consumed = batches * stored_gb
            batches = consumed // self.sampler.global_batch
            batches = min(batches, self.sampler.batches_per_epoch)
        self._state = SamplerState(epoch, batches)

    @property
    def batches_per_epoch(self) -> int:
        return self.sampler.batches_per_epoch

    @property
    def epoch(self) -> int:
        return self._state.epoch

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of host batches, advancing resume state."""
        for state, idx in self.sampler.iter_from(self._state):
            batch = _fetch(self.dataset, idx)
            self._state = state
            yield batch

    def iter_pairs(self) -> Iterator[Tuple[SamplerState, Dict[str, np.ndarray]]]:
        """Infinite ``(state_after, batch)`` stream; does NOT advance the
        loader's resume state: the consumer commits with ``commit_state``
        when it takes the batch (``data/_prefetch.py``)."""
        for state, idx in self.sampler.iter_from(self._state):
            yield state, _fetch(self.dataset, idx)

    def commit_state(self, state: SamplerState) -> None:
        """Record that the consumer has taken every batch up to ``state``."""
        self._state = state

    def iter_epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One full pass (e.g. a validation sweep); resume state untouched."""
        batches = self.sampler.epoch_batches(epoch)
        for b in range(self.sampler.batches_per_epoch):
            yield _fetch(self.dataset, batches[b])


def to_device(
    batch: Dict[str, np.ndarray], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Synchronous copy of a host batch to ``device`` (the prefetch
    pipeline's ``device_prefetch`` is the overlapped form)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
