"""DataLoader: deterministic, shard-aware, resumable batch stream.

Port of ``determined_tpu/data/_loader.py``: the same state dict, resume
rules, ``iter_pairs``/``commit_state`` contract (with microbatches stacked
for gradient accumulation), ``iter_epoch`` pass and ``fetch_workers`` thread
pool, over host batches of numpy arrays.  A loader feeds the whole batch
(``shard_rank=0``, ``num_shards=1`` by default) or, on a mesh, its rank's
slice of it (``shard``); ``to_device`` takes the place of ``to_global`` and
copies a host batch to a torch device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from determined_tpu_torch.data._dataset import Dataset, InMemoryDataset
from determined_tpu_torch.data._sampler import IndexSampler, SamplerState


def _fetch(
    dataset: Dataset, indices: np.ndarray, pool: Optional[Any] = None
) -> Dict[str, np.ndarray]:
    if isinstance(dataset, InMemoryDataset):
        return dataset.gather(indices)
    # map-style dataset: the per-item loop is the slow path (disk reads,
    # decode); a thread pool overlaps the item reads when the loader has a
    # `fetch_workers` budget
    idx = [int(i) for i in indices]
    if pool is not None:
        items = list(pool.map(dataset.__getitem__, idx))
    else:
        items = [dataset[i] for i in idx]
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
        fetch_workers: int = 0,
    ) -> None:
        self.dataset = dataset
        self.fetch_workers = fetch_workers
        self._pool: Optional[Any] = None
        self.sampler = IndexSampler(
            len(dataset),
            batch_size,
            shard_rank=shard_rank,
            num_shards=num_shards,
            shuffle=shuffle,
            seed=seed,
        )
        self._state = SamplerState()

    def shard(self, shard_rank: int, num_shards: int, blocks: int = 1) -> None:
        """Read shard ``shard_rank`` of ``num_shards`` of every global batch
        from now on (the Trainer's rank on a mesh), or with ``blocks`` its
        shard of each of that many contiguous blocks of the batch (a
        pipeline's microbatches); the global batch, the order and the
        resume state stay as they are."""
        s = self.sampler
        self.sampler = IndexSampler(
            s.dataset_len, s.global_batch, shard_rank=shard_rank, num_shards=num_shards,
            shuffle=s.shuffle, seed=s.seed, blocks=blocks,
        )

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

    def _fetch_pool(self) -> Optional[Any]:
        """Lazily built thread pool for the map-style fetch path.  Only
        non-InMemory datasets ever touch it (the columnar gather needs no
        threads), so construction waits for the first such fetch."""
        if self.fetch_workers > 0 and self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=int(self.fetch_workers), thread_name_prefix="dtpu-fetch"
            )
        return self._pool

    def _fetch_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        pool = None if isinstance(self.dataset, InMemoryDataset) else self._fetch_pool()
        return _fetch(self.dataset, idx, pool)

    def close(self) -> None:
        """Release the fetch pool (if one was built).  The loader stays
        usable: a later fetch builds it again."""
        if self._pool is not None:
            # cancel_futures: a preempted trial must not sit in the atexit
            # join while queued slow item reads of an abandoned batch drain
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of host batches, advancing resume state."""
        for state, idx in self.sampler.iter_from(self._state):
            batch = self._fetch_batch(idx)
            self._state = state
            yield batch

    def iter_pairs(self, agg: int = 1) -> Iterator[Tuple[SamplerState, Dict[str, np.ndarray]]]:
        """Infinite ``(state_after, batch)`` stream; does NOT advance the
        loader's resume state: the consumer commits with ``commit_state``
        when it takes the batch (``data/_prefetch.py``).

        ``agg`` > 1 groups that many microbatches into one stacked
        ``[agg, batch, ...]`` batch (gradient accumulation); the state is
        that after the LAST microbatch, so one optimizer step is one commit.
        """
        it = self.sampler.iter_from(self._state)
        if agg <= 1:
            for state, idx in it:
                yield state, self._fetch_batch(idx)
            return
        while True:
            micros = []
            for _ in range(agg):
                state, idx = next(it)
                micros.append(self._fetch_batch(idx))
            yield state, {k: np.stack([m[k] for m in micros]) for k in micros[0]}

    def commit_state(self, state: SamplerState) -> None:
        """Record that the consumer has taken every batch up to ``state``."""
        self._state = state

    def iter_epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One full pass (e.g. a validation sweep); resume state untouched."""
        batches = self.sampler.epoch_batches(epoch)
        for b in range(self.sampler.batches_per_epoch):
            yield self._fetch_batch(batches[b])


def to_device(
    batch: Dict[str, np.ndarray], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Synchronous copy of a host batch to ``device`` (the prefetch
    pipeline's ``device_prefetch`` is the overlapped form)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
