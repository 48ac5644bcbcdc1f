"""Deterministic index pipeline: shuffle -> shard -> batch -> skip.

Reference: ``harness/determined/pytorch/samplers.py`` (DistributedSampler,
SkipBatchSampler, ReproducibleShuffleSampler) and the ordering contract
documented there: **shuffle first, then shard, then batch, then skip** so a
resumed trial sees exactly the batches it would have seen uninterrupted.

A copy of ``determined_tpu/data/_sampler.py``: batches are always full
(drop_last), and sharding is by data-parallel process (one shard per
process; a single process is shard 0 of 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SamplerState:
    """Resume state: epoch + batches already consumed in that epoch."""

    epoch: int = 0
    batches_in_epoch: int = 0


class IndexSampler:
    """Yields per-epoch lists of global indices for THIS shard, batched."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        *,
        shard_rank: int = 0,
        num_shards: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        blocks: int = 1,
    ) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if batch_size % num_shards:
            raise ValueError(
                f"global batch size {batch_size} not divisible by {num_shards} shards"
            )
        if batch_size % (num_shards * blocks):
            # the Trainer reads whole microbatches (one shard) where they do
            # not split over the batch shards, as JAX's pipeline replicates them
            raise ValueError(
                f"global batch size {batch_size} not divisible into {blocks} microbatches "
                f"of {num_shards} shards"
            )
        if not (0 <= shard_rank < num_shards):
            raise ValueError(f"shard_rank {shard_rank} not in [0, {num_shards})")
        self.dataset_len = dataset_len
        self.global_batch = batch_size
        self.shard_batch = batch_size // num_shards
        self.shard_rank = shard_rank
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        # a pipeline's microbatches: the shard takes its part of each of
        # ``blocks`` contiguous blocks of the global batch
        self.blocks = blocks
        # full global batches per epoch (drop_last over the global stream)
        self.batches_per_epoch = dataset_len // batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {dataset_len} records smaller than one global batch "
                f"({batch_size})"
            )

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Global index order for one epoch (same on every shard)."""
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            return rng.permutation(self.dataset_len)
        return np.arange(self.dataset_len)

    def epoch_batches(self, epoch: int) -> np.ndarray:
        """[batches_per_epoch, shard_batch] index array for this shard.

        Shuffle -> batch -> shard: batch b covers global slice
        [b*B, (b+1)*B); this shard takes its contiguous sub-slice, or with
        ``blocks`` its contiguous sub-slice of each of the batch's
        ``blocks`` contiguous blocks, in block order.
        """
        order = self.epoch_indices(epoch)
        usable = order[: self.batches_per_epoch * self.global_batch]
        batches = usable.reshape(self.batches_per_epoch, self.blocks, self.num_shards,
                                 self.shard_batch // self.blocks)
        return batches[:, :, self.shard_rank, :].reshape(self.batches_per_epoch, -1)

    def iter_from(self, state: SamplerState) -> Iterator[tuple]:
        """Infinite stream of (SamplerState, shard_indices) from a resume
        point; the state yielded is the position *after* the batch."""
        epoch, skip = state.epoch, state.batches_in_epoch
        while True:
            batches = self.epoch_batches(epoch)
            for b in range(skip, self.batches_per_epoch):
                yield SamplerState(epoch, b + 1), batches[b]
            epoch, skip = epoch + 1, 0
