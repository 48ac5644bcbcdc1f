"""Batch inference over a sharded dataset with checkpointed progress.

Port of ``determined_tpu/inference.py``: each worker processes its dataset
shard batch by batch; the processor's ``process_batch`` gets host numpy
batches from this process's shard (model calls inside it are ordinary
PyTorch calls on the device the processor chose), and progress and
preemption run through the same core contexts as training
(``core._dummy_init()`` off-cluster).

Usage::

    class Scorer(inference.BatchProcessor):
        def setup(self):
            _, trainer = train.load_trial_from_checkpoint(path)
            self.model = trainer.model.eval()
        def process_batch(self, batch, batch_idx):
            with torch.no_grad():
                out = self.model(torch.from_numpy(batch["tokens"]).cuda())
            torch.save(out.cpu(), f"part-{batch_idx}.pt")

    inference.run_batch_inference(Scorer, dataset, batch_size=8)
"""

from __future__ import annotations

import abc
import json
import logging
import os
from typing import Any, Dict, Optional, Type

import numpy as np

from determined_tpu_torch.data._loader import DataLoader, _fetch

logger = logging.getLogger("determined_tpu_torch.inference")

PROGRESS_FILE = "inference_progress.json"


class BatchProcessor(abc.ABC):
    """User hook object; one instance per worker process."""

    def __init__(self, core_context: Any, rank: int, size: int) -> None:
        self.core = core_context
        self.rank = rank
        self.size = size
        self.setup()

    def setup(self) -> None:
        """Build models/outputs; runs once before the first batch."""

    @abc.abstractmethod
    def process_batch(self, batch: Dict[str, np.ndarray], batch_idx: int) -> None:
        """Handle one host batch from this worker's shard."""

    def on_finish(self) -> None:
        """Runs after the shard is exhausted."""


def run_batch_inference(
    processor_cls: Type[BatchProcessor],
    dataset: Any,
    batch_size: int,
    core_context: Optional[Any] = None,
    checkpoint_interval: int = 50,
) -> int:
    """Process the dataset once; returns batches processed by this worker.

    - the dataset shards over the job's processes (the training sampler,
      unshuffled);
    - every ``checkpoint_interval`` batches the chief records progress as a
      checkpoint (``inference_progress.json``) and the preemption flag is
      polled: a preempted run resumes from the recorded batch index;
    - the run resumes from the core context's ``info.latest_checkpoint``
      when it has one.
    """
    from determined_tpu_torch import core as core_mod

    ctx = core_context or core_mod._dummy_init()
    dist = ctx.distributed
    loader = DataLoader(
        dataset, batch_size, shuffle=False, num_shards=dist.size, shard_rank=dist.rank
    )

    start_batch = 0
    info = getattr(ctx, "info", None)
    latest = getattr(info, "latest_checkpoint", None) if info else None
    if latest:
        with ctx.checkpoint.restore_path(latest) as path:
            marker = os.path.join(path, PROGRESS_FILE)
            if os.path.exists(marker):
                with open(marker) as f:
                    start_batch = int(json.load(f)["batches_done"])
        logger.info("resuming batch inference at batch %d", start_batch)

    proc = processor_cls(ctx, dist.rank, dist.size)
    done = 0
    batches = loader.sampler.epoch_batches(0)
    total = loader.sampler.batches_per_epoch
    for idx in range(start_batch, total):
        proc.process_batch(_fetch(dataset, batches[idx]), idx)
        done += 1
        if done % checkpoint_interval == 0:
            _record_progress(ctx, dist, idx + 1)
            if ctx.preempt.should_preempt():
                logger.info("preempted at batch %d; progress checkpointed", idx + 1)
                return done
    # Final marker BEFORE on_finish: progress was only recorded every
    # checkpoint_interval, so a worker preempted after its last batch but
    # before on_finish would replay the whole tail on resume.  Skipped when
    # the interval already recorded it or when this worker processed nothing.
    if done and done % checkpoint_interval != 0:
        _record_progress(ctx, dist, total)
    proc.on_finish()
    return done


def _record_progress(ctx: Any, dist: Any, batches_done: int) -> None:
    if dist.is_chief:
        with ctx.checkpoint.store_path({"batches_done": batches_done}) as (path, _sid):
            with open(os.path.join(path, PROGRESS_FILE), "w") as f:
                json.dump({"batches_done": batches_done}, f)
    if dist.size > 1:
        dist.barrier()
