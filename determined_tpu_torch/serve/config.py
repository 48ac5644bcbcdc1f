"""ServeConfig: the sizing knobs of one serving replica.

A copy of ``determined_tpu/serve/config.py``.  Every shape the prefill and
decode steps run at comes from here: lane count, prompt padding and
block-table width.  ``docs/serving.md`` explains how to size the cache
(``num_blocks``) against device memory and expected sequence lengths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from determined_tpu_torch.serve.kv_cache import blocks_for_tokens


class InvalidExperimentConfig(ValueError):
    """A configuration value the port cannot run (the port's own copy of
    ``determined_tpu.config.experiment.InvalidExperimentConfig``)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    # ---- paged KV cache ---------------------------------------------------
    #: tokens per cache block (vLLM-style fixed-size pages)
    block_size: int = 16
    #: physical blocks in the pool; block 0 is the scratch block padded
    #: writes land in, so usable capacity is (num_blocks - 1) * block_size
    num_blocks: int = 256
    # ---- continuous batching ----------------------------------------------
    #: decode lanes: max sequences in flight per step (static batch shape)
    max_batch: int = 8
    #: prompts are padded to this length for the prefill step
    max_prompt_len: int = 128
    #: cap on tokens generated per request (requests may ask for fewer)
    max_new_tokens: int = 64
    # ---- admission --------------------------------------------------------
    #: bounded request queue depth; a full queue rejects with 429
    queue_depth: int = 16
    # ---- fast path --------------------------------------------------------
    #: share full KV blocks across requests with a common prompt prefix
    #: (content-addressed hash trie in the allocator); admission then only
    #: prefills the un-cached suffix.  Off restores the PR-9 data path.
    prefix_cache: bool = True
    #: lazy paged decode: gather the block table in chunks of this many
    #: columns per attention pass, running only ceil((pos+1)/chunk) passes
    #: instead of materializing the whole table every step.  0 = legacy
    #: full-table gather.  Must divide blocks_per_seq so every chunk is a
    #: full dynamic slice of the table.
    decode_chunk_blocks: int = 1
    # ---- http / replica ---------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 8001
    #: master heartbeat period (seconds) when registered
    heartbeat_interval_s: float = 2.0
    #: how long a SIGTERM drain waits for in-flight work before giving up
    drain_grace_s: float = 30.0

    def __post_init__(self) -> None:
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is scratch), got {self.num_blocks}"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError("max_prompt_len and max_new_tokens must be >= 1")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        needed = self.blocks_for(self.max_prompt_len + self.max_new_tokens)
        if needed > self.usable_blocks:
            raise ValueError(
                f"cache too small: a worst-case request needs {needed} blocks "
                f"but only {self.usable_blocks} are usable "
                "(raise num_blocks or lower max_prompt_len/max_new_tokens)"
            )
        if self.decode_chunk_blocks < 0:
            raise InvalidExperimentConfig(
                f"decode_chunk_blocks must be >= 0, got {self.decode_chunk_blocks}"
            )
        if self.decode_chunk_blocks and self.blocks_per_seq % self.decode_chunk_blocks:
            # the lazy decode slides a fixed-width window over the table;
            # a chunk that doesn't divide the pool would leave a ragged
            # final slice the fixed-width window can't express
            raise InvalidExperimentConfig(
                f"decode_chunk_blocks={self.decode_chunk_blocks} does not divide "
                f"the block-table width ({self.blocks_per_seq} blocks per "
                "sequence); pick a divisor or 0 for the full-table gather"
            )

    # -- derived sizes -------------------------------------------------------

    @property
    def max_seq_len(self) -> int:
        """Longest sequence a lane can hold (prompt + generated)."""
        return self.max_prompt_len + self.max_new_tokens

    @property
    def blocks_per_seq(self) -> int:
        """Block-table width: logical blocks a worst-case sequence spans."""
        return self.blocks_for(self.max_seq_len)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # scratch block 0 is never allocated

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.block_size)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "ServeConfig":
        raw = dict(raw or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown serve config keys: {sorted(unknown)}")
        return cls(**raw)
