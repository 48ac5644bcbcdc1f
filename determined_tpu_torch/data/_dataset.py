"""Dataset protocol + in-memory/synthetic datasets.

A copy of ``determined_tpu/data/_dataset.py`` (the port imports nothing of
the JAX package): map-style datasets whose items are **dicts of numpy
arrays**, so batches stack into host arrays that the loader copies to the
device.  ``SyntheticDataset`` draws from ``np.random.default_rng(seed)``
exactly as the JAX package does, so both packages see the same data for the
same seed.  Batching always drops ragged tails (``drop_last`` semantics).
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Dataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]: ...


class InMemoryDataset:
    """Columnar dict-of-arrays dataset; the fast input path (whole-batch
    gather by fancy indexing, no per-item loop)."""

    def __init__(self, columns: Dict[str, np.ndarray]) -> None:
        if not columns:
            raise ValueError("InMemoryDataset needs at least one column")
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"column lengths differ: {lengths}")
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self._len = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.columns.items()}

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized batch fetch — one fancy-index per column."""
        return {k: v[indices] for k, v in self.columns.items()}


class SyntheticDataset(InMemoryDataset):
    """Deterministic random dataset for tests/benchmarks (the analog of the
    reference's noop/onevar fixtures, ``harness/tests/experiment/fixtures/``)."""

    def __init__(
        self,
        spec: Dict[str, Any],
        size: int,
        seed: int = 0,
    ) -> None:
        """spec: name -> (shape, dtype) or (shape, dtype, num_classes) for ints."""
        rng = np.random.default_rng(seed)
        cols: Dict[str, np.ndarray] = {}
        for name, s in spec.items():
            shape = (size, *s[0])
            dtype = np.dtype(s[1])
            if np.issubdtype(dtype, np.integer):
                hi = s[2] if len(s) > 2 else 2
                cols[name] = rng.integers(0, hi, size=shape, dtype=dtype)
            else:
                cols[name] = rng.standard_normal(shape).astype(dtype)
        super().__init__(cols)
