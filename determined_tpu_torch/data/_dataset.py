"""Dataset protocol + in-memory/synthetic datasets.

A copy of ``determined_tpu/data/_dataset.py`` (the port imports nothing of
the JAX package): map-style datasets whose items are **dicts of numpy
arrays**, so batches stack into host arrays that the loader copies to the
device.  ``SyntheticDataset``, ``mnist_like`` and ``cifar_like`` draw from
``np.random.default_rng(seed)`` exactly as the JAX package does, so both
packages see the same data for the same seed.  Batching always drops ragged
tails (``drop_last`` semantics).
"""

from __future__ import annotations

import gzip
import os
import struct
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


def mnist_like(
    size: int = 4096, image_key: str = "image", label_key: str = "label", seed: int = 0
) -> InMemoryDataset:
    """MNIST-shaped dataset. Loads the real IDX files if present locally
    (``$DTPU_MNIST_DIR`` or ``~/.cache/mnist``; nothing is downloaded), else
    a class-separable synthetic set so accuracy actually improves during
    tests.
    """
    for root in (os.environ.get("DTPU_MNIST_DIR", ""), os.path.expanduser("~/.cache/mnist")):
        if root and os.path.exists(os.path.join(root, "train-images-idx3-ubyte.gz")):
            # seed selects a disjoint slice so train (seed 0) and val
            # (seed 1) never overlap on real data either.
            return InMemoryDataset(
                _load_idx_mnist(root, size, image_key, label_key, offset=seed * size)
            )
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=size, dtype=np.int32)
    # Class-separable images: per-class template + noise.  Templates come
    # from a FIXED generator so train/val splits (different seeds) share the
    # same label->image mapping and accuracy is meaningful.
    templates = np.random.default_rng(1234).standard_normal((10, 28, 28)).astype(np.float32)
    images = templates[labels] + 0.3 * rng.standard_normal((size, 28, 28)).astype(np.float32)
    return InMemoryDataset({image_key: images[..., None], label_key: labels})


def cifar_like(size: int = 4096, num_classes: int = 10, seed: int = 0) -> InMemoryDataset:
    """Class-separable synthetic 32x32x3 dataset (the JAX package's
    ``determined_tpu/models/resnet.py`` ``cifar_like``; loads nothing): each
    class a low-frequency template, plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    templates = np.stack(
        [
            np.stack(
                [
                    np.sin((c + 1) * np.pi * xx),
                    np.cos((c + 2) * np.pi * yy),
                    np.sin((c + 1) * np.pi * (xx + yy)),
                ],
                axis=-1,
            )
            for c in range(num_classes)
        ]
    )
    images = templates[labels] + rng.normal(0, 0.4, (size, 32, 32, 3)).astype(np.float32)
    return InMemoryDataset({"image": images.astype(np.float32), "label": labels})


def _load_idx_mnist(
    root: str, size: int, image_key: str, label_key: str, offset: int = 0
) -> Dict[str, np.ndarray]:
    def read_idx(path: str) -> np.ndarray:
        with gzip.open(path, "rb") as f:
            magic, = struct.unpack(">H", f.read(4)[2:])
            ndim = magic & 0xFF
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    all_images = read_idx(os.path.join(root, "train-images-idx3-ubyte.gz"))
    all_labels = read_idx(os.path.join(root, "train-labels-idx1-ubyte.gz"))
    if offset + size > len(all_images):
        offset = max(0, len(all_images) - size)
    images = all_images[offset : offset + size]
    labels = all_labels[offset : offset + size]
    return {
        image_key: (images.astype(np.float32) / 255.0)[..., None],
        label_key: labels.astype(np.int32),
    }
