"""Persistent kernel build cache wiring.

Port of ``determined_tpu/utils/compilation_cache.py``.  What the JAX package
compiles per process is its XLA executables; what the port compiles is its
CUDA kernels, each an ``nvcc`` build of a source under ``csrc/`` into a
shared library (``ops/_build.py``).  The libraries are keyed by a hash of
their source, the headers it includes and the compiler flags
(``_build.library_path``), so a directory of them is a cache that any later
process on the same machine can load from instead of running ``nvcc``: a
supervised restart, a new attempt after a crash, the next trial.

The directory comes from ``optimizations.compilation_cache_dir`` (the
experiment's declaration, authoritative) or the ``DTPU_COMPILATION_CACHE``
environment variable (operator-level fallback); it becomes ``_build``'s
library directory.  Unset, the libraries build under the package's own
``_build/``.  Setup is idempotent per process and builds nothing.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from determined_tpu_torch.ops import _build

logger = logging.getLogger("determined_tpu_torch.utils.compilation_cache")


def resolve_cache_dir(config_dir: Optional[str] = None) -> Optional[str]:
    return config_dir or os.environ.get("DTPU_COMPILATION_CACHE") or None


def setup_compilation_cache(config_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at the configured directory.

    Returns the active cache path (None when unconfigured).  Logs one
    warm/cold line so operators can tell from the task log whether a
    restart will load its kernels from disk.
    """
    active = None if _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR else _build.BUILD_DIR
    path = resolve_cache_dir(config_dir)
    if not path:
        return active
    path = os.path.abspath(path)
    if active == path:  # repeat init() calls must not re-log
        return path
    entries = _build.set_build_dir(path)
    if entries:
        logger.info(
            "compilation cache HIT candidate: %s is warm (%d entries); "
            "restart recompiles load from disk",
            path,
            entries,
        )
    else:
        logger.info(
            "compilation cache MISS: %s is cold (first run); compiles will "
            "populate it",
            path,
        )
    return path
