"""Online serving tier of the port: continuous batching over a paged KV cache.

Port of ``determined_tpu/serve``: a ``ServeWorker`` runs a ``ServeEngine``
(continuous batching over the decoder-only transformer's paged KV-cache
path, ``models/transformer.py``) behind ``POST /v1/generate``, ``/healthz``
and ``/stats``.  Registration with the master (``serve/replica.py`` in the
JAX package) comes with a later slice of the port.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from determined_tpu_torch.serve.config import ServeConfig
from determined_tpu_torch.serve.engine import (
    DecodeKernels,
    ServeEngine,
    StaticBatchEngine,
    sample_token,
)
from determined_tpu_torch.serve.http import ServeHTTPServer
from determined_tpu_torch.serve.kv_cache import (
    BlockAllocator,
    CacheOOM,
    prefix_block_hashes,
)
from determined_tpu_torch.serve.scheduler import (
    AdmissionQueue,
    AdmissionRejected,
    GenRequest,
    LaneTable,
)

logger = logging.getLogger("determined_tpu_torch.serve")

__all__ = [
    "AdmissionQueue",
    "AdmissionRejected",
    "BlockAllocator",
    "CacheOOM",
    "DecodeKernels",
    "GenRequest",
    "LaneTable",
    "ServeConfig",
    "prefix_block_hashes",
    "ServeEngine",
    "ServeHTTPServer",
    "ServeWorker",
    "StaticBatchEngine",
    "sample_token",
]


class ServeWorker:
    """One serving replica: engine + HTTP server."""

    def __init__(
        self, engine: ServeEngine, *, host: str = "127.0.0.1", port: int = 0
    ) -> None:
        self.engine = engine
        self.http = ServeHTTPServer(engine, host=host, port=port)

    def start(self) -> str:
        """Start the engine and HTTP; returns the URL the replica serves on."""
        self.engine.start()
        self.http.start()
        logger.info("serving replica up at %s", self.http.url)
        return self.http.url

    def request_drain(self) -> None:
        """Close admission: /healthz flips to draining, new generations
        get 503, queued + in-flight requests run to completion."""
        self.http.start_drain()
        self.engine.queue.start_drain()
        self.engine._wake.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine finished its queued + in-flight work."""
        return self.engine.drain(timeout=timeout)

    def shutdown(self) -> None:
        self.engine.stop()
        self.http.stop()

    def stats(self) -> Dict[str, Any]:
        out = self.engine.stats()
        out["url"] = self.http.url if self.http.running else None
        return out
