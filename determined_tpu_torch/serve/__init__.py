"""Online serving tier of the port: continuous batching over a paged KV cache.

Port of ``determined_tpu/serve``: a ``ServeWorker`` runs a ``ServeEngine``
(continuous batching over the decoder-only transformer's paged KV-cache
path, ``models/transformer.py``) behind ``POST /v1/generate``, ``/healthz``
and ``/stats``.  With a session to the master the worker registers under
``/api/v1/serving`` (``replica.ReplicaRegistration``), heartbeats its
engine's stats, and drains when a rolling deploy asks it to through the
heartbeat's answer.
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
from determined_tpu_torch.serve.replica import ReplicaRegistration
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
    "ReplicaRegistration",
    "ServeConfig",
    "prefix_block_hashes",
    "ServeEngine",
    "ServeHTTPServer",
    "ServeWorker",
    "StaticBatchEngine",
    "sample_token",
]


class ServeWorker:
    """One serving replica: engine + HTTP server + optional registration.

    The CLI (``serve``) and ``exec/serve_replica`` build one of these;
    tests drive it in-process.  ``request_drain`` is idempotent and safe to
    call from the main thread after a signal flag flips (never call it FROM
    a signal handler — it touches Events; the CLI's ``serve`` polls a flag
    the handler sets instead).
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        session: Optional[Any] = None,
        model: str = "",
        checkpoint: str = "",
        model_name: str = "",
        model_version: int = 0,
        task_id: str = "",
    ) -> None:
        self.engine = engine
        self.http = ServeHTTPServer(engine, host=host, port=port)
        self._session = session
        self._model = model
        self._checkpoint = checkpoint
        self._model_name = model_name
        self._model_version = model_version
        self._task_id = task_id
        self.replica: Optional[ReplicaRegistration] = None
        # set from the heartbeat thread when the master asks this replica
        # to drain (rolling deploy); plain attribute writes so the serve
        # main loop can poll it next to its signal flag
        self._master_drain = False
        self.master_drain_info: Dict[str, Any] = {}

    def start(self) -> str:
        """Start engine + HTTP (+ master registration when a session was
        given); returns the URL the replica serves on."""
        self.engine.start()
        self.http.start()
        if self._session is not None:
            self.replica = ReplicaRegistration(
                self._session,
                url=self.http.url,
                model=self._model,
                checkpoint=self._checkpoint,
                model_name=self._model_name,
                model_version=self._model_version,
                task_id=self._task_id,
                heartbeat_interval_s=self.engine.cfg.heartbeat_interval_s,
                stats_fn=self.engine.stats,
                on_drain=self._on_master_drain,
            ).start()
        logger.info("serving replica up at %s", self.http.url)
        return self.http.url

    def _on_master_drain(self, info: Dict[str, Any]) -> None:
        # heartbeat-thread context: attribute writes only (the main loop
        # polls master_drain_requested and runs the actual drain)
        self.master_drain_info = dict(info)
        self._master_drain = True

    def master_drain_requested(self) -> bool:
        """True once the master's heartbeat response asked for a drain
        (rolling deploy walking this replica)."""
        return self._master_drain

    def request_drain(self) -> None:
        """Close admission: /healthz flips to draining, new generations
        get 503, queued + in-flight requests run to completion."""
        self.http.start_drain()
        self.engine.queue.start_drain()
        self.engine._wake.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine finished its queued + in-flight work."""
        return self.engine.drain(timeout=timeout)

    def shutdown(self, deregister: bool = True) -> None:
        if self.replica is not None:
            self.replica.close(deregister=deregister)
            self.replica = None
        self.engine.stop()
        self.http.stop()

    def stats(self) -> Dict[str, Any]:
        out = self.engine.stats()
        out["url"] = self.http.url if self.http.running else None
        if self.replica is not None:
            out["replica_id"] = self.replica.replica_id
        return out
