"""Fault-injection hook points (a copy of ``determined_tpu/utils/faults.py``).

Code calls ``fire(site, **info)`` where real infrastructure fails.  With no
injector installed (the default) a fire is one ``is None`` check.  Tests
install an injector whose ``fire`` may raise to simulate the fault.

Sites wired in the port:

- ``train.step``          before each optimizer step (``step=``)
- ``data.prefetch.fetch`` on the prefetch worker thread, before each host
                          batch fetch (``batches=``); a raise surfaces at the
                          consumer's next ``__next__``
- ``storage.upload``      before a StorageManager upload (``manager=, src=,
                          storage_id=, paths=``)
- ``storage.upload.done`` after a successful upload (same info)
- ``storage.download``    before a StorageManager download (``manager=,
                          storage_id=, dst=``)
- ``experiment.journal.append``
                          before each experiment-journal record lands
                          (``type=, seq=``)
- ``serve.generate``      in the serving replica's /v1/generate handler, before
                          admission; a raise answers 500 and bumps the
                          ``http_5xx`` stat
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Protocol


class Injector(Protocol):
    def fire(self, site: str, **info: Any) -> None: ...


_injector: Optional[Injector] = None
_lock = threading.Lock()


def set_fault_injector(injector: Optional[Injector]) -> None:
    """Install (or with None, remove) the process-global injector."""
    global _injector
    with _lock:
        _injector = injector


def get_fault_injector() -> Optional[Injector]:
    return _injector


def fire(site: str, **info: Any) -> None:
    """Hook point: no-op unless an injector is installed."""
    inj = _injector
    if inj is not None:
        inj.fire(site, **info)
