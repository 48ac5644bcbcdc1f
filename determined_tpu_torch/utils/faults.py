"""Fault-injection hook points (a copy of ``determined_tpu/utils/faults.py``).

Code calls ``fire(site, **info)`` where real infrastructure fails.  With no
injector installed (the default) a fire is one ``is None`` check.  Tests
install an injector whose ``fire`` may raise to simulate the fault.

Sites wired in the port:

- ``serve.generate``  in the serving replica's /v1/generate handler, before
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


def fire(site: str, **info: Any) -> None:
    """Hook point: no-op unless an injector is installed."""
    inj = _injector
    if inj is not None:
        inj.fire(site, **info)
