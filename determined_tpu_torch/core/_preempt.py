"""PreemptContext: cooperative preemption for trials (a copy of
``determined_tpu/core/_preempt.py``).

Off the cluster, a flag that ``simulate()`` sets (the local experiment's
drain on SIGTERM/SIGINT or ``request_preemption()``, tests).  Under the
master, a watcher thread long-polls
``/api/v1/allocations/{id}/signals/preemption`` (an experiment pause, a
scheduler preemption or a searcher stop set it), and a SIGTERM to the trial
process (what the agent sends before it kills an allocation) latches the
same flag.  The Trainer reads it at each boundary through
``should_preempt()``: over several ranks an allgather of every rank's flag
(the JAX ``WorkersAskChief`` vote), so a signal that reached any rank stops every rank at the same
step; the chief then acknowledges the signal to the master.  The JAX
context's other modes (``ChiefOnly``, ``WorkersAskMaster``) have no caller
in either package and are not ported: the chief watches the master.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Any, Optional

logger = logging.getLogger("determined_tpu_torch.core.preempt")


class _PreemptionWatcher(threading.Thread):
    """Long-polls the master for the preemption flag; also latched by the
    signal path."""

    def __init__(self, session: Any, allocation_id: str, poll_interval: float = 5.0) -> None:
        super().__init__(daemon=True, name="preemption-watcher")
        self._session = session
        self._allocation_id = allocation_id
        self._poll_interval = poll_interval
        self._flag = threading.Event()
        self._stop = threading.Event()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def latch(self) -> None:
        self._flag.set()

    def run(self) -> None:
        while not self._stop.is_set() and not self._flag.is_set():
            try:
                # read timeout must exceed the server-side long-poll hold
                resp = self._session.get(
                    f"/api/v1/allocations/{self._allocation_id}/signals/preemption",
                    params={"timeout_seconds": 60},
                    timeout=70,
                )
                if resp.json().get("preempt"):
                    self._flag.set()
                    return
            except Exception:  # noqa: BLE001
                logger.debug("preemption poll failed; retrying", exc_info=True)
            self._stop.wait(self._poll_interval)

    def close(self) -> None:
        self._stop.set()


class PreemptContext:
    def __init__(
        self,
        dist: Any,
        session: Optional[Any] = None,
        allocation_id: Optional[str] = None,
        register_signal_handler: bool = True,
    ) -> None:
        self._dist = dist
        self._session = session
        self._allocation_id = allocation_id
        self._watcher: Optional[_PreemptionWatcher] = None
        # a plain bool, NOT an Event: it is set from the SIGTERM handler,
        # and Event.set takes the Event's internal Condition lock — if the
        # signal interrupts the main thread inside simulate()'s own set()
        # the handler would self-deadlock.  A GIL-atomic attribute write
        # has no lock to hold.
        self._local_flag = False
        self._acked = False
        self._started = False
        self._register_signal_handler = register_signal_handler
        self._prev_sigterm: Any = None

    def start(self) -> "PreemptContext":
        if self._started:
            return self
        self._started = True
        if self._session is not None and self._allocation_id and self._dist.is_chief:
            self._watcher = _PreemptionWatcher(self._session, self._allocation_id or "")
            self._watcher.start()
        if self._register_signal_handler and threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, self._on_sigterm)
        return self

    def _on_sigterm(self, signum, frame) -> None:
        # flag-set pattern ONLY: the handler interrupts the main thread at
        # an arbitrary bytecode boundary, so it must not touch the logging
        # module lock or any Event's Condition lock the interrupted frame
        # might hold; os.write to stderr keeps it visible
        self._local_flag = True
        os.write(2, b"determined-tpu: SIGTERM received, latching preemption flag\n")
        if callable(self._prev_sigterm):
            self._prev_sigterm(signum, frame)

    def _flag(self) -> bool:
        if self._local_flag:
            if self._watcher is not None:
                # normal-thread context: stop the long-poll loop early
                self._watcher.latch()
            return True
        return self._watcher.preempted if self._watcher is not None else False

    def should_preempt(self, auto_ack: bool = True) -> bool:
        """Read at batch boundaries: over several ranks a collective, so
        every rank acts in the same step."""
        if not self._started:
            raise RuntimeError("PreemptContext not started")
        if self._dist.size > 1:
            # allgather (not chief broadcast) so a SIGTERM delivered to ANY
            # host triggers a coordinated checkpoint+exit on every rank
            out = any(self._dist.allgather(self._flag()))
        else:
            out = self._flag()
        if out and auto_ack:
            self.acknowledge_preemption_signal()
        return out

    def simulate(self) -> None:
        """Programmatically trigger preemption.  A plain flag write, so a
        signal handler may call it."""
        self._local_flag = True

    def acknowledge_preemption_signal(self) -> None:
        """Tell the master we saw the signal and will checkpoint and exit
        (off the cluster there is no master: the ack is remembered)."""
        if self._acked or not self._dist.is_chief:
            return
        self._acked = True
        if self._session is not None and self._allocation_id:
            try:
                self._session.post(
                    f"/api/v1/allocations/{self._allocation_id}/signals/ack_preemption"
                )
            except Exception:  # noqa: BLE001
                logger.exception("failed to ack preemption")

    def close(self) -> None:
        if self._watcher is not None:
            self._watcher.close()
        if (
            self._register_signal_handler
            and self._prev_sigterm is not None
            and threading.current_thread() is threading.main_thread()
        ):
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, TypeError):
                pass
