"""PreemptContext: cooperative preemption for trials.

The off-cluster part of ``determined_tpu/core/_preempt.py``: a flag that
``simulate()`` sets (the local experiment's drain on SIGTERM/SIGINT or
``request_preemption()``, tests), read by the Trainer at each boundary
through ``should_preempt()``.  Over several ranks the read is the JAX
package's ``WorkersAskChief`` vote: an allgather of every rank's flag, so a
signal that reached any rank stops every rank at the same step.  The
watcher thread that long-polls the master for the preemption signal, and
the trial-level SIGTERM latch, come with the cluster slice of the port.
"""

from __future__ import annotations

from typing import Any


class PreemptContext:
    def __init__(self, dist: Any) -> None:
        self._dist = dist
        # a plain bool, NOT an Event: simulate() is called from a signal
        # handler, and Event.set takes a lock the interrupted frame may hold
        self._local_flag = False
        self._acked = False
        self._started = False

    def start(self) -> "PreemptContext":
        self._started = True
        return self

    def should_preempt(self, auto_ack: bool = True) -> bool:
        """Read at batch boundaries: True once preemption was requested."""
        if not self._started:
            raise RuntimeError("PreemptContext not started")
        if self._dist.size > 1:
            out = any(self._dist.allgather(self._local_flag))
        else:
            out = self._local_flag
        if out and auto_ack:
            self.acknowledge_preemption_signal()
        return out

    def simulate(self) -> None:
        """Programmatically trigger preemption.  A plain flag write, so a
        signal handler may call it."""
        self._local_flag = True

    def acknowledge_preemption_signal(self) -> None:
        """Off-cluster there is no master to tell: remember the ack."""
        if self._acked or not self._dist.is_chief:
            return
        self._acked = True

    def close(self) -> None:
        return None
