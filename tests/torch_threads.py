"""One intra-op thread for torch in the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module.  The tier-1 suite runs
six pytest workers on the host's cores; at torch's default of an intra-op
thread a core, each small CPU op of a worker splits over an OpenMP team that
contends with the other workers' teams for the same cores, and waits at the
op's barrier for threads the scheduler has set aside.  Under that load a
test spends most of its time waiting: a crash-and-resume test of
``test_torch_fault_tolerance.py`` that takes 0.7 s on one thread took 42.9 s
on eight.  One thread splits no product or reduction, so what a test
computes does not depend on the host's load either (as
``test_torch_searcher.py``'s one-thread fixture and ``test_torch_gang.py``'s
pinned rank threads arrange for their own runs).  The processes a test
starts keep their own settings, and so do the threads it starts: a new
thread's MKL products run on the default team whatever the main thread's
setting, so a test that holds work in the main thread bit for bit against
the same work in other threads runs at ``DEFAULT_THREADS``
(``default_threads``).
"""

import contextlib
from typing import Iterator

import torch

#: torch's intra-op threads before this module set one
DEFAULT_THREADS = torch.get_num_threads()

torch.set_num_threads(1)


@contextlib.contextmanager
def default_threads() -> Iterator[None]:
    """torch's default intra-op threads while open (the main thread's
    products then split as a new thread's do)."""
    before = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
