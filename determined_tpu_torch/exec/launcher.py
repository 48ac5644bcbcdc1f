#!/usr/bin/env python3
"""The agent's interpreter for the port: give this file to
``dtpu-agent --python``.

The native agent execs ``<python> -m determined_tpu.exec.<name> [args]`` for
every trial (``run_trial``) and checkpoint-GC task (``gc_checkpoints``), and
``<python> -m <module>`` for the module the master names (the serving
fleet's replicas: ``serve_replica``).  This launcher
takes that argv and execs ``python -m determined_tpu_torch.exec.<name>
[args]`` with the interpreter that runs it, so the port's trial process runs
where the JAX package's would, with no change to the agent.  A module the
port does not have exits 2 with a message naming it: the JAX module never
runs in its place.  The repository root goes on ``PYTHONPATH``, so the
port imports from any working directory.  The agent's orphan guard looks
for ``determined_tpu`` in a process's command line, which the port's
module names match.

    python -m determined_tpu_torch.cli cluster up --agents N   # sets it
    dtpu-agent ... --python <repo>/determined_tpu_torch/exec/launcher.py
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

JAX_PREFIX = "determined_tpu."
PORT_PREFIX = "determined_tpu_torch."
#: the exec modules the port has
PORTED = ("determined_tpu_torch.exec.run_trial", "determined_tpu_torch.exec.gc_checkpoints",
          "determined_tpu_torch.exec.serve_replica")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class LauncherError(ValueError):
    """An agent command the port cannot run."""


def port_module(module: str) -> Optional[str]:
    """The port's module for the one the agent names (``determined_tpu.X``
    -> ``determined_tpu_torch.X``), or None when the port lacks it."""
    if module.startswith(PORT_PREFIX):
        mapped = module
    elif module.startswith(JAX_PREFIX):
        mapped = PORT_PREFIX + module[len(JAX_PREFIX):]
    else:
        return None
    return mapped if mapped in PORTED else None


def command(argv: List[str]) -> Tuple[str, List[str]]:
    """The interpreter and argv to exec for the agent's ``argv`` (without
    the program name); raises ``LauncherError`` for what the port cannot
    run."""
    if len(argv) < 2 or argv[0] != "-m":
        raise LauncherError(f"launcher: expected `-m MODULE [ARGS]`, got {argv!r}")
    mapped = port_module(argv[1])
    if mapped is None:
        raise LauncherError(
            f"launcher: module {argv[1]!r} has no counterpart in determined_tpu_torch "
            f"(the port runs {', '.join(PORTED)}); refusing to run it"
        )
    return sys.executable, [sys.executable, "-m", mapped, *argv[2:]]


def main(argv: Optional[List[str]] = None) -> None:
    try:
        exe, args = command(sys.argv[1:] if argv is None else argv)
    except LauncherError as e:
        print(e, file=sys.stderr)
        raise SystemExit(2) from None
    path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
    os.execv(exe, args)


if __name__ == "__main__":
    main()
