"""A forking interpreter for the port's import probes, and its client.

A probe asks what a fresh interpreter sees when it runs some code: which
modules an import pulls in, what a script exits with.  Starting one
interpreter a probe costs a torch import each time (seconds under a loaded
test run), so ``Zygote`` starts one interpreter, which installs the import
blocker, optionally imports torch once, and then forks a child for each
probe.  The child is the fresh interpreter the probe asks about, with torch
already imported where the probe's own code would import it first: it runs
the probe's code as ``python -c`` would (``__name__ == "__main__"``,
``sys.path[0]`` the working directory) and reports its exit code, its
standard output and its standard error.

Run as a script: ``python tests/torch_fork_probe.py BLOCKED_JSON PRELOAD``,
then one JSON request a line on standard input.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
from typing import Any, Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Zygote:
    """One forking interpreter: ``run(code)`` is ``subprocess.run([python,
    "-c", code])`` on a child forked from it."""

    def __init__(self, blocked: Sequence[str], preload: str) -> None:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(list(blocked)), preload],
            cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )

    def run(self, code: str, cwd: str = REPO, path: Sequence[str] = (),
            timeout: float = 120.0) -> subprocess.CompletedProcess:
        """Run ``code`` in a forked child (``path`` put after its working
        directory on ``sys.path``, as ``PYTHONPATH`` would); the child is
        killed after ``timeout`` seconds."""
        req = dict(code=code, cwd=cwd, path=list(path), timeout=timeout)
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout + 30.0)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.close()
            raise AssertionError(f"the probe interpreter gave no answer within {timeout} s")
        out = json.loads(line)
        return subprocess.CompletedProcess(["<fork>", code], out["rc"], out["stdout"],
                                           out["stderr"])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


# ---------------------------------------------------------------------------
# the interpreter side
# ---------------------------------------------------------------------------


class _Blocker:
    def __init__(self, blocked: Sequence[str]) -> None:
        self.blocked = tuple(blocked)

    def find_spec(self, name: str, path: Any = None, target: Any = None) -> None:
        if any(name == b or name.startswith(b + ".") for b in self.blocked):
            raise ImportError("blocked import of " + name)
        return None


def _child(req: Dict[str, Any], out_path: str, err_path: str) -> None:
    """The forked child: run the request's code as ``python -c`` would, with
    its output in two files; never returns."""
    import signal
    import traceback

    rc = 0
    try:
        for fd, p in ((1, out_path), (2, err_path)):
            f = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            os.dup2(f, fd)
            os.close(f)
        sys.stdin = open(os.devnull)
        signal.alarm(max(1, int(req["timeout"])))
        os.chdir(req["cwd"])
        sys.path[0:1] = ["", *req["path"]]
        sys.argv = ["-c"]
        main = type(sys)("__main__")
        sys.modules["__main__"] = main
        exec(compile(req["code"], "<string>", "exec"), main.__dict__)
    except SystemExit as e:
        code = e.code
        if code is None:
            rc = 0
        elif isinstance(code, int):
            rc = code
        else:
            print(code, file=sys.stderr)
            rc = 1
    except BaseException:  # noqa: BLE001 - the child reports every failure as python would
        traceback.print_exc()
        rc = 1
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    finally:
        os._exit(rc & 0xFF)


def _serve(blocked: Sequence[str], preload: Optional[str]) -> None:
    import tempfile

    sys.meta_path.insert(0, _Blocker(blocked))
    sys.path[0] = ""
    if preload == "torch":
        import torch  # noqa: F401
    reply = sys.stdout
    tmp = tempfile.mkdtemp(prefix="fork-probe-")
    try:
        for line in sys.stdin:
            req = json.loads(line)
            out_path, err_path = os.path.join(tmp, "out"), os.path.join(tmp, "err")
            pid = os.fork()
            if pid == 0:
                _child(req, out_path, err_path)
            _, status = os.waitpid(pid, 0)
            rc = os.waitstatus_to_exitcode(status)
            with open(out_path) as f:
                stdout = f.read()
            with open(err_path) as f:
                stderr = f.read()
            reply.write(json.dumps(dict(rc=rc, stdout=stdout, stderr=stderr)) + "\n")
            reply.flush()
    finally:
        for name in ("out", "err"):
            if os.path.exists(os.path.join(tmp, name)):
                os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)


if __name__ == "__main__":
    _serve(json.loads(sys.argv[1]), sys.argv[2] if sys.argv[2] != "none" else None)
