"""The gang launch: a trial whose mesh holds several devices, run as one
rank process a device.

The JAX package's local runner is one controller over every device of a
trial's block; the port is multi-controller (one process a device, as
torchrun launches it), so ``LocalExperiment`` runs such a trial as a gang:

- ``Gang.fit`` starts one process of ``determined_tpu_torch.exec.gang_rank``
  a device of the block, each with a torchrun environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
  and a ``MASTER_PORT`` of its own from ``allocate_port``) and the trial's
  spec (a JSON file: the trial class by ``module:qualname``, the
  configuration, hparams, seed, checkpoint directory, the ``fit``
  arguments and the block's devices).  Each rank runs ``train.init`` ->
  ``Trainer(trial).fit`` on the trial's mesh, on its block's device
  (never ``cuda:RANK``).
- The chief relays over a local socket (``_Relay``, the control plane's
  length-prefixed pickles) to the parent: each validation (answered with
  the searcher's stop decision, so ASHA and PBT decide as they do for a
  trial on a thread, at the same boundary), each finalized checkpoint, and
  at the end the fit summary with its kernel launch counts and its
  tracer's events (re-recorded here, so the experiment's trace and goodput
  count the chief's work).  The parent's preemption (``request_preemption``,
  SIGTERM/SIGINT) goes to the chief, whose flag the ranks' collective
  preemption vote turns into a checkpoint and an exit on every rank.
- One rank that dies or exits non-zero tears the gang down: every rank is
  killed and reaped within ``REAP_TIMEOUT_S``, and the attempt raises,
  classified as a trial on a thread would be (the rank's own exception
  kind when it recorded one, else transient).  ``Gang`` quacks like a
  Trainer (``fit``, ``latest_checkpoint``, ``steps_completed``), so
  ``exec.run_trial.TrialSupervisor`` restarts it from the newest finalized
  checkpoint up to ``max_restarts``.  An attempt that outlives
  ``ATTEMPT_TIMEOUT_S`` is torn down the same way.  Nothing falls back to running the
  trial in this process or on one device.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import select
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from determined_tpu_torch.core._distributed import _recv_msg, _send_msg, allocate_port
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.utils.errors import FatalTrialError, TransientError

logger = logging.getLogger("determined_tpu_torch.experiment.gang")

#: seconds the teardown waits for killed ranks to be reaped
REAP_TIMEOUT_S = 30.0
#: seconds a gang attempt may run before its ranks are killed (None: no limit)
ATTEMPT_TIMEOUT_S: Optional[float] = None
#: seconds between two looks at the ranks, the relay and the preemption flag
POLL_S = 0.05
RANK_MODULE = "determined_tpu_torch.exec.gang_rank"


class TrialNotImportableError(FatalTrialError):
    """A gang's rank processes import the trial class by ``module:qualname``,
    and this class cannot be imported so."""


class GangRankError(TransientError):
    """A rank of a gang died or exited non-zero; the gang was torn down."""


class GangFatalError(FatalTrialError):
    """A rank's trial raised an error that no restart cures (its own kind
    was fatal); the gang was torn down."""


def trial_entrypoint(cls: type) -> str:
    """``module:qualname`` of a trial class that a new process imports to
    the same class; raises ``TrialNotImportableError`` otherwise."""
    import importlib

    ref = f"{cls.__module__}:{cls.__qualname__}"
    if "<locals>" in cls.__qualname__ or cls.__module__ == "__main__":
        raise TrialNotImportableError(
            f"the trial class {ref} cannot be imported by name in a rank process; "
            "define it at the top level of an importable module")
    try:
        obj: Any = importlib.import_module(cls.__module__)
        for part in cls.__qualname__.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise TrialNotImportableError(
            f"the trial class {ref} cannot be imported by name: {e}") from e
    if obj is not cls:
        raise TrialNotImportableError(f"{ref} imports to another object than the trial class")
    return ref


def import_trial(ref: str) -> type:
    import importlib

    module_name, _, qualname = ref.partition(":")
    obj: Any = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class _Relay:
    """The parent's end of the chief's relay: a listener on localhost that
    takes one connection, the chief's, identified by a token."""

    def __init__(self) -> None:
        self.token = secrets.token_hex(16)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(4)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self.conn: Optional[socket.socket] = None
        self.closed = False

    def poll(self, timeout: float) -> Optional[Any]:
        """The chief's next message, or None when none came in ``timeout``
        seconds (or the chief has gone: ``closed``)."""
        if self.closed:
            time.sleep(timeout)
            return None
        if self.conn is None:
            ready, _, _ = select.select([self._listener], [], [], timeout)
            if not ready:
                return None
            conn, _ = self._listener.accept()
            conn.setblocking(True)
            conn.settimeout(60.0)
            try:
                hello = _recv_msg(conn)
            except (OSError, ConnectionError, EOFError):
                conn.close()
                return None
            if hello != ("hello", self.token):
                conn.close()
                return None
            self.conn = conn
            return None
        ready, _, _ = select.select([self.conn], [], [], timeout)
        if not ready:
            return None
        try:
            return _recv_msg(self.conn)
        except (OSError, ConnectionError, EOFError):
            self.closed = True
            return None

    def send(self, msg: Any) -> bool:
        if self.conn is None or self.closed:
            return False
        try:
            _send_msg(self.conn, msg)
            return True
        except OSError:
            self.closed = True
            return False

    def close(self) -> None:
        for s in (self.conn, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class Gang:
    """A trial on a block of devices, one rank process a device; one
    ``fit`` call is one attempt.

    ``on_validation(steps, metrics, latest_checkpoint, progress)`` is the
    parent's searcher hook and returns whether the searcher stopped the
    trial; ``latest_checkpoint`` follows the chief's finalized checkpoints;
    ``preempt_requested()`` is polled and, once true, sent to the chief."""

    def __init__(
        self,
        spec: Dict[str, Any],
        devices: List[str],
        workdir: str,
        *,
        on_validation: Callable[[int, Dict[str, Any], Optional[str], float], bool],
        preempt_requested: Callable[[], bool],
    ) -> None:
        self.spec = dict(spec)
        self.devices = list(devices)
        self.workdir = workdir
        self.on_validation = on_validation
        self.preempt_requested = preempt_requested
        self.attempts = 0
        self.latest_checkpoint: Optional[str] = None
        self.steps_completed = 0
        #: the chief's kernel launch counts of the last attempt that ended
        self.launches: Dict[str, Any] = {}

    # -- one attempt ---------------------------------------------------------

    def fit(self, max_length: Any, *, latest_checkpoint: Optional[str] = None,
            **fit_kwargs: Any) -> Dict[str, Any]:
        self.attempts += 1
        attempt_dir = os.path.join(self.workdir, f"attempt_{self.attempts}")
        os.makedirs(attempt_dir, exist_ok=True)
        relay = _Relay()
        spec = dict(self.spec)
        if spec.get("verdict") and spec["verdict"][0] != latest_checkpoint:
            spec["verdict"] = None  # a check of another checkpoint
        spec.update(
            fit=dict(fit_kwargs, max_length=max_length, latest_checkpoint=latest_checkpoint),
            devices=self.devices, relay_port=relay.port, relay_token=relay.token,
            preempt=bool(self.preempt_requested()), attempt_dir=attempt_dir,
        )
        spec_path = os.path.join(attempt_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f, default=_jsonable)
        world = len(self.devices)
        env = dict(os.environ)
        env.update(
            WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(allocate_port()),
            # the ranks import the trial as this process does
            PYTHONPATH=os.pathsep.join(p for p in [os.getcwd(), *sys.path] if p),
        )
        procs: List[subprocess.Popen] = []
        logs = []
        t0 = time.monotonic()
        try:
            with get_tracer().span("gang.launch", cat="setup", world=world,
                                   devices=",".join(self.devices)):
                for rank in range(world):
                    log = open(os.path.join(attempt_dir, f"rank{rank}.log"), "w")
                    logs.append(log)
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", RANK_MODULE, spec_path],
                        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                    ))
            return self._supervise(relay, procs, attempt_dir, t0)
        finally:
            _teardown(procs)
            relay.close()
            for log in logs:
                log.close()

    def _supervise(self, relay: _Relay, procs: List[subprocess.Popen], attempt_dir: str,
                   t0: float) -> Dict[str, Any]:
        result: Optional[Dict[str, Any]] = None
        preempt_sent = False
        timeout = ATTEMPT_TIMEOUT_S
        deadline = t0 + timeout if timeout else None
        while True:
            if not preempt_sent and self.preempt_requested() and relay.send(("preempt",)):
                preempt_sent = True
            msg = relay.poll(POLL_S)
            if msg is not None:
                result = self._handle(relay, msg) or result
                continue
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise self._failure(attempt_dir, bad, codes)
            if all(c == 0 for c in codes) and (relay.closed or relay.conn is None):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise GangRankError(
                    f"the gang on {self.devices} did not finish within {timeout:.0f} s; "
                    f"every rank was killed\n{_tails(attempt_dir, range(len(procs)))}")
        if result is None:
            raise GangRankError(f"the gang on {self.devices} exited without the chief's "
                                f"result\n{_tails(attempt_dir, [0])}")
        return result

    def _handle(self, relay: _Relay, msg: Any) -> Optional[Dict[str, Any]]:
        kind = msg[0]
        if kind == "validation":
            _, steps, metrics, latest, progress = msg
            self.steps_completed = steps
            self._note_checkpoint(latest)
            stop = self.on_validation(steps, metrics, latest, progress)
            # a drain asked for meanwhile stops the trial at this boundary too
            relay.send(("stop", bool(stop or self.preempt_requested())))
        elif kind == "checkpoint":
            self._note_checkpoint(msg[1])
        elif kind == "result":
            _, summary, launches, events, epoch = msg
            self.steps_completed = summary["steps_completed"]
            self._note_checkpoint(summary.get("latest_checkpoint"))
            self.launches = dict(launches)
            get_tracer().ingest(events, epoch)
            return summary
        return None

    def _note_checkpoint(self, sid: Optional[str]) -> None:
        if sid:
            self.latest_checkpoint = sid

    def _failure(self, attempt_dir: str, bad: List[int], codes: List[Optional[int]]):
        """The error of a gang one of whose ranks exited non-zero: fatal
        when a rank recorded a fatal exception of its own, else transient."""
        exits = [f"rank {r} exit {codes[r]}" for r in bad]
        fatal = None
        for r in range(len(codes)):
            path = os.path.join(attempt_dir, f"rank{r}.failure.json")
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("kind") == "fatal":
                    fatal = f"rank {r}: {rec.get('error')}"
                    break
        what = (f"the gang on {self.devices} failed ({', '.join(exits)}); "
                f"every rank was killed")
        tails = _tails(attempt_dir, bad)
        if fatal is not None:
            return GangFatalError(f"{what}: {fatal}\n{tails}")
        return GangRankError(f"{what}\n{tails}")


def _teardown(procs: List[subprocess.Popen]) -> None:
    """Kill every rank still running (its whole session) and reap them all
    within ``REAP_TIMEOUT_S``."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
    deadline = time.monotonic() + REAP_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            logger.error("rank process %d was not reaped within %.0f s", p.pid, REAP_TIMEOUT_S)


def _tails(attempt_dir: str, ranks: Any, n: int = 3000) -> str:
    out = []
    for r in ranks:
        try:
            with open(os.path.join(attempt_dir, f"rank{r}.log"), errors="replace") as f:
                out.append(f"--- rank {r}:\n{f.read()[-n:]}")
        except OSError:
            continue
    return "\n".join(out)


def _jsonable(obj: Any) -> Any:
    """The spec's Lengths as their raw form."""
    if hasattr(obj, "unit") and hasattr(obj, "units"):
        return {obj.unit: obj.units}
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")
