"""Supervisor-launched serving replica: the fleet's relaunch vehicle
(``determined_tpu/exec/serve_replica.py`` for the port).

The master's serving-fleet supervisor (``PUT /api/v1/serving/fleet``)
replaces a dead/failed/drained replica by launching
``determined_tpu.exec.serve_replica`` as a generic agent task; with the
agent's ``--python`` set to the port's launcher (``exec/launcher.py``) that
is this module.  It loads the registry version the master resolved into the
task config on the GPU, serves it as a registered replica (``ServeWorker``),
reports the task ready, and then polls for drain:

- a master-requested drain (rolling deploy walking this replica) or a
  SIGTERM runs the orderly drain and exits 75 (EX_TEMPFAIL) — the
  supervisor counts that as a relaunch, never a crash-loop failure;
- a bad checkpoint (the crash-loop case) fails FAST with a nonzero exit,
  which the agent reports back so the supervisor's capped backoff and
  crash-loop detection engage instead of thrashing the agent.

``DTPU_TASK_CONFIG`` fields (set by the master's ``launch_fleet_replica``):
  model            registry model name
  version          registry version number
  checkpoint_uuid  the version's checkpoint uuid (label only)
  storage_path     checkpoint directory to load
  serve            optional ServeConfig overrides (``ServeConfig.from_dict``)
  env              optional {name: value} environment overrides, applied
                   before anything else — the chaos hook (an injected
                   ``DTPU_SERVE_ERROR_RATE`` manufactures 5xxs on a canary
                   cohort, optionally gated to one registry version with
                   ``DTPU_SERVE_ERROR_VERSION``) rides here, and so does
                   ``DTPU_TORCH_DEVICE``

The replica serves on CUDA unless ``DTPU_TORCH_DEVICE`` names another
device (``cpu`` runs the plain versions, as the CPU tests do); without a
GPU and without that variable it exits 1 naming the device, before it
loads anything.  It logs its device, and prints the kernels' launch counts
of this process and its engine's request counts (``kernel launches:`` and
``serve stats:`` lines) when they changed (at most once a second), when a
drain starts and at exit, so the counts survive in the task's log even
when the process is killed; and its checkpoint load's seconds (``load
seconds:``).
"""

from __future__ import annotations

import errno
import json
import logging
import os
import random
import signal
import sys
import time
import urllib.request

# stdlib only: torch must not load before the task config's env is applied
from determined_tpu_torch.exec._tls import urlopen as _tls_urlopen

logger = logging.getLogger("determined_tpu_torch.exec.serve_replica")

#: orderly-drain exit code (the experiment package's PREEMPTED_EXIT_CODE)
DRAIN_EXIT_CODE = 75
#: the engine counters each ``serve stats:`` line carries
STATS_KEYS = ("submitted", "completed", "errored", "rejected", "tokens_generated",
              "prefix_hits")


def _report_ready() -> None:
    master = os.environ.get("DTPU_MASTER_URL")
    task_id = os.environ.get("DTPU_TASK_ID")
    if not master or not task_id:
        return
    req = urllib.request.Request(
        master.rstrip("/") + f"/api/v1/tasks/{task_id}/ready",
        data=b"{}",
        headers={
            "Authorization": f"Bearer {os.environ.get('DTPU_SESSION_TOKEN', '')}",
            "Content-Type": "application/json",
        },
    )
    try:
        with _tls_urlopen(req, timeout=10) as resp:
            resp.read()
    except Exception:  # noqa: BLE001 - replica still serves; state stays PENDING
        pass


class _ErrorRateInjector:
    """Raise on a fraction of ``serve.generate`` fires: the way to give a
    canary cohort a real error-rate regression."""

    def __init__(self, rate: float) -> None:
        self.rate = rate
        self._rng = random.Random(0xD7B0)  # deterministic across replicas

    def fire(self, site: str, **info: object) -> None:
        if site == "serve.generate" and self._rng.random() < self.rate:
            raise RuntimeError(
                f"injected serve failure (DTPU_SERVE_ERROR_RATE={self.rate})"
            )


class _CountsLog:
    """Prints the ``kernel launches:`` and ``serve stats:`` lines when they
    changed since the last print, at most once every ``INTERVAL_S`` (a
    busy replica's log stays short), or at once with ``force``."""

    INTERVAL_S = 1.0

    def __init__(self, engine) -> None:
        from determined_tpu_torch.exec.gang_rank import launch_counts

        self._engine = engine
        self._counts = launch_counts
        self._last = None
        self._printed_at = float("-inf")

    def emit(self, force: bool = False) -> None:
        if not force and time.monotonic() - self._printed_at < self.INTERVAL_S:
            return
        stats = self._engine.stats()
        now = (self._counts(), {k: stats[k] for k in STATS_KEYS})
        if force or now != self._last:
            self._last, self._printed_at = now, time.monotonic()
            print(f"kernel launches: {json.dumps(now[0], sort_keys=True)}", flush=True)
            print(f"serve stats: {json.dumps(now[1], sort_keys=True)}", flush=True)


def _resolve_device():
    """The device the replica serves on, resolved and logged as
    ``run_trial`` does (``_device.task_device``); None, with a line naming
    the device, when there is none."""
    from determined_tpu_torch._device import DEVICE_ENV, task_device

    try:
        return task_device(logger)
    except RuntimeError as e:
        print(f"serve replica: {e} (or set {DEVICE_ENV} in the fleet's env)",
              file=sys.stderr, flush=True)
        return None


def _print_load_seconds(seconds: float, device) -> None:
    """The checkpoint load's seconds: the whole ``from_checkpoint``, its
    manifest check (md5 of every file) and its restore, from the tracer's
    spans."""
    from determined_tpu_torch.observability import get_tracer

    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    spans = {"checkpoint.verify": "verify_s", "checkpoint.load": "restore_s"}
    out = {"from_checkpoint_s": seconds}
    for e in get_tracer().chrome_events():
        if e.get("ph") == "X" and e.get("name") in spans:
            out[spans[e["name"]]] = e["dur"] / 1e6
    print(f"load seconds: {json.dumps(out, sort_keys=True)}", flush=True)


def main() -> int:
    cfg = json.loads(os.environ.get("DTPU_TASK_CONFIG", "{}") or "{}")
    # env overrides FIRST: fault-injection knobs and the device must be
    # live before torch, the engine or the HTTP layer exists
    for k, v in (cfg.get("env") or {}).items():
        os.environ[str(k)] = str(v)

    model = str(cfg.get("model") or "")
    version = int(cfg.get("version") or 0)

    error_rate = float(os.environ.get("DTPU_SERVE_ERROR_RATE", "0") or 0.0)
    # optional version gate: fleet env applies to every slot the
    # supervisor launches, but a canary-regression drill needs only the
    # NEW version to misbehave (the old cohort is the healthy baseline)
    bad_version = os.environ.get("DTPU_SERVE_ERROR_VERSION", "")
    if bad_version and int(bad_version) != version:
        error_rate = 0.0
    if error_rate > 0.0:
        from determined_tpu_torch.utils import faults

        faults.set_fault_injector(_ErrorRateInjector(error_rate))
        print(f"serve replica: injecting {error_rate:.0%} generate failures",
              flush=True)
    storage = str(cfg.get("storage_path") or "")
    if not storage or not os.path.isdir(storage):
        # fail FAST and nonzero: this is the crash-loop vehicle the
        # supervisor's backoff/degraded detection is tested against
        print(f"serve replica: storage path {storage!r} is not a directory",
              file=sys.stderr, flush=True)
        return 1

    from determined_tpu_torch.api.session import Session
    from determined_tpu_torch.serve import ServeConfig, ServeEngine, ServeWorker

    try:
        serve_cfg = ServeConfig.from_dict(
            {
                "host": "127.0.0.1",
                "port": int(os.environ.get("DTPU_TASK_PORT", "0") or 0),
                **(cfg.get("serve") or {}),
            }
        )
    except (TypeError, ValueError) as e:
        print(f"serve replica: bad serve config: {e}", file=sys.stderr, flush=True)
        return 2

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    )
    device = _resolve_device()
    if device is None:
        return 1
    print(f"serve replica: loading {model}@v{version} from {storage}", flush=True)
    t0 = time.monotonic()
    try:
        engine = ServeEngine.from_checkpoint(storage, serve_cfg, device=device)
    except Exception as e:  # noqa: BLE001 - any load failure is a crash-loop input
        print(f"serve replica: checkpoint load failed: {e}",
              file=sys.stderr, flush=True)
        return 1
    _print_load_seconds(time.monotonic() - t0, device)

    session = None
    master = os.environ.get("DTPU_MASTER_URL")
    if master:
        session = Session(master, token=os.environ.get("DTPU_SESSION_TOKEN"))
    worker = ServeWorker(
        engine,
        host=serve_cfg.host,
        port=serve_cfg.port,
        session=session,
        model=f"{model}@v{version}" if model else "",
        checkpoint=storage,
        model_name=model,
        model_version=version,
        task_id=os.environ.get("DTPU_TASK_ID", ""),
    )
    try:
        url = worker.start()
    except OSError as e:
        if e.errno != errno.EADDRINUSE:
            raise
        # the master's assigned port is advisory: a restarted master's
        # port allocator starts fresh and can hand out a port a surviving
        # pre-restart replica still holds.  Registration carries the real
        # URL, so rebind on an OS-chosen port instead of crash-looping.
        from determined_tpu_torch.serve import ServeHTTPServer

        print(
            f"serve replica: port {serve_cfg.port} in use; "
            "rebinding on an ephemeral port", flush=True,
        )
        worker.http = ServeHTTPServer(engine, host=serve_cfg.host, port=0)
        url = worker.start()
    print(f"serving on {url}", flush=True)
    _report_ready()
    counts = _CountsLog(engine)

    # signal-flag poll pattern (the CLI's serve): the handler only flips a
    # plain attribute; the drain runs on the main thread
    class _Flag:
        set_ = False

    def _on_signal(signum, frame):  # noqa: ARG001 - signal handler shape
        _Flag.set_ = True

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _on_signal)
    try:
        while not _Flag.set_ and not worker.master_drain_requested():
            if engine.failed is not None:
                # the heartbeat already told the master (failed stat ->
                # immediate reap); exit nonzero so the supervisor counts
                # the crash and relaunches with backoff
                print(f"serve replica: engine failed: {engine.failed}",
                      file=sys.stderr, flush=True)
                worker.shutdown(deregister=False)
                counts.emit(force=True)
                return 1
            counts.emit()
            time.sleep(0.2)
        if worker.master_drain_requested() and not _Flag.set_:
            target = worker.master_drain_info.get("target") or "?"
            print(f"deploy drain requested by master (target {target})", flush=True)
        print("drain requested: rejecting new requests, finishing in-flight",
              flush=True)
        counts.emit(force=True)  # the counts at the drain: what was in flight
        worker.request_drain()
        clean = worker.wait_drained(timeout=serve_cfg.drain_grace_s)
        worker.shutdown()
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        counts.emit(force=True)
        print(f"drained ({'clean' if clean else 'grace expired'}); exiting",
              flush=True)
        return DRAIN_EXIT_CODE
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
