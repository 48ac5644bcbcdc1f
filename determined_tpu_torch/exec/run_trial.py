"""Trial process entrypoint: what the agent execs for each allocation
group (``determined_tpu/exec/run_trial.py`` for the port).

The agent runs ``<python> -m determined_tpu.exec.run_trial pkg.module:Trial``
with the launch environment (``DTPU_*``); with ``--python`` set to the
port's launcher (``exec/launcher.py``) that command becomes

    python -m determined_tpu_torch.exec.run_trial pkg.module:TrialClass

This module applies the experiment's ``environment.env``, prefixes a
multi-node gang's output with its rank, joins the master's rendezvous
(``DistributedContext.from_rendezvous``: the torch process group, NCCL on
CUDA), downloads the experiment's context directory, imports the trial,
builds the cluster core context (``core.init``: session, metrics,
checkpoints recorded at the master, heartbeats, the preemption watcher)
and drives ``Trainer.fit`` under ``TrialSupervisor``, which restarts a
failed attempt from its newest finalized checkpoint.  A preempted trial
checkpoints at its next boundary and exits 0; the master relaunches it
with ``DTPU_LATEST_CHECKPOINT``.

A node given ``DTPU_NUM_SLOTS`` = N > 1 slots runs them as N local rank
processes, one a GPU, as torchrun does (``run_local_ranks``): this process
starts N copies of itself, each with ``DTPU_LOCAL_RANK`` set and every GPU
of the node's ``CUDA_VISIBLE_DEVICES`` visible (rank ``i`` takes
``cuda:i``), forwards SIGTERM and SIGINT to them (a preemption reaches
every rank; they vote and checkpoint together), and exits with the first
non-zero code among them, after stopping the others, or 0.  The node's
local rank 0 holds the star's chief on node 0 (the global rank 0); this
process ships the logs and reports the exit where the job does so itself,
and the agent relays what every local rank writes.

The trial trains on CUDA unless the experiment's ``environment.env`` sets
``DTPU_TORCH_DEVICE`` (``cpu`` runs the plain versions, as the CPU tests
do); without a GPU and without that variable the process raises.  It logs
its device and, at the end, the kernels' launch counts of this process.
The lint knobs (``lint.strict``, the retrace, collective and thread
sentinels) raise ``NotImplementedError``: the lint package is a later
slice of the port; ``lint.preflight`` is logged as not run.

A job on an external resource manager has no agent: with
``DTPU_SHIP_LOGS`` it ships its own output to ``/api/v1/logs`` and with
``DTPU_SELF_REPORT_EXIT`` reports its own exit.  A task placed there
(``DTPU_TASK_TYPE``) runs the port's counterpart of ``DTPU_TASK_MODULE``
(the launcher's mapping); a module the port lacks exits 2.  The native
master's Kubernetes and Slurm paths exec the JAX package's module today
(ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import sys
from typing import Any

# stdlib only: torch must not load before the experiment's environment is
# applied (tests/test_torch_imports.py holds this module to it)
from determined_tpu_torch.exec._tls import urlopen as _tls_urlopen

RUN_TRIAL = "determined_tpu_torch.exec.run_trial"

#: seconds the node's other local ranks have to exit after one failed
#: before they are killed (a peer of a lost rank may wait in a collective)
LOCAL_RANK_GRACE_S = 10.0


def run_local_ranks(cmd: list, slots: int) -> int:
    """Run ``cmd`` as ``slots`` local rank processes (``DTPU_LOCAL_RANK``
    0..slots-1, the module docstring) and wait for them: SIGTERM and SIGINT
    are passed on to each; when one exits non-zero the others get SIGTERM,
    then SIGKILL after LOCAL_RANK_GRACE_S, and that code is returned; else
    0."""
    import signal
    import subprocess
    import time

    env = {k: v for k, v in os.environ.items()
           if k not in ("DTPU_SHIP_LOGS", "DTPU_SELF_REPORT_EXIT")}
    procs = []
    for i in range(slots):
        procs.append(subprocess.Popen(cmd, env=dict(env, DTPU_LOCAL_RANK=str(i))))

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    code, deadline = 0, None
    try:
        while [p.poll() for p in procs].count(None):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed and deadline is None:
                code = failed[0]
                print(f"run_trial: a local rank exited {code}; stopping the node's others",
                      file=sys.stderr, flush=True)
                forward(signal.SIGTERM, None)
                deadline = time.monotonic() + LOCAL_RANK_GRACE_S
            if deadline is not None and time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.1)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if code == 0:
        code = next((p.returncode for p in procs if p.returncode), 0)
    # a rank killed by a signal reports its negative number: exit non-zero
    return code if code >= 0 else 128 - code


def _apply_environment_early() -> None:
    """The experiment's ``environment.env`` lands before torch is imported
    (``CUDA_VISIBLE_DEVICES``, allocator settings and the device variable
    are read at import or first use).  Config env overrides the inherited
    process env: the experiment's declaration is authoritative."""
    raw = os.environ.get("DTPU_EXP_CONFIG")
    if raw:
        try:
            env = (json.loads(raw).get("environment") or {}).get("env") or {}
        except Exception:
            env = {}
        for k, v in env.items():
            os.environ[str(k)] = str(v)


def _prepare_context(logger) -> None:
    """Download and unpack the experiment's context directory, then chdir
    in: user code submitted with the experiment becomes the working
    directory of the trial process, so the entrypoint import resolves
    against it."""
    ctx_url = os.environ.get("DTPU_CONTEXT_URL")
    master = os.environ.get("DTPU_MASTER_URL")
    if not ctx_url or not master:
        return
    import tempfile
    import time
    import urllib.request

    url = master.rstrip("/") + ctx_url
    # the context route requires auth: the allocation's session token
    headers = {}
    token = os.environ.get("DTPU_SESSION_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = None
    for attempt in range(4):
        try:
            req = urllib.request.Request(url, headers=headers)
            with _tls_urlopen(req, timeout=60) as resp:
                data = resp.read()
            break
        except Exception as e:  # noqa: BLE001 - transient master hiccups
            if attempt == 3:
                raise RuntimeError(f"context download failed from {url}: {e}") from e
            logger.warning("context download attempt %d failed (%s); retrying", attempt + 1, e)
            time.sleep(2 * (attempt + 1))
    workdir = tempfile.mkdtemp(
        prefix=f"dtt-ctx-{os.environ.get('DTPU_ALLOCATION_ID', 'alloc')}-"
    )
    from determined_tpu_torch.common.context import extract_context

    extract_context(data, workdir)
    os.chdir(workdir)
    logger.info("context: unpacked %d bytes into %s", len(data), workdir)


# set by _install_log_shipper; called before the exit self-report so the
# final lines land at the master before the trial record goes terminal
_log_shipper_flush = None


def _install_log_shipper() -> None:
    """Ship this process's stdout/stderr to the master's ``/api/v1/logs``.

    Agent-launched trials have the agent read their pipe and relay;
    external-RM jobs (``DTPU_SHIP_LOGS``) have no agent, so the trial ships
    its own output.  fd-level dup2, so subprocess and native writes are
    captured, not just Python-level prints.  Batches carry a sequence
    number per allocation, so a resent batch is dropped by the master."""
    master = os.environ.get("DTPU_MASTER_URL")
    trial_id = os.environ.get("DTPU_TRIAL_ID")
    task_id = os.environ.get("DTPU_TASK_ID")
    if not master or not (trial_id or task_id):
        return
    import threading
    import time
    import urllib.request

    token = os.environ.get("DTPU_SESSION_TOKEN", "")
    agent = os.environ.get("DTPU_AGENT_ID", "external")
    url = master.rstrip("/") + "/api/v1/logs"

    read_fd, write_fd = os.pipe()
    os.dup2(write_fd, 1)
    os.dup2(write_fd, 2)
    os.close(write_fd)
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)

    batch: list = []
    batch_lock = threading.Lock()
    # bound memory while the master is unreachable: keep the newest lines
    max_buffered = 10000

    seq = [0]
    pending: list = []  # last unacknowledged batch; resent verbatim
    flush_lock = threading.Lock()  # sender thread vs the exit-path flush
    alloc_id = os.environ.get("DTPU_ALLOCATION_ID", "")

    def post(lines, batch_seq) -> bool:
        payload = {"agent": agent, "lines": lines,
                   "allocation_id": alloc_id, "batch_seq": batch_seq}
        if trial_id:
            payload["trial_id"] = int(trial_id)
        else:
            payload["task_id"] = task_id
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={
                "Authorization": f"Bearer {token}",
                "Content-Type": "application/json",
            },
        )
        try:
            with _tls_urlopen(req, timeout=10) as resp:
                resp.read()
            return True
        except Exception:  # noqa: BLE001 - retried by the next flush
            return False

    def flush() -> None:
        # a failed batch is resent as-is (same lines, same seq) before any
        # new lines ship, so the master's dedup stays exact; one batch in
        # flight per seq (sender thread vs exit-path flush)
        with flush_lock:
            if pending:
                if not post(pending, seq[0]):
                    return  # master still unreachable; new lines wait
                pending.clear()
                seq[0] += 1
            with batch_lock:
                lines, batch[:] = batch[:], []
            if lines:
                if post(lines, seq[0]):
                    seq[0] += 1
                else:
                    pending[:] = lines[-max_buffered:]

    def pump() -> None:
        # reader only: never blocks on the network, so a master outage
        # cannot back-pressure the training process's writes to fd 1/2
        partial = b""
        while True:
            try:
                chunk = os.read(read_fd, 8192)
            except OSError:
                break
            if not chunk:
                break
            partial += chunk
            while b"\n" in partial:
                line, partial = partial.split(b"\n", 1)
                with batch_lock:
                    batch.append(line.decode("utf-8", "replace"))
                    if len(batch) > max_buffered:
                        del batch[: len(batch) - max_buffered]

    def sender() -> None:
        while True:
            time.sleep(0.5)
            flush()

    threading.Thread(target=pump, daemon=True, name="dtt-log-pump").start()
    threading.Thread(target=sender, daemon=True, name="dtt-log-shipper").start()
    global _log_shipper_flush
    _log_shipper_flush = flush


def _warm_start_extended_length(max_length, logger):
    """PBT exploit clones: the master seeds the trial with its parent's
    checkpoint and advertises the inherited step count
    (``DTPU_WARM_START_STEPS``); same horizon rule as the local driver."""
    from determined_tpu_torch.config.experiment import clone_extended_length

    warm = int(os.environ.get("DTPU_WARM_START_STEPS", "0") or 0)
    return clone_extended_length(max_length, warm, logger, context="warm-start ")


def _self_report_exit(code: int) -> None:
    """POST this process's exit to the trials API (external-RM jobs; an
    agent-launched trial's exit is reported by the agent)."""
    master = os.environ.get("DTPU_MASTER_URL")
    trial_id = os.environ.get("DTPU_TRIAL_ID")
    task_id = os.environ.get("DTPU_TASK_ID")
    if not master or not (trial_id or task_id):
        return
    import time
    import urllib.request

    if _log_shipper_flush is not None:
        time.sleep(0.6)  # let the pump drain fds 1/2
        _log_shipper_flush()
    body = json.dumps(
        {"exit_code": code, "allocation_id": os.environ.get("DTPU_ALLOCATION_ID", "")}
    ).encode()
    path = (
        f"/api/v1/trials/{trial_id}/exit" if trial_id else f"/api/v1/tasks/{task_id}/exit"
    )
    req = urllib.request.Request(
        master.rstrip("/") + path,
        data=body,
        headers={
            "Authorization": f"Bearer {os.environ.get('DTPU_SESSION_TOKEN', '')}",
            "Content-Type": "application/json",
        },
    )
    try:
        with _tls_urlopen(req, timeout=10) as resp:
            resp.read()
    except Exception:  # noqa: BLE001 - the master's poll catches silent deaths
        pass


class TrialSupervisor:
    """Supervised trial execution: one attempt = one fresh ``Trainer``
    driven through ``fit``; failures are classified (``utils/errors.py``)
    and TRANSIENT ones re-enter ``fit(latest_checkpoint=...)`` from the
    newest FINALIZED checkpoint with exponential backoff, up to the
    experiment's ``max_restarts``.

    Restart counts go to ``metrics`` (an object with ``report(group,
    steps_completed, metrics)``, group ``restarts``) when one is given.
    """

    def __init__(
        self,
        trainer_factory,
        *,
        policy=None,
        metrics=None,
        master_unreachable=None,
        sleep=None,
    ) -> None:
        self._trainer_factory = trainer_factory
        self._policy = policy
        self._metrics = metrics
        self._master_unreachable = master_unreachable
        self._sleep = sleep
        self._trainer = None
        self.restarts = 0

    def run(self, max_length, *, latest_checkpoint=None, **fit_kwargs):
        import time

        from determined_tpu_torch.train._restart import RestartPolicy, run_with_restarts

        policy = self._policy or RestartPolicy()
        logger = logging.getLogger("determined_tpu_torch.exec.supervisor")

        def attempt(latest):
            self._trainer = self._trainer_factory()
            return self._trainer.fit(
                max_length, latest_checkpoint=latest, **fit_kwargs
            )

        def get_latest_checkpoint():
            return self._trainer.latest_checkpoint if self._trainer is not None else None

        def on_failure(att) -> None:
            self.restarts = att.restarts
            unreachable = bool(self._master_unreachable and self._master_unreachable())
            if unreachable:
                logger.warning(
                    "master unreachable (heartbeat streak latched) while handling "
                    "trial failure; restart decisions proceed locally"
                )
            if self._metrics is not None:
                steps = self._trainer.steps_completed if self._trainer is not None else 0
                try:
                    self._metrics.report(
                        "restarts",
                        steps,
                        {
                            "restarts": att.restarts,
                            "failure_kind": att.kind.value,
                            "error": repr(att.exc),
                            "resume_checkpoint": att.latest_checkpoint,
                            "backoff_seconds": att.delay,
                            "master_unreachable": unreachable,
                        },
                    )
                except Exception:  # noqa: BLE001 - reporting must not mask the failure
                    logger.exception("failed to report restart metrics")

        return run_with_restarts(
            attempt,
            policy=policy,
            initial_checkpoint=latest_checkpoint,
            get_latest_checkpoint=get_latest_checkpoint,
            on_failure=on_failure,
            sleep=self._sleep or time.sleep,
        )


class _RankPrefixStream:
    """Line-wise rank prefixer over a text stream, so a multi-node gang's
    interleaved logs stay attributable after the agent ships them."""

    def __init__(self, stream, prefix: str) -> None:
        self._stream = stream
        self._prefix = prefix
        self._at_line_start = True

    def write(self, text: str) -> int:
        out = []
        for chunk in text.splitlines(keepends=True):
            if self._at_line_start:
                out.append(self._prefix)
            out.append(chunk)
            self._at_line_start = chunk.endswith("\n")
        self._stream.write("".join(out))
        return len(text)

    def flush(self) -> None:
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


def _check_lint(lint_cfg, logger) -> None:
    """The lint knobs: raise for those that need the lint package."""
    from determined_tpu_torch.train._trainer import _LATER

    cseq_env = os.environ.get("DTPU_COLLECTIVE_SENTINEL")
    cseq_on = lint_cfg.collective_sentinel if cseq_env in (None, "") else cseq_env != "0"
    asked = [name for name, on in (
        ("lint.strict", lint_cfg.strict), ("lint.retrace_sentinel", lint_cfg.retrace_sentinel),
        ("lint.collective_sentinel", cseq_on), ("lint.thread_sentinel", lint_cfg.thread_sentinel),
    ) if on]
    if asked:
        raise NotImplementedError(
            f"{' / '.join(asked)} need the lint package, which is not ported to "
            f"determined_tpu_torch yet; {_LATER}"
        )
    if lint_cfg.preflight:
        logger.info("preflight: the lint package is not ported yet; the trial runs unchecked")


def elastic_num_slices(exp_config: Any, logger: Any = None) -> Any:
    """JAX run_trial's elastic reshard: under ``resources.elastic`` the
    master stamps each launch with the number of slices its gang spans
    (``DTPU_NUM_SLICES``), and the mesh's ``num_slices`` (never a wildcard)
    takes it before any mesh is built; the wildcard axis then absorbs the
    placed width (``DTPU_ELASTIC_SLOTS`` ranks) when the mesh resolves
    against the world.  Without the stamp or the policy the configuration
    is returned as it is."""
    stamped = os.environ.get("DTPU_NUM_SLICES")
    if not stamped or exp_config.resources.elastic is None:
        return exp_config
    mesh = exp_config.resources.mesh
    if mesh.num_slices == int(stamped):
        return exp_config
    if logger is not None:
        logger.info("elastic: mesh num_slices %d -> %s for this allocation "
                    "(placed width %s slots)", mesh.num_slices, stamped,
                    os.environ.get("DTPU_ELASTIC_SLOTS", "?"))
    return dataclasses.replace(exp_config, resources=dataclasses.replace(
        exp_config.resources, mesh=dataclasses.replace(mesh, num_slices=int(stamped))))


def main() -> int:
    # external-RM jobs ship their own logs; fd redirect must precede any
    # output (and the rank prefixer, which wraps whatever stdout is)
    if os.environ.get("DTPU_SHIP_LOGS"):
        _install_log_shipper()
    slots = int(os.environ.get("DTPU_NUM_SLOTS", "1") or 1)
    if (slots > 1 and "DTPU_LOCAL_RANK" not in os.environ
            and not os.environ.get("DTPU_TASK_TYPE")):
        # a node of several slots: one local rank process a slot
        return run_local_ranks([sys.executable, "-m", RUN_TRIAL, *sys.argv[1:]], slots)
    # per-rank prefix BEFORE logging configures its handlers
    rdzv_early = os.environ.get("DTPU_RENDEZVOUS")
    if rdzv_early:
        try:
            info_early = json.loads(rdzv_early)
            if int(info_early.get("num_nodes", 1)) * slots > 1:
                rank = (int(info_early.get("node_rank", 0)) * slots
                        + int(os.environ.get("DTPU_LOCAL_RANK", "0")))
                prefix = f"[rank={rank}] "
                sys.stdout = _RankPrefixStream(sys.stdout, prefix)
                sys.stderr = _RankPrefixStream(sys.stderr, prefix)
        except Exception:  # noqa: BLE001 - malformed rendezvous fails later
            pass
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    )
    logger = logging.getLogger("determined_tpu_torch.exec")
    if os.environ.get("DTPU_TASK_TYPE"):
        # a task placed on an external-RM pool runs the same entry as
        # trials: dispatch to the port's counterpart of the task module
        # (the launcher's mapping); a module the port lacks is refused,
        # never imported in its place
        from determined_tpu_torch.exec.launcher import port_module

        named = os.environ.get("DTPU_TASK_MODULE", "")
        mapped = port_module(named)
        if mapped is None or mapped == RUN_TRIAL:
            print(f"run_trial: task module {named!r} has no counterpart in "
                  "determined_tpu_torch; refusing to run it", file=sys.stderr)
            return 2
        return int(importlib.import_module(mapped).main() or 0)
    if len(sys.argv) < 2 or ":" not in sys.argv[1]:
        print("usage: python -m determined_tpu_torch.exec.run_trial pkg.module:TrialClass")
        return 2

    _apply_environment_early()

    import time

    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch._device import task_device
    from determined_tpu_torch.config.experiment import ExperimentConfig, Length
    from determined_tpu_torch.core._cluster_info import get_cluster_info
    from determined_tpu_torch.exec.gang_rank import launch_counts
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.train._restart import RestartPolicy

    cluster = get_cluster_info()
    if cluster is None:
        print("run_trial requires DTPU_* env (set by the agent)")
        return 2
    exp_config = elastic_num_slices(ExperimentConfig.parse(cluster.exp_config or {}), logger)
    _check_lint(exp_config.lint, logger)

    device = task_device(logger)

    module_name, _, class_name = sys.argv[1].partition(":")
    _prepare_context(logger)
    sys.path.insert(0, os.getcwd())
    trial_cls = getattr(importlib.import_module(module_name), class_name)

    obs = exp_config.observability
    tracer = get_tracer()
    tracer.configure(
        enabled=obs.enabled,
        ring_capacity=obs.ring_capacity,
        flush_interval=obs.flush_interval_s,
        max_events=obs.max_events,
        out_dir=(
            os.path.join(os.getcwd(), "traces", f"trial_{cluster.trial_id or 0}")
            if obs.enabled and obs.trace_export
            else None
        ),
    )
    if obs.enabled:
        tracer.start()

    # join the gang's rendezvous before touching the device; the wait is a
    # rendezvous.wait span, so the goodput ledger attributes setup time
    info = cluster.rendezvous or {}
    rdzv_t0 = time.monotonic()
    gang = int(info.get("num_nodes", 1)) * slots > 1
    if gang:
        logger.info(
            "rendezvous: joining as node %s/%s (%d local rank(s), this one %s) via "
            "coordinator %s", info["node_rank"], info["num_nodes"], slots,
            os.environ.get("DTPU_LOCAL_RANK", "0"), info["coordinator"],
        )
    core_ctx = core.init(device=device)
    if gang:
        logger.info("rendezvous: joined in %.1fs (%s, world %d)", time.monotonic() - rdzv_t0,
                    core_ctx.distributed.backend, core_ctx.distributed.size)
        if obs.enabled:
            tracer.record_span(
                "rendezvous.wait", "rendezvous", rdzv_t0, time.monotonic(),
                {"coordinator": info.get("coordinator"), "num_nodes": info.get("num_nodes"),
                 "node_rank": info.get("node_rank")},
            )
    try:
        # expconf-driven profiling: the system sampler and an optional
        # torch.profiler window into shared checkpoint storage
        prof = exp_config.profiling or {}
        if prof.get("enabled"):
            core_ctx.profiler.on(sampling=True, trace=bool(prof.get("trace", False)))

        def make_trainer():
            # one fresh Trainer per attempt: its state re-inits and the
            # checkpoint restore overwrites it
            ctx = train.init(
                hparams=cluster.hparams,
                exp_config=exp_config,
                core_context=core_ctx,
                seed=cluster.trial_seed,
                device=device,
            )
            return train.Trainer(trial_cls(ctx))

        scfg = exp_config.searcher
        max_length = scfg.max_length or exp_config.min_validation_period
        if max_length is None:
            max_length = Length.batches(scfg.max_time or 100)
        max_length = _warm_start_extended_length(max_length, logger)
        supervisor = TrialSupervisor(
            make_trainer,
            policy=RestartPolicy.from_exp_config(exp_config),
            metrics=core_ctx.metrics,
            master_unreachable=lambda: core_ctx.master_unreachable,
        )
        with tracer.span("trial.run", cat="trial", trial=cluster.trial_id):
            summary = supervisor.run(
                max_length,
                validation_period=exp_config.min_validation_period,
                checkpoint_period=exp_config.min_checkpoint_period,
                latest_checkpoint=cluster.latest_checkpoint,
                checkpoint_policy=exp_config.checkpoint_policy,
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logger.info(
            "trial finished: %s (restarts=%d)", summary, summary.get("restarts", 0)
        )
        logger.info("kernel launches: %s", json.dumps(launch_counts(), sort_keys=True))
        return 0
    finally:
        core_ctx.close()
        tracer.stop()
        if obs.enabled and obs.trace_export:
            try:
                tracer.export_chrome_trace(
                    os.path.join(
                        os.getcwd(), "traces", f"trial_{cluster.trial_id or 0}",
                        "trace.json",
                    )
                )
            except Exception:  # noqa: BLE001 - export must not mask the run
                logger.exception("trace export failed")


if __name__ == "__main__":
    try:
        _code = main()
    except SystemExit as e:
        # preserve sys.exit semantics: None = success, str = failure with
        # the message on stderr
        if e.code is None or isinstance(e.code, int):
            _code = e.code or 0
        else:
            print(e.code, file=sys.stderr)
            _code = 1
    except BaseException:  # noqa: BLE001 - report the crash
        import traceback

        traceback.print_exc()
        _code = 1
    if os.environ.get("DTPU_SELF_REPORT_EXIT"):
        _self_report_exit(_code)
    sys.exit(_code)
