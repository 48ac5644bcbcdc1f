"""Command line of the port: the experiment, search, cluster, serving,
registry and fleet verbs of ``determined_tpu/cli/main.py``.

    python -m determined_tpu_torch.cli run-local CONFIG pkg.module:TrialClass \\
        [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli [-m URL] experiment run CONFIG [ENTRYPOINT] \\
        [--cluster] [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli [-m URL] experiment resume DIR [--entrypoint E]
    python -m determined_tpu_torch.cli experiment status DIR [--json]
    python -m determined_tpu_torch.cli experiment profile DIR [--json] [--trace-dir DIR]
    python -m determined_tpu_torch.cli searcher simulate [-c CONFIG] [--methods M,...] \\
        [--seed N] [--period N] [--journal PATH] [--json]
    python -m determined_tpu_torch.cli preview-search CONFIG [--native]
    python -m determined_tpu_torch.cli cluster up [--agents N] [--slots N] [--gpus]
    python -m determined_tpu_torch.cli [-m URL] serve [CHECKPOINT | --model NAME@VERSION]
    python -m determined_tpu_torch.cli [-m URL] model create|list|show|register|promote|pull|
        deploy|register-version ...
    python -m determined_tpu_torch.cli [-m URL] fleet set NAME@VERSION --target N [--env K=V]
    python -m determined_tpu_torch.cli [-m URL] fleet status [--json]
    python -m determined_tpu_torch.cli [-m URL] master info

The search runs in this process on the GPU (it raises without one; the
Python API takes ``device="cpu"`` for small runs).  With ``--cluster`` the
searcher runs here and every trial is submitted to the master at ``-m``
(``$DTPU_MASTER``), whose agents run it through the port's launcher
(``ClusterExperiment``); the session comes from ``api.authentication``
(``DTPU_TOKEN``, the cached token, else a login as ``-u``).  ``experiment
resume`` of a directory whose journal records a master re-attaches to it.
``cluster up`` builds the native master and agent from ``native/`` at first
use and runs a master with N agents, each agent's trials in the port (with
``--gpus``, one GPU an agent).  Exit code 0: the experiment finished; 75:
it was preempted and ``experiment resume`` carries it on.  ``experiment status`` digests a local experiment's journal and
``experiment profile`` prints its goodput ledger (from the traces that
``observability.trace_export`` writes) and the op table of a
``torch.profiler`` window (``--trace-dir``, where the JAX CLI takes
``--xplane``); both exit 2 when there is nothing to read.
``searcher simulate`` and ``preview-search`` run no trial and need no
device: they replay search methods against curve models (``--native`` asks
the master's C++ searcher, ``dtpu-master --simulate``, built from
``native/``).

The master verbs (``serve``, ``model``, ``fleet``, ``master``) go through
the SDK (``determined_tpu_torch.client``) and keep the JAX CLI's arguments,
output lines and exit codes; an error answer of the master exits 1.
``serve`` loads its checkpoint on the GPU (``DTPU_TORCH_DEVICE`` names
another device, as for a cluster trial) and drains on SIGTERM/SIGINT or a
rolling deploy, then exits 75.  ``fleet set`` hands the master a replica
count of a registry version: its supervisor launches each replica as an
agent task, which the port's launcher runs as ``exec/serve_replica``
(``--env DTPU_TORCH_DEVICE=cpu`` serves on the CPU).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Any, Dict, List, Optional


def _print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True, default=str))


def _table(rows: List[Dict[str, Any]], cols: List[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
    print("  ".join(c.upper().ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


def _trial_class(entrypoint: str) -> type:
    module_name, _, class_name = entrypoint.partition(":")
    sys.path.insert(0, os.getcwd())
    return getattr(importlib.import_module(module_name), class_name)


def _session(args, master: Optional[str] = None):
    """An authenticated session to the master (``-m``, else ``master``,
    else ``$DTPU_MASTER``)."""
    from determined_tpu_torch.api.authentication import ensure_session

    url = getattr(args, "master", None) or master or os.environ.get("DTPU_MASTER")
    if not url:
        raise SystemExit("error: no master: pass -m URL or set DTPU_MASTER")
    return ensure_session(url, getattr(args, "user", None))


def exp_run(args) -> int:
    """Drive a search from this process: its trials in this process
    (LocalExperiment), or with ``--cluster`` on the master's agents
    (ClusterExperiment)."""
    from determined_tpu_torch.config.experiment import ExperimentConfig
    from determined_tpu_torch.experiment import PREEMPTED_EXIT_CODE, LocalExperiment

    cfg = ExperimentConfig.from_yaml(args.config)
    entrypoint = getattr(args, "entrypoint", None) or cfg.entrypoint
    if not entrypoint:
        print(
            "error: no entrypoint (pass pkg.module:TrialClass or set `entrypoint:` in the config)",
            file=sys.stderr,
        )
        return 2
    if getattr(args, "cluster", False):
        from determined_tpu_torch.experiment import ClusterExperiment

        summary = ClusterExperiment(cfg, entrypoint, session=_session(args),
                                    checkpoint_dir=args.checkpoint_dir).run()
    else:
        lexp = LocalExperiment(cfg, _trial_class(entrypoint), checkpoint_dir=args.checkpoint_dir)
        summary = lexp.run()
    _print_json(summary)
    # 75 (EX_TEMPFAIL): drained to checkpoints (local) or detached from
    # the running gangs (cluster); `experiment resume DIR` finishes it
    return PREEMPTED_EXIT_CODE if summary.get("status") == "preempted" else 0


# `run-local` predates `experiment run`
run_local = exp_run


def exp_resume_local(args) -> int:
    """Resume a crashed or preempted experiment from its journal, which
    records the configuration and the trial entrypoint.  A journal with a
    ``cluster_attached`` record resumes as a ClusterExperiment: the driver
    re-attaches to its master experiment (``-m`` overrides the journaled
    master url)."""
    from determined_tpu_torch.config.experiment import ExperimentConfig
    from determined_tpu_torch.experiment import (
        PREEMPTED_EXIT_CODE,
        ClusterExperiment,
        ExperimentJournalError,
        LocalExperiment,
        journal_path,
        read_journal,
    )

    try:
        replay = read_journal(journal_path(args.checkpoint_dir))
    except ExperimentJournalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if replay.status == "completed":
        print("experiment already completed; nothing to resume")
        return 0
    started = replay.started or {}
    entrypoint = args.entrypoint or started.get("entrypoint")
    if not entrypoint:
        print(
            "error: journal records no trial entrypoint; pass --entrypoint pkg.module:TrialClass",
            file=sys.stderr,
        )
        return 2
    if not started.get("config"):
        print("error: journal records no experiment config", file=sys.stderr)
        return 2
    cfg = ExperimentConfig.parse(started["config"])
    try:
        if replay.cluster is not None:
            exp = ClusterExperiment(
                cfg, entrypoint,
                session=_session(args, replay.cluster.get("master_url")),
                checkpoint_dir=args.checkpoint_dir, seed=started.get("seed"),
            )
            summary = exp.resume()
        else:
            lexp = LocalExperiment(
                cfg, _trial_class(entrypoint), checkpoint_dir=args.checkpoint_dir,
                seed=started.get("seed"),
            )
            summary = lexp.resume()
    except ExperimentJournalError as e:
        # e.g. the original driver is still alive and owns the journal
        print(f"error: {e}", file=sys.stderr)
        return 2
    _print_json(summary)
    return PREEMPTED_EXIT_CODE if summary.get("status") == "preempted" else 0


def exp_status_local(args) -> int:
    """Digest a local experiment's journal: what completed, what is in
    flight, whether the directory is resumable."""
    from determined_tpu_torch.experiment import ExperimentJournalError, experiment_status

    try:
        st = experiment_status(args.checkpoint_dir)
    except ExperimentJournalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        _print_json(st)
        return 0
    print(f"experiment:  {st['name'] or '(unnamed)'}")
    print(f"status:      {st['status']}" + ("  (resumable)" if st["resumable"] else ""))
    print(f"entrypoint:  {st['entrypoint'] or '(unknown)'}")
    if st.get("cluster"):
        # a cluster experiment's journal: name the master it is attached to
        print(
            f"cluster:     experiment {st['cluster']['experiment_id']} "
            f"at {st['cluster']['master_url']}"
        )
    print(
        f"trials:      {st['trials_completed']} completed, "
        f"{st['trials_in_flight']} in flight, {st['trials_created']} created"
    )
    _table(
        [
            {
                "trial": t["request_id"],
                "state": t["state"],
                "steps": t["steps_completed"] if t["steps_completed"] is not None else "",
                "checkpoint": t["checkpoint"] or "",
            }
            for t in st["trials"]
        ],
        ["trial", "state", "steps", "checkpoint"],
    )
    return 0


def exp_profile_local(args) -> int:
    """Goodput ledger of a local experiment directory: where every second
    of wall-clock went.  Reads the Chrome trace events exported under
    ``<dir>/traces/`` (``observability.trace_export: true``); the
    ``torch.profiler`` windows under ``--trace-dir`` (default
    ``<dir>/traces/torch_profiler``) add the device's op table, so the
    host timeline can be checked against device truth."""
    from determined_tpu_torch.observability import (
        compute_ledger,
        format_ledger_text,
        load_trace_events,
    )

    traces_dir = os.path.join(args.checkpoint_dir, "traces")
    events = load_trace_events(traces_dir)
    if not events:
        print(
            f"error: no trace events under {traces_dir} (run the experiment "
            "with observability.trace_export: true)",
            file=sys.stderr,
        )
        return 2
    ledger = compute_ledger(events)

    # optional device-side cross-check: torch.profiler windows
    # (profiling.trace) folded into an op table by utils/kineto.py
    device_summary = None
    trace_dir = args.trace_dir or os.path.join(traces_dir, "torch_profiler")
    if args.trace_dir and not os.path.isdir(args.trace_dir):
        # an explicit request that cannot be honoured must not be silent
        # (the default-path probe, by contrast, is best-effort)
        print(f"warning: --trace-dir {args.trace_dir} is not a directory", file=sys.stderr)
    if os.path.isdir(trace_dir):
        try:
            from determined_tpu_torch.utils import kineto

            ops = kineto.op_table(trace_dir)
            coll, other = kineto.split_collectives(ops)
            device_summary = {
                "top_ops": ops[:10],
                "category_totals": kineto.category_totals(ops),
                "collective_us": coll,
                "compute_us": other,
            }
        except Exception as e:  # noqa: BLE001 - best effort
            device_summary = {"error": str(e)}

    if args.json:
        out = {"ledger": ledger}
        if device_summary is not None:
            out["torch_profiler"] = device_summary
        _print_json(out)
        return 0
    print(format_ledger_text(ledger))
    if device_summary and "category_totals" in device_summary:
        print("\ntorch.profiler device-time categories (us):")
        for cat, us in list(device_summary["category_totals"].items())[:8]:
            print(f"  {cat:<24} {us:>12.1f}")
    return 0


# ---- searcher simulation (trial-free; no device) ------------------------------


def searcher_simulate(args) -> int:
    """Replay search methods against a seeded learning-curve model and
    print a best-metric-vs-budget table: method choice and bracket/
    population math in milliseconds, no device time."""
    from determined_tpu_torch import searcher as searcher_mod
    from determined_tpu_torch.config.experiment import ExperimentConfig, InvalidExperimentConfig
    from determined_tpu_torch.experiment.journal import ExperimentJournalError, journal_path

    if args.config:
        cfg = ExperimentConfig.from_yaml(args.config)
    else:
        # built-in lr-search space, matched to the synthetic curve model
        cfg = ExperimentConfig.parse(
            {
                "name": "searcher-simulate",
                "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
                "searcher": {
                    "name": "random",
                    "metric": "validation_loss",
                    "max_trials": 16,
                    "max_time": 64,
                    "num_rungs": 3,
                    "divisor": 4,
                },
            }
        )
    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    try:
        if args.journal:
            path = args.journal
            if os.path.isdir(path):
                path = journal_path(path)
            model = searcher_mod.JournalCurveModel.from_journal(
                path, cfg.searcher.metric, cfg.searcher.time_metric or "batches"
            )
        else:
            model = searcher_mod.SyntheticCurveModel(args.seed)
        reports = searcher_mod.compare_methods(
            cfg, methods, model, seed=args.seed, report_period=args.period
        )
    except (InvalidExperimentConfig, ExperimentJournalError, ValueError) as e:
        # covers unknown methods AND a missing/empty --journal
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        _print_json(
            [
                {
                    "method": r.method,
                    "seed": r.seed,
                    "trials_created": r.trials_created,
                    "total_units": r.total_units,
                    "best_metric": r.best_metric,
                    "best_trial": r.best_trial,
                    "best_hparams": r.best_hparams,
                    "curve": r.curve[-32:],
                    "lineage": {str(k): v for k, v in r.lineage.items() if v is not None},
                }
                for r in reports
            ]
        )
        return 0
    print(searcher_mod.format_comparison(reports))
    return 0


def cluster_up(args) -> int:
    """A master and N agents on this host, each agent's trials run by the
    port (``devcluster.LocalCluster``); the binaries are built from
    ``native/`` at first use.  Runs until Ctrl-C or a process exits."""
    import time

    from determined_tpu_torch import devcluster

    built = devcluster.build_binaries()
    if built:
        print(f"built dtpu-master and dtpu-agent in {built:.1f} s")
    gpus = None
    if args.gpus:
        import torch

        gpus = [str(i) for i in range(torch.cuda.device_count())][: args.agents]
        if len(gpus) < args.agents:
            print(f"error: --gpus with {args.agents} agents needs {args.agents} GPUs, "
                  f"found {len(gpus)}", file=sys.stderr)
            return 2
    cluster = devcluster.LocalCluster(
        args.state_dir, args.checkpoint_dir, agents=args.agents,
        slots=1 if gpus is not None else args.slots, gpus=gpus, port=args.port,
        scheduler=args.scheduler,
    )
    try:
        cluster.start()
        per = "1 GPU" if gpus is not None else f"{args.slots} slot(s)"
        print(f"cluster up: master {cluster.url}, {args.agents} agent(s) x {per}, "
              f"trials run by determined_tpu_torch (logs under {cluster.log_dir})", flush=True)
        print("Ctrl-C to tear down", flush=True)
        while cluster.alive():
            time.sleep(1)
        print("a cluster process exited; tearing down", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        cluster.stop()


def _client(args):
    from determined_tpu_torch.client import Determined

    url = args.master or os.environ.get("DTPU_MASTER", "http://127.0.0.1:8080")
    # --cert rides the env so every Session picks it up without threading
    # it through each constructor
    if getattr(args, "cert", None):
        os.environ["DTPU_MASTER_CERT"] = args.cert
    return Determined(url, user=getattr(args, "user", None) or None)


# ---- model registry ---------------------------------------------------------


def model_create(args) -> int:
    m = _client(args).create_model(args.name, description=args.description or "")
    print(f"created model {m.name}")
    return 0


def model_list(args) -> int:
    rows = []
    for m in _client(args).get_models():
        versions = m.get("versions") or []
        latest = max((int(v.get("version") or 0) for v in versions), default=0)
        rows.append(
            {
                "name": m.name,
                "versions": len(versions),
                "latest": f"v{latest}" if latest else "-",
            }
        )
    _table(rows, ["name", "versions", "latest"])
    return 0


def model_show(args) -> int:
    model = _client(args).get_model(args.name).to_dict()
    if args.json:
        _print_json(model)
        return 0
    print(f"model {model['name']}")
    if model.get("labels"):
        print(f"  labels: {', '.join(model['labels'])}")
    for v in model.get("versions") or []:
        lineage = []
        if v.get("source_trial_id"):
            lineage.append(f"trial {v['source_trial_id']}")
        if v.get("source_experiment_id"):
            lineage.append(f"experiment {v['source_experiment_id']}")
        print(
            f"  v{v['version']}: checkpoint {v.get('checkpoint_uuid')}"
            + (f" ({', '.join(lineage)})" if lineage else "")
        )
        if v.get("storage_path"):
            print(f"      path: {v['storage_path']}")
        if v.get("metrics"):
            print(f"      metrics: {json.dumps(v['metrics'], sort_keys=True)}")
    return 0


def model_register(args) -> int:
    from determined_tpu_torch.experiment import registry as registry_mod

    metrics = {}
    for kv in args.metric or []:
        key, _, val = kv.partition("=")
        try:
            metrics[key] = float(val)
        except ValueError:
            metrics[key] = val
    v = registry_mod.register_version(
        _client(args).session,
        args.name,
        checkpoint_uuid=args.checkpoint_uuid,
        storage_path=args.storage_path,
        source_trial_id=args.trial_id,
        source_experiment_id=args.experiment_id,
        metrics=metrics or None,
        labels=args.label or None,
        version=args.version,
    )
    print(f"registered {args.name}@v{v['version']} "
          f"(checkpoint {v['checkpoint_uuid']})")
    return 0


def model_promote(args) -> int:
    from determined_tpu_torch.experiment import registry as registry_mod

    session = _client(args).session
    registry_mod.ensure_model(session, args.name)
    v = session.post(
        f"/api/v1/models/{args.name}/promote", json={"trial_id": args.trial_id}
    ).json()
    print(f"promoted trial {args.trial_id} -> {args.name}@v{v['version']} "
          f"(checkpoint {v['checkpoint_uuid']})")
    return 0


def model_pull(args) -> int:
    """Materialize a registry version's checkpoint locally: copy from its
    shared-storage path when this host can see it, else download through
    the master's checkpoint route."""
    import shutil as _shutil

    from determined_tpu_torch.experiment import registry as registry_mod

    client = _client(args)
    ver = registry_mod.resolve_version(client.session, args.ref)
    target = args.output or f"{ver['model']}-v{ver['version']}"
    src = ver.get("storage_path") or ""
    if os.path.isdir(src):
        if os.path.exists(target):
            print(f"error: {target} already exists", file=sys.stderr)
            return 2
        _shutil.copytree(src, target)
        print(target)
        return 0
    path = client.get_checkpoint(ver["checkpoint_uuid"]).download(target)
    print(path)
    return 0


def model_deploy(args) -> int:
    """Rolling deploy: walk the serving fleet one replica at a time onto
    a registry version (drain -> relaunch -> next; docs/registry.md).
    ``--canary F`` rolls only that cohort first and bakes it against the
    pre-roll error-rate/latency baseline before finishing the roll."""
    import time as _time

    from determined_tpu_torch.experiment import registry as registry_mod

    session = _client(args).session
    name, version = registry_mod.parse_model_ref(args.ref)
    body = {"model": name, "version": version}
    if args.canary is not None:
        body["canary_fraction"] = args.canary
        body["bake_seconds"] = args.bake_seconds
        body["min_requests"] = args.canary_min_requests
        if args.rollback_on_regression:
            body["rollback_on_regression"] = True
    state = session.post("/api/v1/serving/deploy", json=body).json()
    mode = ""
    canary = state.get("canary") or {}
    if canary.get("count"):
        mode = f" (canary cohort: {canary['count']})"
    print(f"deploy {state['id']}: rolling {state['target']} "
          f"over {len(state.get('pending') or [])} replica(s){mode}")
    if not args.wait:
        print(state["status"])
        return 0
    deadline = _time.time() + args.timeout
    phase = state.get("phase")
    while _time.time() < deadline:
        state = session.get("/api/v1/serving/deploy").json()
        if state.get("phase") != phase:
            phase = state.get("phase")
            print(f"deploy {state['id']}: phase {phase}")
        if state["status"] != "rolling":
            break
        _time.sleep(1.0)
    detail = f" ({state['detail']})" if state.get("detail") else ""
    print(f"deploy {state['id']}: {state['status']}{detail}")
    canary = state.get("canary") or {}
    if canary.get("verdict"):
        stat = f" — regressed stat: {canary['offending_stat']}" \
            if canary.get("offending_stat") else ""
        print(f"canary verdict: {canary['verdict']}{stat}")
    return 0 if state["status"] == "completed" else 1


# ---- serving fleet (master-side replica supervisor) -------------------------


def fleet_set(args) -> int:
    """Declare the fleet spec: the master's supervisor launches replicas
    as agent tasks and relaunches any that die (docs/serving.md)."""
    config = {}
    if args.slots is not None:
        config["resources"] = {"slots": args.slots}
    for kv in args.env or []:
        key, _, val = kv.partition("=")
        config.setdefault("env", {})[key] = val
    fleet = _client(args).set_serving_fleet(
        args.ref, args.target, pool=args.pool, config=config or None
    )
    print(f"fleet: {fleet['model']}@v{fleet['version']} "
          f"target {fleet['target']} ({fleet['status']})")
    return 0


def fleet_status(args) -> int:
    from determined_tpu_torch.api.session import NotFoundError

    try:
        fleet = _client(args).get_serving_fleet()
    except NotFoundError:
        print("no fleet spec declared", file=sys.stderr)
        return 1
    if args.json:
        _print_json(fleet)
        return 0
    detail = f" — {fleet['detail']}" if fleet.get("detail") else ""
    print(f"{fleet['model']}@v{fleet['version']} target {fleet['target']} "
          f"status {fleet['status']}{detail}")
    for slot in fleet.get("slots") or []:
        state = "gave-up" if slot.get("gave_up") else (
            "live" if slot.get("replica_id") else "launching")
        err = f" last_error={slot['last_error']!r}" if slot.get("last_error") else ""
        print(f"  slot {slot['index']}: {state} task={slot.get('task_id') or '-'} "
              f"replica={slot.get('replica_id') or '-'} "
              f"launches={slot.get('launches', 0)} "
              f"failures={slot.get('failures', 0)}{err}")
    return 0 if fleet["status"] != "degraded" else 1


def model_register_version(args) -> int:
    v = _client(args).get_model(args.name).register_version(args.checkpoint_uuid)
    print(f"registered {args.name} version {v.version}")
    return 0


def master_info(args) -> int:
    _print_json(_client(args).master_info())
    return 0


class _ServeSignalFlag:
    """Signal-handler-safe drain flag: a plain attribute write holds no
    lock (a handler that takes a lock can deadlock the thread it
    interrupted; same pattern as ``experiment/local.py _PreemptFlag``).
    The serve main loop polls it
    and runs the actual drain — which touches Events — on the main
    thread, never in handler context."""

    __slots__ = ("_flag",)

    def __init__(self) -> None:
        self._flag = False

    def set(self) -> None:
        self._flag = True

    def is_set(self) -> bool:
        return self._flag


def serve_cmd(args) -> int:
    """Run one online-serving replica from a trial checkpoint.

    Loads the checkpoint (``train.load_trial_from_checkpoint``) on the GPU
    (or the device ``DTPU_TORCH_DEVICE`` names, as a cluster trial reads
    it; without a GPU and without it this raises), and serves ``POST
    /v1/generate``
    (+ ``/healthz``, ``/stats``).  With ``--master`` the replica registers
    under ``/api/v1/serving`` and heartbeats until shutdown.  SIGTERM or
    SIGINT drains: new requests are rejected (503), queued + in-flight
    requests finish, and the process exits 75 (EX_TEMPFAIL) so a
    supervisor knows the stop was orderly, not a crash.

    ``--model name[@version|@latest]`` serves a registry version instead
    of a raw path: the checkpoint is resolved through the master
    (``docs/registry.md``), the replica's listing label becomes
    ``name@vN``, and the resolved version rides registration — which is
    also what lets a rolling deploy (``model deploy``) find and
    drain replicas on older versions.  A master-requested drain exits 75
    exactly like a signal drain.
    """
    import signal as _signal
    import time as _time

    from determined_tpu_torch._device import DEVICE_ENV
    from determined_tpu_torch.experiment import PREEMPTED_EXIT_CODE
    from determined_tpu_torch.serve import ServeConfig, ServeEngine, ServeWorker

    try:
        serve_cfg = ServeConfig(
            block_size=args.block_size,
            num_blocks=args.num_blocks,
            max_batch=args.max_batch,
            max_prompt_len=args.max_prompt_len,
            max_new_tokens=args.max_new_tokens,
            queue_depth=args.queue_depth,
            prefix_cache=args.prefix_cache,
            decode_chunk_blocks=args.decode_chunk_blocks,
            host=args.host,
            port=args.port,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    session = None
    if args.master or os.environ.get("DTPU_MASTER"):
        session = _client(args).session
    checkpoint = args.checkpoint
    model_name, model_version = "", 0
    if args.model:
        from determined_tpu_torch.experiment import registry as registry_mod

        if checkpoint:
            print("error: pass a checkpoint path OR --model, not both",
                  file=sys.stderr)
            return 2
        if session is None:
            print("error: --model resolves through the master "
                  "(pass -m/--master or set DTPU_MASTER)", file=sys.stderr)
            return 2
        try:
            ver = registry_mod.resolve_version(session, args.model)
        except Exception as e:  # noqa: BLE001 - CLI boundary
            print(f"error: {e}", file=sys.stderr)
            return 2
        model_name = ver["model"]
        model_version = int(ver["version"])
        checkpoint = ver.get("storage_path") or ""
        if not checkpoint or not os.path.isdir(checkpoint):
            print(f"error: {model_name}@v{model_version} resolves to "
                  f"storage path {checkpoint!r}, which is not a directory "
                  "on this host (serve replicas load via shared storage)",
                  file=sys.stderr)
            return 2
        print(f"resolved {args.model} -> {model_name}@v{model_version} "
              f"({checkpoint})", flush=True)
    elif not checkpoint:
        print("error: pass a checkpoint path or --model name@version",
              file=sys.stderr)
        return 2
    print(f"loading checkpoint {checkpoint} ...", flush=True)
    engine = ServeEngine.from_checkpoint(checkpoint, serve_cfg,
                                         device=os.environ.get(DEVICE_ENV) or None)
    # listing label precedence: explicit --model-name, then the registry
    # ref (name@vN), then the trial class name for raw-path launches
    if model_name:
        label = f"{model_name}@v{model_version}"
    else:
        label = args.model_name or engine.model_label
    worker = ServeWorker(
        engine,
        host=serve_cfg.host,
        port=serve_cfg.port,
        session=session,
        model=args.model_name or label,
        checkpoint=checkpoint,
        model_name=model_name,
        model_version=model_version,
    )
    url = worker.start()
    # the parseable contract scripts/tests rely on: one line, stable prefix
    print(f"serving on {url}", flush=True)

    drain_flag = _ServeSignalFlag()
    prev = {}

    def _on_signal(signum, frame):  # noqa: ARG001 - signal handler shape
        drain_flag.set()  # plain write: safe at any bytecode boundary

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        prev[sig] = _signal.signal(sig, _on_signal)
    try:
        while not drain_flag.is_set() and not worker.master_drain_requested():
            _time.sleep(0.2)
        if worker.master_drain_requested() and not drain_flag.is_set():
            target = worker.master_drain_info.get("target") or "?"
            print(f"deploy drain requested by master (target {target})",
                  flush=True)
        print("drain requested: rejecting new requests, finishing in-flight",
              flush=True)
        worker.request_drain()
        clean = worker.wait_drained(timeout=serve_cfg.drain_grace_s)
        worker.shutdown()
        print(f"drained ({'clean' if clean else 'grace expired'}); exiting",
              flush=True)
        return PREEMPTED_EXIT_CODE
    finally:
        for sig, handler in prev.items():
            _signal.signal(sig, handler)


def _find_binary(name: str) -> str:
    import shutil

    env = os.environ.get(f"DTPU_{name.upper().replace('-', '_')}_BIN")
    if env and os.path.exists(env):
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidate = os.path.join(here, "native", "build", name)
    if os.path.exists(candidate):
        return candidate
    found = shutil.which(name)
    if found:
        return found
    raise SystemExit(
        f"{name} not found: build with `cmake -S native -B native/build && "
        f"cmake --build native/build` or set DTPU_{name.upper().replace('-', '_')}_BIN"
    )


def preview_search(args) -> int:
    """What a config's search would do: trials created and units spent,
    over a synthetic trial (or the master's C++ searcher with --native)."""
    import yaml

    from determined_tpu_torch.config.experiment import ExperimentConfig
    from determined_tpu_torch.searcher import simulate

    with open(args.config) as f:
        raw = yaml.safe_load(f)
        cfg = ExperimentConfig.parse(raw)

    if getattr(args, "native", False):
        # drive the MASTER's C++ searcher (the parity twin of the Python
        # simulate below)
        import subprocess
        import tempfile

        master_bin = _find_binary("dtpu-master")
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(raw, f)
            cfg_path = f.name
        try:
            sim = subprocess.run(
                [master_bin, "--simulate", cfg_path], capture_output=True, text=True, timeout=120,
            )
        finally:
            os.unlink(cfg_path)
        if sim.returncode != 0:
            print(sim.stderr, file=sys.stderr)
            return 1
        native = json.loads(sim.stdout)
        out = {
            "trials_created": native["trials_created"],
            "total_units": native["total_units"],
            "trial_units": native["trial_units"],
        }
    else:
        # synthetic smooth trial: improves with budget, hp-independent
        out = simulate(cfg, lambda hp, step: 1.0 / (1 + step), seed=0)
    smaller = cfg.searcher.smaller_is_better
    print(f"searcher: {cfg.searcher.name} (metric {cfg.searcher.metric}, "
          f"{'min' if smaller else 'max'})")
    print(f"trials created:   {out['trials_created']}")
    print(f"total units:      {out['total_units']}")
    units = sorted(out["trial_units"].values())
    print(f"units per trial:  min {units[0]}, median {units[len(units)//2]}, "
          f"max {units[-1]}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m determined_tpu_torch.cli",
                                description="determined_tpu_torch CLI")
    p.add_argument("-m", "--master", help="master url (default $DTPU_MASTER)")
    p.add_argument("--cert", help="CA bundle for an https master (default $DTPU_MASTER_CERT)")
    p.add_argument("-u", "--user", help="user to log in as (default: the cached token's, "
                   "else determined)")
    sub = p.add_subparsers(dest="cmd", required=True)

    rl = sub.add_parser("run-local")
    rl.add_argument("config")
    rl.add_argument("entrypoint", help="pkg.module:TrialClass")
    rl.add_argument("--checkpoint-dir", default=None)
    rl.set_defaults(fn=run_local)

    exp = sub.add_parser("experiment").add_subparsers(dest="verb", required=True)
    rn = exp.add_parser("run", help="drive a search from this process")
    rn.add_argument("config")
    rn.add_argument(
        "entrypoint", nargs="?",
        help="pkg.module:TrialClass (default: `entrypoint:` in the config)",
    )
    rn.add_argument("--cluster", action="store_true",
                    help="submit the searcher's trials to the master (-m) for its agents "
                    "to run instead of running them in this process")
    rn.add_argument("--checkpoint-dir", default=None,
                    help="driver directory (journal and checkpoints; default "
                    "./local_experiment_checkpoints, or ./cluster_experiment_driver)")
    rn.set_defaults(fn=exp_run)
    rs = exp.add_parser("resume", help="resume a crashed/preempted experiment (a cluster "
                        "journal re-attaches to its master)")
    rs.add_argument("checkpoint_dir")
    rs.add_argument("--entrypoint", help="pkg.module:TrialClass (default: from the journal)")
    rs.set_defaults(fn=exp_resume_local)
    st = exp.add_parser("status", help="journal-backed status of a local experiment directory")
    st.add_argument("checkpoint_dir")
    st.add_argument("--json", action="store_true", help="machine-readable output")
    st.set_defaults(fn=exp_status_local)
    pf = exp.add_parser(
        "profile", help="goodput ledger + phase breakdown from a local experiment's traces"
    )
    pf.add_argument("checkpoint_dir")
    pf.add_argument("--json", action="store_true", help="machine-readable output")
    pf.add_argument(
        "--trace-dir",
        help="directory holding torch.profiler windows (default: <dir>/traces/torch_profiler)",
    )
    pf.set_defaults(fn=exp_profile_local)

    srch = sub.add_parser("searcher").add_subparsers(dest="verb", required=True)
    sim = srch.add_parser(
        "simulate",
        help="replay search methods against a learning-curve model (trial-free, deterministic)",
    )
    sim.add_argument("-c", "--config", help="experiment config yaml "
                     "(default: a built-in lr search space)")
    sim.add_argument("--methods", default="random,asha,hyperband,pbt",
                     help="comma-separated method names to compare")
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--period", type=int, default=0,
                     help="validation period in budget units (0 = per-method default)")
    sim.add_argument("--journal", help="replay recorded curves from an experiment journal "
                     "(file or checkpoint dir) instead of the synthetic model")
    sim.add_argument("--json", action="store_true")
    sim.set_defaults(fn=searcher_simulate)

    ps = sub.add_parser("preview-search")
    ps.add_argument("config")
    ps.add_argument("--native", action="store_true",
                    help="simulate with the master's C++ searcher")
    ps.set_defaults(fn=preview_search)

    cl = sub.add_parser("cluster").add_subparsers(dest="verb", required=True)
    cu = cl.add_parser("up", help="a master and N agents on this host, running the port's "
                       "trials")
    cu.add_argument("--port", type=int, default=8080)
    cu.add_argument("--agents", type=int, default=1)
    cu.add_argument("--slots", type=int, default=1)
    cu.add_argument("--gpus", action="store_true",
                    help="one GPU an agent (CUDA_VISIBLE_DEVICES), one slot each")
    cu.add_argument("--scheduler", default="priority", choices=["priority", "fair_share"])
    cu.add_argument("--state-dir", default=os.path.join(os.getcwd(), "dtt-cluster-state"))
    cu.add_argument("--checkpoint-dir", default=os.path.join(os.getcwd(),
                                                             "dtt-cluster-checkpoints"))
    cu.set_defaults(fn=cluster_up)

    model = sub.add_parser(
        "model", help="model registry: versioned checkpoints promoted from "
        "trials, served and rolled onto the fleet (docs/registry.md)"
    ).add_subparsers(dest="verb", required=True)
    mc = model.add_parser("create")
    mc.add_argument("name")
    mc.add_argument("--description")
    mc.set_defaults(fn=model_create)
    model.add_parser("list").set_defaults(fn=model_list)
    ms = model.add_parser("show", help="model + every version with lineage")
    ms.add_argument("name")
    ms.add_argument("--json", action="store_true")
    ms.set_defaults(fn=model_show)
    mg = model.add_parser(
        "register", help="register a checkpoint as the model's next version"
    )
    mg.add_argument("name")
    mg.add_argument("checkpoint_uuid")
    mg.add_argument("--storage-path",
                    help="checkpoint directory (required when the master "
                         "does not track this checkpoint)")
    mg.add_argument("--trial-id", type=int, help="source trial lineage")
    mg.add_argument("--experiment-id", type=int, help="source experiment lineage")
    mg.add_argument("--metric", action="append", metavar="KEY=VALUE",
                    help="metrics snapshot entry (repeatable)")
    mg.add_argument("--label", action="append", help="version label (repeatable)")
    mg.add_argument("--version", type=int,
                    help="pin an explicit version number (409 if taken)")
    mg.set_defaults(fn=model_register)
    mp = model.add_parser(
        "promote", help="promote a trial's latest checkpoint to the next "
        "version (the master resolves lineage + metrics)"
    )
    mp.add_argument("name")
    mp.add_argument("trial_id", type=int)
    mp.set_defaults(fn=model_promote)
    mpl = model.add_parser("pull", help="materialize a version's checkpoint locally")
    mpl.add_argument("ref", metavar="NAME[@VERSION]")
    mpl.add_argument("--output", help="target directory (default: NAME-vN)")
    mpl.set_defaults(fn=model_pull)
    md = model.add_parser(
        "deploy", help="rolling-deploy a version onto the serving fleet "
        "(drain one replica at a time; supervisors relaunch on the target)"
    )
    md.add_argument("ref", metavar="NAME[@VERSION]")
    md.add_argument("--no-wait", dest="wait", action="store_false",
                    help="start the roll and return immediately")
    md.add_argument("--timeout", type=float, default=600.0,
                    help="seconds to wait for the roll to finish")
    md.add_argument("--canary", type=float, metavar="FRACTION",
                    help="roll this fraction of the fleet first and bake "
                         "it against the pre-roll error-rate/latency "
                         "baseline before finishing the roll")
    md.add_argument("--bake-seconds", type=float, default=30.0,
                    help="canary bake window (default: 30)")
    md.add_argument("--canary-min-requests", type=int, default=1,
                    help="minimum canary-cohort requests before the bake "
                         "verdict counts (default: 1)")
    md.add_argument("--rollback-on-regression", action="store_true",
                    help="on a canary regression, roll the cohort back to "
                         "the prior version instead of holding")
    md.set_defaults(fn=model_deploy, wait=True)

    fleet = sub.add_parser(
        "fleet", help="supervised serving fleet: the master relaunches "
        "replicas that die to hold the declared target (docs/serving.md)"
    ).add_subparsers(dest="verb", required=True)
    fs = fleet.add_parser(
        "set", help="declare the fleet spec (model version + replica count)"
    )
    fs.add_argument("ref", metavar="NAME[@VERSION]")
    fs.add_argument("--target", type=int, required=True,
                    help="replica count the supervisor holds")
    fs.add_argument("--pool", help="resource pool for replica tasks")
    fs.add_argument("--slots", type=int, help="slots per replica task")
    fs.add_argument("--env", action="append", metavar="KEY=VALUE",
                    help="environment override for replica tasks (repeatable)")
    fs.set_defaults(fn=fleet_set)
    fst = fleet.add_parser("status", help="fleet spec + per-slot health")
    fst.add_argument("--json", action="store_true")
    fst.set_defaults(fn=fleet_status)
    mr = model.add_parser("register-version")
    mr.add_argument("name")
    mr.add_argument("checkpoint_uuid")
    mr.set_defaults(fn=model_register_version)

    master = sub.add_parser("master").add_subparsers(dest="verb", required=True)
    master.add_parser("info").set_defaults(fn=master_info)

    sv = sub.add_parser(
        "serve",
        help="run an online-serving replica from a trial checkpoint "
        "(docs/serving.md)",
    )
    sv.add_argument("checkpoint", nargs="?", default=None,
                    help="trial checkpoint directory to serve "
                         "(or use --model to resolve one via the registry)")
    sv.add_argument("--model", default=None, metavar="NAME[@VERSION]",
                    help="serve a registry model version resolved through "
                         "the master, e.g. lm@latest or lm@v3 "
                         "(docs/registry.md)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument(
        "--port", type=int, default=0,
        help="HTTP port (default 0: OS-assigned, printed at startup)",
    )
    sv.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV-cache block")
    sv.add_argument("--num-blocks", type=int, default=256,
                    help="KV-cache pool size in blocks")
    sv.add_argument("--max-batch", type=int, default=8,
                    help="decode lanes (max sequences in flight)")
    sv.add_argument("--max-prompt-len", type=int, default=128)
    sv.add_argument("--max-new-tokens", type=int, default=64)
    sv.add_argument("--queue-depth", type=int, default=16,
                    help="admission queue depth (full -> 429)")
    sv.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="share KV blocks across requests with a common "
                         "prompt prefix (default on; docs/serving.md)")
    sv.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable prefix sharing: every request prefills "
                         "private blocks")
    sv.add_argument("--decode-chunk-blocks", type=int, default=1,
                    help="lazy decode: gather the block table this many "
                         "columns per attention pass, skipping columns "
                         "past the longest live sequence (0 = legacy "
                         "full-table gather; must divide the table width)")
    sv.add_argument("--model-name", default=None,
                    help="label shown in the master's replica listing")
    sv.set_defaults(fn=serve_cmd)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    from determined_tpu_torch.api.session import APIError

    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except APIError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
