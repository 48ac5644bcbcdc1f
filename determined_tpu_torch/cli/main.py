"""Command line of the port: the experiment, search and cluster verbs of
``determined_tpu/cli/main.py``.

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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
