"""Command line of the port: the local experiment and search verbs of
``determined_tpu/cli/main.py``.

    python -m determined_tpu_torch.cli run-local CONFIG pkg.module:TrialClass \\
        [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli experiment run CONFIG [ENTRYPOINT] [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli experiment resume DIR [--entrypoint E]
    python -m determined_tpu_torch.cli searcher simulate [-c CONFIG] [--methods M,...] \\
        [--seed N] [--period N] [--journal PATH] [--json]
    python -m determined_tpu_torch.cli preview-search CONFIG [--native]

The search runs in this process on the GPU (it raises without one; the
Python API takes ``device="cpu"`` for small runs).  Exit code 0: the
experiment finished; 75: it was preempted and ``experiment resume`` carries
it on.  ``searcher simulate`` and ``preview-search`` run no trial and need no
device: they replay search methods against curve models (``--native`` asks
the master's C++ searcher, ``dtpu-master --simulate``, built from
``native/``).  The cluster verbs (``--cluster``, the master's experiments)
come with the cluster slice of the port.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Any, List, Optional


def _print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True, default=str))


def _trial_class(entrypoint: str) -> type:
    module_name, _, class_name = entrypoint.partition(":")
    sys.path.insert(0, os.getcwd())
    return getattr(importlib.import_module(module_name), class_name)


def exp_run(args) -> int:
    """Drive a search from this process (the in-process LocalExperiment)."""
    from determined_tpu_torch.config.experiment import ExperimentConfig
    from determined_tpu_torch.experiment import PREEMPTED_EXIT_CODE, LocalExperiment

    if getattr(args, "cluster", False):
        raise NotImplementedError(
            "--cluster (trials dispatched through the master) is not ported to "
            "determined_tpu_torch yet; it comes with the cluster slice of the port "
            "(ROADMAP.md, Queue 1)"
        )
    cfg = ExperimentConfig.from_yaml(args.config)
    entrypoint = getattr(args, "entrypoint", None) or cfg.entrypoint
    if not entrypoint:
        print(
            "error: no entrypoint (pass pkg.module:TrialClass or set `entrypoint:` in the config)",
            file=sys.stderr,
        )
        return 2
    lexp = LocalExperiment(cfg, _trial_class(entrypoint), checkpoint_dir=args.checkpoint_dir)
    summary = lexp.run()
    _print_json(summary)
    return PREEMPTED_EXIT_CODE if summary.get("status") == "preempted" else 0


# `run-local` predates `experiment run`
run_local = exp_run


def exp_resume_local(args) -> int:
    """Resume a crashed or preempted local experiment from its journal,
    which records the configuration and the trial entrypoint."""
    from determined_tpu_torch.config.experiment import ExperimentConfig
    from determined_tpu_torch.experiment import (
        PREEMPTED_EXIT_CODE,
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
    if replay.cluster is not None:
        raise NotImplementedError(
            "resuming a cluster-driven experiment is not ported to determined_tpu_torch "
            "yet; it comes with the cluster slice of the port (ROADMAP.md, Queue 1)"
        )
    cfg = ExperimentConfig.parse(started["config"])
    try:
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
                    help="dispatch trials through the master (not ported yet)")
    rn.add_argument("--checkpoint-dir", default=None,
                    help="driver directory (journal and checkpoints; default "
                    "./local_experiment_checkpoints)")
    rn.set_defaults(fn=exp_run)
    rs = exp.add_parser("resume", help="resume a crashed/preempted local experiment")
    rs.add_argument("checkpoint_dir")
    rs.add_argument("--entrypoint", help="pkg.module:TrialClass (default: from the journal)")
    rs.set_defaults(fn=exp_resume_local)

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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
