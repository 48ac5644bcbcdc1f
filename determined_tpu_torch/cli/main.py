"""Command line of the port: the local experiment verbs of
``determined_tpu/cli/main.py``.

    python -m determined_tpu_torch.cli run-local CONFIG pkg.module:TrialClass \\
        [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli experiment run CONFIG [ENTRYPOINT] [--checkpoint-dir DIR]
    python -m determined_tpu_torch.cli experiment resume DIR [--entrypoint E]

The search runs in this process on the GPU (it raises without one; the
Python API takes ``device="cpu"`` for small runs).  Exit code 0: the
experiment finished; 75: it was preempted and ``experiment resume`` carries
it on.  The cluster verbs (``--cluster``, the master's experiments) come
with the cluster slice of the port.
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
