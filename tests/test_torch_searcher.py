"""The port's search methods (determined_tpu_torch.searcher: ASHA, adaptive
ASHA, Hyperband, PBT, the simulator) against the JAX package's on the CPU.

- The JAX ``Searcher`` and the port's are fed the same config, seed and
  deterministic event stream: validations with a NaN metric, an errored
  member and an invalid-hparams exit among them.  Every event's actions,
  ``progress()`` and ``state_json()`` are equal exactly, and a search
  restored mid-way from either package's snapshot continues identically.
- ``simulate_method``, ``compare_methods``, the legacy ``simulate`` and
  ``JournalCurveModel`` give equal reports, ``format_comparison`` the same
  text; ``searcher simulate --json`` and ``preview-search`` print the same
  in both CLIs.
- ``lint.suppress`` accepts and rejects the same rule ids as the JAX parser.
- An ASHA ``LocalExperiment`` of MnistTrial stops trials early and journals
  them; preempted and resumed, it ends with the uninterrupted search's
  trials, steps and metrics.
"""

import dataclasses
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.config.experiment import InvalidExperimentConfig as JaxInvalidConfig
from determined_tpu.lint.rules import all_rules
from determined_tpu import searcher as jax_searcher
from determined_tpu_torch import searcher
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.config.experiment import LINT_RULE_IDS, InvalidExperimentConfig
from determined_tpu_torch.experiment import LocalExperiment, journal_path, read_journal
from determined_tpu_torch.models import MnistTrial
from determined_tpu_torch.searcher import ExitedReason
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_cli = importlib.import_module("determined_tpu.cli.main")
port_cli = importlib.import_module("determined_tpu_torch.cli.main")

SPACE = {
    "lr": {"type": "log", "minval": -4, "maxval": -1},
    "width": {"type": "int", "minval": 8, "maxval": 64},
    "act": {"type": "categorical", "vals": ["relu", "gelu"]},
    "units": 64,
}
PERIOD = 4
# request ids that misbehave in every stream: a NaN metric at the first
# validation, an error after it, invalid hyperparameters before it
NAN_RID, ERRORED_RID, INVALID_RID = 3, 4, 5

METHODS = {
    "asha": {"name": "asha", "max_trials": 9, "num_rungs": 3, "divisor": 2,
             "max_length": {"batches": 16}},
    "adaptive_conservative": {"name": "adaptive_asha", "max_trials": 12, "num_rungs": 3,
                              "divisor": 2, "mode": "conservative",
                              "max_length": {"batches": 16}},
    "adaptive_standard": {"name": "adaptive_asha", "max_trials": 12, "num_rungs": 3,
                          "divisor": 2, "mode": "standard", "max_length": {"batches": 16}},
    "adaptive_aggressive": {"name": "adaptive_asha", "max_trials": 12, "num_rungs": 3,
                            "divisor": 2, "mode": "aggressive", "max_length": {"batches": 16}},
    "hyperband": {"name": "hyperband", "max_trials": 12, "divisor": 2,
                  "max_length": {"batches": 16}},
    "pbt": {"name": "pbt", "population_size": 4, "num_generations": 3,
            "truncate_fraction": 0.5, "max_length": {"batches": 8}},
}


def _raw(method):
    return {"hyperparameters": SPACE,
            "searcher": dict(METHODS[method], metric="validation_loss")}


def _metric(rid, hparams, step):
    if rid == NAN_RID and step == PERIOD:
        return math.nan
    lr_term = (math.log10(hparams["lr"]) + 2.5) ** 2
    return lr_term + 4.0 / (1 + step) + 0.01 * hparams["width"] / 64 + 0.001 * (rid % 5)


def _action(a):
    return (type(a).__name__, getattr(a, "request_id", None), getattr(a, "hparams", None),
            getattr(a, "source_trial_id", None), getattr(a, "cancel", None))


def _max_steps(cfg):
    return cfg.searcher.max_length.units


def _drive(s, cfg, max_events=None):
    """Drive searcher ``s`` the way the serial LocalExperiment does, one
    event at a time: the lowest runnable request id validates every PERIOD
    steps until its budget or a stop, then exits.  Returns per event
    (event, actions, progress, state_json)."""
    log = []
    if not s._started:
        log.append(("start", [_action(a) for a in s.start()], s.progress(), s.state_json()))
    while s.shutdown is None and (max_events is None or len(log) < max_events):
        pending = s.runnable_trials()
        if not pending:
            break
        rec = min(pending, key=lambda t: t.request_id)
        rid = rec.request_id
        last = int((rec.metrics or {}).get("batches", 0))
        if rid == INVALID_RID and last == 0:
            event = ("exited_early", rid, ExitedReason.INVALID_HP)
            actions = s.on_trial_exited_early(rid, ExitedReason.INVALID_HP)
        elif rid == ERRORED_RID and last == PERIOD:
            event = ("exited_early", rid, ExitedReason.ERRORED)
            actions = s.on_trial_exited_early(rid, ExitedReason.ERRORED)
        elif s.is_stopped(rid) or last >= _max_steps(cfg):
            event = ("exited", rid)
            actions = s.on_trial_exited(rid)
        else:
            step = last + PERIOD
            metrics = {"validation_loss": _metric(rid, rec.hparams, step), "batches": step}
            event = ("validated", rid, step)
            actions = s.on_validation(rid, metrics)
        log.append((event, [_action(a) for a in actions], s.progress(), s.state_json()))
    return log


def _port_searcher(method, seed):
    cfg = ExperimentConfig.parse(_raw(method))
    method_obj = searcher.method_from_config(cfg.searcher, cfg.hyperparameters)
    return searcher.Searcher(method_obj, cfg.hyperparameters, seed=seed), cfg


def _jax_searcher(method, seed):
    cfg = JaxExperimentConfig.parse(_raw(method))
    method_obj = jax_searcher.method_from_config(cfg.searcher, cfg.hyperparameters)
    return jax_searcher.Searcher(method_obj, cfg.hyperparameters, seed=seed), cfg


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_searcher_matches_jax_event_for_event(method, seed):
    got = _drive(*_port_searcher(method, seed))
    want = _drive(*_jax_searcher(method, seed))
    assert len(got) == len(want) > 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: {g[0]}"
    # the stream reached every corner: a stop or a clone, the NaN, the
    # errored and the invalid member, and the end of the search
    events = [e for e, *_ in got]
    assert ("exited_early", INVALID_RID, ExitedReason.INVALID_HP) in events
    assert ("exited_early", ERRORED_RID, ExitedReason.ERRORED) in events
    assert ("validated", NAN_RID, PERIOD) in events
    actions = [a for _, acts, _, _ in got for a in acts]
    if method == "pbt":
        assert any(a[0] == "Create" and a[3] is not None for a in actions)
        assert actions[-1][0] == "Shutdown" and got[-1][2] == 1.0
    else:
        assert any(a[0] == "Stop" for a in actions)
    assert events[-1][0] == "exited"


@pytest.mark.parametrize("snapshot_from", ["port", "jax"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_restored_search_continues_identically(method, snapshot_from):
    full = _drive(*_port_searcher(method, 1))
    cut = len(full) // 2
    make = _port_searcher if snapshot_from == "port" else _jax_searcher
    s, cfg = make(method, 1)
    head = _drive(s, cfg, max_events=cut)
    assert head == full[:cut]
    restored, cfg = _port_searcher(method, 1)
    restored.restore_json(s.state_json())
    assert restored.start() == []  # a restored search never re-runs its creates
    assert _drive(restored, cfg) == full[cut:]


# ---------------------------------------------------------------------------
# the simulator and the CLI
# ---------------------------------------------------------------------------


def _sim_cfg(pkg_cfg):
    return pkg_cfg.parse({
        "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
        "searcher": {"name": "asha", "metric": "validation_loss", "max_trials": 8,
                     "max_time": 32, "num_rungs": 3, "divisor": 2},
    })


def test_simulate_method_and_compare_methods_equal_jax():
    cfg, jcfg = _sim_cfg(ExperimentConfig), _sim_cfg(JaxExperimentConfig)
    for seed in (0, 3):
        got = searcher.simulate_method(cfg, searcher.SyntheticCurveModel(seed), seed=seed,
                                       report_period=4)
        want = jax_searcher.simulate_method(jcfg, jax_searcher.SyntheticCurveModel(seed),
                                            seed=seed, report_period=4)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        methods = ["random", "asha", "adaptive_asha", "hyperband", "pbt"]
        got = searcher.compare_methods(cfg, methods, searcher.SyntheticCurveModel(seed), seed=seed)
        want = jax_searcher.compare_methods(jcfg, methods, jax_searcher.SyntheticCurveModel(seed),
                                            seed=seed)
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
        assert searcher.format_comparison(got) == jax_searcher.format_comparison(want)


def test_legacy_simulate_equals_jax():
    def trial(hp, step):
        return (math.log10(hp["lr"]) + 2) ** 2 + 1.0 / (1 + step)

    for method in ("asha", "hyperband", "pbt"):
        raw = _raw(method)
        got = searcher.simulate(ExperimentConfig.parse(raw), trial, seed=2)
        want = jax_searcher.simulate(JaxExperimentConfig.parse(raw), trial, seed=2)
        assert got == want
        assert got["trials_created"] > 1


def test_searcher_simulate_json_equals_jax_cli(capsys):
    assert port_cli.main(["searcher", "simulate", "--json"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["searcher", "simulate", "--json"]) == 0
    want = capsys.readouterr().out
    assert got == want
    assert {r["method"] for r in json.loads(got)} == {"random", "asha", "hyperband", "pbt"}
    # and the text table, with the methods and period named
    args = ["searcher", "simulate", "--methods", "asha,pbt", "--seed", "3", "--period", "8"]
    assert port_cli.main(args) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    assert got == capsys.readouterr().out


def test_preview_search_prints_the_same_lines(capsys, tmp_path, monkeypatch):
    config = os.path.join(REPO, "examples", "mnist", "adaptive.yaml")
    assert port_cli.main(["preview-search", config]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["preview-search", config]) == 0
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "searcher: adaptive_asha (metric validation_accuracy, max)"
    # --native runs the master's binary (here a stand-in printing its JSON)
    fake = tmp_path / "dtpu-master"
    fake.write_text('#!/bin/sh\necho \'{"trials_created": 3, "total_units": 40, '
                    '"trial_units": {"1": 10, "2": 10, "3": 20}}\'\n')
    fake.chmod(0o755)
    monkeypatch.setenv("DTPU_DTPU_MASTER_BIN", str(fake))
    assert port_cli.main(["preview-search", config, "--native"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["preview-search", config, "--native"]) == 0
    assert got == capsys.readouterr().out
    assert "units per trial:  min 10, median 10, max 20" in got


# ---------------------------------------------------------------------------
# lint.suppress
# ---------------------------------------------------------------------------


def test_lint_rule_ids_are_the_jax_registry():
    assert len(LINT_RULE_IDS) == len(set(LINT_RULE_IDS))
    assert set(LINT_RULE_IDS) == set(all_rules())


@pytest.mark.parametrize("rule, known", [("host-sync", True), ("host_sync", False),
                                         ("wall-clock-divergence", True), ("hostsync", False)])
def test_lint_suppress_verdicts_equal_jax(rule, known):
    raw = {"lint": {"suppress": [rule]}}
    if known:
        assert ExperimentConfig.parse(raw).lint.suppress == [rule]
        assert JaxExperimentConfig.parse(raw).lint.suppress == [rule]
    else:
        with pytest.raises(InvalidExperimentConfig, match="unknown rules"):
            ExperimentConfig.parse(raw)
        with pytest.raises(JaxInvalidConfig, match="unknown rules"):
            JaxExperimentConfig.parse(raw)


# ---------------------------------------------------------------------------
# an ASHA LocalExperiment on the CPU
# ---------------------------------------------------------------------------

ASHA_RAW = {
    "name": "mnist-asha",
    "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1},
                        "hidden": 16, "global_batch_size": 32, "dataset_size": 256},
    "searcher": {"name": "asha", "metric": "validation_accuracy", "smaller_is_better": False,
                 "max_trials": 6, "num_rungs": 2, "divisor": 2,
                 "max_length": {"batches": 8}},
    "min_validation_period": {"batches": 4},
    "reproducibility": {"experiment_seed": 3},
}


class _Hook:
    """Runs ``action`` when ``train.step`` fires for ``step`` in the
    ``nth`` trial that reaches it."""

    def __init__(self, step, action, nth):
        self.step, self.action, self.left = step, action, nth

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step:
            self.left -= 1
            if self.left == 0:
                self.action()


def _fingerprint(exp):
    return sorted((rid, r.steps_completed, json.dumps(r.hparams, sort_keys=True),
                   json.dumps(r.metrics, sort_keys=True), r.stopped_early)
                  for rid, r in exp.results.items())


@pytest.fixture
def one_intra_op_thread():
    """Run the CPU kernels on one thread for the test's runs.  Their f32
    results depend on how many threads split each product and reduction (a
    [32, 784] x [784, 16] product differs in its last bits between 1, 2 and 8
    threads), and the test compares two whole experiments bit for bit.
    Under the full suite's load the oracle's first trial once ended 2 ulps
    off in validation loss, where its straight and its resumed training
    agree bit for bit alone: the work was split another way (MKL's dynamic
    threading gives a loaded host fewer threads; tests/test_torch_gang.py
    pins its ranks' threads for the same reason).  One thread splits
    nothing."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_asha_experiment_stops_early_journals_and_resumes(tmp_path, one_intra_op_thread):
    cfg = ExperimentConfig.parse(ASHA_RAW)
    oracle = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path / "o"), device="cpu")
    summary = oracle.run()
    assert summary["status"] == "completed" and summary["trials"] == 6
    stopped = [rid for rid, r in oracle.results.items() if r.steps_completed < 8]
    assert stopped and all(oracle.searcher.is_stopped(rid) for rid in stopped)
    replay = read_journal(journal_path(str(tmp_path / "o")))
    assert replay.status == "completed"
    assert sorted(replay.results) == sorted(oracle.results)
    for rid in stopped:
        assert replay.results[rid]["stopped_early"]
        assert replay.results[rid]["steps_completed"] == 4
    # both packages read the journal's curves alike
    for pkg in (searcher, jax_searcher):
        model = pkg.JournalCurveModel.from_journal(
            journal_path(str(tmp_path / "o")), "validation_accuracy")
        assert len(model.curves) == 6
    got = searcher.JournalCurveModel.from_journal(journal_path(str(tmp_path / "o")),
                                                  "validation_accuracy")
    want = jax_searcher.JournalCurveModel.from_journal(journal_path(str(tmp_path / "o")),
                                                       "validation_accuracy")
    assert got.curves == want.curves
    assert (searcher.simulate_method(cfg, got, seed=1).best_metric
            == jax_searcher.simulate_method(JaxExperimentConfig.parse(ASHA_RAW), want,
                                            seed=1).best_metric)

    # preempted in the second trial's first validation period, then resumed
    ckpt = str(tmp_path / "p")
    exp = LocalExperiment(cfg, MnistTrial, checkpoint_dir=ckpt, device="cpu")
    faults.set_fault_injector(_Hook(1, exp.request_preemption, nth=2))
    try:
        first = exp.run()
    finally:
        faults.set_fault_injector(None)
    assert first["status"] == "preempted" and first["in_flight"] == [2], first
    resumed = LocalExperiment(cfg, MnistTrial, checkpoint_dir=ckpt, device="cpu")
    assert resumed.resume()["status"] == "completed"
    assert _fingerprint(resumed) == _fingerprint(oracle)
    assert resumed.searcher.method.state_dict() == oracle.searcher.method.state_dict()
    assert np.isfinite(summary["best_metrics"]["validation_accuracy"])
