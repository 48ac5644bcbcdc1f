"""The port's experiment path as a whole (determined_tpu_torch:
LocalExperiment, the journal, the CLI, reloading a trial) on the CPU, and
against the JAX package's LocalExperiment.

- A ``single`` search preempted through ``request_preemption()`` and
  resumed ends bitwise equal to the uninterrupted search: params, moments,
  step and loader position; the journal reads the same in both packages.
- JAX against the port: the same search, preempted at the same step and
  resumed, on each side, the port's trial starting from the JAX trial's
  initial weights (``convert.load_flax_params``).  Step counts, checkpoint
  steps, ``trainer_state.json`` keys and loader state are equal; validation
  losses and final params agree within ``test_torch_training.F32_TOL``.
- ``run-local`` exits 75 when preempted and ``experiment resume`` finishes
  the search; ``load_trial_from_checkpoint`` rebuilds the trained model.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import LocalExperiment as JaxLocalExperiment
from determined_tpu.experiment import read_journal as jax_read_journal
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu.utils import faults as jax_faults
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import flax_from_state_dict, load_flax_params
from determined_tpu_torch.experiment import LocalExperiment, journal_path, read_journal
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.train import Callback
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL, _compare_trees

# lr 1e-3: over 8 steps the two frameworks' f32 rounding stays inside
# F32_TOL (set for 3 steps at lr 1e-2)
HP = dict(lr=1e-3, global_batch_size=4, seq_len=32, vocab_size=256, d_model=64, n_layers=2,
          n_heads=2, dataset_size=16, attention="flash", fused_ce=True, fused_adamw=True,
          warmup_steps=2, bf16=False)
STEPS, VALIDATE, PREEMPT_AT = 8, 4, 6
RAW = {
    "name": "tiny-lm",
    "hyperparameters": HP,
    "searcher": {"name": "single", "metric": "validation_loss",
                 "max_length": {"batches": STEPS}},
    "min_validation_period": {"batches": VALIDATE},
    # step 6 is a boundary: the Trainer reads the preemption flag there
    "min_checkpoint_period": {"batches": PREEMPT_AT},
}


class _Hook:
    """A fault injector running ``action`` when ``train.step`` fires for
    ``step`` (before that step runs)."""

    def __init__(self, step, action):
        self.step, self.action, self.fired = step, action, False

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step and not self.fired:
            self.fired = True
            self.action()


TRAINERS = []


class _Capture(Callback):
    def on_training_start(self, trainer):
        TRAINERS.append(trainer)


class CapturingLMTrial(LMTrial):
    """LMTrial keeping its Trainer, so a test can read the final state."""

    def build_callbacks(self):
        return {"capture": _Capture()}


class PreemptingLMTrial(LMTrial):
    """LMTrial whose run is preempted before step 6 (the CLI test's
    entrypoint): a SIGTERM to its own process, as a host's maintenance
    event would send."""

    def build_callbacks(self):
        import signal

        class Preempt(Callback):
            def on_training_start(self, trainer):
                if trainer.steps_completed == 0:
                    faults.set_fault_injector(_Hook(
                        PREEMPT_AT - 1, lambda: os.kill(os.getpid(), signal.SIGTERM)))

            def on_trial_shutdown(self):
                faults.set_fault_injector(None)

        return {"preempt": Preempt()}


def _run_preempted_then_resumed(tmp_path, trial_cls):
    cfg = ExperimentConfig.parse(RAW)
    ckpt_dir = str(tmp_path / "ab")
    exp = LocalExperiment(cfg, trial_cls, checkpoint_dir=ckpt_dir, device="cpu")
    faults.set_fault_injector(_Hook(PREEMPT_AT - 1, exp.request_preemption))
    try:
        first = exp.run()
    finally:
        faults.set_fault_injector(None)
    second = LocalExperiment(cfg, trial_cls, checkpoint_dir=ckpt_dir, device="cpu").resume()
    return first, second, ckpt_dir


def _checkpoint_steps(trial_dir):
    steps = []
    for uuid in os.listdir(trial_dir):
        with open(os.path.join(trial_dir, uuid, "metadata.json")) as f:
            steps.append(json.load(f)["steps_completed"])
    return sorted(steps)


def _final_trainer_state(trial_dir):
    newest = max(os.listdir(trial_dir), key=lambda u: json.load(
        open(os.path.join(trial_dir, u, "metadata.json")))["steps_completed"])
    with open(os.path.join(trial_dir, newest, "trainer_state.json")) as f:
        return json.load(f)


def test_preempted_and_resumed_search_equals_uninterrupted_bitwise(tmp_path):
    del TRAINERS[:]
    first, second, ckpt_dir = _run_preempted_then_resumed(tmp_path, CapturingLMTrial)
    assert first["status"] == "preempted" and first["in_flight"] == [1]
    assert second["status"] == "completed" and second["total_steps"] == STEPS
    resumed = TRAINERS[-1]
    ref_exp = LocalExperiment(ExperimentConfig.parse(dict(RAW, checkpoint_policy="none")),
                              CapturingLMTrial, checkpoint_dir=str(tmp_path / "ref"),
                              device="cpu")
    assert ref_exp.run()["total_steps"] == STEPS
    ref = TRAINERS[-1]
    gp, wp = dict(resumed.model.named_parameters()), dict(ref.model.named_parameters())
    for k in wp:
        assert torch.equal(gp[k], wp[k]), k
        assert torch.equal(resumed.state.opt_state.mu[k], ref.state.opt_state.mu[k]), k
        assert torch.equal(resumed.state.opt_state.nu[k], ref.state.opt_state.nu[k]), k
    assert torch.equal(resumed.state.step, ref.state.step)
    assert torch.equal(resumed.state.opt_state.count, ref.state.opt_state.count)
    assert resumed.train_loader.state_dict() == ref.train_loader.state_dict()
    assert resumed._last_val_metrics == ref._last_val_metrics
    # best at 4 (async, drained by the preemption save), preemption at 6,
    # period + best at 8
    assert _checkpoint_steps(os.path.join(ckpt_dir, "trial_1")) == [4, 6, 8]
    # the journal reads the same in both packages
    got, want = read_journal(journal_path(ckpt_dir)), jax_read_journal(journal_path(ckpt_dir))
    assert (got.status, got.in_flight, got.checkpoints, got.results) == \
        (want.status, want.in_flight, want.checkpoints, want.results) == \
        ("completed", [], got.checkpoints, got.results)
    del TRAINERS[:]


def test_resume_checks_the_resume_point_manifest_once(tmp_path, monkeypatch):
    """The experiment verifies the resume point's manifest before the trial
    starts, and the trial's restore reuses that verdict: one md5 pass."""
    from determined_tpu_torch import core
    from determined_tpu_torch.core import _checkpoint

    cfg = ExperimentConfig.parse(RAW)
    ckpt_dir = str(tmp_path / "ab")
    exp = LocalExperiment(cfg, LMTrial, checkpoint_dir=ckpt_dir, device="cpu")
    faults.set_fault_injector(_Hook(PREEMPT_AT - 1, exp.request_preemption))
    try:
        assert exp.run()["status"] == "preempted"
    finally:
        faults.set_fault_injector(None)
    checked = []
    real = _checkpoint.verify_manifest
    counting = lambda p, **kw: checked.append(os.path.basename(p)) or real(p, **kw)  # noqa: E731
    monkeypatch.setattr(core, "verify_manifest", counting)
    monkeypatch.setattr(_checkpoint, "verify_manifest", counting)
    summary = LocalExperiment(cfg, LMTrial, checkpoint_dir=ckpt_dir, device="cpu").resume()
    assert summary["status"] == "completed" and summary["total_steps"] == STEPS
    with open(os.path.join(ckpt_dir, "trial_1", checked[0], "metadata.json")) as f:
        assert json.load(f)["steps_completed"] == PREEMPT_AT
    assert len(checked) == 1


@functools.lru_cache(maxsize=None)
def _jax_init_params(seed):
    ctx = jax_train.init(hparams=dict(HP), mesh_config=MeshConfig(data=1), seed=seed,
                         core_context=jax_core._dummy_init(), devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
    trainer._setup()
    return jax.device_get(trainer.state.params)


class FromJaxLMTrial(CapturingLMTrial):
    """The port's LMTrial starting from the JAX trial's initial weights for
    the same seed."""

    def build_model(self):
        model = super().build_model()
        return load_flax_params(model, _jax_init_params(self.context.seed))


@functools.lru_cache(maxsize=None)
def _jax_search(ckpt_dir):
    """The search on the JAX side: preempted before step 6, then resumed;
    the summaries, the final params and the validation reports."""
    jax_trainers, val = [], []

    class Trial(JaxLMTrial):
        def build_callbacks(self):
            class Capture(jax_train.Callback):
                def on_training_start(self, trainer):
                    jax_trainers.append(trainer)

                def on_validation_end(self, metrics):
                    val.append((jax_trainers[-1].steps_completed, metrics["validation_loss"]))

            return {"capture": Capture()}

    cfg = JaxExperimentConfig.parse(RAW)
    kwargs = dict(checkpoint_dir=ckpt_dir, devices=jax.devices()[:1], preflight=False)
    exp = JaxLocalExperiment(cfg, Trial, **kwargs)
    jax_faults.set_fault_injector(_Hook(PREEMPT_AT - 1, exp.request_preemption))
    try:
        first = exp.run()
    finally:
        jax_faults.set_fault_injector(None)
    second = JaxLocalExperiment(cfg, Trial, **kwargs).resume()
    return first, second, jax.device_get(jax_trainers[-1].state.params), val


def test_search_preempted_and_resumed_matches_jax(tmp_path):
    jax_dir = str(tmp_path / "jax")
    want_first, want_second, want_params, want_val = _jax_search(jax_dir)
    del TRAINERS[:]
    val = []
    orig = FromJaxLMTrial.build_callbacks

    class Trial(FromJaxLMTrial):
        def build_callbacks(self):
            class Val(Callback):
                def on_validation_end(self, metrics):
                    val.append((TRAINERS[-1].steps_completed, metrics["validation_loss"]))

            return dict(orig(self), val=Val())

    got_first, got_second, port_dir = _run_preempted_then_resumed(tmp_path, Trial)
    for got, want in ((got_first, want_first), (got_second, want_second)):
        assert {k: got[k] for k in ("status", "trials", "total_steps", "best_trial")} == \
            {k: want[k] for k in ("status", "trials", "total_steps", "best_trial")}
    assert got_first["in_flight"] == want_first["in_flight"] == [1]
    port_trial, jax_trial = os.path.join(port_dir, "trial_1"), os.path.join(jax_dir, "trial_1")
    assert _checkpoint_steps(port_trial) == _checkpoint_steps(jax_trial) == [4, 6, 8]
    got_ts, want_ts = _final_trainer_state(port_trial), _final_trainer_state(jax_trial)
    assert set(got_ts) == set(want_ts)
    assert got_ts["train_loader"] == want_ts["train_loader"]
    assert got_ts["steps_completed"] == want_ts["steps_completed"] == STEPS
    # one device: the port records its one axis, JAX every axis at size 1
    assert got_ts["mesh_axes"] == {"data": 1}
    assert set(want_ts["mesh_axes"].values()) == {1}
    assert got_ts["seed"] == want_ts["seed"] and got_ts["hparams"] == want_ts["hparams"]
    assert [s for s, _ in val] == [s for s, _ in want_val] == [4, 8]
    np.testing.assert_allclose([v for _, v in val], [v for _, v in want_val], **F32_TOL["loss"])
    cfg = TRAINERS[-1].model.cfg
    got_params = flax_from_state_dict(TRAINERS[-1].model.state_dict(), cfg.n_heads, cfg.kv_heads)
    _compare_trees({"params": got_params}, want_params, F32_TOL["params_rel"], "params",
                   atol=F32_TOL["params_atol"])
    del TRAINERS[:]


def test_cli_run_local_exits_75_when_preempted_and_resume_finishes(tmp_path, monkeypatch,
                                                                   capsys):
    """``run-local`` (a SIGTERM drains the search to a checkpoint) exits 75,
    and ``experiment resume`` finishes the search from the journal.  The
    CLI runs on the GPU; here its device is pinned to the CPU."""
    import yaml

    from determined_tpu_torch.cli.main import main
    from determined_tpu_torch.experiment import local

    monkeypatch.setattr(local, "resolve_device", lambda device: torch.device("cpu"))
    config = tmp_path / "exp.yaml"
    config.write_text(yaml.safe_dump(RAW))
    ckpt_dir = str(tmp_path / "cli")
    entry = "tests.test_torch_experiment:PreemptingLMTrial"
    assert main(["run-local", str(config), entry, "--checkpoint-dir", ckpt_dir]) == 75
    assert json.loads(capsys.readouterr().out)["status"] == "preempted"
    assert main(["experiment", "resume", ckpt_dir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["status"] == "completed" and summary["total_steps"] == STEPS
    assert main(["experiment", "resume", ckpt_dir]) == 0  # nothing left to do


def test_load_trial_from_checkpoint_rebuilds_the_trained_model(tmp_path):
    del TRAINERS[:]
    cfg = ExperimentConfig.parse(dict(RAW, min_checkpoint_period=None, checkpoint_policy="all"))
    LocalExperiment(cfg, CapturingLMTrial, checkpoint_dir=str(tmp_path), device="cpu").run()
    trained = TRAINERS[-1]
    sid = trained.latest_checkpoint
    trial, trainer = train.load_trial_from_checkpoint(
        os.path.join(str(tmp_path), "trial_1", sid), device="cpu")
    assert type(trial) is CapturingLMTrial
    assert trainer.steps_completed == STEPS
    assert trainer.context.hparams == HP and trainer.context.seed == 1
    for k, p in trained.model.named_parameters():
        assert torch.equal(dict(trainer.model.named_parameters())[k], p), k
    with pytest.raises(RuntimeError, match="device='cpu'"):
        # CUDA unless named: never the CPU on its own
        monkeypatched = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            train.load_trial_from_checkpoint(os.path.join(str(tmp_path), "trial_1", sid))
        finally:
            torch.cuda.is_available = monkeypatched
    del TRAINERS[:]
