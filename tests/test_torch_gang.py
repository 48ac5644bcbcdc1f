"""A local experiment whose mesh holds several devices, run as a gang of
rank processes (determined_tpu_torch/experiment/_gang.py,
exec/gang_rank.py) on the CPU: two gloo ranks at ``resources.mesh:
{data: 2}`` (MNIST, from the JAX trial's initial weights), each gang under
a hard attempt deadline (``_gang.ATTEMPT_TIMEOUT_S``).

- The searcher receives every validation through the chief's relay; the
  metrics equal the in-process 2-rank Trainer's bitwise
  (tests/torch_rank_worker.py) and the JAX ``LocalExperiment`` on a
  ``data: 2`` mesh within ``TRAIN_PARITY_TOL``; the chief's spans reach the
  experiment's tracer.
- ``request_preemption`` gives status preempted with a checkpoint, and
  ``resume`` finishes with the uninterrupted run's params, bitwise, after
  one md5 pass of the resume point (the ranks reuse the experiment's).
- A rank killed mid-step tears the gang down, and the supervisor restarts
  it from the newest finalized checkpoint, ending at the uninterrupted
  run's params.
- A trial class that cannot be imported by name raises
  ``TrialNotImportableError`` before any process starts; the lint knobs of
  a later slice still raise ``NotImplementedError``, and
  ``registry.auto_promote`` without a master degrades to
  ``registry_error``.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

from chip_smoke import TRAIN_PARITY_TOL
from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import LocalExperiment as JaxLocalExperiment
from determined_tpu.models.mnist import MnistTrial as JaxMnistTrial
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import mnist_state_dict_from_flax
from determined_tpu_torch.experiment import LocalExperiment, TrialNotImportableError, _gang
from determined_tpu_torch.models import MnistTrial
from determined_tpu_torch.observability import get_tracer
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_gang_trials import FromNpzMnistTrial, KillOneRankMnistTrial
from tests.torch_rank_worker import launch

GANG_TIMEOUT = 120.0
HP = {"lr": 1e-2, "hidden": 32, "global_batch_size": 32, "dataset_size": 256}
STEPS, PERIOD = 8, 4


def _raw(init_npz, **extra):
    return dict({
        "name": "gang",
        "hyperparameters": dict(HP, init_npz=init_npz),
        "searcher": {"name": "single", "metric": "validation_loss",
                     "max_length": {"batches": STEPS}},
        "resources": {"mesh": {"data": 2}},
        "min_validation_period": {"batches": PERIOD},
        "min_checkpoint_period": {"batches": PERIOD},
        "fault_tolerance": {"restart_backoff_base": 0.0},
        # the step-4 checkpoint is finalized before step 5 runs
        "optimizations": {"async_checkpointing": False},
    }, **extra)


@functools.lru_cache(maxsize=None)
def _init_npz(root):
    """The JAX trial's initial weights for trial 1 (seed 0 + 1), converted."""
    ctx = jax_train.init(hparams=dict(HP), mesh_config=JaxMeshConfig(data=1), seed=1,
                         core_context=jax_core._dummy_init(), devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxMnistTrial(ctx))
    trainer._setup()
    state = mnist_state_dict_from_flax(jax.device_get(trainer.state.params))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "init.npz")
    np.savez(path, **state)
    return path


def _validations(ckpt_dir):
    with open(os.path.join(ckpt_dir, "experiment.journal")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["metrics"]["batches"], {k: v for k, v in r["metrics"].items() if k != "batches"})
            for r in recs if r["type"] == "trial_validated"]


def _final_params(exp, ckpt_dir):
    sid = exp.results[1].checkpoint
    _, trainer = train.load_trial_from_checkpoint(
        os.path.join(ckpt_dir, "trial_1", sid), trial_class=MnistTrial, device="cpu")
    return {k: p.detach().numpy() for k, p in trainer.model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _uninterrupted(root):
    npz = _init_npz(os.path.join(root, "init"))
    ckpt = os.path.join(root, "straight")
    get_tracer().close()
    get_tracer().configure(enabled=True)
    get_tracer().reset()
    exp = LocalExperiment(ExperimentConfig.parse(_raw(npz)), FromNpzMnistTrial,
                          checkpoint_dir=ckpt, devices=["cpu", "cpu"])
    summary = exp.run()
    spans = {e["name"] for e in get_tracer().chrome_events() if e["ph"] == "X"}
    return exp, summary, ckpt, spans, _final_params(exp, ckpt)


@pytest.fixture(scope="module", autouse=True)
def _attempt_deadline():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_gang, "ATTEMPT_TIMEOUT_S", GANG_TIMEOUT)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gang"))


@pytest.fixture(scope="module", autouse=True)
def _fixed_cpu_threads():
    """Every rank process (the gangs' and tests/torch_rank_worker.py's) on
    two BLAS and OpenMP threads that a loaded host cannot take away (MKL's
    dynamic threading would split a reduction otherwise), so runs compare
    bitwise."""
    fixed = dict(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", MKL_DYNAMIC="FALSE",
                 OMP_DYNAMIC="FALSE")
    saved = {k: os.environ.get(k) for k in fixed}
    os.environ.update(fixed)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_a_mesh_trial_runs_as_a_gang_and_matches_the_in_process_ranks_and_jax(root, tmp_path):
    exp, summary, ckpt, spans, _ = _uninterrupted(root)
    npz = _init_npz(os.path.join(root, "init"))
    assert summary["status"] == "completed" and summary["total_steps"] == STEPS
    with open(os.path.join(ckpt, "gangs", "trial_1", "attempt_1", "spec.json")) as f:
        assert json.load(f)["devices"] == ["cpu", "cpu"]
    # every validation went through the relay into the searcher
    got = _validations(ckpt)
    assert [s for s, _ in got] == [PERIOD, STEPS]
    assert exp.results[1].metrics == got[-1][1]
    # the chief's spans and the gang's launch reached this process's tracer
    assert {"gang.launch", "trial.run", "step.dispatch", "validate", "checkpoint.save"} <= spans
    assert exp.trial_launches[1]["fused_adamw"] == 0  # the CPU launches no kernel

    # the same trial on two in-process gloo ranks: bitwise
    with np.load(npz) as f:
        init_state = {k: f[k] for k in f.files}
    outs = launch("train", 2, str(tmp_path / "ranks"), dict(
        trial="mnist", hparams=dict(HP, init_npz=npz), mesh=dict(data=2), seed=1,
        ckpt_dir=str(tmp_path / "ck"), init_state=init_state, exp_config=_raw(npz),
        fit=dict(max_length=STEPS, validation_period=PERIOD, checkpoint_period=PERIOD,
                 report_period=PERIOD, checkpoint_policy="best"),
    ))
    assert outs[0]["validation"] == got

    # the JAX runner on a data 2 mesh of two devices
    jax_dir = str(tmp_path / "jax")
    JaxLocalExperiment(JaxExperimentConfig.parse(_raw(npz)), JaxMnistTrial, checkpoint_dir=jax_dir,
                       devices=jax.devices()[:2], preflight=False).run()
    want = _validations(jax_dir)
    assert [s for s, _ in want] == [s for s, _ in got]
    for (s, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"step {s} {k}",
                                       **TRAIN_PARITY_TOL["loss"])


def test_a_preempted_gang_resumes_to_the_uninterrupted_params(root, tmp_path):
    _, _, _, _, want = _uninterrupted(root)
    npz = _init_npz(os.path.join(root, "init"))
    cfg = ExperimentConfig.parse(_raw(npz))
    ckpt = str(tmp_path / "ab")
    exp = LocalExperiment(cfg, FromNpzMnistTrial, checkpoint_dir=ckpt, devices=["cpu", "cpu"])
    first_validation = exp._on_validation

    def preempt_at_first_validation(*args):
        exp.request_preemption()
        return first_validation(*args)

    exp._on_validation = preempt_at_first_validation
    first = exp.run()
    assert first["status"] == "preempted" and first["in_flight"] == [1]
    assert exp._resume_checkpoints[1] is not None
    second = LocalExperiment(cfg, FromNpzMnistTrial, checkpoint_dir=ckpt,
                             devices=["cpu", "cpu"])
    summary = second.resume()
    assert summary["status"] == "completed" and second.results[1].steps_completed == STEPS
    # one md5 pass of the resume point: the experiment's, whose verdict the
    # chief's restore (relayed spans) reuses
    spans = [e["name"] for e in get_tracer().chrome_events() if e["ph"] == "X"]
    assert spans.count("checkpoint.verify") == 1 and spans.count("checkpoint.load") == 1
    got = _final_params(second, ckpt)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_a_killed_rank_tears_the_gang_down_and_the_supervisor_restarts_it(root, tmp_path):
    _, _, _, _, want = _uninterrupted(root)
    npz = _init_npz(os.path.join(root, "init"))
    local_npz = str(tmp_path / "init.npz")
    with open(npz, "rb") as src, open(local_npz, "wb") as dst:
        dst.write(src.read())
    raw = _raw(local_npz)
    raw["hyperparameters"]["kill_at"] = 6
    ckpt = str(tmp_path / "kill")
    exp = LocalExperiment(ExperimentConfig.parse(raw), KillOneRankMnistTrial,
                          checkpoint_dir=ckpt, devices=["cpu", "cpu"])
    summary = exp.run()
    assert summary["status"] == "completed" and exp.results[1].steps_completed == STEPS
    gang_dir = os.path.join(ckpt, "gangs", "trial_1")
    assert sorted(os.listdir(gang_dir)) == ["attempt_1", "attempt_2"]
    with open(os.path.join(gang_dir, "attempt_2", "spec.json")) as f:
        resumed_from = json.load(f)["fit"]["latest_checkpoint"]
    with open(os.path.join(ckpt, "trial_1", resumed_from, "metadata.json")) as f:
        assert json.load(f)["steps_completed"] == PERIOD
    got = _final_params(exp, ckpt)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_a_trial_class_that_cannot_be_imported_raises_before_any_process(tmp_path):
    class Local(MnistTrial):
        pass

    raw = _raw("unused")
    exp = LocalExperiment(ExperimentConfig.parse(raw), Local, checkpoint_dir=str(tmp_path),
                          devices=["cpu", "cpu"])
    with pytest.raises(TrialNotImportableError, match="cannot be imported"):
        exp.run()
    assert not os.path.exists(os.path.join(str(tmp_path), "gangs"))


@pytest.mark.parametrize("knob", [
    {"registry": {"auto_promote": True, "model": "m"}},
    {"lint": {"strict": True}},
    {"lint": {"thread_sentinel": True}},
    {"lint": {"collective_sentinel": True}},
], ids=["auto_promote", "lint_strict", "thread_sentinel", "collective_sentinel"])
def test_knobs_of_later_slices_still_raise(tmp_path, knob, monkeypatch):
    """The lint knobs still raise; registry.auto_promote is ported: without
    a master the experiment is built and its promotion degrades to
    ``registry_error`` (tests/test_torch_cluster_driver.py runs one)."""
    cfg = ExperimentConfig.parse(dict({"hyperparameters": dict(HP)}, **knob))
    if "registry" in knob:
        monkeypatch.delenv("DTPU_MASTER", raising=False)
        exp = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path),
                              devices=["cpu", "cpu"])
        summary = {"best_trial": None}
        exp.on_search_complete(summary)
        assert "no master configured" in summary["registry_error"]
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path), devices=["cpu", "cpu"])
