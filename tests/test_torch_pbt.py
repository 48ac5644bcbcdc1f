"""PBT through the port's LocalExperiment on the CPU: exploit clones
restored from checkpoints (after the JAX package's tests/test_pbt.py).

- MnistTrial: a child resumes from its parent's final checkpoint, copied
  into its own namespace under the parent's uuid, trains past the inherited
  steps (``clone_extended_length``) and journals the clone; its restored
  parameters, moments and step equal the parent's checkpoint bit for bit.
- A tiny LMTrial: every trial's ``lr`` metric follows its OWN lr after a
  restore, a perturbed child's included (the port's optimizer state holds
  no lr: the JAX Trainer's ``_reinject_runtime_hparams`` has nothing to do
  here).
- A preemption mid-generation or at a generation boundary, then
  ``resume()``, reproduces the uninterrupted search: trials, steps,
  hparams, metrics and clone lineage, no request id reused.
- Checkpoint retention keeps live clone sources.
- JAX against the port: one PBT config and seed through both packages'
  LocalExperiment with MnistTrial, the port's trials starting from the JAX
  trials' initial weights.  Lineage, hparams, steps, ``trial_cloned``
  records and each trial directory's checkpoints (by step, the clone under
  its parent's uuid) are equal; validation losses agree within
  ``test_torch_training.F32_TOL``.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import LocalExperiment as JaxLocalExperiment
from determined_tpu.experiment import journal_path as jax_journal_path
from determined_tpu.experiment import read_journal as jax_read_journal
from determined_tpu.models.mnist import MnistTrial as JaxMnistTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig, Length
from determined_tpu_torch.config.experiment import clone_extended_length
from determined_tpu_torch.convert import mnist_state_dict_from_flax
from determined_tpu_torch.exec.gc_checkpoints import RetentionPolicy, apply_retention
from determined_tpu_torch.experiment import LocalExperiment, journal_path, read_journal
from determined_tpu_torch.models import LMTrial, MnistTrial
from determined_tpu_torch.train import Callback
from determined_tpu_torch.train._optim import warmup_cosine_decay_schedule
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL

GEN = 4  # batches a generation


def pbt_config(**overrides):
    raw = {
        "name": "pbt-e2e",
        "hyperparameters": {
            "lr": {"type": "log", "minval": -3, "maxval": -1},
            "hidden": 8,
            "global_batch_size": 16,
            "dataset_size": 64,
        },
        "searcher": {
            "name": "pbt", "metric": "validation_accuracy", "smaller_is_better": False,
            "population_size": 3, "num_generations": 2, "truncate_fraction": 0.34,
            "max_length": {"batches": GEN},
        },
        "min_validation_period": {"batches": 2},
        "min_checkpoint_period": {"batches": 2},
        # sync saves: every boundary leaves a durable resume point
        "optimizations": {"async_checkpointing": False},
    }
    raw.update(overrides)
    return ExperimentConfig.parse(raw)


def _ckpt_meta(checkpoint_dir, rid, uuid):
    with open(os.path.join(checkpoint_dir, f"trial_{rid}", uuid, "metadata.json")) as f:
        return json.load(f)


def test_pbt_child_resumes_from_parent_checkpoint(tmp_path):
    ckdir = str(tmp_path / "ck")
    searcher_ref, seen = [], []
    Check = chip_smoke.clone_restore_check(ckdir, searcher_ref, seen)

    class CheckedMnistTrial(MnistTrial):
        def build_callbacks(self):
            return {"check": Check()}

    exp = LocalExperiment(pbt_config(), CheckedMnistTrial, checkpoint_dir=ckdir, device="cpu")
    searcher_ref.append(exp.searcher)
    summary = exp.run()
    assert summary["status"] == "completed"
    assert summary["trials"] == 6  # 3 members x 2 generations

    children = {rid: src for rid, src in exp.searcher.method.lineage.items() if src is not None}
    assert len(children) == 3
    assert sorted((r["trial"], r["parent"]) for r in seen) == sorted(children.items())
    assert all(r["bitwise"] for r in seen), seen
    for rid, src in children.items():
        parent_ckpt = exp.results[src].checkpoint
        assert parent_ckpt, "exploit parent finished without a checkpoint"
        # materialized under the CHILD's namespace with the parent's uuid
        assert os.path.isdir(os.path.join(ckdir, f"trial_{rid}", parent_ckpt))
        # the generation budget extends past the inherited steps
        assert exp.results[rid].steps_completed == 2 * GEN
        # the child's final checkpoint's lineage walks back to the parent's
        sid, walked = exp.results[rid].checkpoint, set()
        while sid and sid not in walked and sid != parent_ckpt:
            walked.add(sid)
            sid = _ckpt_meta(ckdir, rid, sid).get("parent_storage_id")
        assert sid == parent_ckpt, "child lineage never reached the parent uuid"
    replay = read_journal(journal_path(ckdir))
    assert sorted(replay.clones) == sorted(children)
    for rid, src in children.items():
        assert replay.clones[rid]["source"] == src and replay.clones[rid]["steps"] == GEN
    # at least one exploited child explored (its lr perturbed)
    assert any(exp.results[rid].hparams["lr"] != exp.results[src].hparams["lr"]
               for rid, src in children.items())


def test_clone_extended_length():
    assert clone_extended_length(Length.batches(4), 0) == Length.batches(4)
    assert clone_extended_length(Length.batches(4), 6) == Length.batches(10)
    # only batch budgets extend
    assert clone_extended_length(Length.epochs(2), 6) == Length.epochs(2)


LM_HP = dict(global_batch_size=4, seq_len=32, vocab_size=256, d_model=64, n_layers=2, n_heads=2,
             dataset_size=16, attention="flash", fused_ce=True, fused_adamw=True,
             warmup_steps=3, bf16=False)


def test_pbt_lm_children_train_with_their_own_lr(tmp_path):
    ckdir = str(tmp_path / "lm")
    searcher_ref, seen, reports = [], [], []
    Check = chip_smoke.clone_restore_check(ckdir, searcher_ref, seen)

    class LrLMTrial(LMTrial):
        def build_callbacks(self):
            trial = self

            class Lr(Callback):
                def on_training_workload_end(self, steps, metrics):
                    trial_dir = trial.context.core.checkpoint._storage.base_path
                    reports.append((os.path.basename(trial_dir), steps, metrics["lr"]))

            return {"check": Check(), "lr": Lr()}

    raw_hp = dict(LM_HP, lr={"type": "log", "minval": -4, "maxval": -2})
    cfg = pbt_config(
        hyperparameters=raw_hp,
        searcher={"name": "pbt", "metric": "validation_loss", "population_size": 2,
                  "num_generations": 2, "truncate_fraction": 0.5, "perturb_factor": 2.0,
                  "max_length": {"batches": GEN}},
    )
    exp = LocalExperiment(cfg, LrLMTrial, checkpoint_dir=ckdir, device="cpu")
    searcher_ref.append(exp.searcher)
    assert exp.run()["status"] == "completed"
    children = {rid: src for rid, src in exp.searcher.method.lineage.items() if src is not None}
    assert len(children) == 2 and len(seen) == 2 and all(r["bitwise"] for r in seen), seen
    lrs = {f"trial_{rid}": r.hparams["lr"] for rid, r in exp.results.items()}
    assert any(lrs[f"trial_{rid}"] != lrs[f"trial_{src}"] for rid, src in children.items())
    period = 2
    for trial_dir, steps, reported in reports:
        own = warmup_cosine_decay_schedule(0.0, lrs[trial_dir], LM_HP["warmup_steps"], 10000)
        want = float(own(torch.arange(steps - period, steps)).float().mean())
        np.testing.assert_allclose(reported, want, rtol=1e-6)
    # the children's reports cover their own steps 4..8, after the restore
    for rid in children:
        assert [s for d, s, _ in reports if d == f"trial_{rid}"] == [GEN + 2, 2 * GEN]


def test_restored_trainer_keeps_its_own_lr_not_the_checkpoints(tmp_path):
    """The counterpart of the JAX Trainer's ``_reinject_runtime_hparams``:
    a checkpoint written at lr 1e-2, restored by a trainer built with lr
    1e-3, trains at 1e-3 (the state holds (count, mu, nu) only)."""
    from determined_tpu_torch import core

    base = dict(LM_HP, lr=1e-2)
    ctx = train.init(hparams=base, seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path)))
    first = train.Trainer(LMTrial(ctx))
    summary = first.fit(max_length=2, report_period=2, checkpoint_policy="all",
                        validation_period=2)
    assert set(first.state.opt_state._fields) == {"count", "mu", "nu"}
    ctx2 = train.init(hparams=dict(base, lr=1e-3), seed=0, device="cpu",
                      core_context=core._dummy_init(checkpoint_dir=str(tmp_path)))
    second = train.Trainer(LMTrial(ctx2))
    second.fit(max_length=4, report_period=2, latest_checkpoint=summary["latest_checkpoint"],
               checkpoint_policy="none")
    (steps, metrics), = ctx2.core.train.metrics("training")
    assert steps == 4
    own = warmup_cosine_decay_schedule(0.0, 1e-3, LM_HP["warmup_steps"], 10000)
    np.testing.assert_allclose(metrics["lr"], float(own(torch.arange(2, 4)).float().mean()),
                               rtol=1e-6)


class _Hook:
    """Runs ``action`` when ``train.step`` fires for ``step`` the ``nth``
    time (counted over trials)."""

    def __init__(self, step, action, nth):
        self.step, self.action, self.left = step, action, nth

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step:
            self.left -= 1
            if self.left == 0:
                self.action()


def _fingerprint(exp):
    return sorted((rid, r.steps_completed, json.dumps(r.hparams, sort_keys=True),
                   json.dumps(r.metrics, sort_keys=True)) for rid, r in exp.results.items())


@pytest.mark.parametrize("step, nth", [
    (GEN + 1, 1),  # in generation 2's first child, after its restore
    (1, 3),        # in generation 1's last member: the turnover comes after the resume
])
def test_pbt_preempted_and_resumed_reproduces_uninterrupted(tmp_path, step, nth):
    cfg = pbt_config()
    oracle = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path / "o"), device="cpu")
    assert oracle.run()["status"] == "completed"

    ckdir = str(tmp_path / "p")
    exp = LocalExperiment(cfg, MnistTrial, checkpoint_dir=ckdir, device="cpu")
    faults.set_fault_injector(_Hook(step, exp.request_preemption, nth))
    try:
        first = exp.run()
    finally:
        faults.set_fault_injector(None)
    assert first["status"] == "preempted" and len(first["in_flight"]) == 1, first
    resumed = LocalExperiment(cfg, MnistTrial, checkpoint_dir=ckdir, device="cpu")
    assert resumed.resume()["status"] == "completed"
    assert _fingerprint(resumed) == _fingerprint(oracle)
    assert resumed.searcher.method.lineage == oracle.searcher.method.lineage
    records = read_journal(journal_path(ckdir)).records
    created = [r["rid"] for r in records if r.get("type") == "trial_created"]
    assert len(created) == len(set(created))


def test_gc_protects_live_clone_sources(tmp_path):
    ckdir = str(tmp_path / "ck")
    exp = LocalExperiment(pbt_config(), MnistTrial, checkpoint_dir=ckdir, device="cpu")
    assert exp.run()["status"] == "completed"
    metric = {rid: r.metrics.get("validation_accuracy", 0.0) for rid, r in exp.results.items()}
    protected = set(exp.searcher.clone_source_trials())
    members = {m["rid"] for m in exp.searcher.method.members}
    assert members <= protected
    # a policy that would keep only the best trial's checkpoint
    policy = RetentionPolicy(keep_trial_latest=0, keep_experiment_best=1, smaller_is_better=False)
    apply_retention(ckdir, policy, metric_by_trial=metric, protected_trials=protected)
    for rid in members:
        sid = exp.results[rid].checkpoint
        assert os.path.isdir(os.path.join(ckdir, f"trial_{rid}", sid)), rid
    # without the protection the same policy deletes some of them
    apply_retention(ckdir, policy, metric_by_trial=metric)
    gone = [rid for rid in members
            if not os.path.isdir(os.path.join(ckdir, f"trial_{rid}", exp.results[rid].checkpoint))]
    assert gone


# ---------------------------------------------------------------------------
# the JAX package's LocalExperiment against the port's on one PBT search
# ---------------------------------------------------------------------------

PARITY_RAW = {
    "name": "pbt-parity",
    "hyperparameters": {
        "lr": {"type": "log", "minval": -3, "maxval": -1},
        "hidden": 8,
        "global_batch_size": 16,
        "dataset_size": 64,
    },
    # a continuous metric: accuracies over 64 images tie, and a tie broken
    # by a last-bit difference would fork the lineage
    "searcher": {
        "name": "pbt", "metric": "validation_loss", "population_size": 3,
        "num_generations": 2, "truncate_fraction": 0.34, "max_length": {"batches": GEN},
    },
    "resources": {"mesh": {"data": 1}},
    "min_validation_period": {"batches": 2},
    "min_checkpoint_period": {"batches": 2},
    "optimizations": {"async_checkpointing": False},
}


@functools.lru_cache(maxsize=None)
def _jax_mnist_init(seed, hp_json):
    ctx = jax_train.init(hparams=json.loads(hp_json), mesh_config=MeshConfig(data=1), seed=seed,
                         core_context=jax_core._dummy_init(), devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxMnistTrial(ctx))
    trainer._setup()
    return jax.device_get(trainer.state.params)


class FromJaxMnistTrial(MnistTrial):
    """The port's MnistTrial starting from the JAX trial's initial weights
    for the same seed and hparams."""

    def build_model(self):
        model = super().build_model()
        hp = json.dumps(self.context.hparams, sort_keys=True)
        state = mnist_state_dict_from_flax(_jax_mnist_init(self.context.seed, hp))
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
        return model


def _checkpoints_by_step(ckdir, rid):
    """{uuid: steps_completed} of the checkpoints in a trial's directory."""
    trial_dir = os.path.join(ckdir, f"trial_{rid}")
    return {sid: json.load(open(os.path.join(trial_dir, sid, "metadata.json")))["steps_completed"]
            for sid in os.listdir(trial_dir)
            if os.path.isfile(os.path.join(trial_dir, sid, "metadata.json"))}


def _layout(ckdir, exp, clones):
    """Per trial: its checkpoints' steps, each marked whether it is the
    clone of its parent's checkpoint (named by the parent's uuid)."""
    return {rid: sorted((steps, sid == clones.get(rid, {}).get("uuid"))
                        for sid, steps in _checkpoints_by_step(ckdir, rid).items())
            for rid in exp.results}


def test_pbt_search_matches_the_jax_experiment(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = JaxLocalExperiment(JaxExperimentConfig.parse(PARITY_RAW), JaxMnistTrial,
                              checkpoint_dir=jax_dir, devices=jax.devices()[:1], preflight=False)
    assert want.run()["status"] == "completed"
    got = LocalExperiment(ExperimentConfig.parse(PARITY_RAW), FromJaxMnistTrial,
                          checkpoint_dir=port_dir, device="cpu")
    assert got.run()["status"] == "completed"

    lineage = got.searcher.method.lineage
    assert lineage == want.searcher.method.lineage
    assert sum(src is not None for src in lineage.values()) == 3
    assert sorted(got.results) == sorted(want.results)
    for rid, w in want.results.items():
        g = got.results[rid]
        assert (g.hparams, g.steps_completed, g.stopped_early) == \
            (w.hparams, w.steps_completed, w.stopped_early), rid
        np.testing.assert_allclose(g.metrics["validation_loss"], w.metrics["validation_loss"],
                                   **F32_TOL["loss"])

    got_journal = read_journal(journal_path(port_dir))
    want_journal = jax_read_journal(jax_journal_path(jax_dir))
    # the same records in the same order
    assert [(r["seq"], r["type"], r.get("rid")) for r in got_journal.records] == \
        [(r["seq"], r["type"], r.get("rid")) for r in want_journal.records]
    got_recs = [r for r in got_journal.records if r.get("type") == "trial_cloned"]
    want_recs = [r for r in want_journal.records if r.get("type") == "trial_cloned"]
    assert [set(r) for r in got_recs] == [set(r) for r in want_recs]
    assert sorted((r["rid"], r["source"], r["steps"]) for r in got_recs) == \
        sorted((r["rid"], r["source"], r["steps"]) for r in want_recs)
    for recs, exp in ((got_recs, got), (want_recs, want)):
        # the clone is the parent's final checkpoint
        assert all(r["uuid"] == exp.results[r["source"]].checkpoint for r in recs)
    assert _layout(port_dir, got, got_journal.clones) == \
        _layout(jax_dir, want, want_journal.clones)
