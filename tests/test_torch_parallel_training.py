"""The port's Trainer on a mesh: 4 gloo ranks on the CPU
(tests/torch_rank_worker.py, each launch under a hard timeout of
``RANK_TIMEOUT`` seconds) against the JAX Trainer on the 8-device virtual
mesh.

- ``LMTrial`` with MoE at data 2 x expert 2 tracks the JAX Trainer at
  ``MeshConfig(data=2, expert=4)`` (tests/test_moe.py's hparams) for 8
  steps from the same weights and batches, with the gradient clip engaged:
  losses and ``moe_aux_loss`` within chip_smoke's ``TRAIN_PARITY_TOL``
  loss tolerance, the params' updates within its update norm (perplexity,
  the mean of the slices' exp(loss), within 1e-2 and above JAX's).
- ``MnistTrial`` learns past 0.5 validation accuracy at data 4, fsdp 4 and
  data 2 x fsdp 2 (tests/test_trainer.py's cases without the tensor axis).
- A checkpoint saved at data 2 resumes at fsdp 2 x expert 2 and on one
  rank without a mesh (tests/test_trainer.py's resume across a mesh
  change), and the resumed runs end where an uninterrupted one does.
- Gradient accumulation on a mesh (FSDP syncs on the last microbatch
  only) ends at one device's params.
- Preemption asked of one rank stops every rank at the same boundary,
  with one checkpoint that every rank names.
- Every mesh composition passes the configuration check (tensor and
  ``num_slices`` beside pipe too; tests/test_torch_pipe_axes.py trains
  them); without a process group a mesh of several devices is refused for
  its size.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_PARITY_TOL
from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import to_global
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from determined_tpu_torch.data import to_device
from determined_tpu_torch.models import LMTrial, MnistTrial
from determined_tpu_torch.ops.fused_adamw import global_norm
from determined_tpu_torch.parallel import MeshConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

MOE_HP = dict(
    lr=1e-3, global_batch_size=16, seq_len=32, vocab_size=128, d_model=64, n_layers=2,
    n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1,
    moe_experts=4, moe_every=2, fused_adamw=True, grad_clip=0.05,
)
STEPS = 8
MNIST_HP = {"lr": 1e-2, "hidden": 32, "global_batch_size": 32, "dataset_size": 256}


@functools.lru_cache(maxsize=None)
def _jax_moe_mesh_run():
    ctx = jax_train.init(
        hparams=dict(MOE_HP), mesh_config=JaxMeshConfig(data=2, expert=4),
        core_context=jax_core._dummy_init(), seed=0, devices=jax.devices()[:8],
    )
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    metrics = []
    for _ in range(STEPS):
        state = trainer._train_step(state, to_global(next(it), trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init_params, jax.device_get(state.params)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_moe_lm_on_data2_expert2_tracks_the_jax_expert_mesh(tmp_path):
    want, init_params, want_params = _jax_moe_mesh_run()
    init_state = state_dict_from_flax(init_params)
    # the clip engages: the first step's global gradient norm is far above it
    ctx = train.init(hparams=dict(MOE_HP), seed=0, device="cpu")
    trial = LMTrial(ctx)
    model = trial.build_model()
    model.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()})
    batch = to_device(next(iter(trial.build_training_data_loader())), ctx.device)
    trial.loss(model, batch)[0].backward()
    norm = float(global_norm({k: p.grad for k, p in model.named_parameters()}))
    assert norm > 10 * MOE_HP["grad_clip"], norm

    outs = launch("train", 4, str(tmp_path / "run"), dict(
        trial="lm", hparams=dict(MOE_HP), mesh=dict(data=2, expert=2), seed=0,
        ckpt_dir=str(tmp_path / "ck"), init_state=init_state,
        fit=dict(max_length=STEPS, report_period=1, checkpoint_policy="none"),
    ))
    # rank r sits at (data, expert) = divmod(r, 2) and reads batch shard data
    assert [o["batch_shard"] for o in outs] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    got = outs[0]["training"]
    assert [s for s, _ in got] == list(range(1, STEPS + 1))
    tol = TRAIN_PARITY_TOL["loss"]
    for (step, g), w in zip(got, want):
        for k in ("loss", "moe_aux_loss", "lr"):
            np.testing.assert_allclose(g[k], w[k], err_msg=f"step {step} {k}", **tol)
        # a metric that is not a mean over examples is the ranks' mean of
        # their own values: exp of each slice's loss, not of the global one
        assert g["perplexity"] >= w["perplexity"] * (1 - 1e-6)
        np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=1e-2)
    got_params = flax_from_state_dict(outs[0]["params"], 4, 4)
    init = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(init_params)}
    got_leaves = {jax.tree_util.keystr(p): v
                  for p, v in jax.tree_util.tree_leaves_with_path({"params": got_params})}
    for path, ref in jax.tree_util.tree_leaves_with_path(want_params):
        key = jax.tree_util.keystr(path)
        upd_ref, upd = np.asarray(ref) - init[key], got_leaves[key] - init[key]
        assert _rel(upd, upd_ref) <= TRAIN_PARITY_TOL["update_rel"], (key, _rel(upd, upd_ref))


@pytest.mark.parametrize(
    "mesh", [dict(data=4), dict(fsdp=4), dict(data=2, fsdp=2)],
    ids=["dp4", "fsdp4", "dp2-fsdp2"],
)
def test_mnist_learns_under_parallelism(tmp_path, mesh):
    outs = launch("train", 4, str(tmp_path / "run"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=mesh, seed=7,
        ckpt_dir=str(tmp_path / "ck"),
        fit=dict(max_length=40, validation_period=20, report_period=10),
    ))
    summaries = [o["summary"] for o in outs]
    # every rank agrees on the run, the chief reported it
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["steps_completed"] == 40
    assert summaries[0]["validation_metrics"]["validation_accuracy"] > 0.5
    assert summaries[0]["latest_checkpoint"] is not None
    rows = outs[0]["training"]
    assert [s for s, _ in rows] == [10, 20, 30, 40]
    assert rows[-1][1]["loss"] < rows[0][1]["loss"]
    assert outs[1]["training"] == []  # only the chief reports


def _mnist_single(tmp_path, **fit):
    ctx = train.init(hparams=dict(MNIST_HP), seed=7, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "ck")))
    trainer = train.Trainer(MnistTrial(ctx))
    summary = trainer.fit(**fit)
    return trainer, summary


def test_checkpoint_resumes_across_a_mesh_change(tmp_path):
    """Saved at data 2 after 10 steps; resumed to 20 at fsdp 2 x expert 2
    and on one rank without a mesh; both end at the params of 20
    uninterrupted steps on one rank."""
    ck = str(tmp_path / "ck")
    first = launch("train", 2, str(tmp_path / "a"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(data=2), seed=7, ckpt_dir=ck,
        fit=dict(max_length=10, checkpoint_period=10, report_period=10,
                 checkpoint_policy="none"),
    ))
    sid = first[0]["summary"]["latest_checkpoint"]
    assert sid and first[1]["summary"]["latest_checkpoint"] == sid
    tstate = train.serialization.load_trainer_state(os.path.join(ck, sid))
    assert tstate["mesh_axes"] == {"dcn": 1, "data": 2, "fsdp": 1, "tensor": 1, "seq": 1,
                                   "expert": 1, "pipe": 1}

    resumed = launch("train", 4, str(tmp_path / "b"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(fsdp=2, expert=2), seed=7, ckpt_dir=ck,
        fit=dict(max_length=20, latest_checkpoint=sid, report_period=10,
                 checkpoint_policy="none"),
    ))
    assert resumed[0]["summary"]["steps_completed"] == 20
    assert [s for s, _ in resumed[0]["training"]] == [20]

    single, summary = _mnist_single(tmp_path, max_length=20, latest_checkpoint=sid,
                                    report_period=10, checkpoint_policy="none")
    assert summary["steps_completed"] == 20
    straight, _ = _mnist_single(tmp_path, max_length=20, report_period=20,
                                checkpoint_policy="none")
    want = {k: p.detach().numpy() for k, p in straight.model.named_parameters()}
    for k, p in single.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(resumed[0]["params"][k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize(
    "axes",
    [dict(tensor=2), dict(seq=2), dict(pipe=2, tensor=2), dict(num_slices=2, pipe=2)],
    ids=["tensor", "seq", "pipe", "num_slices"],
)
def test_mesh_axes_of_later_slices_raise(axes):
    # tensor, seq, pipe and num_slices are ported, MoE blocks on tensor and
    # seq too, and tensor or num_slices beside pipe (a mesh of several
    # devices needs a process group: the check of the mesh passes, then the
    # world's size refuses it)
    from determined_tpu_torch.train._trainer import check_exp_config

    n = 1
    for v in axes.values():
        n *= v
    hp = dict(MOE_HP) if set(axes) <= {"tensor", "seq"} else dict(MNIST_HP)
    cfg = ExperimentConfig.parse({"hyperparameters": hp, "resources": {"mesh": dict(axes)}})
    check_exp_config(cfg)
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        train.init(hparams=hp, device="cpu", mesh_config=MeshConfig(**axes))
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        train.init(exp_config=cfg, device="cpu")


def test_a_mesh_of_one_device_without_a_process_group_is_the_single_device_path():
    ctx = train.init(hparams=dict(MNIST_HP), device="cpu", mesh_config=MeshConfig(data=-1))
    assert ctx.mesh is None and ctx.batch_axis_size == 1
    with pytest.raises(ValueError, match="needs 2 devices, got 1"):
        train.init(hparams=dict(MNIST_HP), device="cpu", mesh_config=MeshConfig(data=2))


def test_gradient_accumulation_on_a_mesh_equals_one_device(tmp_path):
    raw = {"hyperparameters": dict(MNIST_HP),
           "optimizations": {"aggregation_frequency": 2}}
    outs = launch("train", 2, str(tmp_path / "run"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(data=2), seed=7, exp_config=raw,
        ckpt_dir=str(tmp_path / "ck"), fit=dict(max_length=6, report_period=6,
                                                 checkpoint_policy="none"),
    ))
    ctx = train.init(exp_config=ExperimentConfig.parse(raw), seed=7, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "one")))
    single = train.Trainer(MnistTrial(ctx))
    single.fit(max_length=6, report_period=6, checkpoint_policy="none")
    assert single.agg == 2
    for k, p in single.model.named_parameters():
        np.testing.assert_allclose(outs[0]["params"][k], p.detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(outs[0]["training"][-1][1]["loss"],
                               ctx.core.train.metrics("training")[-1][1]["loss"], rtol=1e-5)


def test_preemption_of_one_rank_stops_every_rank(tmp_path):
    outs = launch("train", 4, str(tmp_path / "run"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(data=2, fsdp=2), seed=7,
        ckpt_dir=str(tmp_path / "ck"), preempt_at=7,
        fit=dict(max_length=40, report_period=5, checkpoint_policy="none"),
    ))
    summaries = [o["summary"] for o in outs]
    assert all(s == summaries[0] for s in summaries)
    # asked before step 7, read at the next boundary (step 10)
    assert summaries[0]["stopped_early"] and summaries[0]["steps_completed"] == 10
    sid = summaries[0]["latest_checkpoint"]
    assert sid is not None
    tstate = train.serialization.load_trainer_state(str(tmp_path / "ck" / sid))
    assert tstate["steps_completed"] == 10
