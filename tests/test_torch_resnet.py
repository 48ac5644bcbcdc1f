"""The port's CIFAR ResNet slice (determined_tpu_torch: ``cifar_like``,
``models/resnet.py``, ``train/_optim.py``'s ``sgd``,
``convert.resnet_state_dict_from_flax``) against the JAX package's on the
CPU, and ``examples/cifar10/const.yaml`` through the port's ``run-local``.

- ``cifar_like`` gives the JAX package's arrays bit for bit.
- ``ResidualBlock`` and ``ResNet`` give the flax modules' outputs from the
  same weights: f32 within ``F32_ATOL``, bf16 within ``BF16_REL`` of the
  largest logit.  The stride-2 cases hold flax's asymmetric ``SAME`` pad
  (0 before, 1 after on 32 -> 16).  The weights round-trip exactly.
- ``sgd`` steps as ``optax.sgd(lr, momentum)``: bit for bit (the same f32
  operations in the same order).
- ``CifarTrial`` takes 3 steps in the JAX Trainer and in the port's from the
  same weights and batches (f32, widths (8, 16), one block a stage): losses,
  accuracies, params and momentum traces agree within
  ``test_torch_training.F32_TOL``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax.core import unfreeze

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import to_global
from determined_tpu.models.resnet import CifarTrial as JaxCifarTrial
from determined_tpu.models.resnet import ResidualBlock as JaxResidualBlock
from determined_tpu.models.resnet import ResNet as JaxResNet
from determined_tpu.models.resnet import cifar_like as jax_cifar_like
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig, Length
from determined_tpu_torch.convert import flax_from_resnet_state_dict, resnet_state_dict_from_flax
from determined_tpu_torch.data import cifar_like, to_device
from determined_tpu_torch.models import CifarTrial, ResidualBlock, ResNet
from determined_tpu_torch.train._optim import SGD, sgd
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL, _compare_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: both sides sum the same convolution terms in other orders (oneDNN
# against XLA) through up to 5 conv + GroupNorm layers; logits of order 1
F32_ATOL = 1e-5
# bf16: 8 mantissa bits, each side rounding every conv, GroupNorm, relu and
# residual sum on its own: within 2e-2 of the largest |output|
BF16_REL = 2e-2
STEPS = 3


def _load(model, params):
    state = resnet_state_dict_from_flax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def _flax_params(module, *args):
    params = nn.meta.unbox(unfreeze(module.init(jax.random.key(3), *map(jnp.asarray, args))))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("size, seed, classes", [(256, 0, 10), (100, 1, 10), (64, 7, 4)])
def test_cifar_like_equals_jax(size, seed, classes):
    got, want = cifar_like(size, classes, seed), jax_cifar_like(size, classes, seed)
    assert set(got.columns) == set(want.columns) == {"image", "label"}
    for k in want.columns:
        assert got.columns[k].dtype == want.columns[k].dtype, k
        np.testing.assert_array_equal(got.columns[k], want.columns[k])
    assert got.columns["image"].shape == (size, 32, 32, 3)


def _tol(dtype, want):
    return F32_ATOL if dtype == "float32" else BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin, channels, stride", [(8, 8, 1), (8, 16, 2), (3, 8, 2)])
def test_residual_block_gives_the_flax_output(cin, channels, stride, dtype):
    """A block alone on a 32x32 NHWC map; with stride 2 its conv1 and proj
    pad as flax's SAME does (0 before, 1 after), which a symmetric pad of 1
    does not give."""
    x = np.random.default_rng(cin + stride).standard_normal((3, 32, 32, cin)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_block = JaxResidualBlock(channels, stride, jdt)
    params = _flax_params(jax_block, jnp.asarray(x, jdt))
    want = np.asarray(jax_block.apply(params, jnp.asarray(x, jdt)), np.float32)
    block = _load(ResidualBlock(cin, channels, stride, device="cpu"), params)
    got = block(torch.tensor(x).permute(0, 3, 1, 2).to(tdt)).permute(0, 2, 3, 1).float()
    assert got.shape == want.shape == (3, 32 // stride, 32 // stride, channels)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=_tol(dtype, want))
    if stride == 2 and dtype == "float32":
        # the same weights with torch's symmetric padding=1 miss the flax output
        sym = torch.nn.functional.conv2d(
            torch.tensor(x).permute(0, 3, 1, 2), block.conv1.weight, stride=2, padding=1)
        asym = block.conv1(torch.tensor(x).permute(0, 3, 1, 2))
        assert (sym - asym).abs().max() > 100 * F32_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_gives_the_flax_logits(dtype):
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    jax_model = JaxResNet(widths=(8, 16), depth_per_stage=2, dtype=getattr(jnp, dtype))
    params = _flax_params(jax_model, x)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    model = _load(ResNet(widths=(8, 16), depth_per_stage=2, dtype=getattr(torch, dtype),
                         device="cpu"), params)
    got = model(torch.tensor(x))
    assert got.dtype == torch.float32  # the f32 head
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=_tol(dtype, want))
    # and back: the flax tree bit for bit
    back = flax_from_resnet_state_dict(model.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(params["params"])
    assert len(flat_back) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_resnet20_has_the_flax_parameter_count():
    shapes = jax.eval_shape(JaxResNet().init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    leaves = jax.tree.leaves(shapes)
    model = ResNet(device="cpu")
    assert len(list(model.parameters())) == len(leaves) == 65
    assert sum(p.numel() for p in model.parameters()) == sum(np.prod(s.shape) for s in leaves)


def test_sgd_steps_as_optax_sgd():
    rng = np.random.default_rng(2)
    shapes = {"w": (8, 3, 3, 3), "b": (17,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.sgd(0.05, momentum=0.9)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tx = sgd(0.05, momentum=0.9)
    tstate = tx.init(tparams)
    for _ in range(STEPS):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        _, tstate = tx.apply_step({k: torch.tensor(g) for k, g in grads.items()}, tstate, tparams)
        for k in shapes:
            np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(jparams[k]))
            np.testing.assert_array_equal(tstate.trace[k].numpy(), np.asarray(jstate[0].trace[k]))


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer(CifarTrial), JAX against the port
# ---------------------------------------------------------------------------

HP = dict(lr=0.05, momentum=0.9, global_batch_size=8, dataset_size=64, widths=[8, 16],
          depth_per_stage=1, bf16=False)


@functools.lru_cache(maxsize=None)
def _jax_run(steps):
    ctx = jax_train.init(hparams=dict(HP), mesh_config=MeshConfig(data=1),
                         core_context=jax_core._dummy_init(), seed=0,
                         devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxCifarTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    batches, metrics = [], []
    for _ in range(steps):
        batches.append(next(it))
        state = trainer._train_step(state, to_global(batches[-1], trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init_params, jax.device_get(state.params), \
        jax.device_get(state.opt_state), batches


def test_cifar_trial_trains_as_the_jax_trainer():
    want_metrics, init_params, want_params, want_opt, want_batches = _jax_run(STEPS)
    ctx = train.init(hparams=dict(HP), seed=0, device="cpu")
    trainer = train.Trainer(CifarTrial(ctx))
    trainer._setup()
    assert trainer.tx == SGD(0.05, 0.9)
    _load(trainer.model, init_params)
    it = iter(trainer.train_loader)
    for step in range(STEPS):
        batch = next(it)
        for k in batch:
            np.testing.assert_array_equal(batch[k], want_batches[step][k])
        trainer._train_step(to_device(batch, trainer.device))
        got = trainer.state.fetch_metrics()
        trainer.state.reset_metrics()
        assert set(got) == set(want_metrics[step]) == {"loss", "accuracy"}
        np.testing.assert_allclose(got["loss"], want_metrics[step]["loss"], **F32_TOL["loss"])
        np.testing.assert_allclose(got["accuracy"], want_metrics[step]["accuracy"], atol=1e-6)
    got_params = flax_from_resnet_state_dict(trainer.model.state_dict())
    _compare_trees({"params": got_params}, want_params, F32_TOL["params_rel"], "params",
                   atol=F32_TOL["params_atol"])
    trace = want_opt[0].trace  # optax.sgd: (TraceState, EmptyState)
    got_trace = flax_from_resnet_state_dict(trainer.state.opt_state.trace)
    _compare_trees({"params": got_trace}, trace, F32_TOL["moments_rel"], "trace")


# ---------------------------------------------------------------------------
# examples/cifar10/const.yaml through the port's run-local
# ---------------------------------------------------------------------------


def test_cifar10_const_yaml_epochs_are_4_x_64_steps_with_a_validation_each():
    import yaml

    cfg = ExperimentConfig.from_yaml(os.path.join(REPO, "examples/cifar10/const.yaml"))
    assert cfg.searcher.max_length == Length.epochs(4)
    ctx = train.init(exp_config=cfg, device="cpu")
    trainer = train.Trainer(CifarTrial(ctx))
    trainer._setup()
    assert trainer.train_loader.batches_per_epoch == 8192 // 128 == 64
    assert trainer._to_batches(cfg.searcher.max_length) == 4 * 64
    assert trainer._to_batches(cfg.min_validation_period) == 64
    assert yaml.safe_load(open(os.path.join(REPO, "examples/cifar10/const.yaml")))[
        "hyperparameters"] == {k: v for k, v in ctx.hparams.items()}


def test_cifar10_const_yaml_runs_through_run_local(tmp_path, monkeypatch, capsys):
    """``run-local examples/cifar10/const.yaml
    determined_tpu_torch.models.resnet:CifarTrial``, cut in size (a batch
    of 8 over 32 samples: 4 steps an epoch, 2 epochs, a validation each, f32
    on the CPU).  The CLI runs on the GPU; here its device is pinned to the
    CPU."""
    import yaml

    from determined_tpu_torch.cli.main import main
    from determined_tpu_torch.experiment import journal_path, local

    monkeypatch.setattr(local, "resolve_device", lambda device: torch.device("cpu"))
    raw = yaml.safe_load(open(os.path.join(REPO, "examples/cifar10/const.yaml")))
    raw["hyperparameters"].update(global_batch_size=8, dataset_size=32, bf16=False)
    raw["searcher"]["max_length"] = {"epochs": 2}
    config = tmp_path / "const.yaml"
    config.write_text(yaml.safe_dump(raw))
    ckpt_dir = str(tmp_path / "ckpts")
    entry = "determined_tpu_torch.models.resnet:CifarTrial"
    assert main(["run-local", str(config), entry, "--checkpoint-dir", ckpt_dir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["status"] == "completed" and summary["total_steps"] == 8
    assert set(summary["best_metrics"]) >= {"validation_loss", "validation_accuracy"}
    with open(journal_path(ckpt_dir)) as f:
        validated = [r["metrics"] for r in map(json.loads, f) if r["type"] == "trial_validated"]
    assert len(validated) == 2, validated  # one a epoch
