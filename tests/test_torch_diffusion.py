"""The port's DDPM slice (determined_tpu_torch: ``models/diffusion.py``,
``convert.unet_state_dict_from_flax``, the Trainer's step generator, the
fused AdamW's plain version) against the JAX package's on the CPU, and
``examples/diffusion/const.yaml`` through the port's ``run-local``.

- ``timestep_embedding`` and ``cosine_schedule`` give the JAX tables to a
  few f32 ulps (``TABLE_ATOL``).
- ``UNet`` (``base_channels`` 8) gives the flax module's output from the same weights (every
  leaf, the zero-initialised ones too, moved off zero): f32 within
  ``F32_ATOL``; bf16 within ``BF16_REL_NORM`` of the JAX bf16 output.  Its
  gradients in f32 within ``GRAD_REL`` in relative norm, leaf by leaf.  The
  weights round-trip exactly; at ``base_channels`` 32 it has flax's 82
  leaves and 517,249 parameters.
- ``noised_loss`` with the t and eps JAX draws (``split(fold_in(rng,
  step))``) gives the JAX trial's loss; ``ddpm_sample`` at T = 8 fed JAX's
  noise gives JAX's samples.
- The port's AdamW (``fused_adamw`` with decay 1e-4 and no clip) steps as
  ``optax.adamw(lr)``; ``DiffusionTrial`` takes 3 steps in the JAX Trainer
  and in the port's from the same weights, batches and draws.
- The step generator: a run preempted and resumed ends bitwise equal to the
  uninterrupted one, and an accumulated step draws one t and eps for all
  its microbatches.
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
from determined_tpu.models import diffusion as jd
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import (
    _adam_state,
    flax_from_unet_state_dict,
    unet_state_dict_from_flax,
)
from determined_tpu_torch.data import to_device
from determined_tpu_torch.experiment import LocalExperiment
from determined_tpu_torch.models import CifarTrial, DiffusionTrial, UNet
from determined_tpu_torch.models import diffusion as pd
from determined_tpu_torch.ops.fused_adamw import FusedAdamW
from determined_tpu_torch.train import Callback
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_mnist import ADAM_TOL
from tests.test_torch_training import F32_TOL, _compare_trees, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tables: both sides take the same f32 operations, their cos, exp and
# cumprod a last bit apart; betas and 1 - alpha_bar are differences from 1,
# so they are held in absolute terms: 4 ulps of 1.0
TABLE_ATOL = 4 * 2.0 ** -23
# the embedding's arguments reach 999 rad, where a last-bit difference of
# a frequency (exp) moves cos and sin by up to 999 * 2^-24 relative
EMB_ATOL = 6e-5
# f32 forward through ~20 conv / GroupNorm / dense layers, sums in other
# orders (oneDNN against XLA); outputs of order 1
F32_ATOL = 2e-5
# bf16: each side rounds ~25 times with 8 mantissa bits; JAX's bf16 output
# itself departs from its f32 one by ~1.8% in relative norm at these
# weights, so the two bf16 outputs are held to each other (and each to the
# f32 reference) at 4e-2
BF16_REL_NORM = 4e-2
# f32 gradients, summed over the batch and the map in other orders
GRAD_REL = 1e-4
# a gradient that is 0 in exact arithmetic: f32 noise of the sums around it
ZERO_GRAD = 1e-6
# at base_channels 8, the biases whose every path runs into a GroupNorm of
# one channel a group: conv1's into its block's GroupNorm_1 (down0, up0),
# up0's conv2 and skip into the UNet's GroupNorm_0
ZERO_GRAD_BIASES = [("down0", "conv1"), ("up0", "conv1"), ("up0", "conv2"), ("up0", "skip")]
# base_channels 16: every GroupNorm group holds two channels or more.  At 8
# a group of down0 and up0 holds one channel, which the norm maps to 0
# whatever conv1's bias adds, so that bias's true gradient is 0 and both
# sides return f32 noise for it
# Trainer(DiffusionTrial), 3 steps: the zero-initialised conv2 kernels
# close every ResBlock's inner path at step 1, so the leaves behind them
# get zero gradients, then at step 2 gradients of order lr.  Adam turns
# those small gradients' f32 differences into update differences of up to
# 0.1% of lr, and the leaves that start at zero (biases, GroupNorm shifts)
# hold nothing but updates: params held in relative norm within 1e-3, and
# elementwise within 2 * sum(lr), as F32_TOL holds them (a weight moves by
# at most lr a step whatever its gradient); losses and moments at F32_TOL
PARAMS_REL = 1e-3
HP = dict(lr=1e-3, base_channels=16, timesteps=50, global_batch_size=4, dataset_size=32,
          bf16=False)
STEPS = 3


@functools.lru_cache(maxsize=None)
def _flax_unet(base, dtype, seed=1):
    """A flax UNet and its params with every leaf moved off its init (the
    zero-initialised conv2, proj and head would hide their paths), once per
    arguments (the module's tests only read them)."""
    rng = np.random.default_rng(seed)
    model = jd.UNet(base_channels=base, dtype=dtype)
    params = nn.meta.unbox(unfreeze(model.init(
        jax.random.key(seed), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32))))
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    return model, params


def _port_unet(params, base, dtype):
    model = UNet(base_channels=base, dtype=dtype, device="cpu")
    state = unet_state_dict_from_flax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def _inputs(seed=2, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 28, 28, 1)).astype(np.float32)
    t = np.array([0, 17, 999, 5, 400][:b], np.int32)
    return x, t


@pytest.mark.parametrize("dim", [32, 128])
def test_timestep_embedding_equals_jax(dim):
    t = np.array([0, 1, 7, 50, 500, 999], np.int32)
    want = np.asarray(jd.timestep_embedding(jnp.asarray(t), dim))
    got = pd.timestep_embedding(torch.tensor(t), dim)
    assert got.dtype == torch.float32 and got.shape == want.shape == (6, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMB_ATOL)


@pytest.mark.parametrize("timesteps", [8, 50, 1000])
def test_cosine_schedule_equals_jax(timesteps):
    want, got = jd.cosine_schedule(timesteps), pd.cosine_schedule(timesteps)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape == (timesteps,), k
        if k == "sqrt_1mab":  # sqrt near 0 amplifies: hold 1 - alpha_bar
            w, g = w ** 2, g ** 2
        np.testing.assert_allclose(g, w, rtol=0, atol=TABLE_ATOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_gives_the_flax_output(dtype):
    x, t = _inputs()
    jax_model, params = _flax_unet(8, getattr(jnp, dtype))
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t)))
    model = _port_unet(params, 8, getattr(torch, dtype))
    got = model(torch.tensor(x), torch.tensor(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == x.shape
    got = got.detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        f32 = np.asarray(jd.UNet(base_channels=8).apply(params, jnp.asarray(x), jnp.asarray(t)))
        assert _rel(got, want) <= BF16_REL_NORM, _rel(got, want)
        assert _rel(got, f32) <= BF16_REL_NORM and _rel(want, f32) <= BF16_REL_NORM
    back = flax_from_unet_state_dict(model.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(params["params"])
    assert len(flat_back) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_unet_gradients_equal_flax():
    """f32 gradients leaf by leaf at base_channels 8.  There the GroupNorms
    over 8 channels hold one channel a group and map a per-channel constant
    to 0: the biases added just before one (ZERO_GRAD_BIASES) have a true
    gradient of 0, and both sides must give only f32 noise for them, under
    ZERO_GRAD of the largest leaf gradient."""
    x, t = _inputs()
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jax_model, params = _flax_unet(8, jnp.float32)
    want = jax.grad(lambda p: jnp.sum(jax_model.apply(p, jnp.asarray(x), jnp.asarray(t)) * r))(
        jax.tree.map(jnp.asarray, params))
    model = _port_unet(params, 8, torch.float32)
    (model(torch.tensor(x), torch.tensor(t)) * torch.tensor(r)).sum().backward()
    got = dict(jax.tree_util.tree_leaves_with_path(
        flax_from_unet_state_dict({k: p.grad for k, p in model.named_parameters()})))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(want)["params"])
    noise = ZERO_GRAD * max(np.linalg.norm(w) for _, w in want)
    zero = sorted(jax.tree_util.keystr(p) for p, w in want if np.linalg.norm(w) <= noise)
    assert zero == [f"['{m}']['{c}']['bias']" for m, c in ZERO_GRAD_BIASES], zero
    for path, w in want:
        g, name = got[path], jax.tree_util.keystr(path)
        if name in zero:
            assert np.linalg.norm(g) <= noise, (name, np.linalg.norm(g))
        else:
            assert _rel(g, np.asarray(w)) <= GRAD_REL, (name, _rel(g, np.asarray(w)))


def _jax_draws(rng, b, timesteps):
    """The t and eps the JAX trial draws from its step rng."""
    t_rng, n_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (b,), 0, timesteps)
    eps = jax.random.normal(n_rng, (b, 28, 28, 1))
    return np.asarray(t), np.asarray(eps)


def test_noised_loss_with_the_jax_draws_gives_the_jax_loss():
    jax_model, params = _flax_unet(8, jnp.float32)
    trial = jd.DiffusionTrial.__new__(jd.DiffusionTrial)
    trial.context = type("C", (), {"get_hparam": staticmethod(
        lambda name, default=None: dict(HP).get(name, default))})()
    img = np.random.default_rng(5).random((4, 28, 28, 1)).astype(np.float32)
    step_rng = jax.random.fold_in(jax.random.key(11), 3)
    want, metrics = trial.loss(jax_model, params, {"image": jnp.asarray(img)}, step_rng)
    t, eps = _jax_draws(step_rng, 4, HP["timesteps"])
    model = _port_unet(params, 8, torch.float32)
    got = pd.noised_loss(model, torch.tensor(img) * 2 - 1, torch.tensor(t).long(),
                         torch.tensor(eps), pd.cosine_schedule(HP["timesteps"]))
    np.testing.assert_allclose(float(got.detach()), float(want), **F32_TOL["loss"])
    assert float(metrics["mse"]) == float(want)


def test_ddpm_sample_with_the_jax_noise_gives_the_jax_samples():
    jax_model, params = _flax_unet(8, jnp.float32)
    shape, T = (2, 28, 28, 1), 8
    rng = jax.random.key(7)
    want = np.asarray(jd.ddpm_sample(jax_model, params, rng, shape, timesteps=T))
    x0 = np.asarray(jax.random.normal(rng, shape))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, t), shape))
                      for t in range(T)])
    model = _port_unet(params, 8, torch.float32)
    got = pd.ddpm_sample(model, shape, T, x_init=torch.tensor(x0), step_noise=torch.tensor(noise))
    assert got.shape == want.shape == shape
    # the last step divides by sqrt(alpha) = sqrt(0.001): f32 differences
    # grow ~30x there; samples of order 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # from a generator: finite, the same for the same seed
    a = pd.ddpm_sample(model, shape, T, generator=torch.Generator().manual_seed(0))
    b = pd.ddpm_sample(model, shape, T, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_port_adamw_steps_as_optax_adamw():
    """DiffusionTrial's optimizer (what ``optax.adamw(lr)`` is: decay 1e-4,
    no clip, f32 moments) at UNet leaf shapes."""
    rng = np.random.default_rng(2)
    shapes = {"conv": (3, 3, 8, 16), "bias": (16,), "dense": (32, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adamw(2e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    ctx = train.init(hparams=dict(HP, lr=2e-4), device="cpu")
    tx = DiffusionTrial(ctx).build_optimizer()
    assert tx == FusedAdamW(2e-4, weight_decay=1e-4, clip_norm=None)
    tstate = tx.init(tparams)
    for _ in range(STEPS):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        _, tstate = tx.apply_step({k: torch.tensor(g) for k, g in grads.items()}, tstate, tparams)
        adam = _adam_state(jstate)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **ADAM_TOL)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(adam.mu[k]), **ADAM_TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), **ADAM_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer(DiffusionTrial), JAX against the port
# ---------------------------------------------------------------------------


class FedDiffusionTrial(DiffusionTrial):
    """DiffusionTrial whose step takes the t and eps set in ``feed``."""

    feed = None

    def loss(self, model, batch, rng):
        t, eps = self.feed
        loss = pd.noised_loss(model, batch["image"].float() * 2.0 - 1.0, t, eps, self.schedule)
        return loss, {"mse": loss}


@functools.lru_cache(maxsize=None)
def _jax_run(steps):
    ctx = jax_train.init(hparams=dict(HP), mesh_config=MeshConfig(data=1),
                         core_context=jax_core._dummy_init(), seed=0,
                         devices=jax.devices()[:1])
    trainer = jax_train.Trainer(jd.DiffusionTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    batches, draws, metrics = [], [], []
    for _ in range(steps):
        batches.append(next(it))
        draws.append(_jax_draws(jax.random.fold_in(state.rng, state.step),
                                HP["global_batch_size"], HP["timesteps"]))
        state = trainer._train_step(state, to_global(batches[-1], trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init_params, jax.device_get(state.params), \
        jax.device_get(state.opt_state), batches, draws


def test_diffusion_trial_trains_as_the_jax_trainer():
    want_metrics, init_params, want_params, want_opt, want_batches, draws = _jax_run(STEPS)
    ctx = train.init(hparams=dict(HP), seed=0, device="cpu")
    trainer = train.Trainer(FedDiffusionTrial(ctx))
    trainer._setup()
    state = unet_state_dict_from_flax(init_params)
    trainer.model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    it = iter(trainer.train_loader)
    for step in range(STEPS):
        batch = next(it)
        for k in batch:
            np.testing.assert_array_equal(batch[k], want_batches[step][k])
        t, eps = draws[step]
        trainer.trial.feed = (torch.tensor(t).long(), torch.tensor(eps))
        trainer._train_step(to_device(batch, trainer.device))
        got = trainer.state.fetch_metrics()
        trainer.state.reset_metrics()
        assert set(got) == set(want_metrics[step]) == {"loss", "mse"}
        np.testing.assert_allclose(got["loss"], want_metrics[step]["loss"], **F32_TOL["loss"])
    got_params = flax_from_unet_state_dict(trainer.model.state_dict())
    _compare_trees({"params": got_params}, want_params, PARAMS_REL, "params",
                   atol=2 * STEPS * HP["lr"])
    adam = _adam_state(want_opt)
    opt = trainer.state.opt_state
    assert int(opt.count) == int(np.asarray(adam.count)) == STEPS
    for which in ("mu", "nu"):
        got = flax_from_unet_state_dict(getattr(opt, which))
        _compare_trees({"params": got}, getattr(adam, which), F32_TOL["moments_rel"], which)


# ---------------------------------------------------------------------------
# the step generator: resume and gradient accumulation
# ---------------------------------------------------------------------------

TRAINERS = []


class _Capture(Callback):
    def on_training_start(self, trainer):
        TRAINERS.append(trainer)


class CapturingDiffusionTrial(DiffusionTrial):
    def build_callbacks(self):
        return {"capture": _Capture()}


class CapturingCifarTrial(CifarTrial):
    def build_callbacks(self):
        return {"capture": _Capture()}


class _Hook:
    def __init__(self, step, action):
        self.step, self.action, self.fired = step, action, False

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step and not self.fired:
            self.fired = True
            self.action()


CIFAR_HP = dict(lr=0.05, momentum=0.9, global_batch_size=4, dataset_size=32, widths=[8, 16],
                depth_per_stage=1, bf16=False)


@pytest.mark.parametrize("trial_cls, hp", [(CapturingDiffusionTrial, HP),
                                           (CapturingCifarTrial, CIFAR_HP)])
def test_preempted_and_resumed_run_equals_uninterrupted_bitwise(tmp_path, trial_cls, hp):
    """8 steps, preempted before step 6 and resumed, against 8 steps in one
    go: params, optimizer state and step bitwise (the diffusion steps'
    draws come from the step generator, the ResNet's momentum traces go
    through the checkpoint)."""
    raw = {"name": "tiny", "hyperparameters": hp,
           "searcher": {"name": "single", "metric": "validation_loss",
                        "max_length": {"batches": 8}},
           "min_validation_period": {"batches": 4}, "min_checkpoint_period": {"batches": 6}}
    cfg = ExperimentConfig.parse(raw)
    del TRAINERS[:]
    assert LocalExperiment(cfg, trial_cls, checkpoint_dir=str(tmp_path / "c"),
                           device="cpu").run()["status"] == "completed"
    whole = TRAINERS[-1]
    exp = LocalExperiment(cfg, trial_cls, checkpoint_dir=str(tmp_path / "ab"), device="cpu")
    faults.set_fault_injector(_Hook(5, exp.request_preemption))
    try:
        assert exp.run()["status"] == "preempted"
    finally:
        faults.set_fault_injector(None)
    resumed = LocalExperiment(cfg, trial_cls, checkpoint_dir=str(tmp_path / "ab"),
                              device="cpu").resume()
    assert resumed["status"] == "completed"
    last = TRAINERS[-1]
    assert last is not whole and last.steps_completed == whole.steps_completed == 8
    assert int(last.state.step) == 8
    for k, p in whole._params.items():
        assert torch.equal(last._params[k], p), k
    for a, b in zip(whole.state.opt_state, last.state.opt_state):
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert torch.equal(a, b)
    del TRAINERS[:]


class RecordingDiffusionTrial(DiffusionTrial):
    """Records the timesteps each loss call draws."""

    drawn = []

    def loss(self, model, batch, rng):
        state = rng.get_state()
        t = torch.randint(0, int(self._hp("timesteps", 1000)), (batch["image"].shape[0],),
                          generator=rng)
        rng.set_state(state)
        self.drawn.append(t)
        return super().loss(model, batch, rng)


def test_an_accumulated_step_draws_one_set_for_all_its_microbatches():
    cfg = ExperimentConfig.parse({"hyperparameters": HP,
                                  "optimizations": {"aggregation_frequency": 2}})
    trainer = train.Trainer(RecordingDiffusionTrial(train.init(exp_config=cfg, device="cpu")))
    RecordingDiffusionTrial.drawn = []
    trainer.fit(max_length=3, checkpoint_policy="none")
    drawn = RecordingDiffusionTrial.drawn
    assert len(drawn) == 6  # 3 steps of 2 microbatches
    for step in range(3):
        assert torch.equal(drawn[2 * step], drawn[2 * step + 1]), step
    assert not torch.equal(drawn[0], drawn[2]) and not torch.equal(drawn[2], drawn[4])
    # and a step draws what it draws in an unaccumulated run at that step
    seed = trainer.state.step_seed(1)
    want = torch.randint(0, HP["timesteps"], (HP["global_batch_size"],),
                         generator=torch.Generator().manual_seed(seed))
    assert torch.equal(drawn[2], want)


def test_validation_draws_from_a_generator_seeded_with_0():
    """As JAX's ``evaluate_batch`` passes ``jax.random.key(0)``: the trial's
    own and the base class's default (for a trial whose loss takes a
    generator) draw the same t and eps every time."""
    from determined_tpu_torch.train import TorchTrial

    class DefaultEvaluation(DiffusionTrial):
        evaluate_batch = TorchTrial.evaluate_batch

    ctx = train.init(hparams=dict(HP, base_channels=8), seed=0, device="cpu")
    trial, default = DiffusionTrial(ctx), DefaultEvaluation(ctx)
    model = trial.build_model()
    for p in model.parameters():  # off the zero init, so the loss reads the model
        torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(1))
    batch = to_device(next(iter(trial.build_validation_data_loader())), ctx.device)
    with torch.no_grad():
        first = trial.evaluate_batch(model, batch)
        again = trial.evaluate_batch(model, batch)
        base = default.evaluate_batch(model, batch)
    assert set(first) == {"validation_loss"} and set(base) == {"validation_loss", "val_mse"}
    assert torch.equal(first["validation_loss"], again["validation_loss"])
    assert torch.equal(first["validation_loss"], base["validation_loss"])


# ---------------------------------------------------------------------------
# examples/diffusion/const.yaml through the port's run-local
# ---------------------------------------------------------------------------


def test_diffusion_const_yaml_runs_through_run_local(tmp_path, monkeypatch, capsys):
    """``run-local examples/diffusion/const.yaml
    determined_tpu_torch.models.diffusion:DiffusionTrial``, cut in length (4
    batches of 4, a validation every 2, 16 samples; the UNet at its
    base_channels 32, bf16).  The CLI runs on the GPU; here its device is
    pinned to the CPU."""
    import yaml

    from determined_tpu_torch.cli.main import main
    from determined_tpu_torch.experiment import journal_path, local

    monkeypatch.setattr(local, "resolve_device", lambda device: torch.device("cpu"))
    raw = yaml.safe_load(open(os.path.join(REPO, "examples/diffusion/const.yaml")))
    raw["hyperparameters"].update(global_batch_size=4, dataset_size=16)
    raw["searcher"]["max_length"] = {"batches": 4}
    raw["min_validation_period"] = {"batches": 2}
    config = tmp_path / "const.yaml"
    config.write_text(yaml.safe_dump(raw))
    ckpt_dir = str(tmp_path / "ckpts")
    entry = "determined_tpu_torch.models.diffusion:DiffusionTrial"
    assert main(["run-local", str(config), entry, "--checkpoint-dir", ckpt_dir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["status"] == "completed" and summary["total_steps"] == 4
    with open(journal_path(ckpt_dir)) as f:
        validated = [r["metrics"] for r in map(json.loads, f) if r["type"] == "trial_validated"]
    assert len(validated) == 2 and all(np.isfinite(m["validation_loss"]) for m in validated)


@pytest.mark.parametrize("part, path", [("cifar10", "examples/cifar10/const.yaml"),
                                        ("diffusion", "examples/diffusion/const.yaml")])
def test_chip_smoke_models_configs_are_their_files_apart_from_their_cuts(part, path):
    import yaml

    import chip_smoke
    from tests.test_torch_mnist import _restore_cuts

    file_raw = yaml.safe_load(open(os.path.join(REPO, path)))
    assert {"cifar10": chip_smoke.CIFAR_CONST, "diffusion": chip_smoke.DIFFUSION_CONST}[part] \
        == file_raw
    got = chip_smoke.models_raw_config(part, "/tmp/ckpts", 7)
    placeholders = {"<temp dir>": "/tmp/ckpts", "<--seed>": 7}
    assert _restore_cuts(got, chip_smoke.MODELS_CUTS, placeholders, file_raw) == file_raw
    cfg = ExperimentConfig.parse(got)
    assert cfg.checkpoint_storage.host_path == "/tmp/ckpts"
    assert cfg.reproducibility.experiment_seed == 7
    # part P changes hyperparameters only, each from the file's value
    for which, key, file_value, _value, _why in chip_smoke.MODELS_PARITY_CUTS:
        if which == part:
            assert file_raw["hyperparameters"].get(key) == file_value, key
