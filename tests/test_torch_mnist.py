"""The port's MNIST slice (determined_tpu_torch: ``mnist_like``,
``models/mnist.py``, ``convert.mnist_state_dict_from_flax``) against the JAX
package's on the CPU, and ``chip_smoke.py``'s search configurations against
their files.

- ``mnist_like`` gives the JAX package's arrays bit for bit, synthetic and
  from IDX files under ``$DTPU_MNIST_DIR``.
- ``MnistMLP`` and ``MnistCNN`` give the flax modules' logits from the same
  weights (f32; atol 1e-5 for the MLP, 1e-4 for the CNN, whose convolutions
  sum in another order), and the weight conversion round-trips exactly.
- The port's Adam (``fused_adamw`` with no decay and no clip, what
  ``MnistTrial`` builds) steps as ``optax.adam`` does.
- ``MnistTrial`` takes 5 steps in the JAX Trainer and in the port's from
  the same weights and batches: losses, accuracies, params and both Adam
  moments agree within ``test_torch_training.F32_TOL``.  The CNN variant is
  held there for 3 steps: its loss jumps at step 3 (lr 1e-3), and from
  there the two frameworks' f32 differences grow (the first moments differ
  by 1e-6 relative after one step, 8e-6 after three, 5.4e-4 after four and
  4.5e-4 after five, past F32_TOL's 1e-4).  That this is rounding and not a fault in
  the convolution backward or the flatten order: in float64 the port's CNN
  and loss follow the flax CNN and the JAX trial's loss through all 5 steps
  (one f64 Adam on both sides) to 2.5e-15 relative, inside F64_REL.  The
  likely amplifier in f32 is Adam's update g / (|g| + 1e-8), which turns a
  1e-10 rounding error in a nearly cancelling 1e-8 gradient into 1% of lr.
"""

import functools
import gzip
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as nn
from flax.core import unfreeze

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import mnist_like as jax_mnist_like
from determined_tpu.data import to_global
from determined_tpu.models.mnist import MnistCNN as JaxMnistCNN
from determined_tpu.models.mnist import MnistMLP as JaxMnistMLP
from determined_tpu.models.mnist import MnistTrial as JaxMnistTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import flax_from_mnist_state_dict, mnist_state_dict_from_flax
from determined_tpu_torch.data import mnist_like, to_device
from determined_tpu_torch.models import MnistCNN, MnistMLP, MnistTrial
from determined_tpu_torch.ops.fused_adamw import FusedAdamW
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL, _compare_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's f32 Adam sweep against optax: the JAX package's bound for its
# own fused sweep (chip_smoke.ADAMW_TOL["float32"], tests/test_ops.py)
ADAM_TOL = dict(rtol=2e-6, atol=2e-7)
STEPS = 5
# float64: 2^-52 rounding grown by the factor that takes f32's 2^-23 to
# 4e-4 over the CNN's 5 steps (~4e3); the two sides differ by 2.5e-15
F64_REL = 1e-12


def _same_dataset(got, want):
    assert set(got.columns) == set(want.columns)
    for k in want.columns:
        assert got.columns[k].dtype == want.columns[k].dtype, k
        np.testing.assert_array_equal(got.columns[k], want.columns[k])


@pytest.mark.parametrize("size, seed", [(256, 0), (100, 1), (64, 7)])
def test_mnist_like_synthetic_equals_jax(size, seed, monkeypatch):
    monkeypatch.setenv("HOME", "/nonexistent")  # no ~/.cache/mnist in either
    monkeypatch.delenv("DTPU_MNIST_DIR", raising=False)
    _same_dataset(mnist_like(size=size, seed=seed), jax_mnist_like(size=size, seed=seed))
    assert mnist_like(size=size, seed=seed).columns["image"].shape == (size, 28, 28, 1)


def _write_idx(path, array):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, array.ndim))
        f.write(struct.pack(f">{array.ndim}I", *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def test_mnist_like_reads_idx_files_as_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    _write_idx(tmp_path / "train-images-idx3-ubyte.gz", rng.integers(0, 256, (50, 28, 28)))
    _write_idx(tmp_path / "train-labels-idx1-ubyte.gz", rng.integers(0, 10, (50,)))
    monkeypatch.setenv("DTPU_MNIST_DIR", str(tmp_path))
    for size, seed in ((20, 0), (20, 1), (40, 1)):  # the last slice clamps to the end
        got = mnist_like(size=size, seed=seed)
        _same_dataset(got, jax_mnist_like(size=size, seed=seed))
        assert got.columns["image"].max() <= 1.0


def _flax_params(module, x):
    params = nn.meta.unbox(unfreeze(module.init(jax.random.key(3), jnp.asarray(x))))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind, atol", [("mlp", 1e-5), ("cnn", 1e-4)])
def test_mnist_models_give_the_flax_logits(kind, atol):
    x = np.random.default_rng(1).standard_normal((6, 28, 28, 1)).astype(np.float32)
    jax_model, model = {
        "mlp": (JaxMnistMLP(hidden=48), MnistMLP(48, device="cpu")),
        "cnn": (JaxMnistCNN(), MnistCNN(device="cpu")),
    }[kind]
    params = _flax_params(jax_model, x)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    state = mnist_state_dict_from_flax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    got = model(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # and back: the flax tree bit for bit
    back = flax_from_mnist_state_dict(model.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        np.testing.assert_array_equal(flat_back[path], leaf)
        assert flat_back[path].shape == leaf.shape


def test_port_adam_steps_as_optax_adam():
    rng = np.random.default_rng(2)
    shapes = {"w": (33, 17), "b": (17,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adam(3e-3)
    jstate = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tx = FusedAdamW(3e-3, weight_decay=0.0, clip_norm=None)
    tstate = tx.init(tparams)
    for _ in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32) * 10 for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        _, tstate = tx.apply_step({k: torch.tensor(g) for k, g in grads.items()}, tstate, tparams)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **ADAM_TOL)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate[0].mu[k]),
                                       **ADAM_TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate[0].nu[k]),
                                       **ADAM_TOL)
    assert int(tstate.count) == int(jstate[0].count) == 4


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer(MnistTrial), JAX against the port
# ---------------------------------------------------------------------------

HP = dict(lr=1e-3, hidden=32, global_batch_size=16, dataset_size=128)


@functools.lru_cache(maxsize=None)
def _jax_run(hp_items, steps):
    hp = dict(hp_items)
    ctx = jax_train.init(hparams=hp, mesh_config=MeshConfig(data=1),
                         core_context=jax_core._dummy_init(), seed=0,
                         devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxMnistTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    batches, metrics = [], []
    for _ in range(steps):
        batch = next(it)
        batches.append(batch)
        state = trainer._train_step(state, to_global(batch, trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init_params, jax.device_get(state.params), jax.device_get(state.opt_state), \
        batches


@pytest.mark.parametrize("kind, steps", [("mlp", STEPS), ("cnn", 3)])
def test_mnist_trial_trains_as_the_jax_trainer(kind, steps):
    hp = dict(HP, model=kind)
    want_metrics, init_params, want_params, want_opt, want_batches = _jax_run(
        tuple(sorted(hp.items())), steps)
    ctx = train.init(hparams=hp, seed=0, device="cpu")
    trainer = train.Trainer(MnistTrial(ctx))
    trainer._setup()
    assert isinstance(trainer.tx, FusedAdamW)
    assert (trainer.tx.weight_decay, trainer.tx.clip_norm) == (0.0, None)
    state = mnist_state_dict_from_flax(init_params)
    trainer.model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    it = iter(trainer.train_loader)
    for step in range(steps):
        batch = next(it)
        for k in batch:
            np.testing.assert_array_equal(batch[k], want_batches[step][k])
        trainer._train_step(to_device(batch, trainer.device))
        got = trainer.state.fetch_metrics()
        trainer.state.reset_metrics()
        assert set(got) == set(want_metrics[step]) == {"loss", "accuracy"}
        np.testing.assert_allclose(got["loss"], want_metrics[step]["loss"], **F32_TOL["loss"])
        np.testing.assert_allclose(got["accuracy"], want_metrics[step]["accuracy"], atol=1e-6)
    got_params = flax_from_mnist_state_dict(trainer.model.state_dict())
    _compare_trees({"params": got_params}, want_params, F32_TOL["params_rel"], "params",
                   atol=F32_TOL["params_atol"])
    adam = want_opt.inner_state[0]  # inject_hyperparams(adam): (ScaleByAdamState, ...)
    opt = trainer.state.opt_state
    assert int(opt.count) == int(np.asarray(adam.count)) == steps
    for which in ("mu", "nu"):
        got = flax_from_mnist_state_dict(getattr(opt, which))
        _compare_trees({"params": got}, getattr(adam, which), F32_TOL["moments_rel"], which)


def _adam_f64(params, grads, mu, nu, t, lr):
    """``optax.adam``'s step (b1 0.9, b2 0.999, eps 1e-8) in numpy float64 on
    flax-layout dicts; returns the new params, mu, nu."""
    mu = jax.tree.map(lambda g, m: 0.1 * g + 0.9 * m, grads, mu)
    nu = jax.tree.map(lambda g, v: 0.001 * g * g + 0.999 * v, grads, nu)
    params = jax.tree.map(
        lambda p, m, v: p - lr * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t)) + 1e-8),
        params, mu, nu)
    return params, mu, nu


def _cnn_trajectory(loss_and_grads, init, batches, lr):
    """``len(batches)`` f64 Adam steps from ``init`` with the given loss and
    gradient function; returns the losses, the params and both moments."""
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), init["params"])
    mu = jax.tree.map(np.zeros_like, params)
    nu = jax.tree.map(np.zeros_like, params)
    losses = []
    for t, batch in enumerate(batches, start=1):
        batch = dict(batch, image=np.asarray(batch["image"], np.float64))
        loss, grads = loss_and_grads(params, batch)
        losses.append(loss)
        params, mu, nu = _adam_f64(params, grads, mu, nu, t, lr)
    return losses, params, mu, nu


def test_mnist_cnn_follows_the_flax_cnn_in_float64():
    """The cause of the CNN's 3-step f32 bound above: in float64 the port's
    MnistCNN and MnistTrial.loss follow the flax CNN and the JAX trial's
    loss for all 5 steps of an Adam run from the same weights and batches
    (one f64 Adam on both sides, each side's own gradients), within
    F32_TOL and within F64_REL, so the f32 gap comes from rounding and not
    from the convolution backward or the flatten order."""
    hp = dict(HP, model="cnn")
    _, init_params, _, _, batches = _jax_run(tuple(sorted(hp.items())), STEPS)
    jax_trial = JaxMnistTrial(jax_train.init(
        hparams=hp, mesh_config=MeshConfig(data=1), core_context=jax_core._dummy_init(), seed=0,
        devices=jax.devices()[:1]))
    jax_model = jax_trial.build_model()
    trial = MnistTrial(train.init(hparams=hp, seed=0, device="cpu"))
    model = MnistCNN(device="cpu").double()

    def jax_loss_and_grads(params, batch):
        with jax.enable_x64(True):
            def loss(p):
                return jax_trial.loss(jax_model, {"params": p}, batch, jax.random.key(0))[0]

            value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
            assert value.dtype == jnp.float64
            return float(value), jax.tree.map(np.asarray, jax.device_get(grads))

    def port_loss_and_grads(params, batch):
        state = mnist_state_dict_from_flax(params)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        loss, _ = trial.loss(model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        assert loss.dtype == torch.float64
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return float(loss.detach()), flax_from_mnist_state_dict(dict(zip(names, grads)))

    want = _cnn_trajectory(jax_loss_and_grads, init_params, batches, hp["lr"])
    got = _cnn_trajectory(port_loss_and_grads, init_params, batches, hp["lr"])
    np.testing.assert_allclose(got[0], want[0], **F32_TOL["loss"])
    np.testing.assert_allclose(got[0], want[0], rtol=F64_REL, atol=0)
    for what, g, w, rel in (("params", got[1], want[1], F32_TOL["params_rel"]),
                            ("mu", got[2], want[2], F32_TOL["moments_rel"]),
                            ("nu", got[3], want[3], F32_TOL["moments_rel"])):
        for f in (rel, F64_REL):
            _compare_trees({"params": g}, {"params": w}, f, what)
        assert all(leaf.dtype == np.float64 for leaf in jax.tree.leaves(g)), what


def test_mnist_trial_fits_and_validates_on_cpu():
    ctx = train.init(hparams=dict(HP, dataset_size=256), seed=1, device="cpu")
    summary = train.Trainer(MnistTrial(ctx)).fit(max_length=24, validation_period=12,
                                                 checkpoint_policy="none")
    val = summary["validation_metrics"]
    assert set(val) == {"validation_loss", "validation_accuracy"}
    assert val["validation_accuracy"] > 0.5  # the synthetic classes separate
    first, last = ctx.core.train.metrics("validation")
    assert last[1]["validation_loss"] < first[1]["validation_loss"]


# ---------------------------------------------------------------------------
# chip_smoke's search configurations against their files
# ---------------------------------------------------------------------------


def _restore_cuts(got, cuts, placeholders, file_raw):
    """Undo ``cuts`` on ``got`` (each checked to hold the run's value and
    the file to hold the cut's file value); returns the result."""
    restored = yaml.safe_load(yaml.safe_dump(got))
    for path, file_value, run_value, _why in cuts:
        *parents, leaf = path.split(".")
        node, want = restored, file_raw
        for p in parents:
            node, want = node[p], want.get(p, {})
        if isinstance(run_value, str):
            run_value = placeholders.get(run_value, run_value)
        assert node[leaf] == run_value, path
        assert want.get(leaf) == file_value, path
        if file_value is None:
            del node[leaf]
        else:
            node[leaf] = file_value
    return {k: v for k, v in restored.items() if v != {}}


@pytest.mark.parametrize("part, path", [
    ("S1", "examples/transformer_lm/const.yaml"),
    ("S2", "examples/transformer_lm/const.yaml"),
    ("S3", "examples/mnist/adaptive.yaml"),
])
def test_chip_smoke_searches_are_their_files_apart_from_their_cuts(part, path):
    import chip_smoke

    file_raw = yaml.safe_load(open(os.path.join(REPO, path)))
    got = chip_smoke.search_raw_config(part, "/tmp/ckpts", 7)
    cuts = {"S1": chip_smoke.SEARCH_ASHA_CUTS, "S2": chip_smoke.SEARCH_PBT_CUTS,
            "S3": chip_smoke.SEARCH_MNIST_CUTS}[part]
    placeholders = {"<temp dir>": "/tmp/ckpts", "<--seed>": 7}
    assert _restore_cuts(got, cuts, placeholders, file_raw) == file_raw
    if part == "S3":
        assert chip_smoke.MNIST_ADAPTIVE == file_raw
    cfg = ExperimentConfig.parse(got)
    assert cfg.searcher.name == {"S1": "asha", "S2": "pbt", "S3": "adaptive_asha"}[part]
    assert cfg.checkpoint_storage.host_path == "/tmp/ckpts"
