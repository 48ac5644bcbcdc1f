"""The port's GPT-2 fine-tune slice (determined_tpu_torch: ``models/hf_gpt2.py``,
``models/_hf_common.py``, ``convert.gpt2_state_dict_from_flax``) against the
JAX package's trial over transformers' ``FlaxGPT2LMHeadModel`` on the CPU.

- ``GPT2Config``'s defaults are transformers' ``GPT2Config()``'s on every
  field the port reads; ``synthetic_lm`` is the JAX set bit for bit.
- ``GPT2LMHeadModel`` gives the flax module's logits (deterministic) from
  the same weights, every leaf moved off its init, within ``LOGITS_ATOL``;
  the gradient of the trial's loss, leaf by leaf through ``convert``,
  within ``GRAD_REL`` in relative norm.  Both at a tiny size and at GPT-2
  base's width (768, 12 heads, vocabulary 50257, 128 tokens), 2 layers deep.
- ``Trainer(GPT2FinetuneTrial)`` steps as the JAX ``Trainer`` for 5 steps
  with plain and with fused AdamW (dropout 0 through test-local subclasses
  of both trials).
- With dropout on: the attention probabilities' mask is one ``[q, k]``
  mask shared by batch and heads, keep rates sit within binomial bounds,
  and a preempted and resumed run draws the uninterrupted run's masks (its
  params end bitwise equal).
- The trial passes the JAX test's learning bar at that test's hparams.
- A Flax ``save_pretrained`` directory through ``pretrained_dir``: the
  port's params equal flax's bitwise and the forward matches the JAX
  trial's from the same directory.
- ``examples/hf_gpt2/const.yaml`` runs through the port's ``run-local``, and
  ``chip_smoke.py``'s copy of it is the file apart from its cuts.

The helpers ``jax_steps``, ``port_steps`` and ``compare_steps`` serve
``tests/test_torch_hf_bert.py`` too.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import to_global
from determined_tpu.models import hf_gpt2 as jg
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import _adam_state, gpt2_state_dict_from_flax
from determined_tpu_torch.data import to_device
from determined_tpu_torch.experiment import LocalExperiment
from determined_tpu_torch.models import GPT2FinetuneTrial, GPT2LMHeadModel
from determined_tpu_torch.models import _hf_common
from determined_tpu_torch.models import hf_gpt2 as pg
from determined_tpu_torch.ops.fused_adamw import FusedAdamW
from determined_tpu_torch.train import Callback
from determined_tpu_torch.train._optim import ClipAdamW
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 logits of order 1-3 through 2 layers (order 1 at GPT-2 base's width): both sides take the same f32
# operations, summed in other orders (oneDNN against XLA) and LayerNorm's
# variance taken two ways (flax: E[x^2] - E[x]^2)
LOGITS_ATOL = 1e-5
# f32 gradients summed over the batch and sequence in other orders; the
# smallest leaves (LayerNorm shifts, biases) are sums of a few hundred
# terms of both signs
GRAD_REL = 1e-5
HP = dict(lr=2e-3, global_batch_size=8, seq_len=16, vocab_size=128, hidden_size=32,
          num_layers=2, num_heads=4, dataset_size=64, warmup_steps=2)
STEPS = 5
# GPT-2 base's width, heads, vocabulary and sequence (examples/hf_gpt2), 2
# layers deep and 2 sequences a batch: the shapes each of const.yaml's 12
# layers and its head take, at a size the CPU runs in seconds
BASE_WIDTH_HP = dict(HP, vocab_size=50257, hidden_size=768, num_heads=12, seq_len=128)
SIZES = {"tiny": (HP, 0.1, (3, 16)), "gpt2_base_width": (BASE_WIDTH_HP, 0.02, (2, 128))}
# a first moment built from gradients whose true value is 0: f32 noise of
# sums of order 1 over a few hundred terms
ZERO_GRAD_MU = 1e-6
NO_DROPOUT = dict(attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)
# tests/test_transformer.py::test_hf_gpt2_trial_learns
LEARN_HP = dict(lr=2e-3, global_batch_size=32, seq_len=32, vocab_size=128, hidden_size=64,
                num_layers=1, num_heads=2, dataset_size=256, warmup_steps=2)
LEARN_STEPS = 40


def off_init(params, seed=1, scale=0.1):
    """``params`` as numpy with every leaf moved off its init by normal
    noise of std ``scale`` (zero biases and unit LayerNorm scales would hide
    their paths)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)).astype(np.float32),
        params)


class JaxNoDropoutGPT2(jg.GPT2FinetuneTrial):
    """The JAX trial with every dropout probability 0."""

    def build_model(self):
        holder = super().build_model()
        for k, v in NO_DROPOUT.items():
            setattr(holder.config, k, v)
        return jg._GPT2Module(holder.config, seed=self.context.seed)


class PortNoDropoutGPT2(GPT2FinetuneTrial):
    """The port's trial with every dropout probability 0."""

    def config(self):
        return dataclasses.replace(super().config(), **NO_DROPOUT)


def _jax_ids(seed=0, b=3, s=16, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _jax_trial(cls, hp):
    return cls(jax_train.init(hparams=dict(hp), mesh_config=MeshConfig(data=1),
                              core_context=jax_core._dummy_init(), seed=0,
                              devices=jax.devices()[:1]))


def _port_model(cfg, state):
    model = GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def test_config_defaults_are_transformers():
    want = transformers.GPT2Config()
    for f in dataclasses.fields(pg.GPT2Config):
        assert getattr(pg.GPT2Config(), f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("size, seq, vocab, seed", [(64, 16, 128, 0), (37, 33, 50257, 1)])
def test_synthetic_lm_equals_jax(size, seq, vocab, seed):
    want = jg.synthetic_lm(size, seq, vocab, seed).columns
    got = pg.synthetic_lm(size, seq, vocab, seed).columns
    assert set(got) == set(want) == {"input_ids"}
    assert got["input_ids"].dtype == want["input_ids"].dtype == np.int32
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


@functools.lru_cache(maxsize=None)
def _flax_side(hp_items, scale):
    """The JAX trial, its module and its weights off their init
    (``off_init``'s ``scale``), once per hparams and scale (the module's
    tests only read them)."""
    trial = _jax_trial(JaxNoDropoutGPT2, dict(hp_items))
    holder = trial.build_model()
    return trial, holder, off_init(holder.init(jax.random.key(0), jnp.asarray(_jax_ids())),
                                   scale=scale)


def _flax_and_port(trial_hp, scale=0.1):
    """The JAX trial's module with weights off their init (``off_init``'s
    ``scale``), and the port's model holding the same weights."""
    trial, holder, params = _flax_side(tuple(trial_hp.items()), scale)
    ptrial = PortNoDropoutGPT2(train.init(hparams=dict(trial_hp), device="cpu"))
    return trial, holder, params, ptrial, _port_model(ptrial.config(),
                                                      gpt2_state_dict_from_flax(params))


@pytest.mark.parametrize("size", list(SIZES))
def test_forward_gives_the_flax_logits(size):
    hp, scale, (b, s) = SIZES[size]
    _, holder, params, _, model = _flax_and_port(hp, scale)
    ids = _jax_ids(b=b, s=s, vocab=hp["vocab_size"])
    want = np.asarray(holder.apply(params, jnp.asarray(ids), deterministic=True).logits)
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, s, hp["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGITS_ATOL)
    # one leaf for the tied head, as in flax
    names = set(dict(model.named_parameters()))
    assert "lm_head.weight" not in names
    assert len(names) == len(jax.tree_util.tree_leaves(params)) == 4 + 12 * 2


@pytest.mark.parametrize("size", list(SIZES))
def test_loss_gradients_equal_flax_leaf_by_leaf(size):
    hp, scale, (b, s) = SIZES[size]
    trial, holder, params, ptrial, model = _flax_and_port(hp, scale)
    batch = {"input_ids": _jax_ids(seed=4, b=b + 1, s=s, vocab=hp["vocab_size"])}
    jparams = jax.tree.map(jnp.asarray, params)
    (want_loss, want_m), want = jax.value_and_grad(
        lambda p: trial.loss(holder, p, batch, jax.random.key(0)), has_aux=True)(jparams)
    loss, metrics = ptrial.loss(model, {"input_ids": torch.tensor(batch["input_ids"])},
                                torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **F32_TOL["loss"])
    np.testing.assert_allclose(float(metrics["perplexity"].detach()), float(want_m["perplexity"]),
                               **F32_TOL["loss"])
    want = gpt2_state_dict_from_flax(jax.device_get(want))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= GRAD_REL, (k, _rel(got[k], w))


# ---------------------------------------------------------------------------
# the slice as a whole: the Trainer, JAX against the port (shared with BERT)
# ---------------------------------------------------------------------------


def jax_steps(trial_cls, hp, steps):
    """``steps`` steps of the JAX Trainer: each step's metrics, the initial
    and final params, the final optimizer state and the batches."""
    trainer = jax_train.Trainer(_jax_trial(trial_cls, hp))
    trainer._setup()
    init = jax.device_get(trainer.state.params)
    state, it = trainer.state, iter(trainer.train_loader)
    batches, metrics = [], []
    for _ in range(steps):
        batches.append(next(it))
        state = trainer._train_step(state, to_global(batches[-1], trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init, jax.device_get(state.params), jax.device_get(state.opt_state), batches


def port_steps(trial_cls, hp, init_state, want_batches):
    """The port's Trainer from ``init_state`` over the same batches (held
    equal to ``want_batches``); returns each step's metrics and the
    Trainer."""
    trainer = train.Trainer(trial_cls(train.init(hparams=dict(hp), seed=0, device="cpu")))
    trainer._setup()
    trainer.model.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()},
                                  strict=True)
    it, metrics = iter(trainer.train_loader), []
    for want in want_batches:
        batch = next(it)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
        trainer._train_step(to_device(batch, trainer.device))
        metrics.append(trainer.state.fetch_metrics())
        trainer.state.reset_metrics()
    return metrics, trainer


def _split(a, sl):
    """(the elements of ``a`` outside ``sl``, those inside)."""
    inside = np.zeros(a.shape, bool)
    inside[sl] = True
    return a[~inside], a[inside]


def compare_steps(jax_cls, port_cls, hp, to_state_dict, fused, zero_grad, steps=STEPS):
    """Both Trainers ``steps`` steps from the same weights and batches:
    metrics each step, final params and moments.  ``zero_grad`` maps a leaf
    to the slice of it whose true gradient is 0 (the attention key's bias:
    softmax does not see a constant added to every score of a row): both
    sides move it by their own f32 noise, so it is held by the elementwise
    bound only, and its moments must stay at noise level."""
    hp = dict(hp, fused_adamw=fused)
    want_metrics, init, want_params, want_opt, batches = jax_steps(jax_cls, hp, steps)
    got_metrics, trainer = port_steps(port_cls, hp, to_state_dict(init), batches)
    assert isinstance(trainer.tx, FusedAdamW if fused else ClipAdamW)
    assert trainer.tx.clip_norm is None and trainer.tx.weight_decay == 0.01
    for want, got in zip(want_metrics, got_metrics):
        assert set(got) == set(want), (got, want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **F32_TOL["loss"], err_msg=k)
    # a weight moves by at most about lr a step whatever its gradient
    sched = trainer.tx.learning_rate
    atol = 2 * sum(float(sched(torch.tensor(i))) for i in range(steps))
    want_params = to_state_dict(want_params)
    got_params = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got_params) == set(want_params)
    for k, w in want_params.items():
        sl = zero_grad.get(k, slice(0))
        g, w = _split(got_params[k], sl), _split(w, sl)
        assert _rel(g[0], w[0]) <= F32_TOL["params_rel"], (k, _rel(g[0], w[0]))
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
    adam = _adam_state(want_opt)
    opt = trainer.state.opt_state
    assert int(opt.count) == int(np.asarray(adam.count)) == steps
    for which, noise in (("mu", ZERO_GRAD_MU), ("nu", ZERO_GRAD_MU ** 2)):
        want = to_state_dict(getattr(adam, which))
        got = getattr(opt, which)
        for k, w in want.items():
            sl = zero_grad.get(k, slice(0))
            g, w = _split(got[k].numpy(), sl), _split(w, sl)
            assert _rel(g[0], w[0]) <= F32_TOL["moments_rel"], (which, k, _rel(g[0], w[0]))
            assert np.abs(g[1]).max(initial=0) <= noise and np.abs(w[1]).max(initial=0) <= noise


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused_adamw"])
def test_gpt2_trial_trains_as_the_jax_trainer(fused):
    d = HP["hidden_size"]
    key_bias = {f"transformer.h.{i}.attn.c_attn.bias": slice(d, 2 * d)
                for i in range(HP["num_layers"])}
    compare_steps(JaxNoDropoutGPT2, PortNoDropoutGPT2, HP, gpt2_state_dict_from_flax, fused,
                  key_bias)


# the learning curve at GPT-2's own vocabulary (examples/hf_gpt2's lr and
# warmup), cut in width, depth, batch and length: 100 steps of the JAX
# Trainer and the port's from the same weights and batches, dropout 0
CURVE_HP = dict(lr=5e-4, global_batch_size=8, seq_len=32, vocab_size=50257, hidden_size=64,
                num_layers=2, num_heads=2, dataset_size=256, warmup_steps=50)
CURVE_STEPS = 100
# f32 differences grown over 100 Adam steps (the losses agree to 1e-5
# relative at step 5, F32_TOL)
CURVE_RTOL = 1e-4


def test_gpt2_learning_curve_at_the_gpt2_vocabulary_equals_jax(capsys):
    """Whether the port learns as the JAX trial does where it matters for
    examples/hf_gpt2 (a 50,257-token vocabulary, lr 5e-4, warmup 50): the
    training loss of each of 100 steps within ``CURVE_RTOL``."""
    hp = dict(CURVE_HP, fused_adamw=False)
    want, init, _, _, batches = jax_steps(JaxNoDropoutGPT2, hp, CURVE_STEPS)
    got, _ = port_steps(PortNoDropoutGPT2, hp, gpt2_state_dict_from_flax(init), batches)
    want = np.array([m["loss"] for m in want])
    got = np.array([m["loss"] for m in got])
    with capsys.disabled():
        print(f"\nGPT-2 vocab 50257, steps 1/50/100: JAX {want[[0, 49, 99]].tolist()} "
              f"port {got[[0, 49, 99]].tolist()}")
    assert want[-1] < want[0] - 0.5  # it learns
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _binomial_ok(kept: int, n: int, keep: float) -> bool:
    """Within 5 standard deviations of n * keep."""
    return abs(kept - n * keep) <= 5 * math.sqrt(n * keep * (1 - keep))


def test_attention_dropout_mask_is_one_mask_for_every_batch_row_and_head():
    """q = k = 0 makes every probability 1 / s; v = identity returns the
    probabilities themselves, each dropped or scaled by 1 / keep."""
    b, h, s, rate = 2, 3, 64, 0.1
    q = torch.zeros(b, h, s, s)
    v = torch.eye(s).expand(b, h, s, s)
    out = _hf_common.dot_product_attention(q, q, v, None, rate, torch.Generator().manual_seed(3))
    for i in range(b):
        for j in range(h):
            assert torch.equal(out[i, j], out[0, 0]), (i, j)
    kept = out[0, 0] != 0
    want = torch.tensor(1 / s, dtype=torch.float32) * (1 / torch.tensor(1 - rate))
    assert torch.equal(out[0, 0][kept], want.expand(int(kept.sum())))
    assert _binomial_ok(int(kept.sum()), s * s, 1 - rate)
    # without a generator: the probabilities as they are
    plain = _hf_common.dot_product_attention(q, q, v, None, rate, None)
    assert torch.equal(plain, torch.full_like(plain, 1 / s))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_is_binomial_and_kept_values_are_scaled(rate):
    x = torch.ones(400, 500)
    out = _hf_common.dropout(x, rate, torch.Generator().manual_seed(1))
    kept = out != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 1 - rate)
    assert torch.equal(out[kept], (x / (1 - rate))[kept])
    assert _hf_common.dropout(x, rate, None) is x


def test_forward_draws_its_masks_from_the_generator():
    cfg = pg.GPT2Config(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4)
    model = GPT2LMHeadModel(cfg, device="cpu")
    ids = torch.tensor(_jax_ids(vocab=64))
    with torch.no_grad():
        a = model(ids, torch.Generator().manual_seed(5))
        b = model(ids, torch.Generator().manual_seed(5))
        c = model(ids, torch.Generator().manual_seed(6))
        d, e = model(ids), model(ids)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)
    assert not torch.equal(a, d)


TRAINERS = []


class _Capture(Callback):
    def on_training_start(self, trainer):
        TRAINERS.append(trainer)


class _Hook:
    def __init__(self, step, action):
        self.step, self.action, self.fired = step, action, False

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step and not self.fired:
            self.fired = True
            self.action()


def resumed_equals_uninterrupted(tmp_path, trial_cls, hp):
    """8 steps with dropout on, preempted before step 6 and resumed, against
    8 steps in one go: params, optimizer state and step bitwise (the masks
    come from the step generator)."""
    class Capturing(trial_cls):
        def build_callbacks(self):
            return {"capture": _Capture()}

    raw = {"name": "tiny", "hyperparameters": hp,
           "searcher": {"name": "single", "metric": "validation_loss",
                        "max_length": {"batches": 8}},
           "min_validation_period": {"batches": 4}, "min_checkpoint_period": {"batches": 6}}
    cfg = ExperimentConfig.parse(raw)
    del TRAINERS[:]
    assert LocalExperiment(cfg, Capturing, checkpoint_dir=str(tmp_path / "c"),
                           device="cpu").run()["status"] == "completed"
    whole = TRAINERS[-1]
    exp = LocalExperiment(cfg, Capturing, checkpoint_dir=str(tmp_path / "ab"), device="cpu")
    faults.set_fault_injector(_Hook(5, exp.request_preemption))
    try:
        assert exp.run()["status"] == "preempted"
    finally:
        faults.set_fault_injector(None)
    assert LocalExperiment(cfg, Capturing, checkpoint_dir=str(tmp_path / "ab"),
                           device="cpu").resume()["status"] == "completed"
    last = TRAINERS[-1]
    assert last is not whole and last.steps_completed == whole.steps_completed == 8
    for k, p in whole._params.items():
        assert torch.equal(last._params[k], p), k
    for a, b in zip(whole.state.opt_state, last.state.opt_state):
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert torch.equal(a, b)
    del TRAINERS[:]
    return whole


def test_preempted_and_resumed_run_draws_the_uninterrupted_masks(tmp_path):
    whole = resumed_equals_uninterrupted(tmp_path, GPT2FinetuneTrial, HP)
    assert whole.model.cfg.attn_pdrop == whole.model.cfg.resid_pdrop == 0.1


def test_gpt2_trial_passes_the_jax_learning_bar(tmp_path):
    """tests/test_transformer.py::test_hf_gpt2_trial_learns's hparams and
    bar, on the CPU: the validation loss below 0.8 ln(vocab)."""
    ctx = train.init(hparams=dict(LEARN_HP), seed=0, device="cpu")
    summary = train.Trainer(GPT2FinetuneTrial(ctx)).fit(
        max_length=LEARN_STEPS, validation_period=LEARN_STEPS, checkpoint_policy="none")
    vm = summary["validation_metrics"]
    assert vm["validation_loss"] < 0.8 * math.log(LEARN_HP["vocab_size"]), vm


# ---------------------------------------------------------------------------
# pretrained_dir: a Flax save_pretrained directory
# ---------------------------------------------------------------------------


def test_pretrained_dir_loads_the_flax_weights_bitwise(tmp_path):
    trial = _jax_trial(jg.GPT2FinetuneTrial, HP)
    cfg = trial.build_model().config
    flax_model = transformers.FlaxGPT2LMHeadModel(cfg, seed=3)
    flax_model.params = off_init(flax_model.params, seed=2)
    flax_model.save_pretrained(str(tmp_path))
    hp = dict(HP, pretrained_dir=str(tmp_path))
    model = GPT2FinetuneTrial(train.init(hparams=hp, seed=0, device="cpu")).build_model()
    want = gpt2_state_dict_from_flax(flax_model.params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the JAX trial from the same directory gives the same logits
    holder = _jax_trial(jg.GPT2FinetuneTrial, hp).build_model()
    ids = _jax_ids()
    jparams = holder.init(jax.random.key(9), jnp.asarray(ids))
    want_logits = np.asarray(holder.apply(jparams, jnp.asarray(ids)).logits)
    got_logits = model(torch.tensor(ids)).detach().numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=LOGITS_ATOL)


# ---------------------------------------------------------------------------
# examples/hf_gpt2/const.yaml
# ---------------------------------------------------------------------------


def run_local_const_yaml(tmp_path, monkeypatch, capsys, path, entry, hp_cut):
    """``run-local`` over ``path`` with its hyperparameters cut by
    ``hp_cut``, 4 batches, a validation every 2, on the CPU; returns the
    validations' metrics."""
    import yaml

    from determined_tpu_torch.cli.main import main
    from determined_tpu_torch.experiment import journal_path, local

    monkeypatch.setattr(local, "resolve_device", lambda device: torch.device("cpu"))
    raw = yaml.safe_load(open(os.path.join(REPO, path)))
    raw["hyperparameters"].update(hp_cut)
    raw["searcher"]["max_length"] = {"batches": 4}
    raw["min_validation_period"] = {"batches": 2}
    config = tmp_path / "const.yaml"
    config.write_text(yaml.safe_dump(raw))
    ckpt_dir = str(tmp_path / "ckpts")
    assert main(["run-local", str(config), entry, "--checkpoint-dir", ckpt_dir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["status"] == "completed" and summary["total_steps"] == 4
    with open(journal_path(ckpt_dir)) as f:
        validated = [r["metrics"] for r in map(json.loads, f) if r["type"] == "trial_validated"]
    assert len(validated) == 2
    return validated


def test_gpt2_const_yaml_runs_through_run_local(tmp_path, monkeypatch, capsys):
    """``run-local examples/hf_gpt2/const.yaml
    determined_tpu_torch.models.hf_gpt2:GPT2FinetuneTrial``, cut in size (2
    layers of width 64, vocab 512, 4 batches of 4 x 32)."""
    validated = run_local_const_yaml(
        tmp_path, monkeypatch, capsys, "examples/hf_gpt2/const.yaml",
        "determined_tpu_torch.models.hf_gpt2:GPT2FinetuneTrial",
        dict(global_batch_size=4, seq_len=32, vocab_size=512, hidden_size=64, num_layers=2,
             num_heads=2, dataset_size=16))
    assert all(np.isfinite(m["validation_loss"]) for m in validated)
    assert set(validated[0]) >= {"validation_loss", "validation_perplexity"}


@pytest.mark.parametrize("part, path", [("gpt2", "examples/hf_gpt2/const.yaml"),
                                        ("bert", "examples/hf_bert/const.yaml")])
def test_chip_smoke_hf_configs_are_their_files_apart_from_their_cuts(part, path):
    import yaml

    import chip_smoke
    from tests.test_torch_mnist import _restore_cuts

    file_raw = yaml.safe_load(open(os.path.join(REPO, path)))
    assert {"gpt2": chip_smoke.HF_GPT2_CONST, "bert": chip_smoke.HF_BERT_CONST}[part] == file_raw
    got = chip_smoke.hf_raw_config(part, "/tmp/ckpts", 7)
    placeholders = {"<temp dir>": "/tmp/ckpts", "<--seed>": 7}
    assert _restore_cuts(got, chip_smoke.HF_CUTS, placeholders, file_raw) == file_raw
    cfg = ExperimentConfig.parse(got)
    assert cfg.checkpoint_storage.host_path == "/tmp/ckpts"
    assert cfg.reproducibility.experiment_seed == 7


def test_chip_smoke_leaf_counts_are_the_models():
    """The leaf counts chip_smoke.py derives its exact fused_adamw launch
    counts from: GPT-2 base (4 + 12 a layer, the head tied) and BERT-base
    (5 + 16 a layer + 4), built at a narrow width."""
    import chip_smoke
    from determined_tpu_torch.models import BertConfig, BertForSequenceClassification

    gpt2 = GPT2LMHeadModel(pg.GPT2Config(vocab_size=64, n_positions=64, n_embd=16, n_layer=12,
                                         n_head=2), device="cpu")
    bert = BertForSequenceClassification(BertConfig(vocab_size=64, hidden_size=16,
                                                    num_hidden_layers=12, num_attention_heads=2,
                                                    intermediate_size=64, num_labels=4),
                                         device="cpu")
    assert len(dict(gpt2.named_parameters())) == chip_smoke.HF_GPT2_LEAVES == 148
    assert len(dict(bert.named_parameters())) == chip_smoke.HF_NORTH_STAR_LEAVES == 201


def test_chip_smoke_hf_parity_cuts_name_their_files_values():
    """Each of P's cuts names the value of the file it cuts, and the
    gpt2_base part cuts nothing of GPT-2 base but its batch."""
    import chip_smoke

    consts = {"gpt2": chip_smoke.HF_GPT2_CONST, "bert": chip_smoke.HF_BERT_CONST}
    families = dict(chip_smoke.HF_PARITY_PARTS)
    for part, key, file_value, _value, _why in chip_smoke.HF_PARITY_CUTS:
        assert consts[families[part]]["hyperparameters"][key] == file_value, (part, key)
    assert [k for p, k, *_ in chip_smoke.HF_PARITY_CUTS if p == "gpt2_base"] == [
        "global_batch_size"]
    assert set(chip_smoke.HF_NO_DROPOUT) == set(families.values())
