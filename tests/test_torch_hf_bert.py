"""The port's BERT fine-tune slice (determined_tpu_torch: ``models/hf_bert.py``,
``convert.bert_state_dict_from_flax``, ``train/_optim.ClipAdamW`` without a
clip) against the JAX package's trial over transformers'
``FlaxBertForSequenceClassification`` on the CPU.

- ``BertConfig``'s defaults are transformers' ``BertConfig()``'s on every
  field the port reads; ``synthetic_classification`` is the JAX set bit for
  bit.
- ``BertForSequenceClassification`` gives the flax module's logits
  (deterministic) from the same weights, every leaf moved off its init,
  within ``LOGITS_ATOL``; the gradient of the trial's loss leaf by leaf
  through ``convert`` within ``GRAD_REL`` in relative norm.
- ``ClipAdamW(clip_norm=None)`` steps as ``optax.adamw`` (decay on every
  leaf, no norm); ``Trainer(BertClassifyTrial)`` steps as the JAX
  ``Trainer`` for 5 steps with plain and with fused AdamW (dropout 0
  through test-local subclasses of both trials).
- With dropout on, a preempted and resumed run ends bitwise equal to the
  uninterrupted one; the trial passes the JAX test's learning bar.
- ``pretrained_dir``: a ``FlaxBertForSequenceClassification`` directory
  loads bitwise; a ``FlaxBertModel`` directory (no classifier) loads into
  ``bert.*`` bitwise, keeps the port's init for the classifier and logs
  the missing keys, as ``from_pretrained`` does.
- ``examples/hf_bert/const.yaml`` runs through the port's ``run-local``.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import transformers

from determined_tpu.models import hf_bert as jb
from determined_tpu_torch import train
from determined_tpu_torch.convert import _adam_state, bert_state_dict_from_flax
from determined_tpu_torch.models import BertClassifyTrial, BertForSequenceClassification
from determined_tpu_torch.models import hf_bert as pb
from determined_tpu_torch.train._optim import ClipAdamW, warmup_cosine_decay_schedule
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_hf_gpt2 import (
    _jax_ids,
    _jax_trial,
    compare_steps,
    off_init,
    resumed_equals_uninterrupted,
    run_local_const_yaml,
)
from tests.test_torch_mnist import ADAM_TOL
from tests.test_torch_training import F32_TOL, _rel

# f32 logits through 2 post-LayerNorm layers and the pooler's tanh: sums in
# other orders and LayerNorm's variance taken two ways (flax: E[x^2] - E[x]^2)
LOGITS_ATOL = 1e-5
# as tests/test_torch_hf_gpt2.py, but the key's bias, whose true gradient
# is 0 (softmax does not see a constant added to a row's scores), is held
# against the largest leaf gradient: both sides give f32 noise there
GRAD_REL = 1e-5
ZERO_GRAD = 1e-6
HP = dict(lr=1e-3, global_batch_size=8, seq_len=16, vocab_size=128, hidden_size=32,
          num_layers=2, num_heads=4, num_labels=4, dataset_size=64, warmup_steps=2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# tests/test_transformer.py::test_hf_bert_trial_learns
LEARN_HP = dict(lr=1e-3, global_batch_size=32, seq_len=32, vocab_size=256, hidden_size=64,
                num_layers=1, num_heads=2, num_labels=4, dataset_size=256, warmup_steps=2)
LEARN_STEPS = 30


class JaxNoDropoutBert(jb.BertClassifyTrial):
    """The JAX trial with every dropout probability 0."""

    def build_model(self):
        holder = super().build_model()
        for k, v in NO_DROPOUT.items():
            setattr(holder.config, k, v)
        return jb._BertModule(holder.config, seed=self.context.seed)


class PortNoDropoutBert(BertClassifyTrial):
    """The port's trial with every dropout probability 0."""

    def config(self):
        return dataclasses.replace(super().config(), **NO_DROPOUT)


def _key_biases(layers):
    return [f"bert.encoder.layer.{i}.attention.self.key.bias" for i in range(layers)]


def test_config_defaults_are_transformers():
    want = transformers.BertConfig()
    for f in dataclasses.fields(pb.BertConfig):
        assert getattr(pb.BertConfig(), f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("size, seq, vocab, labels, seed",
                         [(64, 16, 128, 4, 0), (37, 128, 8192, 4, 1), (50, 9, 30522, 2, 2)])
def test_synthetic_classification_equals_jax(size, seq, vocab, labels, seed):
    want = jb.synthetic_classification(size, seq, vocab, labels, seed).columns
    got = pb.synthetic_classification(size, seq, vocab, labels, seed).columns
    assert set(got) == set(want) == {"input_ids", "label"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@functools.lru_cache(maxsize=None)
def _flax_side(hp_items):
    """The JAX trial, its module and its params off their init, once per
    hparams (the module's tests only read them)."""
    trial = _jax_trial(JaxNoDropoutBert, dict(hp_items))
    holder = trial.build_model()
    return trial, holder, off_init(holder.init(jax.random.key(0), jnp.asarray(_jax_ids())))


def _flax_and_port(hp):
    trial, holder, params = _flax_side(tuple(hp.items()))
    ptrial = PortNoDropoutBert(train.init(hparams=dict(hp), device="cpu"))
    model = BertForSequenceClassification(ptrial.config(), device="cpu")
    state = bert_state_dict_from_flax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return trial, holder, params, ptrial, model


def test_forward_gives_the_flax_logits():
    _, holder, params, _, model = _flax_and_port(HP)
    ids = _jax_ids()
    want = np.asarray(holder.apply(params, jnp.asarray(ids), deterministic=True).logits)
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGITS_ATOL)
    # 5 embedding leaves, 16 a layer, the pooler's 2 and the classifier's 2
    assert len(dict(model.named_parameters())) == len(jax.tree_util.tree_leaves(params)) \
        == 5 + 16 * HP["num_layers"] + 4


def test_loss_gradients_equal_flax_leaf_by_leaf():
    trial, holder, params, ptrial, model = _flax_and_port(HP)
    rng = np.random.default_rng(4)
    batch = {"input_ids": _jax_ids(seed=4, b=6),
             "label": rng.integers(0, HP["num_labels"], 6).astype(np.int32)}
    (want_loss, want_m), want = jax.value_and_grad(
        lambda p: trial.loss(holder, p, batch, jax.random.key(0)), has_aux=True)(
            jax.tree.map(jnp.asarray, params))
    loss, metrics = ptrial.loss(model, {k: torch.tensor(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **F32_TOL["loss"])
    assert float(metrics["accuracy"]) == float(want_m["accuracy"])
    want = bert_state_dict_from_flax(jax.device_get(want))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    noise = ZERO_GRAD * max(np.linalg.norm(w) for w in want.values())
    zero = sorted(k for k, w in want.items() if np.linalg.norm(w) <= noise)
    assert zero == _key_biases(HP["num_layers"]), zero
    for k, w in want.items():
        if k in zero:
            assert np.linalg.norm(got[k]) <= noise, (k, np.linalg.norm(got[k]))
        else:
            assert _rel(got[k], w) <= GRAD_REL, (k, _rel(got[k], w))


def test_clip_adamw_without_a_clip_steps_as_optax_adamw():
    """``ClipAdamW(schedule, clip_norm=None, weight_decay=0.01)`` against
    ``optax.adamw(schedule, weight_decay=0.01)``: no global norm (gradients
    far above any clip are taken as they are), decay on every leaf."""
    rng = np.random.default_rng(2)
    shapes = {"kernel": (32, 16), "bias": (16,), "scale": (32,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100), weight_decay=0.01)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tx = ClipAdamW(warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100), clip_norm=None,
                   weight_decay=0.01)
    tstate = tx.init(tparams)
    for _ in range(5):
        grads = {k: 100 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        _, tstate = tx.apply_step({k: torch.tensor(g) for k, g in grads.items()}, tstate, tparams)
        adam = _adam_state(jstate)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **ADAM_TOL)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(adam.mu[k]), **ADAM_TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), **ADAM_TOL)
    assert int(tstate.count) == 5


def test_bert_trial_optimizers_are_the_jax_trials():
    for fused in (False, True):
        ctx = train.init(hparams=dict(HP, fused_adamw=fused), device="cpu")
        tx = BertClassifyTrial(ctx).build_optimizer()
        assert tx.clip_norm is None and tx.weight_decay == 0.01 and tx.mu_dtype is None
        lr = [float(tx.learning_rate(torch.tensor(i))) for i in (0, 1, 2, 1000)]
        want = optax.warmup_cosine_decay_schedule(0.0, HP["lr"], 2, 2000)
        np.testing.assert_allclose(lr, [float(want(i)) for i in (0, 1, 2, 1000)], rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused_adamw"])
def test_bert_trial_trains_as_the_jax_trainer(fused):
    compare_steps(JaxNoDropoutBert, PortNoDropoutBert, HP, bert_state_dict_from_flax, fused,
                  {k: slice(None) for k in _key_biases(HP["num_layers"])})


def test_preempted_and_resumed_run_draws_the_uninterrupted_masks(tmp_path):
    whole = resumed_equals_uninterrupted(tmp_path, BertClassifyTrial, HP)
    assert whole.model.cfg.hidden_dropout_prob == 0.1


def test_bert_trial_passes_the_jax_learning_bar():
    """tests/test_transformer.py::test_hf_bert_trial_learns's hparams and
    bar, on the CPU: validation accuracy above 0.6 (4 classes)."""
    ctx = train.init(hparams=dict(LEARN_HP), seed=0, device="cpu")
    summary = train.Trainer(BertClassifyTrial(ctx)).fit(
        max_length=LEARN_STEPS, validation_period=LEARN_STEPS, checkpoint_policy="none")
    vm = summary["validation_metrics"]
    assert vm["validation_accuracy"] > 0.6, vm


def _flax_config(hp):
    return _jax_trial(jb.BertClassifyTrial, hp).build_model().config


def test_pretrained_dir_loads_a_classification_directory_bitwise(tmp_path):
    flax_model = transformers.FlaxBertForSequenceClassification(_flax_config(HP), seed=3)
    flax_model.params = off_init(flax_model.params, seed=2)
    flax_model.save_pretrained(str(tmp_path))
    hp = dict(HP, pretrained_dir=str(tmp_path))
    model = BertClassifyTrial(train.init(hparams=hp, seed=0, device="cpu")).build_model()
    want = bert_state_dict_from_flax(flax_model.params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    holder = _jax_trial(jb.BertClassifyTrial, hp).build_model()
    ids = _jax_ids()
    jparams = holder.init(jax.random.key(9), jnp.asarray(ids))
    want_logits = np.asarray(holder.apply(jparams, jnp.asarray(ids)).logits)
    np.testing.assert_allclose(model(torch.tensor(ids)).detach().numpy(), want_logits,
                               rtol=0, atol=LOGITS_ATOL)


def test_pretrained_base_model_directory_keeps_the_classifier_init(tmp_path, caplog):
    """A ``FlaxBertModel`` directory holds no ``bert`` prefix and no
    classifier: as ``from_pretrained``, the port loads it into ``bert.*``,
    keeps its own init for the classifier and logs the missing keys."""
    base = transformers.FlaxBertModel(_flax_config(HP), seed=3)
    base.params = off_init(base.params, seed=5)
    base.save_pretrained(str(tmp_path))
    ctx = train.init(hparams=dict(HP, pretrained_dir=str(tmp_path)), seed=0, device="cpu")
    with caplog.at_level(logging.WARNING, logger="determined_tpu_torch.models._hf_common"):
        model = BertClassifyTrial(ctx).build_model()
    fresh = BertClassifyTrial(train.init(hparams=dict(HP), seed=0, device="cpu")).build_model()
    want = bert_state_dict_from_flax({"bert": base.params})
    got = model.state_dict()
    assert set(got) - set(want) == {"classifier.weight", "classifier.bias"}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    for k in ("classifier.weight", "classifier.bias"):
        assert torch.equal(got[k], fresh.state_dict()[k]), k
    (record,) = [r for r in caplog.records if "newly initialized" in r.getMessage()]
    assert "['classifier.bias', 'classifier.weight']" in record.getMessage()
    # the JAX trial from the same directory holds the same encoder weights
    holder = _jax_trial(jb.BertClassifyTrial, dict(HP, pretrained_dir=str(tmp_path))
                        ).build_model()
    jparams = holder.init(jax.random.key(9), jnp.asarray(_jax_ids()))
    for k, w in bert_state_dict_from_flax(jparams).items():
        if k.startswith("bert."):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_pretrained_dir_with_a_shape_that_differs_raises(tmp_path):
    transformers.FlaxBertForSequenceClassification(_flax_config(HP), seed=3).save_pretrained(
        str(tmp_path))
    ctx = train.init(hparams=dict(HP, pretrained_dir=str(tmp_path), num_labels=3), device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        BertClassifyTrial(ctx).build_model()


def test_bert_const_yaml_runs_through_run_local(tmp_path, monkeypatch, capsys):
    """``run-local examples/hf_bert/const.yaml
    determined_tpu_torch.models.hf_bert:BertClassifyTrial``, cut in size (2
    layers of width 64, vocab 512, 4 batches of 4 x 32)."""
    validated = run_local_const_yaml(
        tmp_path, monkeypatch, capsys, "examples/hf_bert/const.yaml",
        "determined_tpu_torch.models.hf_bert:BertClassifyTrial",
        dict(global_batch_size=4, seq_len=32, vocab_size=512, hidden_size=64, num_layers=2,
             num_heads=2, dataset_size=16))
    assert all(np.isfinite(m["validation_loss"]) for m in validated)
    assert all(0.0 <= m["validation_accuracy"] <= 1.0 for m in validated)
