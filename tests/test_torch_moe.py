"""The port's MoE layer (determined_tpu_torch/models/moe.py) and the MoE LM
against the JAX package's, on the CPU in f32.

- ``_top2_dispatch`` on the same gates (made by JAX): dispatch and combine
  bitwise equal, the aux loss within 1e-6 (a mean over the group, summed
  in another order), and the cases of tests/test_moe.py.
- The ``MoE`` layer from flax's weights (carried over by convert.py's
  layout): the routing tensors equal, then output, aux and every gradient
  (router, experts, input) within 1e-5, with a token count that pads the
  last group.
- ``LMTrial`` with ``moe_experts: 4`` takes 8 steps from the JAX Trainer's
  initial weights on the same batches; losses within chip_smoke's
  ``TRAIN_PARITY_TOL`` and ``moe_aux_loss`` reported.
- Serving refuses an MoE config with the JAX text.
- Expert parallelism on 4 gloo ranks (tests/torch_rank_worker.py, under a
  hard timeout of ``RANK_TIMEOUT`` seconds): at data 2 x expert 2 and at
  expert 4 each rank's output, aux and gradients (x, the router, its
  expert slices) equal the unsharded layer's on the same tokens within
  1e-5; with the batch sharded under one routing group, every rank's rows
  equal the unsharded layer's on the whole batch, and the ranks' mean
  gradient its gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from chip_smoke import TRAIN_PARITY_TOL
from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import to_global
from determined_tpu.models import moe as jax_moe
from determined_tpu.models import transformer as jax_tf
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import train
from determined_tpu_torch.convert import (
    flax_from_opt_state,
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)
from determined_tpu_torch.data import to_device
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.moe import MoE, _top2_dispatch
from determined_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
    transformer_prefill,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_moe.py's LM hparams (without its expert axis)
MOE_HP = dict(
    lr=1e-3, global_batch_size=16, seq_len=32, vocab_size=128, d_model=64, n_layers=2,
    n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1,
    moe_experts=4, moe_every=2,
)
STEPS = 8


def _gates(g, e, seed):
    rng = np.random.default_rng(seed)
    return jax.nn.softmax(jnp.asarray(rng.standard_normal((g, e)), jnp.float32))


@pytest.mark.parametrize("g, e, c, seed", [(8, 4, 8, 0), (64, 8, 6, 1), (33, 4, 3, 2)],
                         ids=["ample", "tight", "odd"])
def test_top2_dispatch_bitwise_on_jax_gates(g, e, c, seed):
    gates = _gates(g, e, seed)
    want = jax_moe._top2_dispatch(gates, c)
    got = _top2_dispatch(torch.from_numpy(np.asarray(gates)), c)
    for name, a, b in zip(("dispatch", "combine"), got[:2], want[:2]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_top2_dispatch_routes_and_renormalizes():
    """tests/test_moe.py's first case: ample capacity, two slots a token,
    combine weights summing to 1."""
    got_d, got_c, aux = _top2_dispatch(torch.from_numpy(np.asarray(_gates(8, 4, 0))), 8)
    assert got_d.shape == (8, 4, 8)
    np.testing.assert_allclose(got_d.sum(dim=(1, 2)).numpy(), 2.0)
    np.testing.assert_allclose(got_c.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)
    assert float(aux) > 0


def test_top2_dispatch_respects_capacity():
    """tests/test_moe.py's capacity case: every token prefers expert 0, so
    experts 0 and 1 each take ``capacity`` tokens, and the aux loss is
    large; equal to JAX's on the same gates."""
    g, e, c = 16, 4, 2
    gates = jnp.tile(jnp.asarray([[0.7, 0.3, 0.0, 0.0]], jnp.float32), (g, 1))
    want = jax_moe._top2_dispatch(gates, c)
    dispatch, combine, aux = _top2_dispatch(torch.from_numpy(np.asarray(gates)), c)
    per_expert = dispatch.sum(dim=(0, 2)).numpy()
    assert per_expert[0] == c and per_expert[1] == c
    assert float(aux) > 1.0
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(want[1]))
    assert float(aux) == pytest.approx(float(want[2]), rel=1e-6)


def test_batched_dispatch_equals_per_group():
    """The port takes a stack of groups where JAX vmaps: the same as one
    call a group."""
    gates = torch.softmax(torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 16, 4)).astype(np.float32)), dim=-1)
    d, c, aux = _top2_dispatch(gates, 5)
    for i in range(3):
        di, ci, ai = _top2_dispatch(gates[i], 5)
        assert torch.equal(d[i], di) and torch.equal(c[i], ci) and torch.equal(aux[i], ai)


# ---------------------------------------------------------------------------
# the layer against flax's
# ---------------------------------------------------------------------------

E, D, F_FF, GROUP = 4, 32, 64, 16


def _flax_layer():
    return jax_moe.MoE(num_experts=E, d_ff=F_FF, group_size=GROUP, dtype=jnp.float32,
                       partition=False)


def _port_layer(params):
    layer = MoE(D, E, F_FF, group_size=GROUP, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    return layer


@functools.lru_cache(maxsize=None)
def _layer_case(b=2, s=19, seed=4):
    """38 tokens in groups of 16: 3 groups, the last padded with 10 zeros."""
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    params = flax_meta.unbox(_flax_layer().init(jax.random.key(seed), jnp.asarray(x)))["params"]
    return x, {k: np.asarray(v) for k, v in params.items()}


def _jax_loss(params, x):
    y, aux = _flax_layer().apply({"params": params}, x)
    return (y ** 2).mean() + 0.01 * aux, (y, aux)


def test_moe_routes_the_same_tokens_as_flax():
    x, params = _layer_case()
    g = x.shape[0] * x.shape[1]
    pad = (-g) % GROUP
    xg = np.concatenate([x.reshape(g, D), np.zeros((pad, D), np.float32)]).reshape(-1, GROUP, D)
    cap = max(int(1.25 * GROUP * 2 / E), 1)
    jg = jax.nn.softmax(jnp.einsum("ngd,de->nge", xg, params["router"]))
    want = jax.vmap(lambda gt: jax_moe._top2_dispatch(gt, cap))(jg)
    layer = _port_layer(params)
    pg = torch.softmax(torch.einsum("ngd,de->nge", torch.from_numpy(xg), layer.router), dim=-1)
    got = _top2_dispatch(pg.detach(), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


def test_moe_forward_and_gradients_match_flax():
    x, params = _layer_case()
    (want_loss, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        _jax_loss, argnums=(0, 1), has_aux=True
    )(params, jnp.asarray(x))
    layer = _port_layer(params)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = layer(xt)
    loss = (y ** 2).mean() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **TOL)
    for name in ("router", "w_in", "w_gate", "w_out"):
        grad = getattr(layer, name).grad.numpy()
        assert float(np.abs(grad).sum()) > 0, name
        np.testing.assert_allclose(grad, np.asarray(want_gp[name]), err_msg=name, **TOL)


def test_moe_init_scales_follow_flax_lecun_normal():
    """flax's lecun_normal counts the stacked expert dim in the fan-in."""
    layer = MoE(256, 8, 1024, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    want = {"router": 256 ** -0.5, "w_in": (8 * 256) ** -0.5, "w_gate": (8 * 256) ** -0.5,
            "w_out": (8 * 1024) ** -0.5}
    ref = flax_meta.unbox(jax_moe.MoE(num_experts=8, d_ff=1024, partition=False).init(
        jax.random.key(0), jnp.zeros((1, 8, 256), jnp.float32)))["params"]
    for name, std in want.items():
        got = float(getattr(layer, name).std())
        assert got == pytest.approx(std, rel=0.02), name
        assert float(np.std(np.asarray(ref[name]))) == pytest.approx(std, rel=0.02), name


def test_expert_sharding_needs_a_divisible_expert_count():
    layer = MoE(8, 4, 16, device="cpu")
    with pytest.raises(ValueError, match="not divisible by axis 3"):
        layer.shard_experts(None, 3, 0)


# ---------------------------------------------------------------------------
# the LM: config, conversion, the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------


def _jax_lm(**kw):
    cfg = jax_tf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=4, n_heads=4, max_seq_len=32,
        attention_impl="reference", dtype=jnp.float32, moe_experts=4, **kw)
    model = jax_tf.TransformerLM(cfg)
    params = flax_meta.unbox(model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    return cfg, model, params


def test_moe_lm_forward_and_aux_match_flax_and_convert_round_trips():
    jcfg, jmodel, params = _jax_lm(moe_every=2)
    tokens = np.random.default_rng(5).integers(0, 64, size=(2, 12)).astype(np.int32)
    want_logits, want_aux = jmodel.apply(params, jnp.asarray(tokens), return_aux=True)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=4, n_heads=4, max_seq_len=32,
                            attention_impl="reference", dtype=torch.float32, moe_experts=4)
    model = load_flax_params(TransformerLM(cfg, device="cpu"), params)
    # blocks 1 and 3 carry experts, as i % moe_every == moe_every - 1
    assert [hasattr(b, "moe") for b in model.blocks] == [False, True, False, True]
    logits, aux = model(torch.from_numpy(tokens).long(), return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    back = flax_from_state_dict(model.state_dict(), cfg.n_heads, cfg.kv_heads)
    for i in (1, 3):
        assert set(back[f"block_{i}"]) == {"ln1", "ln2", "attn", "moe"}
        for name in ("router", "w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(back[f"block_{i}"]["moe"][name],
                                          np.asarray(params["params"][f"block_{i}"]["moe"][name]))
    assert state_dict_from_flax(back).keys() == model.state_dict().keys()


def test_moe_lm_without_experts_reports_a_zero_aux():
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2,
                            dtype=torch.float32)
    _, aux = TransformerLM(cfg, device="cpu")(torch.zeros((1, 4), dtype=torch.long),
                                              return_aux=True)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_serving_refuses_moe_with_the_jax_text():
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_layers=2, n_heads=2, moe_experts=2,
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    cache = init_kv_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(ValueError) as got:
        transformer_prefill(model, torch.zeros((1, 4), dtype=torch.long),
                            torch.tensor([4]), torch.tensor([[1]]), cache)
    with pytest.raises(ValueError) as want:
        jax_tf._check_decodable(jax_tf.TransformerConfig(moe_experts=2))
    assert str(got.value) == str(want.value) == "KV-cache serving does not support MoE configs yet"


def test_lm_trial_reads_every_moe_hparam():
    ctx = train.init(hparams=dict(MOE_HP, moe_capacity_factor=2.0, moe_aux_weight=0.5,
                                  moe_every=1), seed=0, device="cpu")
    cfg = LMTrial(ctx)._cfg()
    assert (cfg.moe_experts, cfg.moe_every, cfg.moe_capacity_factor, cfg.moe_aux_weight) == \
        (4, 1, 2.0, 0.5)
    model = LMTrial(ctx).build_model()
    assert all(b.moe.capacity_factor == 2.0 for b in model.blocks)


@functools.lru_cache(maxsize=None)
def _jax_moe_run(hp_items):
    hp = dict(hp_items)
    ctx = jax_train.init(
        hparams=hp, mesh_config=MeshConfig(data=1), core_context=jax_core._dummy_init(),
        seed=0, devices=jax.devices()[:1],
    )
    trainer = jax_train.Trainer(jax_tf.LMTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    batches, metrics = [], []
    for _ in range(STEPS):
        batch = next(it)
        batches.append(batch)
        state = trainer._train_step(state, to_global(batch, trainer.mesh))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return metrics, init_params, jax.device_get(state.params), \
        jax.device_get(state.opt_state), batches


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("fused_ce", [False, True], ids=["logits", "fused_ce"])
def test_lm_trial_moe_tracks_the_jax_trainer(fused_ce):
    """8 steps of LMTrial with 4 experts every second block, from the JAX
    Trainer's initial weights on the same batches, on both loss paths:
    losses and moe_aux_loss within TRAIN_PARITY_TOL's loss tolerance,
    params and both moments within its update and moment norms."""
    hp = dict(MOE_HP, fused_ce=fused_ce, fused_adamw=True)
    want_metrics, init_params, want_params, want_opt, want_batches = _jax_moe_run(
        tuple(sorted(hp.items())))
    ctx = train.init(hparams=hp, seed=0, device="cpu")
    trainer = train.Trainer(LMTrial(ctx))
    trainer._setup()
    load_flax_params(trainer.model, init_params)
    it = iter(trainer.train_loader)
    tol = TRAIN_PARITY_TOL["loss"]
    for step in range(STEPS):
        batch = next(it)
        np.testing.assert_array_equal(batch["tokens"], want_batches[step]["tokens"])
        trainer._train_step(to_device(batch, trainer.device))
        got = trainer.state.fetch_metrics()
        trainer.state.reset_metrics()
        want = want_metrics[step]
        assert set(got) == set(want) == {"loss", "lr", "perplexity", "moe_aux_loss"}
        for k in ("loss", "moe_aux_loss", "perplexity"):
            np.testing.assert_allclose(got[k], want[k], err_msg=f"step {step} {k}", **tol)
    cfg = trainer.model.cfg
    got_params = flax_from_state_dict(trainer.model.state_dict(), cfg.n_heads, cfg.kv_heads)
    init = jax.tree_util.tree_leaves_with_path(init_params)
    init = {jax.tree_util.keystr(p): np.asarray(v) for p, v in init}
    got_leaves = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path({"params": got_params})}
    for path, ref in jax.tree_util.tree_leaves_with_path(want_params):
        key = jax.tree_util.keystr(path)
        # the update over 8 steps, held in relative norm
        upd_ref = np.asarray(ref) - init[key]
        upd = np.asarray(got_leaves[key]) - init[key]
        assert _rel(upd, upd_ref) <= TRAIN_PARITY_TOL["update_rel"], (key, _rel(upd, upd_ref))
    got_opt = flax_from_opt_state(trainer.state.opt_state, cfg.n_heads, cfg.kv_heads)
    for which in ("mu", "nu"):
        ref_tree = getattr(want_opt, which)
        got_tree = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_leaves_with_path({"params": got_opt[which]})}
        for path, ref in jax.tree_util.tree_leaves_with_path(ref_tree):
            key = jax.tree_util.keystr(path)
            r = _rel(np.asarray(got_tree[key]), np.asarray(ref))
            assert r <= TRAIN_PARITY_TOL["moment_rel"], (which, key, r)


# ---------------------------------------------------------------------------
# expert parallelism on gloo ranks
# ---------------------------------------------------------------------------


def _ep_case(seed=6, b=4, s=10):
    layer = MoE(D, E, F_FF, group_size=GROUP, dtype=torch.float32, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    params = {k: v.detach().numpy().copy() for k, v in layer.state_dict().items()}
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    return params, x


def _unsharded(params, x):
    layer = _port_layer(params)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = layer(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return y.detach().numpy(), float(aux), xt.grad.numpy(), {
        n: p.grad.numpy() for n, p in layer.named_parameters()}


@pytest.mark.parametrize("mesh", [dict(data=2, expert=2), dict(expert=4)],
                         ids=["data2-expert2", "expert4"])
def test_expert_parallel_moe_equals_the_unsharded_layer(tmp_path, mesh):
    params, x = _ep_case()
    outs = launch("moe_ep", 4, str(tmp_path), dict(mesh=mesh, dims=(D, E, F_FF, GROUP),
                                                  params=params, x=x))
    n_data, n_exp = mesh.get("data", 1), mesh["expert"]
    per = E // n_exp
    for out in outs:
        rows = np.array_split(x, n_data)[out["data"]]
        y, aux, gx, gp = _unsharded(params, rows)
        np.testing.assert_allclose(out["y"], y, **TOL)
        np.testing.assert_allclose(out["aux"], aux, **TOL)
        np.testing.assert_allclose(out["x_grad"], gx, **TOL)
        np.testing.assert_allclose(out["grad_router"], gp["router"], **TOL)
        lo = out["expert"] * per
        for name in ("w_in", "w_gate", "w_out"):
            assert out[f"grad_{name}"].shape[0] == per
            np.testing.assert_allclose(out[f"grad_{name}"], gp[name][lo:lo + per],
                                       err_msg=name, **TOL)


def test_batch_sharded_routing_equals_the_whole_batch(tmp_path):
    """4 x 10 tokens in one routing group of 40 (the whole global batch)
    over data 2 x expert 2: each rank routes the gathered group and keeps
    its 20 rows."""
    params, x = _ep_case(seed=7)
    group = x.shape[0] * x.shape[1]
    outs = launch("moe_ep", 4, str(tmp_path), dict(
        mesh=dict(data=2, expert=2), dims=(D, E, F_FF, group), params=params, x=x,
        shard_batch=True))
    layer = MoE(D, E, F_FF, group_size=group, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    xt = torch.tensor(x, requires_grad=True)
    y, aux = layer(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    halves = np.array_split(np.arange(x.shape[0]), 2)
    mean_grads = {}
    for out in outs:
        rows = halves[out["data"]]
        np.testing.assert_allclose(out["y"], y.detach().numpy()[rows], **TOL)
        np.testing.assert_allclose(out["aux"], float(aux), **TOL)
        # each rank's loss is its half's mean: twice the whole loss's gradient
        np.testing.assert_allclose(out["x_grad"] / 2, xt.grad.numpy()[rows], **TOL)
        mean_grads.setdefault("router", []).append(out["grad_router"])
    np.testing.assert_allclose(np.mean(mean_grads["router"], axis=0),
                               layer.router.grad.numpy(), **TOL)
    for e_rank in (0, 1):
        for name in ("w_in", "w_gate", "w_out"):
            got = np.mean([o[f"grad_{name}"] for o in outs if o["expert"] == e_rank], axis=0)
            want = getattr(layer, name).grad.numpy()[2 * e_rank:2 * e_rank + 2]
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_moe_ep_const_is_the_example_file():
    """chip_smoke's MOE_EP_CONST is examples/transformer_lm/moe_ep.yaml."""
    import os

    import yaml

    from chip_smoke import MOE_CUTS, MOE_EP_CONST

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "examples", "transformer_lm", "moe_ep.yaml")) as f:
        assert yaml.safe_load(f) == MOE_EP_CONST
    hp = MOE_EP_CONST["hyperparameters"]
    for key, old, _new, _why in MOE_CUTS:
        if not key.startswith("resources"):
            assert hp[key] == old, key
