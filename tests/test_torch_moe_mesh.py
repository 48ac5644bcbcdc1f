"""MoE blocks on every mesh axis outside a pipeline (determined_tpu_torch/
models/moe.py's splits, parallel/sharding.py's placement) against the JAX
package, on the CPU: gloo ranks (tests/torch_rank_worker.py, each launch
under its hard timeout) against flax's layer and the JAX Trainer on the
8-device virtual mesh.

- The layer, split as ``shard_model`` splits it, on each rank's part of the
  global batch (its batch shard's rows by its seq part of each) against
  flax's ``MoE`` on the whole batch, f32: each rank's output, the aux loss
  (on every rank where groups span ranks, the ranks' mean where they lie
  inside one), the input's gradient and the parameters' (the ranks' mean over the token
  shards, a rank's expert rows and ``f`` columns) within 1e-5.  Meshes: seq
  2, tensor 2, data 2 x seq 2 (groups that span rows and ranks, groups that
  span the seq ranks of one row, groups inside one rank, a padded last
  group, and a case that drops tokens at capacity factor 1.25) and tensor 2
  x expert 2.
- ``LMTrial`` with MoE at seq 2 x expert 2, tensor 2 x expert 2 and data 2
  x seq 2 tracks the JAX Trainer at the same mesh for 8 steps from the
  same weights and batches, the gradient clip engaged: losses and
  ``moe_aux_loss`` within 1e-5, perplexity within 2e-2, the params'
  updates within the training parity tolerance.
- On tensor 2 x expert 2 an expert leaf is split on two dims: the clip's
  norm (``ShardPlan.global_norm``) equals the norm of the whole gradients,
  ``full`` gathers each leaf whole, and each rank's leaves are its boxes
  (``ShardPlan.box``, ``convert.state_dict_box``) of the converted flax
  tree.
- A tensor 2 x expert 2 sharded checkpoint restores bitwise on seq 2 x
  expert 2 and on one device.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from determined_tpu.models import moe as jax_moe
from determined_tpu_torch import train
from determined_tpu_torch.convert import state_dict_box
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.train import serialization
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_pipeline_schedules import (
    HP,
    _init_state,
    check_against_jax,
    jax_pipe_run,
    run_on_ranks,
)
from tests.torch_rank_worker import launch

TOL = dict(atol=1e-5, rtol=1e-5)
E, D, F_FF = 4, 32, 64

# name: (mesh, x's shape [B, S], group size, capacity factor)
LAYER2 = {
    # s 8 a rank: a group of 32 is 2 rows x both seq ranks
    "seq2": (dict(seq=2), (4, 16), 32, 1.25),
    # 40 tokens in groups of 16: the last one padded
    "tensor2": (dict(tensor=2), (4, 10), 16, 1.25),
}
LAYER4 = {
    "data2-seq2-span-rows": (dict(data=2, seq=2), (4, 16), 32, 1.25),
    "data2-seq2-span-ranks": (dict(data=2, seq=2), (4, 16), 16, 1.25),
    "data2-seq2-in-rank": (dict(data=2, seq=2), (4, 16), 8, 1.25),
    "data2-seq2-pad": (dict(data=2, seq=2), (2, 12), 16, 1.25),
    # the whole batch in one group at capacity 1.25: tokens are dropped
    "data2-seq2-drops": (dict(data=2, seq=2), (4, 16), 64, 1.25),
    "tensor2-expert2": (dict(tensor=2, expert=2), (4, 10), 16, 1.25),
}
LAYERS = {**LAYER2, **LAYER4}


@functools.lru_cache(maxsize=None)
def _layer_inputs(name):
    _, (b, s), grp, cap = LAYERS[name]
    x = np.random.default_rng(len(name)).standard_normal((b, s, D)).astype(np.float32)
    if name.endswith("drops"):
        x += 1.0  # a common offset: the load is uneven and 24 routes drop
    layer = jax_moe.MoE(num_experts=E, d_ff=F_FF, group_size=grp, capacity_factor=cap,
                        dtype=jnp.float32, partition=False)
    params = flax_meta.unbox(layer.init(jax.random.key(len(name)), jnp.asarray(x)))["params"]
    params = {k: np.asarray(v) for k, v in params.items()}

    def loss(p, xs):
        y, aux = layer.apply({"params": p}, xs)
        return (y ** 2).mean() + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return x, params, dict(y=np.asarray(y), aux=float(aux), x_grad=np.asarray(gx),
                           **{f"grad_{k}": np.asarray(v) for k, v in gp.items()})


def _layer_case(name):
    mesh, _, grp, cap = LAYERS[name]
    x, params, _ = _layer_inputs(name)
    return dict(mesh=mesh, dims=(D, E, F_FF, grp), capacity=cap, params=params, x=x)


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_layers")
    out = {}
    for world, names in ((2, LAYER2), (4, LAYER4)):
        outs = launch("moe_layers", world, str(root / f"w{world}"),
                      dict(cases={n: _layer_case(n) for n in names}))
        out.update({n: [o[n] for o in outs] for n in names})
    return out


@pytest.mark.parametrize("name", list(LAYERS))
def test_the_split_layer_equals_flax_on_the_whole_batch(layer_runs, name):
    mesh, _, grp, cap = LAYERS[name]
    x, _, want = _layer_inputs(name)
    b, s = x.shape[:2]
    n_seq = mesh.get("seq", 1)
    if name.endswith("drops"):
        cap_slots = max(int(cap * grp * 2 / E), 1)
        gates = jax.nn.softmax(jnp.einsum("gd,de->ge", x.reshape(-1, D),
                                          _layer_inputs(name)[1]["router"]))
        dispatch, _, _ = jax_moe._top2_dispatch(gates, cap_slots)
        assert float(dispatch.sum()) < 2 * b * s, "no token dropped"
    outs = layer_runs[name]
    n_tok = outs[0]["batch_shard"][1] * n_seq
    expert_n, tensor_n = mesh.get("expert", 1), mesh.get("tensor", 1)
    mean = {}
    for out in outs:
        (bi, nb), sj = out["batch_shard"], out["coords"]["seq"]
        part = (slice(bi * b // nb, (bi + 1) * b // nb), slice(sj * s // n_seq,
                                                              (sj + 1) * s // n_seq))
        np.testing.assert_allclose(out["y"], want["y"][part], **TOL)
        if not name.endswith("in-rank"):
            # gathered routing: the global aux on every rank
            np.testing.assert_allclose(out["aux"], want["aux"], **TOL)
        # each rank's loss is its tokens' share: n_tok times the whole
        # loss's gradient
        np.testing.assert_allclose(out["x_grad"] / n_tok, want["x_grad"][part], **TOL)
        key = (out["coords"]["expert"], out["coords"]["tensor"])
        for k in ("grad_router", "grad_w_in", "grad_w_gate", "grad_w_out"):
            mean.setdefault((k, key), []).append(out[k])
    # groups inside each rank: its own groups' mean, whose mean over the
    # ranks (the Trainer's) is the global aux
    np.testing.assert_allclose(np.mean([o["aux"] for o in outs]), want["aux"], **TOL)
    for (k, (ei, ti)), grads in mean.items():
        got = np.mean(grads, axis=0)
        ref = want[k]
        if k != "grad_router":
            per, f = E // expert_n, F_FF // tensor_n
            ref = ref[ei * per:(ei + 1) * per]
            ref = ref[:, :, ti * f:(ti + 1) * f] if k != "grad_w_out" else \
                ref[:, ti * f:(ti + 1) * f]
        assert got.shape == ref.shape, k
        assert float(np.abs(ref).sum()) > 0, k
        np.testing.assert_allclose(got, ref, err_msg=f"{k} {ei} {ti}", **TOL)


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

MOE = dict(moe_experts=4, moe_every=2, moe_aux_weight=0.01, attention="ring")
RUNS = {
    "seq2-expert2": (dict(seq=2, expert=2), MOE, {}),
    "tensor2-expert2": (dict(tensor=2, expert=2), MOE, {}),
    "data2-seq2": (dict(data=2, seq=2), MOE, {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_on_ranks(tmp_path_factory.mktemp("moe_runs"), list(RUNS), RUNS, 4)


@pytest.mark.parametrize("name", list(RUNS))
def test_moe_lm_tracks_the_jax_trainer_at_the_same_mesh(runs, name):
    mesh, hp, opt = RUNS[name]
    out = runs[name]
    check_against_jax(out, mesh, hp, opt)
    assert all(0.0 < m["moe_aux_loss"] < 4.0 for _, m in out["training"])


def _jax_init(name):
    mesh, hp, opt = RUNS[name]
    hp = dict(HP, **hp)
    _, init, _ = jax_pipe_run(tuple(mesh.items()), tuple(hp.items()), tuple(opt.items()))
    return _init_state(init, mesh, hp), hp


def test_a_leaf_split_over_expert_and_tensor_norms_gathers_and_boxes(tmp_path):
    state, hp = _jax_init("tensor2-expert2")
    outs = launch("moe_plan", 4, str(tmp_path / "run"), dict(
        hparams=hp, mesh=dict(tensor=2, expert=2), init_state=state,
        ckpt_dir=str(tmp_path / "ck")))
    both = [k for k in outs[0]["tensor_dims"] if k in outs[0]["expert_params"]]
    assert sorted(both) == sorted(f"blocks.{i}.moe.{n}" for i in (1, 3)
                                  for n in ("w_in", "w_gate", "w_out"))
    boxes = []
    for out in outs:
        # the whole gradient's norm, summed over both groups once each
        np.testing.assert_allclose(out["norm"], out["whole_norm"], rtol=1e-6)
        assert out["norm"] > 10 * hp["grad_clip"]
        for k, whole in out["params"].items():
            np.testing.assert_array_equal(whole, state[k], err_msg=k)
        local = state_dict_box(state, out["boxes"])
        for k, v in out["local"].items():
            np.testing.assert_array_equal(v, local[k], err_msg=k)
        boxes.append(out["boxes"]["blocks.1.moe.w_in"])
    # experts over expert, hidden units over tensor: four distinct boxes
    assert sorted(boxes) == [((lo, lo + 2), (0, D), (f, f + 64)) for lo in (0, 2)
                             for f in (0, 64)]
    # the norm is the same on every rank
    assert len({round(o["norm"], 6) for o in outs}) == 1


def test_a_tensor2_expert2_checkpoint_restores_on_seq2_expert2_and_one_device(tmp_path):
    state, hp = _jax_init("tensor2-expert2")
    ck = str(tmp_path / "ck")
    outs = launch("sharded", 4, str(tmp_path / "run"), dict(
        trial="lm", hparams=hp, mesh=dict(tensor=2, expert=2), seed=0, ckpt_dir=ck,
        init_state=state, fit=dict(max_length=2, checkpoint_period=2, report_period=1,
                                   checkpoint_policy="none"),
        restore=[(dict(seq=2, expert=2), 2)]))
    written, moved = outs[0]["runs"]
    sid = written["summary"]["latest_checkpoint"]
    path = os.path.join(ck, sid)
    layout = serialization.load_layout(path)
    # the expert leaves' pieces: boxes over two split dims
    pieces = layout["leaves"]["params/blocks.1.moe.w_in"]["pieces"]
    assert len(pieces) == 4 and all(
        p["box"][0][1] - p["box"][0][0] == 2 and p["box"][2][1] - p["box"][2][0] == 64
        for p in pieces)
    ref = written["state"]
    assert "trial.resize" in moved["spans"]
    for key, (dtype, value) in moved["state"].items():
        assert dtype == ref[key][0], key
        np.testing.assert_array_equal(value, ref[key][1], err_msg=key)
    _, single = train.load_trial_from_checkpoint(path, trial_class=LMTrial, device="cpu")
    flat = serialization.flatten(single._array_state())
    for key, (dtype, value) in ref.items():
        leaf = flat[key]
        got = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf.detach()
        np.testing.assert_array_equal(got.float().numpy(), value, err_msg=key)
