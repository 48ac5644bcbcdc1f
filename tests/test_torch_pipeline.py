"""The port's pipeline through the Trainer (determined_tpu_torch/parallel/
pipeline.py, LMTrial's pipeline branches) against the JAX package's, on the
CPU: gloo ranks (tests/torch_rank_worker.py) against the JAX Trainer on the
8-device virtual mesh.

- ``LMTrial`` on pipe 2, pipe 2 with fused cross-entropy, pipe 2 x data 2,
  pipe 2 x fsdp 2, MoE at pipe 2 x expert 2 (its aux loss reported) and
  dense at pipe 2 x seq 2 (ring attention inside each stage) tracks the
  JAX Trainer at the same mesh for 8 steps from the same weights and
  batches, with the gradient clip engaged: losses (and moe_aux_loss)
  within 1e-5, perplexity (the ranks' mean of exp(loss)) within 2e-2, the
  params' updates within the training parity tolerance.  Each rank holds
  its stage's leaves only, under the whole model's names.
- Checkpoints: a pipe 2 run saves every 2 steps; the same mesh resumes the
  step-2 checkpoint and ends where the run did, bitwise; the same mesh,
  data 2 (another pipe size) and one device without a mesh restore the
  step-4 checkpoint bitwise.
- ``convert``: JAX's split layout (``split_pipeline_params``, gpipe and
  interleaved) maps both ways to the port's state dict, and each pipe
  rank's part is its stage's leaves.
- A virtual pipe of 2 (``train.init(virtual_pipe=2)``) trains as the
  unpipelined model aggregating the same microbatches does.
"""

import jax
import numpy as np
import pytest
import torch

from determined_tpu.models.transformer import TransformerLM as JaxLM
from determined_tpu.models.transformer import TransformerConfig as JaxConfig
from determined_tpu.models.transformer import split_pipeline_params
from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import (
    split_from_state_dict,
    stage_state_dict,
    state_dict_from_flax,
    state_dict_from_split,
)
from determined_tpu_torch.models import LMTrial
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_pipeline_schedules import (
    HP,
    _init_state,
    check_against_jax,
    jax_pipe_run,
    run_on_ranks,
)
from tests.torch_rank_worker import launch

MOE = dict(moe_experts=4, moe_every=2, moe_aux_weight=0.01)
# name: (mesh, hparams over HP, optimizations)
RUNS2 = {
    "pipe2": (dict(pipe=2), {}, {}),
    "pipe2-fused-ce": (dict(pipe=2), dict(fused_ce=True), {}),
}
RUNS4 = {
    "pipe2-data2": (dict(pipe=2, data=2), {}, {}),
    "pipe2-fsdp2": (dict(pipe=2, fsdp=2), {}, {}),
    "moe-pipe2-expert2": (dict(pipe=2, expert=2), MOE, {}),
    "pipe2-seq2": (dict(pipe=2, seq=2), dict(attention="ring"), {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    out = run_on_ranks(root / "two", list(RUNS2), RUNS2, 2)
    out.update(run_on_ranks(root / "four", list(RUNS4), RUNS4, 4))
    return out


@pytest.mark.parametrize("name", list(RUNS2) + list(RUNS4))
def test_lm_on_a_pipe_mesh_tracks_the_jax_trainer(runs, name):
    mesh, hp, opt = {**RUNS2, **RUNS4}[name]
    out = runs[name]
    check_against_jax(out, mesh, hp, opt)
    if "moe_experts" in hp:
        assert all(0.0 < m["moe_aux_loss"] < 4.0 for _, m in out["training"])
    # each rank holds its stage's leaves under the whole model's names
    keys = [set(k) for k in out["local_keys"]]
    stage0 = [k for k in keys if "embed.weight" in k]
    stage1 = [k for k in keys if "lm_head.weight" in k]
    assert len(stage0) == len(stage1) == len(keys) // 2
    assert all(k.startswith(("embed.", "blocks.0.", "blocks.1.")) for k in stage0[0])
    assert all(k.startswith(("ln_f.", "lm_head.", "blocks.2.", "blocks.3.")) for k in stage1[0])


CKPT_HP = dict(HP, lr=1e-2, grad_clip=1.0)


def test_pipe_checkpoints_resume_and_restore_bitwise(tmp_path):
    out = launch("pipe_ckpt", 2, str(tmp_path / "run"), dict(
        hparams=CKPT_HP, mesh=dict(pipe=2), steps=4, other=[dict(data=2)],
        ckpt_dir=str(tmp_path / "ck")))[0]
    first = out["first"]
    assert out["steps"] == 2
    for label, got in [("resumed", out["resumed"]), ("restored", out["restored"]),
                       ("data2", out["other"][0])]:
        assert set(got) == set(first), label
        for k, (dtype, v) in got.items():
            assert dtype == first[k][0] and np.array_equal(v, first[k][1]), (label, k)
    # one device, no mesh: the same leaves bitwise
    core_ctx = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    ctx = train.init(hparams=dict(CKPT_HP), seed=0, device="cpu", core_context=core_ctx)
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=4, latest_checkpoint=out["last"], checkpoint_policy="none")
    assert summary["steps_completed"] == 4
    for name, p in trainer._params.items():
        assert np.array_equal(p.detach().numpy(), first[f"params/{name}"][1]), name
    for which in ("mu", "nu"):
        for name, t in getattr(trainer.state.opt_state, which).items():
            assert np.array_equal(t.numpy(), first[f"opt_state/{which}/{name}"][1]), name


@pytest.mark.parametrize("n,v", [(2, 1), (4, 1), (2, 2)])
def test_convert_maps_the_split_layout_both_ways(n, v):
    from flax.core import meta as flax_meta

    cfg = JaxConfig(vocab_size=64, d_model=32, n_layers=8, n_heads=4, n_kv_heads=2,
                    max_seq_len=8, dtype=jax.numpy.float32, attention_impl="reference")
    params = jax.device_get(flax_meta.unbox(
        JaxLM(cfg).init(jax.random.key(3), jax.numpy.zeros((1, 8), jax.numpy.int32))))
    whole = state_dict_from_flax(params)
    split = jax.device_get(flax_meta.unbox(split_pipeline_params(params, n, v)))
    got = state_dict_from_split(split, n, v)
    assert set(got) == set(whole)
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)
    back = split_from_state_dict(whole, 4, 2, n, v)
    flat = jax.tree_util.tree_leaves_with_path(split)
    back_flat = dict((jax.tree_util.keystr(p), x) for p, x in
                     jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[jax.tree_util.keystr(path)], leaf)
    # each rank's part: its chunks' layers, embed first, the head last
    lpc = 8 // (n * v)
    for rank in range(n):
        part = stage_state_dict(whole, rank, n, v)
        layers = {int(k.split(".")[1]) for k in part if k.startswith("blocks.")}
        assert layers == {c * lpc + j for c in range(rank, n * v, n) for j in range(lpc)}
        assert ("embed.weight" in part) == (rank == 0)
        assert ("lm_head.weight" in part) == (rank == n - 1)


def _losses(hp, virtual_pipe=None, agg=1, steps=4):
    exp = ExperimentConfig.parse({"optimizations": {"aggregation_frequency": agg}})
    ctx = train.init(hparams=hp, seed=0, device="cpu", exp_config=exp, virtual_pipe=virtual_pipe)
    trainer = train.Trainer(LMTrial(ctx))
    trainer.fit(max_length=steps, report_period=1, checkpoint_policy="none")
    return ([m["loss"] for _, m in ctx.core.train.metrics("training")],
            {k: p.detach().clone() for k, p in trainer._params.items()})


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1), ("interleaved", 2)])
def test_a_virtual_pipe_trains_as_the_unpipelined_model_aggregating(schedule, v):
    hp = dict(HP, global_batch_size=8, pipe_microbatches=4, grad_clip=1.0,
              pipeline_schedule=schedule, virtual_stages=v)
    got, got_params = _losses(hp, virtual_pipe=2)
    plain = {k: x for k, x in hp.items()
             if k not in ("pipe_microbatches", "pipeline_schedule", "virtual_stages")}
    want, want_params = _losses(dict(plain, global_batch_size=2), agg=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k, p in want_params.items():
        torch.testing.assert_close(got_params[k], p, rtol=1e-4, atol=1e-5, msg=k)


def test_the_jax_run_starts_from_the_converted_init():
    # the JAX Trainer's split init and the port's whole init state name the
    # same weights: restacking the converted state gives the split back
    mesh, hp, opt = RUNS2["pipe2"]
    hp = dict(HP, **hp)
    _, init, _ = jax_pipe_run(tuple(mesh.items()), tuple(hp.items()), tuple(opt.items()))
    state = _init_state(init, mesh, hp)
    back = split_from_state_dict(state, hp["n_heads"], hp["n_heads"], 2)
    for path, leaf in jax.tree_util.tree_leaves_with_path(init):
        key = jax.tree_util.keystr(path)
        want = dict((jax.tree_util.keystr(p), x) for p, x in
                    jax.tree_util.tree_leaves_with_path(back))[key]
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=key)


def test_pipeline_yaml_is_chip_smokes_and_each_schedule_passes_the_port():
    """chip_smoke's PIPE_CONST is examples/transformer_lm/pipeline.yaml,
    which the port accepts under each schedule; pipeline_seq_ep.yaml (pipe x
    seq x expert with MoE) raises, naming MoE x seq, and pipe x tensor
    raises, each naming a later slice."""
    import os

    import yaml

    from chip_smoke import PIPE_CONST, PIPE_CUTS
    from determined_tpu_torch.train._trainer import check_exp_config
    from mesh_smoke import P_CUTS

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "transformer_lm")
    with open(os.path.join(root, "pipeline.yaml")) as f:
        raw = yaml.safe_load(f)
    assert raw == PIPE_CONST
    for key, old, _new, _why in PIPE_CUTS + P_CUTS:
        section, _, leaf = key.rpartition(".")
        assert (raw[section][leaf] if section else raw["hyperparameters"].get(key)) == old, key
    for schedule, v in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
        check_exp_config(ExperimentConfig.parse(
            dict(raw, optimizations={"pipeline_schedule": schedule, "virtual_stages": v})))
    with open(os.path.join(root, "pipeline_seq_ep.yaml")) as f:
        seq_ep = ExperimentConfig.parse(yaml.safe_load(f))
    with pytest.raises(NotImplementedError, match="MoE x seq.*later slice"):
        check_exp_config(seq_ep)
    with pytest.raises(NotImplementedError, match="'tensor' mesh axis beside 'pipe'.*later slice"):
        check_exp_config(ExperimentConfig.parse(
            dict(raw, resources={"mesh": {"pipe": 4, "tensor": 4}})))


def test_run_local_runs_a_pipe_trial_as_a_gang_of_ranks(tmp_path, monkeypatch):
    """run-local's path on a pipe mesh: LocalExperiment runs the trial as a
    gang of two gloo rank processes (experiment/_gang.py), which trains
    through the interleaved schedule to the one-device run's validation
    loss."""
    from determined_tpu_torch.experiment import LocalExperiment, _gang

    monkeypatch.setattr(_gang, "ATTEMPT_TIMEOUT_S", 240.0)
    hp = dict(CKPT_HP, pipeline_schedule="interleaved", virtual_stages=2)
    raw = {"name": "pipe-gang", "hyperparameters": hp,
           "searcher": {"name": "single", "metric": "validation_loss",
                        "max_length": {"batches": 4}},
           "resources": {"mesh": {"pipe": 2}}, "min_validation_period": {"batches": 4}}
    exp = LocalExperiment(ExperimentConfig.parse(raw), LMTrial,
                          checkpoint_dir=str(tmp_path / "exp"), devices=["cpu", "cpu"])
    summary = exp.run()
    assert summary["status"] == "completed" and exp.results[1].steps_completed == 4
    # the same trial (seed 0 + trial 1) on one device, no pipe
    plain = {k: v for k, v in hp.items() if k not in ("pipeline_schedule", "virtual_stages")}
    ctx = train.init(hparams=plain, seed=1, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "one")))
    train.Trainer(LMTrial(ctx)).fit(max_length=4, validation_period=4, checkpoint_policy="none")
    want = ctx.core.train.metrics("validation")[-1][1]["validation_loss"]
    np.testing.assert_allclose(exp.results[1].metrics["validation_loss"], want, rtol=1e-5)
