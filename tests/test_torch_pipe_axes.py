"""The pipeline on every mesh axis (determined_tpu_torch/parallel/sharding.py
``cut_pipe``/``shard_model``, models/transformer.py's stage loss,
train/_quant.py's row-parallel scales, train/_trainer.py's replicated
microbatches) against the JAX Trainer, on the CPU.

Each run trains ``LMTrial`` (d 32, 4 layers, f32, the clip engaged) through
the port's Trainer on gloo ranks (tests/torch_rank_worker.py, one launch a
world) and through the JAX Trainer on its virtual CPU mesh of the same
shape, from the same weights (``convert``) and batches, for STEPS steps:

- pipe 2 x tensor 2 under gpipe and 1f1b.  JAX's stages replicate their
  params over tensor; the port splits each stage's blocks, the first
  stage's embedding and the last stage's head over it (the same math);
- pipe 2 x dcn 2 (``num_slices`` 2) with the flat sync, and pipe 2 x dcn
  2 x data 2 (eight ranks) with the hierarchical one (HSDP: replicated
  over the slices, sharded over data within each; the overlapped sync on);
- pipe 2 x data 2 with ``overlap_grad_sync`` on: the plan over the stage's
  own leaves, its buckets as FSDP2 units of one chunk;
- pipe 2 x data 2 at a global batch of 12 in 4 microbatches: 3 rows do not
  split over 2 batch shards, so (JAX's ``batch_axes = ()``) every batch rank
  runs the whole microbatch;
- ``quantized_matmul`` int8 on data 2 x tensor 2 and on pipe 2 x tensor 2
  (the row-parallel o and down products scale over the whole contracting
  dim).

Tolerances: f32 runs hold every step's loss and lr within 1e-5 (rtol and
atol) and every final parameter within 1e-5 of JAX's (atol, with rtol
1e-5), as f32 sums in another order allow; int8 runs hold the losses within
1e-3 relative, tests/test_torch_quant.py's bound for the int8 Trainer
(a value on either side of a quantizer's rounding boundary moves a product
by one quantum, and Adam carries it on).

Also: ``check_exp_config`` accepts examples/transformer_lm/pipeline.yaml on
pipe 2 x tensor 2, on pipe 2 x data 2 over two slices and with the
overlapped sync; a row-parallel quantized product over two ranks equals the
whole product.
"""

import numpy as np
import pytest
import torch

from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.train._trainer import check_exp_config
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_pipeline_schedules import HP, _init_state, clip_engages, jax_pipe_run
from tests.torch_rank_worker import launch

STEPS = 4
F32 = dict(rtol=1e-5, atol=1e-5)
# tests/test_torch_quant.py test_lm_trial_int8_tracks_the_jax_int8_trainer
INT8_LOSS_RTOL = 1e-3
ON = {"overlap_grad_sync": True, "overlap_bucket_mb": 1}
INT8 = {"quantized_matmul": "int8"}
WIDE = dict(d_model=64)  # leaves of 64 KiB: the overlapped sync buckets them
# name: (world, mesh, hparams over HP, the port's optimizations, the JAX
# Trainer's: the same knobs, or for the overlapped and hierarchical syncs
# the run without them, which computes the same step)
RUNS = {
    "pipe2-tensor2-gpipe": (4, dict(pipe=2, tensor=2), {}, {}, {}),
    "pipe2-tensor2-1f1b": (4, dict(pipe=2, tensor=2), dict(pipeline_schedule="1f1b"), {}, {}),
    "pipe2-data2-overlap": (4, dict(pipe=2, data=2), WIDE, ON, {}),
    "pipe2-data2-replicated": (4, dict(pipe=2, data=2), dict(global_batch_size=12), {}, {}),
    "data2-tensor2-int8": (4, dict(data=2, tensor=2), {}, INT8, INT8),
    "pipe2-tensor2-int8": (4, dict(pipe=2, tensor=2), {}, INT8, INT8),
    "pipe2-dcn2-flat": (4, dict(num_slices=2, pipe=2), {}, {}, {}),
    "pipe2-dcn2-data2-hier": (8, dict(num_slices=2, pipe=2, data=2), WIDE,
                              dict(ON, hierarchical_collectives=True), {}),
}


def _jax(name):
    _, mesh, hp, _, jopt = RUNS[name]
    hp = dict(HP, **hp)
    return jax_pipe_run(tuple(mesh.items()), tuple(hp.items()), tuple(jopt.items()), STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run through the port's Trainer, one launch a world; each run's
    chief result and every rank's."""
    out = {}
    for world in (4, 8):
        cases = []
        for name, (w, mesh, hp, opt, _) in RUNS.items():
            if w != world:
                continue
            hp = dict(HP, **hp)
            _, init, _ = _jax(name)
            cases.append(dict(name=name, trial="lm", hparams=hp, mesh=mesh, seed=0,
                              init_state=_init_state(init, mesh, hp),
                              exp_config={"optimizations": opt} if opt else None,
                              fit=dict(max_length=STEPS, report_period=1,
                                       checkpoint_policy="none")))
        tmp = tmp_path_factory.mktemp(f"world{world}")
        ranks = launch("train_runs", world, str(tmp / "runs"),
                       dict(cases=cases, ckpt_dir=str(tmp / "ck")), timeout=300.0)
        for i, r in enumerate(ranks[0]["runs"]):
            out[r["name"]] = dict(r, ranks=[o["runs"][i] for o in ranks])
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_each_composition_tracks_the_jax_trainer(runs, name):
    _, mesh, hp, opt, _ = RUNS[name]
    hp = dict(HP, **hp)
    want, init, final = _jax(name)
    assert clip_engages(hp, _init_state(init, mesh, hp))
    got = runs[name]["training"]
    assert [s for s, _ in got] == list(range(1, STEPS + 1))
    quant = opt.get("quantized_matmul", "none") != "none"
    for (step, g), w in zip(got, want):
        np.testing.assert_allclose(g["lr"], float(w["lr"]), **F32, err_msg=f"step {step} lr")
        if quant:
            np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=INT8_LOSS_RTOL,
                                       err_msg=f"step {step} loss")
        else:
            np.testing.assert_allclose(g["loss"], float(w["loss"]), **F32,
                                       err_msg=f"step {step} loss")
    if quant:
        return
    start, end = _init_state(init, mesh, hp), _init_state(final, mesh, hp)
    params = runs[name]["params"]
    assert set(params) == set(end)
    for k, ref in end.items():
        np.testing.assert_allclose(params[k], ref, **F32, err_msg=k)
        # and every leaf moved
        assert not np.array_equal(ref, start[k]), k


def test_tensor_splits_each_stages_blocks_embedding_and_head(runs):
    """On pipe 2 x tensor 2 rank (p, t) holds stage p's blocks with half
    of their heads and hidden units, the first stage the embedding's half
    of the vocabulary, the last the head's."""
    ranks = runs["pipe2-tensor2-gpipe"]["ranks"]
    d, vocab, ff = HP["d_model"], HP["vocab_size"], 4 * HP["d_model"]
    for rank, r in enumerate(ranks):
        pipe = rank // 2  # the JAX mesh order: pipe outer, tensor inner
        shapes = r["local_shapes"]
        layers = {int(k.split(".")[1]) for k in shapes if k.startswith("blocks.")}
        assert layers == {2 * pipe, 2 * pipe + 1}
        i = 2 * pipe
        assert shapes[f"blocks.{i}.attn.wq.weight"] == (d // 2, d)
        assert shapes[f"blocks.{i}.attn.wo.weight"] == (d, d // 2)
        assert shapes[f"blocks.{i}.mlp.w_down.weight"] == (d, ff // 2)
        assert shapes[f"blocks.{i}.ln1.weight"] == (d,)
        assert ("embed.weight" in shapes) == (pipe == 0)
        assert ("lm_head.weight" in shapes) == (pipe == 1)
        for k in ("embed.weight", "lm_head.weight"):
            if k in shapes:
                assert shapes[k] == (vocab // 2, d)


def test_replicated_microbatches_read_the_whole_batch(runs):
    """12 rows in 4 microbatches of 3: the microbatch does not split over
    data 2, so every rank reads all of it (shard 0 of 1); at 16 rows it
    splits (the overlap run: its data rank's shard of 2)."""
    assert {r["batch_shard"] for r in runs["pipe2-data2-replicated"]["ranks"]} == {(0, 1)}
    shards = [r["batch_shard"] for r in runs["pipe2-data2-overlap"]["ranks"]]
    assert shards == [(0, 2), (1, 2), (0, 2), (1, 2)]


def test_overlap_plans_over_the_stages_own_leaves(runs):
    """The plan is over the stage's own leaves (its blocks, embed or the
    head), in JAX's order; its one bucket is one FSDP2 unit of the stage's
    two blocks; the plan without a pipe axis is over every leaf."""
    for rank, r in enumerate(runs["pipe2-data2-overlap"]["ranks"]):
        pipe = rank // 2
        plan = r["plan"]
        assert plan["enabled"] and plan["names"] == sorted(r["local_keys"],
                                                           key=lambda n: n.split("."))
        blocks = {k.split(".")[1] for k in r["local_keys"] if k.startswith("blocks.")}
        assert blocks == {str(2 * pipe), str(2 * pipe + 1)}
        # one unit holding both blocks' leaves
        assert len(r["units"]) == 1
        assert {k.split(".")[1] for k in r["units"][0]} == blocks
    hier = runs["pipe2-dcn2-data2-hier"]["ranks"][0]["plan"]
    assert hier["fingerprint"].endswith(":hier=dcn2")


@pytest.mark.parametrize("mesh,slices,opt", [
    ({"pipe": 2, "tensor": 2}, None, {}),
    ({"pipe": 2, "data": 2}, 2, {}),
    ({"pipe": 2, "data": 2}, 2, {"overlap_grad_sync": True, "hierarchical_collectives": True}),
    ({"pipe": 4, "data": 2, "fsdp": 2}, None, {"overlap_grad_sync": True}),
], ids=["pipe-tensor", "pipe-dcn", "pipe-dcn-hier", "file-mesh-overlap"])
def test_pipeline_yaml_passes_the_config_check_on_every_axis(mesh, slices, opt):
    cfg = ExperimentConfig.from_yaml("examples/transformer_lm/pipeline.yaml")
    raw = {"hyperparameters": {k: getattr(v, "val", v) for k, v in cfg.hyperparameters.items()},
           "resources": {"mesh": dict(mesh, **({"num_slices": slices} if slices else {}))},
           "optimizations": opt}
    check_exp_config(ExperimentConfig.parse(raw))


def test_a_row_parallel_quantized_product_equals_the_whole_one(tmp_path):
    """x [6, 64] @ w[48, 64].T at int8 and fp8 (emulated): two ranks each
    holding 32 columns of the contracting dim, scaled over the whole of it
    (the absmaxes maxed over the group) and summed, against the whole
    product, to f32 reassociation."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    x[2, 40] = 9.0  # the row's absmax lies in rank 1's columns
    w[5, 3] = -7.0  # and a weight row's in rank 0's
    outs = launch("quant_rows", 2, str(tmp_path / "q"), dict(x=x, w=w))
    from determined_tpu_torch.train import _quant

    for mode in ("int8", "fp8"):
        want = _quant.quantized_matmul_reference(torch.tensor(x), torch.tensor(w), mode)
        for o in outs:
            np.testing.assert_allclose(o[mode], want.numpy(), rtol=1e-5, atol=1e-5)
        # scaled over its own columns only, rank 0's part would differ
        own = _quant.quantized_matmul_reference(torch.tensor(x[:, :32]),
                                                torch.tensor(w[:, :32]), mode)
        assert not np.allclose(own.numpy(), outs[0][f"{mode}_part"], rtol=1e-6, atol=1e-6)
