"""Tensor and sequence parallelism under the port's Trainer: 4 gloo ranks on
the CPU (tests/torch_rank_worker.py, each launch under a hard timeout of
``RANK_TIMEOUT`` seconds) against the JAX Trainer on one device.

- ``LMTrial`` (GQA, remat, fused chunked cross-entropy, ``attention: ring``
  as fsdp_tp_sp.yaml has it) at tensor 2 x seq 2 (the zigzag ring), with
  MQA there too (one kv head: ``wk``/``wv`` whole on every tensor rank), and
  at fsdp 2 x tensor 2 (no seq axis: whole-sequence attention, JAX's
  fallback, as on the JAX Trainer's one device) tracks the JAX Trainer
  for 8 steps from the same weights and batches with the gradient clip
  engaged: losses within chip_smoke's ``TRAIN_PARITY_TOL`` loss tolerance,
  every parameter's update within its update norm.  Ring and tensor
  sharding change no math, so one device is the reference.
- The split leaves are real: on a tensor-2 rank ``w_gate`` is
  ``[d_ff / 2, d_model]`` (tests/test_trainer.py's
  ``test_tp_weights_actually_sharded``).
- ``MnistTrial`` learns past 0.5 validation accuracy at fsdp 2 x tensor 2,
  resumed there from a checkpoint saved at data 2; the checkpoint also
  resumes on one rank, and both end at the params of an uninterrupted run.
- The tensor axis and ``num_slices`` beside the pipeline axis pass
  (tests/test_torch_pipe_axes.py trains them), and so do MoE blocks on the
  tensor or seq axis (tests/test_torch_moe_mesh.py runs them).
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
from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from determined_tpu_torch.ops.fused_adamw import global_norm
from determined_tpu_torch.parallel import MeshConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

LM_HP = dict(
    lr=1e-3, global_batch_size=4, seq_len=32, vocab_size=128, d_model=64, n_layers=2,
    n_heads=4, n_kv_heads=2, dataset_size=32, bf16=False, warmup_steps=1, fused_adamw=True,
    grad_clip=0.05, remat=True, fused_ce=True, ce_chunk=48, attention="ring",
)
STEPS = 8
# name: (mesh, LM_HP's changes); MQA's one kv head does not split over
# tensor 2, so wk/wv stay whole on every tensor rank
MESHES = {"tp2-sp2": (dict(tensor=2, seq=2), {}),
          "tp2-sp2-mqa": (dict(tensor=2, seq=2), dict(n_kv_heads=1)),
          "fsdp2-tp2": (dict(fsdp=2, tensor=2), {})}
MNIST_HP = {"lr": 1e-2, "hidden": 32, "global_batch_size": 32, "dataset_size": 256}


def _hparams(name):
    return dict(LM_HP, **MESHES[name][1])


@functools.lru_cache(maxsize=None)
def _jax_run(n_kv_heads):
    ctx = jax_train.init(
        hparams=dict(LM_HP, n_kv_heads=n_kv_heads), mesh_config=JaxMeshConfig(data=1),
        core_context=jax_core._dummy_init(), seed=0, devices=jax.devices()[:1],
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


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """Each mesh's 4-rank fit of the LM from the JAX Trainer's weights."""
    runs = {}
    for name, (mesh, _) in MESHES.items():
        hp = _hparams(name)
        _, init_params, _ = _jax_run(hp["n_kv_heads"])
        root = tmp_path_factory.mktemp(name)
        runs[name] = launch("train", 4, str(root / "run"), dict(
            trial="lm", hparams=hp, mesh=mesh, seed=0, ckpt_dir=str(root / "ck"),
            init_state=state_dict_from_flax(init_params),
            fit=dict(max_length=STEPS, report_period=1, checkpoint_policy="none"),
        ))
    return runs


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_the_clip_engages_at_these_hparams():
    ctx = train.init(hparams=dict(LM_HP), seed=0, device="cpu")
    trial = LMTrial(ctx)
    model = trial.build_model()
    batch = to_device(next(iter(trial.build_training_data_loader())), ctx.device)
    trial.loss(model, batch)[0].backward()
    norm = float(global_norm({k: p.grad for k, p in model.named_parameters()}))
    assert norm > 10 * LM_HP["grad_clip"], norm


@pytest.mark.parametrize("name", list(MESHES))
def test_lm_tracks_the_jax_trainer(name, lm_runs):
    hp = _hparams(name)
    want, init_params, want_params = _jax_run(hp["n_kv_heads"])
    outs = lm_runs[name]
    # tensor and seq ranks of one (data, fsdp) slice read the same batch
    shards = [o["batch_shard"] for o in outs]
    assert shards == ([(0, 1)] * 4 if "fsdp" not in MESHES[name][0]
                      else [(0, 2), (0, 2), (1, 2), (1, 2)])
    got = outs[0]["training"]
    assert [s for s, _ in got] == list(range(1, STEPS + 1))
    for (step, g), w in zip(got, want):
        for k in ("loss", "lr"):
            np.testing.assert_allclose(g[k], w[k], err_msg=f"step {step} {k}",
                                       **TRAIN_PARITY_TOL["loss"])
        # the ranks' mean of exp(loss of their tokens) is at least exp of
        # the mean, and close to it: here a rank's tokens are half of 4
        # sequences or 2 whole ones, whose losses differ by a few percent
        assert g["perplexity"] >= w["perplexity"] * (1 - 1e-6)
        np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=2e-2)
    cfg = TransformerConfig(n_heads=hp["n_heads"], n_kv_heads=hp["n_kv_heads"])
    got_params = flax_from_state_dict(outs[0]["params"], cfg.n_heads, cfg.kv_heads)
    init = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(init_params)}
    got_leaves = {jax.tree_util.keystr(p): v
                  for p, v in jax.tree_util.tree_leaves_with_path({"params": got_params})}
    for path, ref in jax.tree_util.tree_leaves_with_path(want_params):
        key = jax.tree_util.keystr(path)
        upd_ref, upd = np.asarray(ref) - init[key], got_leaves[key] - init[key]
        assert _rel(upd, upd_ref) <= TRAIN_PARITY_TOL["update_rel"], (key, _rel(upd, upd_ref))


@pytest.mark.parametrize("name", list(MESHES))
def test_tensor_split_leaves_are_real(name, lm_runs):
    d, ff, v, hd = LM_HP["d_model"], 4 * LM_HP["d_model"], LM_HP["vocab_size"], 16
    kv = _hparams(name)["n_kv_heads"]
    # wk splits by kv heads where tensor 2 divides them, else stays whole
    wk = (kv * hd // 2 if kv % 2 == 0 else kv * hd, d)
    want = {"blocks.0.mlp.w_gate.weight": (ff // 2, d), "blocks.0.mlp.w_up.weight": (ff // 2, d),
            "blocks.0.mlp.w_down.weight": (d, ff // 2), "blocks.0.attn.wq.weight": (2 * hd, d),
            "blocks.0.attn.wk.weight": wk, "blocks.0.attn.wv.weight": wk,
            "blocks.0.attn.wo.weight": (d, 2 * hd),
            "embed.weight": (v // 2, d), "lm_head.weight": (v // 2, d),
            "blocks.0.ln1.weight": (d,)}
    for o in lm_runs[name]:
        shapes = o["local_shapes"]
        for k, shape in want.items():
            assert shapes[k] == shape, (name, k, shapes[k])


@pytest.fixture(scope="module")
def mnist_runs(tmp_path_factory):
    """20 steps at data 2 saved; resumed to 40 at fsdp 2 x tensor 2 with a
    validation, and on one rank; an uninterrupted run of 40 on one rank."""
    root = tmp_path_factory.mktemp("mnist")
    ck = str(root / "ck")
    first = launch("train", 2, str(root / "a"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(data=2), seed=7, ckpt_dir=ck,
        fit=dict(max_length=20, checkpoint_period=20, report_period=10,
                 checkpoint_policy="none"),
    ))
    sid = first[0]["summary"]["latest_checkpoint"]
    resumed = launch("train", 4, str(root / "b"), dict(
        trial="mnist", hparams=dict(MNIST_HP), mesh=dict(fsdp=2, tensor=2), seed=7, ckpt_dir=ck,
        fit=dict(max_length=40, latest_checkpoint=sid, validation_period=20, report_period=10,
                 checkpoint_policy="none"),
    ))

    def single(**fit):
        ctx = train.init(hparams=dict(MNIST_HP), seed=7, device="cpu",
                         core_context=core._dummy_init(checkpoint_dir=ck))
        trainer = train.Trainer(MnistTrial(ctx))
        return trainer, trainer.fit(report_period=20, checkpoint_policy="none", **fit)

    return dict(first=first, sid=sid, ck=ck, resumed=resumed,
                single=single(max_length=40, latest_checkpoint=sid),
                straight=single(max_length=40))


def test_mnist_learns_at_fsdp2_tensor2(mnist_runs):
    outs = mnist_runs["resumed"]
    summaries = [o["summary"] for o in outs]
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["steps_completed"] == 40
    assert summaries[0]["validation_metrics"]["validation_accuracy"] > 0.5
    rows = outs[0]["training"]
    assert [s for s, _ in rows] == [30, 40]
    assert outs[1]["training"] == []  # only the chief reports
    # fc1 is split by its output units, fc2 by its input columns
    assert outs[0]["local_shapes"]["fc1.weight"] == (16, 784)
    assert outs[0]["local_shapes"]["fc2.weight"] == (10, 16)
    assert outs[0]["local_shapes"]["fc2.bias"] == (10,)


def test_data2_checkpoint_resumes_at_fsdp2_tensor2_and_on_one_rank(mnist_runs):
    tstate = train.serialization.load_trainer_state(
        os.path.join(mnist_runs["ck"], mnist_runs["sid"]))
    assert tstate["mesh_axes"]["data"] == 2 and tstate["steps_completed"] == 20
    single, summary = mnist_runs["single"]
    assert summary["steps_completed"] == 40
    straight, _ = mnist_runs["straight"]
    want = {k: p.detach().numpy() for k, p in straight.model.named_parameters()}
    for k, p in single.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(mnist_runs["resumed"][0]["params"][k], want[k], rtol=2e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("axes", [dict(pipe=2, tensor=2), dict(num_slices=2, pipe=2)],
                         ids=["pipe", "num_slices"])
def test_axes_of_later_slices_still_raise(axes):
    # ported (tests/test_torch_pipe_axes.py trains both): without a process
    # group the mesh of 4 devices is refused for its size
    with pytest.raises(ValueError, match="needs 4 devices"):
        train.init(hparams=dict(LM_HP), device="cpu", mesh_config=MeshConfig(**axes))


@pytest.mark.parametrize("axis", ["tensor", "seq"])
def test_moe_blocks_on_tensor_or_seq_raise(axis):
    """Ported: MoE blocks on tensor or seq pass the port's checks, and the
    model's split of them takes MoE blocks (the experts' f dim over
    tensor; over seq the model's part of each sequence)."""
    from determined_tpu_torch.train._trainer import check_exp_config

    moe = dict(LM_HP, moe_experts=4)
    check_exp_config(ExperimentConfig.parse({"hyperparameters": moe,
                                             "resources": {"mesh": {axis: 2}}}))
    # without a process group a mesh of 2 devices is refused for its size
    with pytest.raises(ValueError, match="needs 2 devices"):
        train.init(hparams=moe, device="cpu", mesh_config=MeshConfig(**{axis: 2}))
    model = TransformerLM(TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                                            moe_experts=4, dtype=torch.float32), device="cpu")
    if axis == "tensor":
        assert model.shard_tensor(None, 2, 0) == {"embed.weight": 0, "lm_head.weight": 0}
        assert model.blocks[1].moe.shard_tensor(None, 2, 1) == {"w_in": 2, "w_gate": 2,
                                                                "w_out": 1}
        assert tuple(model.blocks[1].moe.w_in.shape) == (4, 32, 64)
        assert tuple(model.blocks[1].moe.w_out.shape) == (4, 64, 32)
    else:
        model.shard_seq(None, 2, 1)
        assert model.seq[1:] == (2, 1)
        assert model.seq_slice(torch.arange(8)[None]).tolist() == [[4, 5, 6, 7]]


def test_unsupported_combinations_raise_before_sharding():
    # quantized products on tensor are ported (tests/test_torch_pipe_axes.py
    # trains them): the MLP splits as without them
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                            dtype=torch.float32, quantized_matmul="int8")
    assert TransformerLM(cfg, device="cpu").blocks[0].mlp.shard_tensor(None, 2, 0) == {
        "w_gate.weight": 0, "w_up.weight": 0, "w_down.weight": 1}
    flash = TransformerLM(TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                                            attention_impl="flash"), device="cpu")
    with pytest.raises(ValueError, match="ring attention there"):
        flash.shard_seq(None, 2, 0)
    with pytest.raises(ValueError, match="the tensor axis \\(3\\) must divide n_heads"):
        TransformerLM(TransformerConfig(vocab_size=66, d_model=32, n_layers=1, n_heads=2),
                      device="cpu").blocks[0].attn.shard_tensor(None, 3, 0)


def test_seq_const_is_the_example_file_and_passes_the_port():
    """chip_smoke's SEQ_CONST is examples/transformer_lm/fsdp_tp_sp.yaml,
    whose fsdp 4 x tensor 4 x seq 2 mesh the port now accepts."""
    import yaml

    from chip_smoke import SEQ_CONST, SEQ_CUTS, _seq_hparams
    from determined_tpu_torch.train._trainer import check_exp_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "examples", "transformer_lm", "fsdp_tp_sp.yaml")) as f:
        raw = yaml.safe_load(f)
    assert raw == SEQ_CONST
    check_exp_config(ExperimentConfig.parse(raw))
    hp = SEQ_CONST["hyperparameters"]
    for key, old, _new, _why in SEQ_CUTS:
        section, _, leaf = key.rpartition(".")
        assert (raw[section][leaf] if section else hp.get(key)) == old, key
    # no cut of the attention: the file's ring runs on one card too
    assert _seq_hparams()["n_layers"] == 4 and _seq_hparams()["attention"] == "ring"
