"""The port's training slice (determined_tpu_torch: data, train, LMTrial)
against the JAX package's on the CPU.

- The data copies yield the same arrays as the JAX package's for the same
  seed, batch for batch.
- Reducers, ``Length`` and the overlapped input feed behave as there.
- The slice as a whole: the JAX ``Trainer(LMTrial)`` and the port's take 3
  steps from the same weights (the JAX initial params loaded into the port
  through convert.py) on the same batches; losses, the ``lr`` metric,
  params and both Adam moments agree.
- ``fit`` runs on the CPU, returns validation metrics and saves and
  restores checkpoints; what the port does not have yet raises
  NotImplementedError.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.data import DataLoader as JaxDataLoader
from determined_tpu.data import IndexSampler as JaxIndexSampler
from determined_tpu.data import SyntheticDataset as JaxSyntheticDataset
from determined_tpu.data import to_global
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu.train._reducer import get_reducer as jax_get_reducer
from determined_tpu_torch import train
from determined_tpu_torch.config import InvalidExperimentConfig, Length
from determined_tpu_torch.convert import (
    flax_from_opt_state,
    flax_from_state_dict,
    load_flax_params,
)
from determined_tpu_torch.data import (
    DataLoader,
    EpochFeed,
    IndexSampler,
    InputPipeline,
    SyntheticDataset,
    to_device,
)
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.transformer import TransformerLM
from determined_tpu_torch.train import MetricReducer, get_reducer
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)

HP = dict(
    lr=1e-2, global_batch_size=4, seq_len=128, vocab_size=512, d_model=128, n_layers=2,
    n_heads=2, dataset_size=16, attention="flash", fused_ce=True, fused_adamw=True,
    warmup_steps=2, bf16=False,
)
# f32 through 2 layers on the CPU, XLA against PyTorch: losses and the lr
# agree to f32 reassociation.  Adam divides each moment by its root, so a
# gradient element near zero whose value differs in the last bits moves its
# weight differently (by up to lr a step); params and moments are therefore
# held in relative norm over each tensor, and params elementwise within
# 2 * sum(lr) = 0.03 beside it.
F32_TOL = dict(loss=dict(rtol=1e-5, atol=1e-5), params_rel=1e-4, moments_rel=1e-4,
               params_atol=0.03)
# bf16 compute: the two frameworks round activations and gradients to bf16
# at different places (the port takes the lm_head product in bf16 before
# f32 where XLA keeps its f32 accumulator; JAX sums the embedding gradient
# in bf16, the port in f32), so gradients differ by a few percent in
# relative norm and the moments with them; a weight moves by at most lr a
# step whatever its gradient, so params stay within 2 * sum(lr) = 0.03
BF16_TOL = dict(loss=dict(rtol=2e-3, atol=2e-3), params_rel=0.06, moments_rel=0.12,
                params_atol=0.03)
STEPS = 3


# ---------------------------------------------------------------------------
# data copies
# ---------------------------------------------------------------------------


def test_synthetic_dataset_arrays_equal_jax():
    spec = {"tokens": ((9,), np.int32, 100), "x": ((3, 2), np.float32)}
    want = JaxSyntheticDataset(spec, size=20, seed=7)
    got = SyntheticDataset(spec, size=20, seed=7)
    assert len(got) == len(want) == 20
    for k in spec:
        np.testing.assert_array_equal(got.columns[k], want.columns[k])
        assert got.columns[k].dtype == want.columns[k].dtype
    idx = np.array([3, 1, 19])
    for k in spec:
        np.testing.assert_array_equal(got.gather(idx)[k], want.gather(idx)[k])


@pytest.mark.parametrize("shuffle", [True, False])
def test_index_sampler_equals_jax(shuffle):
    a = IndexSampler(50, 8, shuffle=shuffle, seed=3)
    b = JaxIndexSampler(50, 8, shuffle=shuffle, seed=3)
    for epoch in range(3):
        np.testing.assert_array_equal(a.epoch_batches(epoch), b.epoch_batches(epoch))


def test_data_loader_batches_and_state_equal_jax():
    spec = {"tokens": ((5,), np.int32, 50)}
    port = DataLoader(SyntheticDataset(spec, 22, seed=1), 4, shuffle=True, seed=9)
    ref = JaxDataLoader(JaxSyntheticDataset(spec, 22, seed=1), 4, shuffle=True, seed=9,
                        shard_rank=0, num_shards=1)
    assert port.batches_per_epoch == ref.batches_per_epoch == 5
    for a, b in zip(iter(port), iter(ref)):  # across an epoch boundary
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert port.state_dict() == ref.state_dict()
        if port.state_dict()["epoch"] == 2:
            break
    for a, b in zip(port.iter_epoch(1), ref.iter_epoch(1)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # resume from a state dict, also across a changed global batch
    state = {"epoch": 1, "batches_in_epoch": 3, "global_batch": 2}
    port.load_state_dict(state)
    ref.load_state_dict(state)
    assert port.state_dict() == ref.state_dict()
    np.testing.assert_array_equal(next(iter(port))["tokens"], next(iter(ref))["tokens"])


def test_input_pipeline_commits_the_consumed_position():
    spec = {"tokens": ((4,), np.int32, 10)}
    loader = DataLoader(SyntheticDataset(spec, 12, seed=0), 3, seed=2)
    want = [b["tokens"] for b in DataLoader(SyntheticDataset(spec, 12, seed=0), 3, seed=2)
            .iter_epoch(0)]
    pipe = InputPipeline(loader, torch.device("cpu"), prefetch_depth=2, device_buffer=2)
    try:
        for i in range(3):
            batch = next(pipe)
            assert isinstance(batch["tokens"], torch.Tensor)
            np.testing.assert_array_equal(batch["tokens"].numpy(), want[i])
            # the worker has fetched ahead, the loader records what was taken
            assert loader.state_dict()["batches_in_epoch"] == i + 1
    finally:
        pipe.close()
    with EpochFeed(loader.iter_epoch(0), torch.device("cpu")) as feed:
        got = [b["tokens"].numpy() for b in feed]
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prefetch_worker_error_reaches_the_consumer():
    class Boom:
        def fire(self, site, **info):
            if site == "data.prefetch.fetch" and info["batches"] == 2:
                raise OSError("disk gone")

    spec = {"tokens": ((4,), np.int32, 10)}
    loader = DataLoader(SyntheticDataset(spec, 12, seed=0), 3)
    faults.set_fault_injector(Boom())
    try:
        pipe = InputPipeline(loader, torch.device("cpu"))
        next(pipe)
        with pytest.raises(OSError, match="disk gone"):
            next(pipe)
        pipe.close()
    finally:
        faults.set_fault_injector(None)


def test_to_device_keeps_values_and_dtypes():
    batch = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.ones(2, np.float32)}
    out = to_device(batch, torch.device("cpu"))
    assert out["a"].dtype == torch.int32 and out["b"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"].numpy(), batch["a"])


# ---------------------------------------------------------------------------
# reducers and lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mean", "avg", "sum", "min", "max", "last"])
def test_builtin_reducers_match_jax(name):
    values = [3.0, -1.5, 7.25, 0.5]
    port, ref = get_reducer(name), jax_get_reducer(name)
    carry = torch.tensor(port.init)
    ref_carry = jax.numpy.asarray(ref.init, jax.numpy.float32)
    for v in values:
        carry = port.accumulate(carry, torch.tensor(v))
        ref_carry = ref.accumulate(ref_carry, jax.numpy.asarray(v, jax.numpy.float32))
    got = port.finalize(float(carry), float(len(values)))
    want = ref.finalize(float(ref_carry), float(len(values)))
    assert got == pytest.approx(want)


def test_custom_reducer_and_unknown_name():
    r = MetricReducer(init=1.0, accumulate=lambda c, v: c * v)
    assert get_reducer(r) is r
    with pytest.raises(ValueError, match="unknown reducer"):
        get_reducer("median")


@pytest.mark.parametrize(
    "raw, want",
    [
        (5, Length(5, "batches")),
        ({"epochs": 2}, Length(2, "epochs")),
        ({"records": 100}, Length(100, "records")),
        (Length(3, "epochs"), Length(3, "epochs")),
    ],
)
def test_length_parse(raw, want):
    assert Length.parse(raw) == want


@pytest.mark.parametrize("raw", [{"epochs": 1, "batches": 2}, "ten", {"weeks": 1}, -1])
def test_length_parse_rejects(raw):
    with pytest.raises(InvalidExperimentConfig):
        Length.parse(raw)


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer(LMTrial), JAX against the port
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(hp_items):
    """3 JAX Trainer steps: per-step metrics, the initial and final params
    and the final optimizer state (host numpy), and the batches fed."""
    hp = dict(hp_items)
    ctx = jax_train.init(
        hparams=hp, mesh_config=MeshConfig(data=1), core_context=jax_core._dummy_init(),
        seed=0, devices=jax.devices()[:1],
    )
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
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
    return metrics, init_params, jax.device_get(state.params), jax.device_get(state.opt_state), \
        batches


def _port_run(hp, init_params):
    ctx = train.init(hparams=hp, seed=0, device="cpu")
    trainer = train.Trainer(LMTrial(ctx))
    trainer._setup()
    load_flax_params(trainer.model, init_params)
    it = iter(trainer.train_loader)
    batches, metrics = [], []
    for _ in range(STEPS):
        batch = next(it)
        batches.append(batch)
        trainer._train_step(to_device(batch, trainer.device))
        metrics.append(trainer.state.fetch_metrics())
        trainer.state.reset_metrics()
    return trainer, metrics, batches


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _compare_trees(got, want, rel_norm, what, atol=None):
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(want):
        name = f"{what} {jax.tree_util.keystr(path)}"
        ref = np.asarray(ref, np.float32)
        g = np.asarray(got_leaves[path], np.float32)
        assert g.shape == ref.shape, name
        assert _rel(g, ref) <= rel_norm, (name, _rel(g, ref))
        if atol is not None:
            np.testing.assert_allclose(g, ref, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize(
    "case",
    ["f32_fused", "f32_optax_chain", "bf16_fused_mu_bf16"],
)
def test_trainer_lm_trial_matches_jax_trainer(case):
    hp = dict(HP)
    tol = F32_TOL
    if case == "f32_optax_chain":
        hp["fused_adamw"] = False
    if case == "bf16_fused_mu_bf16":
        hp.update(bf16=True, adam_mu_bf16=True)
        tol = BF16_TOL
    want_metrics, init_params, want_params, want_opt, want_batches = _jax_run(
        tuple(sorted(hp.items()))
    )
    trainer, got_metrics, got_batches = _port_run(hp, init_params)
    for a, b in zip(got_batches, want_batches):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for step, (g, w) in enumerate(zip(got_metrics, want_metrics)):
        assert set(g) == set(w) == {"loss", "lr", "perplexity"}, (g, w)
        for k in ("loss", "perplexity"):
            np.testing.assert_allclose(g[k], w[k], err_msg=f"step {step} {k}", **tol["loss"])
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6, err_msg=f"step {step} lr")
    cfg = trainer.model.cfg
    got_params = flax_from_state_dict(trainer.model.state_dict(), cfg.n_heads, cfg.kv_heads)
    _compare_trees({"params": got_params}, want_params, tol["params_rel"], "params",
                   atol=tol["params_atol"])
    got_opt = flax_from_opt_state(trainer.state.opt_state, cfg.n_heads, cfg.kv_heads)
    adam = want_opt if hasattr(want_opt, "mu") else want_opt[1][0]
    assert got_opt["count"] == int(np.asarray(adam.count)) == STEPS
    _compare_trees({"params": got_opt["mu"]}, adam.mu, tol["moments_rel"], "mu")
    _compare_trees({"params": got_opt["nu"]}, adam.nu, tol["moments_rel"], "nu")


def test_fit_on_cpu_returns_validation_metrics():
    ctx = train.init(hparams=dict(HP, seq_len=32, dataset_size=8), seed=0, device="cpu")
    summary = train.Trainer(LMTrial(ctx)).fit(
        max_length=4, validation_period=4, report_period=2, checkpoint_policy="none"
    )
    assert summary["steps_completed"] == 4
    assert summary["latest_checkpoint"] is None and not summary["stopped_early"]
    val = summary["validation_metrics"]
    assert set(val) == {"validation_loss", "validation_perplexity"}
    assert np.isfinite(val["validation_loss"])
    # the mean of per-batch exp(loss) is at least exp of the mean loss
    assert val["validation_perplexity"] >= np.exp(val["validation_loss"]) * (1 - 1e-6)
    reports = ctx.core.train.metrics("training")
    assert [s for s, _ in reports] == [2, 4]
    for _, m in reports:
        assert {"loss", "lr", "perplexity", "samples_per_second"} <= set(m)
        assert m["samples_per_second"] > 0
    assert [s for s, _ in ctx.core.train.metrics("validation")] == [4]


@pytest.mark.parametrize(
    "kwargs",
    [dict(checkpoint_policy="best"), dict(), dict(checkpoint_policy="none", checkpoint_period=2),
     dict(checkpoint_policy="none", latest_checkpoint=True)],
    ids=["best", "default", "period", "restore"],
)
def test_fit_checkpoint_options_work(kwargs, tmp_path):
    """Every checkpoint option of ``fit`` runs on the CPU: "best" and the
    default policy save (a validation's best and the final checkpoint), a
    period of 2 saves at steps 2 and 4, and ``latest_checkpoint`` resumes."""
    from determined_tpu_torch import core

    hp = dict(HP, seq_len=32, dataset_size=8)

    def trainer():
        ctx = train.init(hparams=hp, seed=0, device="cpu",
                         core_context=core._dummy_init(checkpoint_dir=str(tmp_path)))
        return train.Trainer(LMTrial(ctx))

    ckpt = core._dummy_init(checkpoint_dir=str(tmp_path)).checkpoint
    if kwargs.get("latest_checkpoint"):
        first = trainer().fit(max_length=2, checkpoint_policy="all", validation_period=2)
        kwargs = dict(kwargs, latest_checkpoint=first["latest_checkpoint"])
        resumed = trainer()
        summary = resumed.fit(max_length=4, report_period=1, **kwargs)
        assert summary["steps_completed"] == 4
        # the resumed run started at step 2: its reports are of steps 3, 4
        assert [s for s, _ in resumed.core.train.metrics("training")] == [3, 4]
        return
    summary = trainer().fit(max_length=4, validation_period=2, **kwargs)
    sid = summary["latest_checkpoint"]
    assert summary["steps_completed"] == 4 and sid is not None
    assert ckpt.get_metadata(sid)["steps_completed"] == 4
    if "checkpoint_period" in kwargs:
        parent = ckpt.get_checkpoint_parent(sid)
        assert ckpt.get_metadata(parent)["steps_completed"] == 2
    with ckpt.restore_path(sid, require_manifest=True) as path:
        assert set(os.listdir(os.path.join(path, "state"))) == {
            "step.pt", "params.pt", "opt_state.pt", "rng.pt"
        }


def test_unported_options_raise():
    # the pipeline hparams are ported: without a pipe axis they change
    # nothing, as in the JAX trial; tensor beside pipe still waits
    ctx = train.init(hparams=dict(HP, pipe_microbatches=2), device="cpu")
    from determined_tpu_torch.parallel import MeshConfig as PortMeshConfig

    assert LMTrial(ctx).build_model().pipe is None
    with pytest.raises(NotImplementedError, match="later slice"):
        train.init(hparams=dict(HP, pipe_microbatches=2), device="cpu",
                   mesh_config=PortMeshConfig(pipe=2, tensor=2))
    # ring attention is ported; on one device (the JAX Trainer's mesh of
    # one) it is whole-sequence attention (plain on the CPU), as JAX's ring
    # falls back without a seq axis, and the bare model without a mesh
    # raises as the JAX Attention
    tokens = torch.arange(8)[None] % HP["vocab_size"]
    ring = LMTrial(train.init(hparams=dict(HP, attention="ring"), device="cpu")).build_model()
    plain = LMTrial(train.init(hparams=dict(HP, attention="reference"), device="cpu")
                    ).build_model()
    assert torch.equal(ring(tokens), plain(tokens))
    bare = TransformerLM(ring.cfg, device="cpu")
    with pytest.raises(ValueError, match="ring attention requires the mesh"):
        bare(tokens)


@pytest.mark.parametrize(
    "raw",
    # tensor, seq and overlap are ported: MoE blocks on them and overlap
    # beside pipe are what waits
    [{"optimizations": {"overlap_grad_sync": True}, "resources": {"mesh": {"pipe": 2}}},
     {"resources": {"mesh": {"data": 2, "tensor": 2}}, "moe_experts": 2},
     {"resources": {"mesh": {"fsdp": 2, "data": -1, "seq": 2}}, "moe_experts": 2}],
    ids=["overlap_grad_sync", "mesh_data2", "mesh_fsdp2"],
)
def test_exp_config_knobs_of_later_slices_raise(raw):
    from determined_tpu_torch.config import ExperimentConfig

    raw = dict(raw)
    hp = dict(HP, moe_experts=raw.pop("moe_experts")) if "moe_experts" in raw else HP
    cfg = ExperimentConfig.parse(dict(raw, hyperparameters=hp))
    with pytest.raises(NotImplementedError, match="later slice"):
        train.init(exp_config=cfg, device="cpu")


def test_init_without_a_gpu_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.init(hparams=HP)


def test_fused_adamw_auto_is_the_fused_optimizer_on_cuda_only():
    from determined_tpu_torch.ops.fused_adamw import FusedAdamW
    from determined_tpu_torch.train._optim import ClipAdamW

    ctx = train.init(hparams=dict(HP, fused_adamw="auto"), device="cpu")
    assert isinstance(LMTrial(ctx).build_optimizer(), ClipAdamW)
    ctx.device = torch.device("cuda")  # what auto reads; nothing is built here
    assert isinstance(LMTrial(ctx).build_optimizer(), FusedAdamW)


def test_remat_gives_the_same_gradients():
    hp = dict(HP, seq_len=32)
    grads = []
    for remat in (False, True):
        ctx = train.init(hparams=dict(hp, remat=remat), seed=0, device="cpu")
        trial = LMTrial(ctx)
        model = trial.build_model()
        batch = to_device(next(iter(trial.build_training_data_loader())), ctx.device)
        loss, _ = trial.loss(model, batch)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-7)
