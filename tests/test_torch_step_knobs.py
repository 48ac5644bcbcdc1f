"""The single-device step knobs of the port's Trainer against the JAX
package's on the CPU: gradient accumulation (``aggregation_frequency``),
``fetch_workers`` and ``compilation_cache_dir``.

- At ``aggregation_frequency`` 2 the port's ``Trainer(LMTrial)`` tracks the
  JAX Trainer step for step from the same weights and stacked batches, with
  the gradients averaged and summed; epoch and record lengths divide by agg
  as there, and the loader's committed state is the one after the last
  microbatch of each step.
- ``fetch_workers`` reads the same batches as the sequential loop and as
  the JAX loader, the Trainer passes the experiment's value to loaders that
  set none, and ``close()`` releases the pool.
- ``compilation_cache_dir`` resolves and logs as the JAX module does, and
  points the kernels' builds at the directory without building anything.
- ``train.init`` (its ``check_exp_config``) takes all four knobs, and a
  local experiment runs a configuration with them.
"""

import functools
import logging
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.data import DataLoader as JaxDataLoader
from determined_tpu.data import mnist_like as jax_mnist_like
from determined_tpu.data import to_global
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu.utils import compilation_cache as jax_cc
from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import flax_from_opt_state, flax_from_state_dict, load_flax_params
from determined_tpu_torch.data import DataLoader, InMemoryDataset, InputPipeline, mnist_like
from determined_tpu_torch.data import to_device
from determined_tpu_torch.experiment import LocalExperiment
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.ops import _build
from determined_tpu_torch.utils import compilation_cache as cc
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL, _compare_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HP = dict(
    lr=1e-2, global_batch_size=4, seq_len=64, vocab_size=256, d_model=64, n_layers=2,
    n_heads=2, dataset_size=32, attention="flash", fused_ce=True, fused_adamw=True,
    warmup_steps=2, bf16=False,
)
AGG = 2
STEPS = 3


def _opt(**knobs):
    return {"optimizations": knobs}


# ---------------------------------------------------------------------------
# gradient accumulation: the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_agg_run(average):
    """STEPS JAX Trainer steps at aggregation_frequency AGG: per-step
    metrics, the initial and final params and optimizer state, the stacked
    batches, and the trainer (for its length arithmetic)."""
    exp = JaxExperimentConfig.parse(
        _opt(aggregation_frequency=AGG, average_aggregated_gradients=average)
    )
    ctx = jax_train.init(
        hparams=dict(HP), exp_config=exp, mesh_config=MeshConfig(data=1),
        core_context=jax_core._dummy_init(), seed=0, devices=jax.devices()[:1],
    )
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    pairs = trainer.train_loader.iter_pairs(agg=AGG)
    batches, metrics = [], []
    for _ in range(STEPS):
        _, batch = next(pairs)
        batches.append(batch)
        state = trainer._train_step(state, to_global(batch, trainer.mesh, micro_dim=True))
        metrics.append(state.fetch_metrics())
        state = state.reset_metrics()
    return (metrics, init_params, jax.device_get(state.params),
            jax.device_get(state.opt_state), batches, trainer)


def _port_agg_trainer(average=True, **hp):
    exp = ExperimentConfig.parse(
        _opt(aggregation_frequency=AGG, average_aggregated_gradients=average)
    )
    ctx = train.init(hparams=dict(HP, **hp), exp_config=exp, seed=0, device="cpu")
    return train.Trainer(LMTrial(ctx))


@pytest.mark.parametrize("average", [True, False], ids=["averaged", "summed"])
def test_agg2_trainer_matches_jax_trainer(average):
    """f32 on both sides: the per-microbatch gradients add in the same
    order as the JAX scan, so the F32_TOL of the unaccumulated comparison
    (tests/test_torch_training.py) holds here too."""
    want_metrics, init_params, want_params, want_opt, want_batches, _ = _jax_agg_run(average)
    trainer = _port_agg_trainer(average)
    trainer._setup()
    assert trainer.agg == AGG
    load_flax_params(trainer.model, init_params)
    pairs = trainer.train_loader.iter_pairs(agg=AGG)
    for step in range(STEPS):
        _, batch = next(pairs)
        assert batch["tokens"].shape == (AGG, HP["global_batch_size"], HP["seq_len"] + 1)
        np.testing.assert_array_equal(batch["tokens"], want_batches[step]["tokens"])
        trainer._train_step(to_device(batch, trainer.device))
        got = trainer.state.fetch_metrics()
        trainer.state.reset_metrics()
        want = want_metrics[step]
        assert set(got) == set(want) == {"loss", "lr", "perplexity"}
        for k in ("loss", "perplexity"):
            np.testing.assert_allclose(got[k], want[k], err_msg=f"step {step} {k}",
                                       **F32_TOL["loss"])
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    cfg = trainer.model.cfg
    got_params = flax_from_state_dict(trainer.model.state_dict(), cfg.n_heads, cfg.kv_heads)
    _compare_trees({"params": got_params}, want_params, F32_TOL["params_rel"], "params",
                   atol=F32_TOL["params_atol"])
    got_opt = flax_from_opt_state(trainer.state.opt_state, cfg.n_heads, cfg.kv_heads)
    assert got_opt["count"] == int(np.asarray(want_opt.count)) == STEPS  # one update a step
    _compare_trees({"params": got_opt["mu"]}, want_opt.mu, F32_TOL["moments_rel"], "mu")
    _compare_trees({"params": got_opt["nu"]}, want_opt.nu, F32_TOL["moments_rel"], "nu")


def test_summed_gradients_are_agg_times_the_averaged_ones():
    """The same step with ``average_aggregated_gradients`` off hands the
    optimizer AGG times the gradients: the second moment (g^2, before any
    clip) scales by AGG^2."""
    nus = {}
    for average in (True, False):
        trainer = _port_agg_trainer(average, grad_clip=1e9)
        trainer._setup()
        _, batch = next(trainer.train_loader.iter_pairs(agg=AGG))
        trainer._train_step(to_device(batch, trainer.device))
        nus[average] = trainer.state.opt_state.nu
    for k, nu in nus[True].items():
        np.testing.assert_allclose(nus[False][k].numpy(), AGG ** 2 * nu.numpy(),
                                   rtol=1e-5, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("length", [
    {"epochs": 1}, {"epochs": 3}, {"records": 40}, {"records": 7}, {"batches": 5},
])
def test_lengths_in_optimizer_steps_match_jax(length):
    """Epoch and record lengths divide by agg (one data pass is one epoch
    whatever agg is); a batch length counts optimizer steps."""
    *_, jax_trainer = _jax_agg_run(True)
    trainer = _port_agg_trainer()
    trainer._setup()
    assert trainer._to_batches(length) == jax_trainer._to_batches(length)


def test_input_pipeline_stacks_microbatches_and_commits_after_the_last():
    spec = {"tokens": ((5,), np.int32, 50)}
    from determined_tpu.data import SyntheticDataset as JaxSyntheticDataset
    from determined_tpu_torch.data import SyntheticDataset

    port = DataLoader(SyntheticDataset(spec, 26, seed=1), 4, seed=9)
    ref = JaxDataLoader(JaxSyntheticDataset(spec, 26, seed=1), 4, seed=9,
                        shard_rank=0, num_shards=1)
    want = [b for _, b in zip(range(5), ref.iter_pairs(agg=3))]
    pipe = InputPipeline(port, torch.device("cpu"), agg=3, prefetch_depth=2, device_buffer=2)
    try:
        for i, (state, batch) in enumerate(want):
            got = next(pipe)
            assert tuple(got["tokens"].shape) == (3, 4, 5)
            np.testing.assert_array_equal(got["tokens"].numpy(), batch["tokens"])
            # the worker ran ahead; the loader holds the state after the
            # LAST microbatch taken (across the epoch boundary of 6 batches)
            assert (port.state_dict()["epoch"], port.state_dict()["batches_in_epoch"]) == (
                state.epoch, state.batches_in_epoch)
    finally:
        pipe.close()


def test_fit_under_agg_checkpoints_the_consumed_microbatches(tmp_path):
    """A run of 3 optimizer steps at agg 2 consumes 6 loader batches: the
    checkpoint's loader state says so, the reports count agg x batch
    samples a step, and a resume continues from there."""
    exp = ExperimentConfig.parse(_opt(aggregation_frequency=AGG))

    def trainer():
        ctx = train.init(hparams=dict(HP, dataset_size=64), exp_config=exp, seed=0,
                         device="cpu", core_context=core._dummy_init(checkpoint_dir=str(tmp_path)))
        return train.Trainer(LMTrial(ctx))

    first = trainer()
    summary = first.fit(max_length=3, report_period=3, checkpoint_policy="all")
    assert first.train_loader.state_dict()["batches_in_epoch"] == 3 * AGG
    sid = summary["latest_checkpoint"]
    with first.core.checkpoint.restore_path(sid) as path:
        state = train.serialization.load_trainer_state(path)
    assert state["train_loader"]["batches_in_epoch"] == 3 * AGG
    resumed = trainer()
    assert resumed.fit(max_length=4, latest_checkpoint=sid,
                       checkpoint_policy="none")["steps_completed"] == 4
    assert resumed.train_loader.state_dict()["batches_in_epoch"] == 4 * AGG
    assert resumed.state.opt_state.count.item() == 4


# ---------------------------------------------------------------------------
# fetch_workers
# ---------------------------------------------------------------------------


class _MapStyle:
    """A map-style dataset (no columnar gather): the loader's per-item path."""

    def __init__(self, inner):
        self.inner = inner
        self.threads = set()

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        self.threads.add(threading.current_thread().name)
        return {k: v[i] for k, v in self.inner.columns.items()}


def test_fetch_workers_read_the_same_batches_as_the_loop_and_as_jax():
    ds = _MapStyle(mnist_like(size=40, seed=3))
    jax_ds = jax_mnist_like(size=40, seed=3)
    pooled = DataLoader(ds, 8, seed=1, fetch_workers=3)
    plain = DataLoader(_MapStyle(mnist_like(size=40, seed=3)), 8, seed=1)
    ref = JaxDataLoader(jax_ds, 8, seed=1, shard_rank=0, num_shards=1, fetch_workers=3)
    try:
        for a, b, c in zip(pooled.iter_epoch(0), plain.iter_epoch(0), ref.iter_epoch(0)):
            for k in c:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k])
        assert ds.threads and all(t.startswith("dtpu-fetch") for t in ds.threads)
    finally:
        ref.close()
    pooled.close()
    assert pooled._pool is None
    next(iter(pooled))  # still usable: the pool is built again
    assert pooled._pool is not None
    pooled.close()


def test_in_memory_dataset_never_builds_the_pool():
    loader = DataLoader(mnist_like(size=32, seed=0), 8, fetch_workers=4)
    assert isinstance(loader.dataset, InMemoryDataset)
    for _ in zip(range(5), loader):
        pass
    list(loader.iter_epoch(0))
    assert loader._pool is None


class _OwnWorkersTrial(LMTrial):
    """Reads its training data item by item (a map-style dataset) and sets
    its validation loader's fetch_workers itself."""

    datasets = []

    def build_training_data_loader(self):
        loader = super().build_training_data_loader()
        loader.dataset = _MapStyle(loader.dataset)
        self.datasets.append(loader.dataset)
        return loader

    def build_validation_data_loader(self):
        loader = super().build_validation_data_loader()
        loader.fetch_workers = 1
        return loader


def test_trainer_passes_fetch_workers_to_loaders_that_set_none():
    exp = ExperimentConfig.parse(_opt(fetch_workers=3))
    ctx = train.init(hparams=dict(HP, dataset_size=16), exp_config=exp, seed=0, device="cpu")
    trainer = train.Trainer(_OwnWorkersTrial(ctx))
    trainer._setup()
    assert trainer.train_loader.fetch_workers == 3
    assert trainer.val_loader.fetch_workers == 1
    # the items were read on the pool's threads, and fit closed the pools
    trainer.fit(max_length=2, checkpoint_policy="none")
    assert _OwnWorkersTrial.datasets[-1].threads
    assert all(t.startswith("dtpu-fetch") for t in _OwnWorkersTrial.datasets[-1].threads)
    assert trainer.train_loader._pool is None and trainer.val_loader._pool is None


# ---------------------------------------------------------------------------
# compilation_cache_dir
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv("DTPU_COMPILATION_CACHE", raising=False)


@pytest.mark.parametrize("config_dir, env", [
    (None, None), ("/c/from-config", None), (None, "/c/from-env"),
    ("/c/from-config", "/c/from-env"), ("", "/c/from-env"),
])
def test_resolve_cache_dir_matches_jax(config_dir, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("DTPU_COMPILATION_CACHE", raising=False)
    else:
        monkeypatch.setenv("DTPU_COMPILATION_CACHE", env)
    assert cc.resolve_cache_dir(config_dir) == jax_cc.resolve_cache_dir(config_dir)


_JAX_SETUP = (
    "import logging, sys\n"
    "logging.basicConfig(level=logging.INFO, stream=sys.stdout, format='%(message)s')\n"
    "import jax; jax.config.update('jax_platforms', 'cpu')\n"
    "from determined_tpu.utils.compilation_cache import setup_compilation_cache\n"
    "setup_compilation_cache(sys.argv[1])\n"
)


def _jax_cache_line(path):
    """The JAX module's log line for ``path``, in a process of its own (it
    points jax's own cache there, which this process must not do)."""
    proc = subprocess.run([sys.executable, "-c", _JAX_SETUP, path], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [ln for ln in proc.stdout.splitlines() if "compilation cache" in ln]


def _port_cache_lines(caplog, path):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=cc.logger.name):
        cc.setup_compilation_cache(path)
    return [r.getMessage() for r in caplog.records if "compilation cache" in r.getMessage()]


def test_setup_logs_miss_then_hit_like_jax(tmp_path, caplog, fresh_cache, monkeypatch):
    cold, warm = tmp_path / "cold", tmp_path / "warm"
    warm.mkdir()
    (warm / "libflash_fwd-0123456789abcdef.so").write_bytes(b"\0")
    got_cold = _port_cache_lines(caplog, str(cold))
    assert got_cold == _jax_cache_line(str(cold)) and "MISS" in got_cold[0]
    assert _build.BUILD_DIR == str(cold) and cold.is_dir()
    assert _port_cache_lines(caplog, str(cold)) == []  # idempotent: no second line
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    got_warm = _port_cache_lines(caplog, str(warm))
    assert got_warm == _jax_cache_line(str(warm)) and "HIT" in got_warm[0]


def test_cache_dir_becomes_the_kernels_build_dir_and_builds_nothing(tmp_path, fresh_cache,
                                                                     monkeypatch):
    def no_nvcc():
        raise AssertionError("setup must not build")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    default = _build.library_path("fused_adamw.cu")
    exp = ExperimentConfig.parse(dict(_opt(compilation_cache_dir=str(tmp_path / "kc")),
                                      hyperparameters=HP))
    train.init(exp_config=exp, device="cpu")  # init sets it up, as the JAX init does
    lib = _build.library_path("fused_adamw.cu")
    assert os.path.dirname(lib) == str(tmp_path / "kc")
    assert os.path.basename(lib) == os.path.basename(default)  # the same source hash
    assert os.listdir(tmp_path / "kc") == []


def test_env_var_names_the_cache_when_the_config_does_not(tmp_path, fresh_cache,
                                                          monkeypatch):
    monkeypatch.setenv("DTPU_COMPILATION_CACHE", str(tmp_path / "env"))
    assert cc.setup_compilation_cache(None) == str(tmp_path / "env")
    assert _build.BUILD_DIR == str(tmp_path / "env")


# ---------------------------------------------------------------------------
# the knobs pass check_exp_config and run in a local experiment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [
    dict(aggregation_frequency=4), dict(aggregation_frequency=2,
                                        average_aggregated_gradients=False),
    dict(fetch_workers=2), dict(quantized_matmul="int8"),
], ids=["agg4", "agg2_summed", "fetch_workers", "int8"])
def test_knobs_no_longer_raise(knobs):
    exp = ExperimentConfig.parse(dict(_opt(**knobs), hyperparameters=HP))
    ctx = train.init(exp_config=exp, device="cpu")
    assert ctx.exp_config.optimizations == exp.optimizations


@pytest.mark.parametrize("knobs", [
    dict(aggregation_frequency=4, fetch_workers=2),
    dict(quantized_matmul="fp8"),
], ids=["agg4_fetch_workers", "fp8_emulated"])
def test_local_experiment_runs_the_knobs(knobs, tmp_path, monkeypatch, fresh_cache):
    monkeypatch.setenv("DTPU_QUANT_EMULATE", "1")
    raw = {
        "hyperparameters": dict(HP, dataset_size=64),
        "searcher": {"name": "single", "metric": "validation_loss",
                     "max_length": {"batches": 4}},
        "min_validation_period": {"batches": 4},
        "optimizations": dict(knobs, compilation_cache_dir=str(tmp_path / "kc")),
    }
    summary = LocalExperiment(ExperimentConfig.parse(raw), LMTrial,
                              checkpoint_dir=str(tmp_path / "exp"), device="cpu").run()
    assert summary["status"] == "completed" and summary["total_steps"] == 4
    assert _build.BUILD_DIR == str(tmp_path / "kc")
