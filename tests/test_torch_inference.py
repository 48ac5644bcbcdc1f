"""Train to serve on the port, on the CPU: ``ServeEngine.from_checkpoint``
and batch inference (``determined_tpu_torch/inference.py``) against the JAX
package's.

- A checkpoint the port's Trainer wrote serves, through
  ``from_checkpoint``, the greedy tokens of an engine built from the
  trainer's in-memory model and of the JAX engine over the same weights;
  it names its trial, refuses a model without ``.cfg`` and a corrupt file,
  and reads and verifies the params' file alone (not the moments).
- ``run_batch_inference`` hands the processor the JAX function's batches,
  and the three cases of tests/test_inference.py hold on the port: the
  whole shard, a resume from recorded progress, and the tail's progress.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from determined_tpu import core as jax_core
from determined_tpu import inference as jax_inference
from determined_tpu import serve as jax_serve
from determined_tpu.data import mnist_like as jax_mnist_like
from determined_tpu.models import transformer as jax_tf
from determined_tpu_torch import core, inference, train
from determined_tpu_torch.convert import flax_from_state_dict
from determined_tpu_torch.data import mnist_like
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.mnist import MnistTrial
from determined_tpu_torch.serve import DecodeKernels, ServeConfig, ServeEngine
from determined_tpu_torch.utils.errors import CheckpointCorruptError
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.faults import FaultInjector

HP = dict(
    lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=128, d_model=32, n_layers=2,
    n_heads=4, n_kv_heads=2, dataset_size=16, attention="reference", fused_ce=False,
    fused_adamw=True, warmup_steps=1, bf16=False,
)
SERVE_KW = dict(block_size=4, num_blocks=48, max_batch=2, max_prompt_len=16, max_new_tokens=6)
PROMPTS = [[3, 14, 15, 9, 2, 6], list(range(20, 33)), [7]]


def _trained(tmp_path, trial_cls=LMTrial, hp=HP):
    ctx = train.init(hparams=dict(hp), seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "ckpts")))
    trainer = train.Trainer(trial_cls(ctx))
    summary = trainer.fit(max_length=2, checkpoint_policy="best")
    return str(tmp_path / "ckpts" / summary["latest_checkpoint"]), trainer


def _drive(eng, prompts, max_steps=200):
    reqs = [eng.submit(p, max_new_tokens=SERVE_KW["max_new_tokens"]) for p in prompts]
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        assert eng.step_once(), "scheduler stalled"
    assert all(r.error is None for r in reqs)
    return [list(r.output) for r in reqs]


def test_from_checkpoint_serves_the_trained_tokens(tmp_path):
    path, trainer = _trained(tmp_path)
    scfg = ServeConfig(**SERVE_KW)
    eng = ServeEngine.from_checkpoint(path, scfg, device="cpu")
    assert eng.model_label == "LMTrial"
    got = _drive(eng, PROMPTS)
    assert all(len(t) == SERVE_KW["max_new_tokens"] for t in got)
    # the trainer's in-memory model, served by the port
    assert got == _drive(ServeEngine(DecodeKernels(trainer.model, scfg, device="cpu")), PROMPTS)
    # and by the JAX engine over the same weights
    cfg = trainer.model.cfg
    jcfg = jax_tf.TransformerConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, max_seq_len=cfg.max_seq_len,
        dtype=jnp.float32, attention_impl="reference",
    )
    params = flax_from_state_dict(trainer.model.state_dict(), cfg.n_heads, cfg.kv_heads)
    jeng = jax_serve.ServeEngine(jax_serve.DecodeKernels(
        jcfg, {"params": params}, jax_serve.ServeConfig(**SERVE_KW)))
    assert got == _drive(jeng, PROMPTS)


def test_from_checkpoint_serving_stays_unquantized(tmp_path):
    """A checkpoint trained at int8 serves the logits of its weights
    unquantized: the same tokens as the in-memory model's plain engine."""
    path, trainer = _trained(tmp_path, hp=dict(HP, quantized_matmul="int8"))
    scfg = ServeConfig(**SERVE_KW)
    eng = ServeEngine.from_checkpoint(path, scfg, device="cpu")
    assert eng.kernels.model_cfg.quantized_matmul == "int8"
    assert _drive(eng, PROMPTS) == _drive(
        ServeEngine(DecodeKernels(trainer.model, scfg, device="cpu")), PROMPTS)


def test_from_checkpoint_refuses_a_model_without_cfg(tmp_path):
    path, _ = _trained(tmp_path, MnistTrial, dict(lr=1e-2, hidden=16, global_batch_size=16,
                                                  dataset_size=64))
    with pytest.raises(ValueError, match="no .cfg"):
        ServeEngine.from_checkpoint(path, device="cpu")


def test_from_checkpoint_verifies_the_manifest(tmp_path):
    path, _ = _trained(tmp_path)
    FaultInjector.bit_flip(os.path.join(path, "state", "params.pt"))
    with pytest.raises(CheckpointCorruptError, match="md5"):
        ServeEngine.from_checkpoint(path, ServeConfig(**SERVE_KW), device="cpu")


def test_from_checkpoint_reads_and_verifies_the_params_alone(tmp_path, monkeypatch):
    """A server loads the params: the optimizer's moments (two thirds of a
    checkpoint's bytes) are neither hashed nor read, so a flipped bit there
    does not stop it serving the trained tokens, where a full load refuses
    the checkpoint."""
    from determined_tpu_torch.storage import base

    path, trainer = _trained(tmp_path)
    FaultInjector.bit_flip(os.path.join(path, "state", "opt_state.pt"))
    hashed = []
    md5 = base.file_md5
    monkeypatch.setattr(base, "file_md5", lambda p, *a: (hashed.append(p), md5(p, *a))[1])
    scfg = ServeConfig(**SERVE_KW)
    eng = ServeEngine.from_checkpoint(path, scfg, device="cpu")
    assert sorted(os.path.relpath(p, path) for p in hashed) == [
        os.path.join("state", "params.pt"), "trainer_state.json"]
    assert _drive(eng, PROMPTS) == _drive(
        ServeEngine(DecodeKernels(trainer.model, scfg, device="cpu")), PROMPTS)
    with pytest.raises(CheckpointCorruptError, match="opt_state.pt: md5"):
        train.load_trial_from_checkpoint(path, device="cpu")


# ---------------------------------------------------------------------------
# batch inference: the three cases of tests/test_inference.py, and the JAX
# function's batches
# ---------------------------------------------------------------------------


def _collector(seen):
    class Collector(inference.BatchProcessor):
        def process_batch(self, batch, batch_idx):
            seen.append((batch_idx, batch))

        def on_finish(self):
            seen.append("done")

    return Collector


def test_batch_inference_hands_over_the_jax_batches(tmp_path):
    seen, jax_seen = [], []
    n = inference.run_batch_inference(
        _collector(seen), mnist_like(size=64, seed=0), batch_size=16,
        core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "port")))

    class JaxCollector(jax_inference.BatchProcessor):
        def process_batch(self, batch, batch_idx):
            jax_seen.append((batch_idx, batch))

        def on_finish(self):
            jax_seen.append("done")

    jn = jax_inference.run_batch_inference(
        JaxCollector, jax_mnist_like(size=64, seed=0), batch_size=16,
        core_context=jax_core._dummy_init(checkpoint_dir=str(tmp_path / "jax")))
    assert n == jn == 4 and seen[-1] == jax_seen[-1] == "done"
    for (i, b), (j, c) in zip(seen[:-1], jax_seen[:-1]):
        assert i == j
        assert set(b) == set(c)
        for k in b:
            np.testing.assert_array_equal(b[k], c[k])


def test_batch_inference_processes_whole_shard(tmp_path):
    seen = []
    ctx = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    n = inference.run_batch_inference(_collector(seen), mnist_like(size=64, seed=0),
                                      batch_size=16, core_context=ctx)
    assert n == 4
    assert seen[-1] == "done"
    assert [s[0] for s in seen[:-1]] == [0, 1, 2, 3]
    assert all(s[1]["image"].shape[0] == 16 for s in seen[:-1])


def _latest_progress_checkpoint(ck_dir) -> str:
    best, best_done = None, -1
    for name in os.listdir(ck_dir):
        marker = os.path.join(ck_dir, name, inference.PROGRESS_FILE)
        if not os.path.exists(marker):
            continue
        with open(marker) as f:
            done = int(json.load(f)["batches_done"])
        if done > best_done:
            best, best_done = name, done
    assert best is not None, "no progress checkpoint written"
    return best


def _indices(processed):
    class Collector(inference.BatchProcessor):
        def process_batch(self, batch, batch_idx):
            processed.append(batch_idx)

    return Collector


def test_batch_inference_resumes_from_progress(tmp_path):
    """A preempted run leaves a marker; the next run resumes there."""
    processed = []
    ds = mnist_like(size=128, seed=0)
    ctx = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    ctx.preempt.simulate()  # stops at the first poll, right after a marker
    n = inference.run_batch_inference(_indices(processed), ds, batch_size=16,
                                      core_context=ctx, checkpoint_interval=5)
    assert n == 5 and processed == list(range(5))

    processed.clear()

    class Info:
        latest_checkpoint = _latest_progress_checkpoint(tmp_path / "ck")

    ctx2 = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    ctx2.info = Info()  # the JAX function's source of the resume point
    n2 = inference.run_batch_inference(_indices(processed), ds, batch_size=16,
                                       core_context=ctx2, checkpoint_interval=100)
    assert processed and processed[0] == 5
    assert n2 == 3 and processed == [5, 6, 7]


def test_batch_inference_records_tail_progress(tmp_path):
    """The shard end records a final marker even off a checkpoint_interval
    boundary, so a resume replays nothing."""
    processed = []
    ds = mnist_like(size=128, seed=0)  # 8 batches; interval 5 leaves a 3-batch tail
    ctx = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    n = inference.run_batch_inference(_indices(processed), ds, batch_size=16,
                                      core_context=ctx, checkpoint_interval=5)
    assert n == 8 and processed == list(range(8))

    processed.clear()

    class Info:
        latest_checkpoint = _latest_progress_checkpoint(tmp_path / "ck")

    ctx2 = core._dummy_init(checkpoint_dir=str(tmp_path / "ck"))
    ctx2.info = Info()
    n2 = inference.run_batch_inference(_indices(processed), ds, batch_size=16,
                                       core_context=ctx2, checkpoint_interval=100)
    assert n2 == 0 and processed == []  # nothing replayed
