"""Sharded checkpoints of the port (``core/_checkpoint.py``'s ``shard=True``,
``train/serialization.py``'s layout, the Trainer's save and restore)
against the JAX package.

- ``CheckpointContext`` ``upload`` / ``store_path`` / ``store_path_async``
  with ``shard=True`` on thread ranks (each a real control-plane context)
  give the merged file set, manifest and metadata that the JAX context gives
  on the same rank files (the ``format`` key names each package); the
  manifest verifies, and a corrupted rank file fails it.
- The Trainer on gloo ranks (tests/torch_rank_worker.py's ``sharded``
  case, under its hard timeout) saves sharded at fsdp 2 (MNIST, uneven FSDP
  chunks), fsdp 2 x tensor 2 (the LM, bf16 first moments) and data 2 x
  expert 2 (the MoE LM): no rank file holds a whole FSDP-split leaf, every
  value of every leaf is stored once, the restore on the same mesh is
  bitwise and has no ``trial.resize`` span, the restore on another mesh
  and ``load_trial_from_checkpoint`` on one device equal the gathered state
  bitwise (the other mesh inside a ``trial.resize`` span), the dense LM
  serves from its checkpoint (``ServeEngine.from_checkpoint``), and the MoE LM
  resumed at fsdp 2 x expert 2 tracks the JAX Trainer within
  ``TRAIN_PARITY_TOL``.
- A whole-state checkpoint of one device restores on fsdp 2 bitwise, each
  rank cutting its box from the whole leaves (a ``trial.resize`` span).
- A writer that dies between the rank writes and the chief's manifest
  leaves a checkpoint without one, which the lineage fallback skips.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_PARITY_TOL
from determined_tpu.core import CheckpointContext as JaxCheckpointContext
from determined_tpu.core import verify_manifest as jax_verify_manifest
from determined_tpu.storage import SharedFSStorageManager as JaxSharedFS
from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import state_dict_from_flax
from determined_tpu_torch.core import DistributedContext, verify_manifest
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.models import LMTrial, MnistTrial
from determined_tpu_torch.serve import ServeEngine
from determined_tpu_torch.storage.shared_fs import SharedFSStorageManager
from determined_tpu_torch.train import serialization
from determined_tpu_torch.utils import faults
from determined_tpu_torch.utils.errors import CheckpointCorruptError
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.parallel_utils import Execution
from tests.test_torch_distributed import _run
from tests.test_torch_parallel_training import MOE_HP, _jax_moe_mesh_run, _rel
from tests.torch_rank_worker import launch


def _write(path, content):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)


def _sharded_call(ctx, call, rank, tmp):
    """Rank ``rank``'s part of one sharded checkpoint through ``call``:
    its own file, a file every rank writes the same, its metadata key."""
    md = {f"rank{rank}": rank, "steps_completed": 3}
    files = {f"shard-{rank}.bin": f"data{rank}" * (rank + 5), "common/layout.txt": "same"}
    if call == "upload":
        src = os.path.join(tmp, f"src{rank}")
        for rel, text in files.items():
            _write(os.path.join(src, rel), text)
        return ctx.upload(src, metadata=md, shard=True)
    if call == "store_path":
        with ctx.store_path(md, shard=True) as (path, sid):
            for rel, text in files.items():
                _write(os.path.join(path, rel), text)
        return sid
    path, sid, finish = ctx.store_path_async(md, shard=True)
    for rel, text in files.items():
        _write(os.path.join(path, rel), text)
    finish()
    return sid


@pytest.mark.parametrize("call", ["upload", "store_path", "store_path_async"])
def test_sharded_context_merges_every_ranks_files_as_jax_does(tmp_path, call):
    port_store, jax_store = str(tmp_path / "port"), str(tmp_path / "jax")
    port = _run(DistributedContext, 3, lambda d, r: _sharded_call(
        CheckpointContext(d, SharedFSStorageManager(port_store)), call, r, str(tmp_path / "p")))
    jax = Execution(3).run(lambda d, r: _sharded_call(
        JaxCheckpointContext(d, JaxSharedFS(jax_store)), call, r, str(tmp_path / "j")))
    assert len(set(port)) == 1 and len(set(jax)) == 1
    port_dir, jax_dir = os.path.join(port_store, port[0]), os.path.join(jax_store, jax[0])
    # the same files; metadata.json (and so manifest.json) differs in its
    # "format" value alone
    port_files = SharedFSStorageManager(port_store).list_files(port[0])
    jax_files = JaxSharedFS(jax_store).list_files(jax[0])
    assert set(port_files) == set(jax_files)
    meta = {"metadata.json", "manifest.json"}
    assert {k: v for k, v in port_files.items() if k not in meta} == \
        {k: v for k, v in jax_files.items() if k not in meta}

    def manifest(d):
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        return {k: v for k, v in m["files"].items() if k != "metadata.json"}

    assert manifest(port_dir) == manifest(jax_dir)

    def metadata(d):
        with open(os.path.join(d, "metadata.json")) as f:
            return json.load(f)

    assert metadata(port_dir).pop("format") == "determined_tpu_torch"
    assert metadata(jax_dir).pop("format") == "determined_tpu"
    assert {k: v for k, v in metadata(port_dir).items() if k != "format"} == \
        {k: v for k, v in metadata(jax_dir).items() if k != "format"}
    assert verify_manifest(port_dir, require_manifest=True) is True
    assert jax_verify_manifest(jax_dir, require_manifest=True) is True
    _write(os.path.join(port_dir, "shard-1.bin"), "data1" * 5 + "x")
    with pytest.raises(CheckpointCorruptError, match="shard-1.bin"):
        verify_manifest(port_dir, require_manifest=True)


def test_a_writer_killed_before_the_manifest_leaves_a_checkpoint_the_fallback_skips(tmp_path):
    """Both ranks write their files; the chief dies at its manifest upload
    (the worker's barrier then times out): the checkpoint has its files and
    metadata but no manifest, and resume walks back to its parent."""
    from determined_tpu_torch.experiment import LocalExperiment

    store = str(tmp_path / "exp" / "trial_1")
    first = _run(DistributedContext, 2, lambda d, r: _sharded_call(
        CheckpointContext(d, SharedFSStorageManager(store)), "store_path", r, str(tmp_path)))[0]

    class DieAtManifest:
        def fire(self, site, **info):
            if site == "storage.upload" and info.get("paths") == ["manifest.json"]:
                raise RuntimeError("killed before the manifest")

    def second(d, r):
        ctx = CheckpointContext(d, SharedFSStorageManager(store))
        path, sid, finish = ctx.store_path_async(
            {"steps_completed": 6, "parent_storage_id": first}, shard=True)
        _write(os.path.join(path, f"shard-{r}.bin"), f"step6-{r}")
        try:
            finish()
        except Exception as e:  # noqa: BLE001 - each rank's failure is the point
            return sid, repr(e)
        return sid, None

    faults.set_fault_injector(DieAtManifest())
    try:
        out = _run(DistributedContext, 2, second, timeout=3.0)
    finally:
        faults.set_fault_injector(None)
    (sid, err0), (_, err1) = out
    assert "killed before the manifest" in err0 and err1 is not None
    torn = os.path.join(store, sid)
    assert sorted(os.listdir(torn)) == ["metadata.json", "shard-0.bin", "shard-1.bin"]
    with pytest.raises(CheckpointCorruptError, match="no manifest.json"):
        verify_manifest(torn, require_manifest=True)
    cfg = ExperimentConfig.parse({"hyperparameters": {"global_batch_size": 32}})
    exp = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path / "exp"), device="cpu")
    assert exp._verified_resume_checkpoint(1, sid) == first


LM_HP = dict(
    lr=1e-3, global_batch_size=4, seq_len=32, vocab_size=128, d_model=64, n_layers=2,
    n_heads=4, n_kv_heads=2, dataset_size=32, bf16=False, warmup_steps=1, fused_adamw=True,
    grad_clip=0.05, fused_ce=True, ce_chunk=48, adam_mu_bf16=True,
)
# name: (world, trial, hparams, writer mesh, other mesh, steps written, steps resumed to)
CASES = {
    "fsdp2": (2, "mnist", {"lr": 1e-2, "hidden": 33, "global_batch_size": 32,
                           "dataset_size": 256}, dict(fsdp=2), dict(data=2), 4, 4),
    "fsdp2-tensor2": (4, "lm", LM_HP, dict(fsdp=2, tensor=2), dict(data=2, fsdp=2), 4, 4),
    "data2-expert2": (4, "lm", MOE_HP, dict(data=2, expert=2), dict(fsdp=2, expert=2), 4, 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_a_sharded_checkpoint_restores_on_any_mesh_and_one_device(tmp_path, name):
    world, trial, hp, mesh, other, steps, resumed_to = CASES[name]
    init_state = None
    if name == "data2-expert2":
        want, init_params, want_params = _jax_moe_mesh_run()
        init_state = state_dict_from_flax(init_params)
    ck = str(tmp_path / "ck")
    outs = launch("sharded", world, str(tmp_path / "run"), dict(
        trial=trial, hparams=dict(hp), mesh=mesh, seed=0, ckpt_dir=ck, init_state=init_state,
        fit=dict(max_length=steps, checkpoint_period=2, report_period=1,
                 checkpoint_policy="none"),
        restore=[(mesh, steps), (other, resumed_to)],
    ))
    written, same, moved = outs[0]["runs"]
    sid = written["summary"]["latest_checkpoint"]
    assert sid and all(o["runs"][0]["summary"]["latest_checkpoint"] == sid for o in outs)
    path = os.path.join(ck, sid)
    assert verify_manifest(path, require_manifest=True)

    # the layout: every value of every leaf stored once, no rank file with
    # a whole leaf that the mesh splits
    layout = serialization.load_layout(path)
    files = {r: torch.load(serialization.shard_path(path, r), weights_only=True)
             for r in range(world) if os.path.exists(serialization.shard_path(path, r))}
    assert 0 in files
    split = 0
    for key, entry in layout["leaves"].items():
        whole = int(np.prod(entry["shape"], dtype=np.int64))
        stored = [files[p["rank"]][key] for p in entry["pieces"]]
        assert sum(t.numel() for t in stored) == whole, key
        if len(entry["pieces"]) > 1:
            split += 1
            assert all(t.numel() < whole for t in stored), key
        assert all(str(t.dtype) == f"torch.{entry['dtype']}" for t in stored), key
    assert split, "no leaf is split"
    if name == "fsdp2":  # MNIST's 33-wide bias: FSDP's uneven chunks, 17 and 16
        assert [p["box"] for p in layout["leaves"]["params/fc1.bias"]["pieces"]] == \
            [[[0, 17]], [[17, 33]]]
    if name == "fsdp2-tensor2":
        assert written["state"]["opt_state/mu/blocks.0.attn.wq.weight"][0] == "bfloat16"

    ref = written["state"]
    for run, resized in ((same, False), (moved, True)):
        assert ("trial.resize" in run["spans"]) == resized
        assert "checkpoint.load" in run["spans"]
    for key, (dtype, value) in same["state"].items():
        assert dtype == ref[key][0], key
        np.testing.assert_array_equal(value, ref[key][1], err_msg=key)
    if resumed_to == steps:
        for key, (dtype, value) in moved["state"].items():
            assert dtype == ref[key][0], key
            np.testing.assert_array_equal(value, ref[key][1], err_msg=key)
    else:
        # resumed on another mesh to the JAX run's end: its losses and
        # updates track the JAX Trainer's
        tol = TRAIN_PARITY_TOL["loss"]
        rows = moved["training"]
        assert [s for s, _ in rows] == list(range(steps + 1, resumed_to + 1))
        for (s, g), w in zip(rows, want[steps:]):
            for k in ("loss", "moe_aux_loss", "lr"):
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {s} {k}", **tol)
        import jax

        from determined_tpu_torch.convert import flax_from_state_dict

        got = flax_from_state_dict({k[len("params/"):]: v for k, (_, v) in
                                    moved["state"].items() if k.startswith("params/")}, 4, 4)
        init = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(init_params)}
        got_leaves = {jax.tree_util.keystr(p): v
                      for p, v in jax.tree_util.tree_leaves_with_path({"params": got})}
        for p, leaf in jax.tree_util.tree_leaves_with_path(want_params):
            k = jax.tree_util.keystr(p)
            assert _rel(got_leaves[k] - init[k], np.asarray(leaf) - init[k]) <= \
                TRAIN_PARITY_TOL["update_rel"], k

    # one device: the gathered state, bitwise
    cls = MnistTrial if trial == "mnist" else LMTrial
    _, single = train.load_trial_from_checkpoint(path, trial_class=cls, device="cpu")
    assert single.mesh is None
    flat = serialization.flatten(single._array_state())
    for key, (dtype, value) in ref.items():
        leaf = flat[key]
        got = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf.detach()
        assert str(got.dtype) == f"torch.{dtype}", key
        np.testing.assert_array_equal(got.float().numpy(), value, err_msg=key)
    if name == "fsdp2-tensor2":  # KV-cache serving takes no MoE
        engine = ServeEngine.from_checkpoint(path, trial_class=LMTrial, device="cpu")
        for k, p in engine.kernels.model.named_parameters():
            np.testing.assert_array_equal(p.detach().float().numpy(), ref[f"params/{k}"][1],
                                          err_msg=k)


def test_a_one_device_checkpoint_restores_on_a_mesh(tmp_path):
    hp = {"lr": 1e-2, "hidden": 33, "global_batch_size": 32, "dataset_size": 256}
    ck = str(tmp_path / "ck")
    ctx = train.init(hparams=dict(hp), seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=ck))
    trainer = train.Trainer(MnistTrial(ctx))
    sid = trainer.fit(max_length=4, checkpoint_period=4, checkpoint_policy="none",
                      report_period=4)["latest_checkpoint"]
    assert serialization.load_layout(os.path.join(ck, sid)) is None  # the whole format
    flat = serialization.flatten(trainer._array_state())
    outs = launch("sharded", 2, str(tmp_path / "run"), dict(
        trial="mnist", hparams=dict(hp), mesh=dict(fsdp=2), seed=0, ckpt_dir=ck, sid=sid,
        restore=[(dict(fsdp=2), 4)],
    ))
    (run,) = outs[0]["runs"]
    assert "trial.resize" in run["spans"]
    for key, (dtype, value) in run["state"].items():
        leaf = flat[key]
        want = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf.detach()
        assert str(want.dtype) == f"torch.{dtype}", key
        np.testing.assert_array_equal(value, want.float().numpy(), err_msg=key)
