"""The port's checkpoint layer (determined_tpu_torch: storage, core
checkpoint context, train serialization, retention) against the JAX
package's on the CPU.

- ``build_manifest`` over one directory gives equal manifests in both.
- The corruption cases of ``tests/test_checkpoint.py`` (truncated,
  bit-flipped, missing manifest, partial delete) give the same verdicts.
- ``store_path``/``restore_path``, the parent lineage and ``delete``
  round-trip, and a manifest written by either package verifies in the other.
- A port checkpoint's ``state/`` turns into the JAX param and Adam trees
  through ``convert.py``, a bf16 first moment byte for byte.
- The retention planner keeps and deletes the same checkpoints.
"""

import hashlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from determined_tpu.core import _checkpoint as jax_ckpt
from determined_tpu.core._distributed import DummyDistributedContext as JaxDist
from determined_tpu.exec import gc_checkpoints as jax_gc
from determined_tpu.storage import SharedFSStorageManager as JaxSharedFS
from determined_tpu.storage import file_md5 as jax_file_md5
from determined_tpu.storage import list_directory as jax_list_directory
from determined_tpu.utils.errors import CheckpointCorruptError as JaxCorrupt
from determined_tpu_torch import core, storage, train
from determined_tpu_torch.core import _checkpoint as port_ckpt
from determined_tpu_torch.exec import gc_checkpoints as port_gc
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.utils.errors import CheckpointCorruptError
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.faults import FaultInjector

HP = dict(lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=256, d_model=64, n_layers=2,
          n_heads=2, dataset_size=8, attention="flash", fused_ce=True, fused_adamw=True,
          warmup_steps=2, bf16=False)


def _write(path, content):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)


def _src_dir(tmp_path):
    src = tmp_path / "src"
    _write(str(src / "model.bin"), "weights" * 100)
    _write(str(src / "sub" / "opt.bin"), "moments" * 50)
    return str(src)


def _contexts(tmp_path):
    """A JAX and a port CheckpointContext, each over its own store."""
    jax_ctx = jax_ckpt.CheckpointContext(JaxDist(), JaxSharedFS(str(tmp_path / "jax")))
    port_ctx = port_ckpt.CheckpointContext(
        core.DummyDistributedContext(), storage.SharedFSStorageManager(str(tmp_path / "port"))
    )
    return {"jax": (jax_ctx, str(tmp_path / "jax")), "port": (port_ctx, str(tmp_path / "port"))}


def test_listing_digests_and_manifest_equal_jax(tmp_path):
    src = _src_dir(tmp_path)
    resources = storage.list_directory(src)
    assert resources == jax_list_directory(src)
    digests = {p: storage.file_md5(os.path.join(src, p)) for p in resources if not p.endswith("/")}
    assert digests == {p: jax_file_md5(os.path.join(src, p)) for p in digests}
    for parent in (None, "abc"):
        assert port_ckpt.build_manifest(resources, digests, parent) == jax_ckpt.build_manifest(
            resources, digests, parent
        )
    merged = [port_ckpt.merge_resources([resources, resources], [digests, digests]),
              jax_ckpt.merge_resources([resources, resources], [digests, digests])]
    assert merged[0] == merged[1]


def test_manifest_written_by_either_package_verifies_in_both(tmp_path):
    src = _src_dir(tmp_path)
    for name, (ctx, store) in _contexts(tmp_path).items():
        uuid = ctx.upload(src, metadata={"steps_completed": 3})
        path = os.path.join(store, uuid)
        manifest = json.load(open(os.path.join(path, port_ckpt.MANIFEST_FILE)))
        assert set(manifest["files"]) == {"model.bin", "sub/opt.bin", "metadata.json"}, name
        assert port_ckpt.verify_manifest(path) is True
        assert jax_ckpt.verify_manifest(path) is True


def _corrupt(case, store, uuid, ctx):
    victim = os.path.join(store, uuid, "model.bin")
    if case == "truncated":
        FaultInjector.truncate_file(victim)
    elif case == "bit_flipped":
        FaultInjector.bit_flip(victim)
    elif case == "missing_manifest":
        os.remove(os.path.join(store, uuid, port_ckpt.MANIFEST_FILE))
    elif case == "partial_delete":
        ctx.delete(uuid, globs=["sub/*"])


def _verdict(ctx, uuid, errors, **kwargs):
    try:
        with ctx.restore_path(uuid, **kwargs) as path:
            return ("ok", sorted(os.listdir(path)))
    except errors as e:
        msg = str(e)
        return ("corrupt", [w for w in ("size", "md5", "manifest") if w in msg][:1])


@pytest.mark.parametrize("case", ["truncated", "bit_flipped", "missing_manifest",
                                  "partial_delete"])
def test_corruption_verdicts_equal_jax(tmp_path, case):
    src = _src_dir(tmp_path)
    verdicts = {}
    for name, (ctx, store) in _contexts(tmp_path).items():
        uuid = ctx.upload(src, metadata={"steps_completed": 3})
        _corrupt(case, store, uuid, ctx)
        errors = JaxCorrupt if name == "jax" else CheckpointCorruptError
        verdicts[name] = [
            _verdict(ctx, uuid, errors),
            _verdict(ctx, uuid, errors, require_manifest=True),
            _verdict(ctx, uuid, errors, verify=False),
        ]
    assert verdicts["port"] == verdicts["jax"]
    lenient, strict, unverified = verdicts["port"]
    assert unverified[0] == "ok"
    if case in ("truncated", "bit_flipped"):
        assert lenient == strict == ("corrupt", ["size" if case == "truncated" else "md5"])
    else:
        # no manifest: restorable unless the resume path requires one
        assert lenient[0] == "ok" and strict == ("corrupt", ["manifest"])


def test_store_restore_lineage_and_delete_round_trip(tmp_path):
    ctx = core._dummy_init(checkpoint_dir=str(tmp_path / "store")).checkpoint
    with ctx.store_path({"steps_completed": 1}) as (path, first):
        _write(os.path.join(path, "a.txt"), "one")
    path, second, finish = ctx.store_path_async(
        {"steps_completed": 2, "parent_storage_id": first}
    )
    _write(os.path.join(path, "a.txt"), "two")
    assert ctx.get_manifest(second) == {}  # no manifest before finish
    finish()
    assert ctx.get_checkpoint_parent(second) == first
    assert ctx.get_metadata(second)["steps_completed"] == 2
    assert ctx.get_metadata(second)["format"] == "determined_tpu_torch"
    with ctx.restore_path(second, require_manifest=True) as p:
        assert open(os.path.join(p, "a.txt")).read() == "two"
    # the manifest's parent wins; the metadata copy covers a checkpoint
    # killed between its metadata and its manifest
    os.remove(os.path.join(str(tmp_path / "store"), second, port_ckpt.MANIFEST_FILE))
    assert ctx.get_checkpoint_parent(second) == first
    assert ctx.delete(first) == {}
    assert not os.path.exists(os.path.join(str(tmp_path / "store"), first))


def test_restore_reuses_a_manifest_verdict_only_for_unchanged_files(tmp_path, monkeypatch):
    """A verdict handed over by accept_verified spares restore_path its md5
    pass once, and only while every file keeps its size and mtime."""
    store = str(tmp_path / "store")
    ctx = core._dummy_init(checkpoint_dir=store).checkpoint
    with ctx.store_path({"steps_completed": 1}) as (path, sid):
        _write(os.path.join(path, "model.bin"), "weights" * 100)
    ckpt = os.path.join(store, sid)
    past = time.time_ns() - 10 ** 10  # written a while ago
    for name in os.listdir(ckpt):
        os.utime(os.path.join(ckpt, name), ns=(past, past))
    stats = core.file_stats(ckpt)
    assert port_ckpt.verify_manifest(ckpt, require_manifest=True)
    checked = []
    real = port_ckpt.verify_manifest
    monkeypatch.setattr(port_ckpt, "verify_manifest",
                        lambda p, **kw: checked.append(p) or real(p, **kw))

    ctx.accept_verified(sid, stats)
    with ctx.restore_path(sid, require_manifest=True):
        pass
    assert checked == []
    with ctx.restore_path(sid, require_manifest=True):  # the verdict was used up
        pass
    assert checked == [ckpt]

    ctx.accept_verified(sid, stats)
    FaultInjector.bit_flip(os.path.join(ckpt, "model.bin"))
    with pytest.raises(CheckpointCorruptError, match="md5"):
        with ctx.restore_path(sid, require_manifest=True):
            pass
    assert checked == [ckpt, ckpt]


@pytest.mark.parametrize("save", ["sync", "async"])
def test_a_save_takes_its_digests_from_the_write(tmp_path, monkeypatch, save):
    """The Trainer's array files are digested as they are written: the
    save's finalize reads none of them again, its manifest holds their
    true md5, and a restore still reads and checks every file."""
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.storage import base

    hashed = []
    md5 = base.file_md5
    monkeypatch.setattr(base, "file_md5", lambda p, *a: (hashed.append(p), md5(p, *a))[1])
    exp = ExperimentConfig.parse({"optimizations": {"async_checkpointing": save == "async"}})
    ctx = train.init(hparams=dict(HP, attention="reference"), seed=0, device="cpu",
                     exp_config=exp,
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path / "ck")))
    sid = train.Trainer(LMTrial(ctx)).fit(max_length=2, checkpoint_period=2,
                                          checkpoint_policy="all")["latest_checkpoint"]
    ckpt = str(tmp_path / "ck" / sid)
    assert not [p for p in hashed if p.endswith(".pt")]
    with open(os.path.join(ckpt, port_ckpt.MANIFEST_FILE)) as f:
        files = json.load(f)["files"]
    pts = [rel for rel in files if rel.endswith(".pt")]
    assert pts and all(files[rel]["md5"] == md5(os.path.join(ckpt, rel)) for rel in pts)
    hashed.clear()
    assert port_ckpt.verify_manifest(ckpt, require_manifest=True)
    assert sorted(os.path.relpath(p, ckpt) for p in hashed if p.endswith(".pt")) == sorted(pts)
    FaultInjector.bit_flip(os.path.join(ckpt, pts[0]))
    with pytest.raises(CheckpointCorruptError, match="md5"):
        port_ckpt.verify_manifest(ckpt, require_manifest=True)


def test_a_digesting_writer_bounds_what_waits_for_the_hash(tmp_path, monkeypatch):
    """One write larger than what may wait for the hash (a whole tensor, as
    torch.save writes a storage) behind a slow hasher: the writer waits
    for it, holding at most ``_DIGEST_QUEUED`` pieces of at most
    ``_DIGEST_CHUNK`` bytes; the digest is the file's, and a finalize
    forgets the files it did not take."""
    from determined_tpu_torch.storage import base

    monkeypatch.setattr(base, "_DIGEST_CHUNK", 1 << 16)
    data = np.random.default_rng(0).bytes(10 * (1 << 16) + 123)
    queued, pieces = [], []
    w = base.DigestingWriter(str(tmp_path / "big.pt"))
    put, update = w._queue.put, w._md5.update

    def slow_update(b):
        time.sleep(0.01)
        update(b)

    def counted_put(item):
        if item is not None:
            pieces.append(len(item))
        put(item)
        queued.append(w._queue.qsize())

    w._md5 = types.SimpleNamespace(update=slow_update, hexdigest=w._md5.hexdigest)
    w._queue.put = counted_put
    assert w.write(data) == len(data)
    w.close()
    assert max(pieces) == 1 << 16 and len(pieces) == 11
    assert max(queued) <= base._DIGEST_QUEUED == w._queue.maxsize
    assert base.md5_files(str(tmp_path), ["big.pt"], written=True) == {
        "big.pt": hashlib.md5(data).hexdigest()}
    # a file this process wrote but another finalizes is forgotten
    other = base.DigestingWriter(str(tmp_path / "other.pt"))
    other.write(b"x")
    other.close()
    base.md5_files(str(tmp_path), [], written=True)
    assert os.path.realpath(str(tmp_path / "other.pt")) not in base._WRITTEN


def test_cloud_storage_raises_naming_the_later_slice():
    for url in ("s3://bucket/x", "gs://bucket", "azure://c/p"):
        with pytest.raises(NotImplementedError, match="later slice"):
            storage.from_string(url)
    assert isinstance(storage.from_string("/tmp/x"), storage.SharedFSStorageManager)
    assert isinstance(storage.from_string("directory:///tmp/x"), storage.DirectoryStorageManager)


def test_port_checkpoint_turns_into_the_jax_trees(tmp_path):
    """state/params.pt and state/opt_state.pt hold the port's names, which
    convert.py maps onto the JAX param and Adam trees; a bf16 first moment
    is stored in bf16, byte for byte."""
    from determined_tpu_torch.convert import flax_from_opt_state, flax_from_state_dict
    from determined_tpu_torch.ops.fused_adamw import FusedAdamWState

    ctx = train.init(hparams=dict(HP, adam_mu_bf16=True), seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(tmp_path)))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=2, checkpoint_policy="all", validation_period=2)
    path = os.path.join(str(tmp_path), summary["latest_checkpoint"])
    params = train.serialization.load_arrays(path, "params")
    opt = train.serialization.load_arrays(path, "opt_state")
    assert set(params) == set(dict(trainer.model.named_parameters()))
    assert set(opt) == {"count"} | {f"{m}/{k}" for m in ("mu", "nu") for k in params}
    live = trainer.state.opt_state
    for k in params:
        assert opt[f"mu/{k}"].dtype == torch.bfloat16
        assert torch.equal(opt[f"mu/{k}"].view(torch.int16), live.mu[k].view(torch.int16))
        assert torch.equal(params[k], dict(trainer.model.named_parameters())[k].detach())
    cfg = trainer.model.cfg
    tree = flax_from_state_dict(params, cfg.n_heads, cfg.kv_heads)
    assert tree["block_0"]["attn"]["wq"]["kernel"].shape == (64, 2, 32)
    state = FusedAdamWState(
        opt["count"],
        {k[3:]: v for k, v in opt.items() if k.startswith("mu/")},
        {k[3:]: v for k, v in opt.items() if k.startswith("nu/")},
    )
    jax_opt = flax_from_opt_state(state, cfg.n_heads, cfg.kv_heads)
    assert jax_opt["count"] == 2
    np.testing.assert_array_equal(
        jax_opt["nu"]["lm_head"]["kernel"], live.nu["lm_head.weight"].numpy().T
    )
    tstate = train.serialization.load_trainer_state(path)
    assert tstate["trial_class"] == "determined_tpu_torch.models.transformer:LMTrial"
    assert tstate["mesh_axes"] == {"data": 1}
    assert json.load(open(os.path.join(path, "metadata.json")))["framework"] == \
        "determined_tpu_torch"


def _fake_checkpoints(root):
    """trial_<rid>/<uuid>/ with metadata, manifest and parent pointers."""
    layout = {1: [("a1", 4, None), ("a2", 8, "a1"), ("a3", 12, "a2")],
              2: [("b1", 4, None), ("b2", 8, "b1")],
              3: [("c1", 4, None), ("c2", 8, None)]}
    for rid, ckpts in layout.items():
        for uuid, steps, parent in ckpts:
            d = os.path.join(root, f"trial_{rid}", uuid)
            _write(os.path.join(d, "metadata.json"),
                   json.dumps({"steps_completed": steps, "parent_storage_id": parent}))
            if uuid != "c2":  # c2: no manifest (possibly mid-write)
                _write(os.path.join(d, "manifest.json"), json.dumps({"parent": parent}))


def test_retention_keeps_and_deletes_what_jax_does(tmp_path):
    kwargs = dict(metric_by_trial={1: 0.5, 2: 0.3, 3: 0.9}, protected={"b1"})
    outcomes = {}
    for name, gc in (("jax", jax_gc), ("port", port_gc)):
        root = str(tmp_path / name)
        _fake_checkpoints(root)
        policy = gc.RetentionPolicy(keep_trial_latest=1, keep_experiment_best=1)
        outcomes[name] = gc.apply_retention(root, policy=policy, **kwargs)
        outcomes[name]["deleted"] = sorted(outcomes[name]["deleted"])
    assert outcomes["port"] == outcomes["jax"]
    # the kept a3's parent a2 is its fallback; c2 may still be in flight
    assert {"a3", "a2", "b2", "b1", "c2"} <= set(outcomes["port"]["kept"])
    assert "a1" in outcomes["port"]["deleted"]
