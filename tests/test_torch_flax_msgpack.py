"""The port's reader of Flax ``save_pretrained`` weights
(``determined_tpu_torch/models/_flax_msgpack.py``) against
``flax.serialization``, with no ``msgpack`` package in the port.

- Trees of every dtype and rank ``msgpack_serialize`` writes read back
  equal to ``msgpack_restore``'s, nested dicts of numpy arrays; bfloat16 is
  widened to float32 exactly.
- Leaves over the chunk size in flax's ``__msgpack_chunked_array__`` form
  (the chunk size lowered for the test) are joined back.
- A ``save_pretrained`` directory reads as ``msgpack_restore`` reads its
  file; a sharded one (``save_pretrained(max_shard_size=...)``, at least
  three shards and ``flax_model.msgpack.index.json``) of a tiny GPT-2 and a
  tiny BERT reads as the Flax class's ``from_pretrained`` reads it, leaf
  for leaf; a missing shard, a leaf in two shards and a leaf the index does
  not give its shard each raise a named ``FlaxMsgpackError``; a directory
  without the file raises ``FileNotFoundError``.
- What the reader does not read (ext 2 and 3, an unknown dtype, a
  non-string key, a truncated file, bytes after the tree) raises
  ``FlaxMsgpackError``: nothing is guessed.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import transformers
from flax import serialization

from determined_tpu_torch.models import _flax_msgpack as fm
from tests import torch_threads  # noqa: F401  (one intra-op thread)


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            w = np.asarray(w)
            assert isinstance(got[k], np.ndarray) and got[k].dtype == w.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "kernel": rng.standard_normal((7, 5)).astype(np.float32),
            "bias": np.zeros((5,), np.float32),
            "layer": {"0": {"scale": rng.standard_normal((3,)).astype(np.float32)}},
        },
        "f16": rng.standard_normal((2, 3, 4)).astype(np.float16),
        "f64": rng.standard_normal((4,)),
        "ints": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "i64": np.array([2 ** 40, -5], np.int64),
        "u8": np.arange(256, dtype=np.uint8),
        "bools": np.array([True, False, True]),
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_trees_read_as_msgpack_restore_reads_them():
    data = serialization.msgpack_serialize(_tree())
    got = fm.read_msgpack(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))
    _assert_trees_equal(got, _tree())
    # each leaf owns its memory
    assert all(a.flags.owndata and a.flags.writeable for a in (got["f64"], got["ints"]))


def test_bfloat16_is_widened_to_float32_exactly():
    x = np.asarray(jnp.array([1.5, -2.25, 3.0e38, 1e-40, 0.0], jnp.bfloat16))
    got = fm.read_msgpack(serialization.msgpack_serialize({"w": x}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.astype(np.float32))


def test_chunked_leaves_are_joined_back(monkeypatch):
    """A leaf over flax's chunk size is written as
    ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``;
    the chunk size is lowered so a small leaf takes that form."""
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((37, 29)).astype(np.float32),
            "nested": {"big16": rng.standard_normal((1001,)).astype(np.float16)},
            "small": np.ones((3,), np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    data = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, ext_hook=lambda code, d: code)
    assert raw["big"]["__msgpack_chunked_array__"] is True and len(raw["big"]["chunks"]) == 5
    assert len(raw["nested"]["big16"]["chunks"]) == 3 and raw["small"] == 1
    _assert_trees_equal(fm.read_msgpack(data), tree)


def test_save_pretrained_directory_reads_as_flax_reads_it(tmp_path):
    cfg = transformers.GPT2Config(vocab_size=50, n_positions=16, n_embd=8, n_layer=1, n_head=2)
    model = transformers.FlaxGPT2LMHeadModel(cfg, seed=0)
    model.save_pretrained(str(tmp_path))
    with open(tmp_path / fm.WEIGHTS_NAME, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = fm.read_pretrained_dir(str(tmp_path))
    _assert_trees_equal(got, want)
    assert "transformer" in got and "lm_head" not in got  # the tied head has no leaf


def _tiny_flax_model(kind):
    if kind == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=64, n_positions=16, n_embd=16, n_layer=2,
                                      n_head=2)
        return transformers.FlaxGPT2LMHeadModel, transformers.FlaxGPT2LMHeadModel(cfg, seed=0)
    cfg = transformers.BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=32,
                                  max_position_embeddings=16, num_labels=3)
    cls = transformers.FlaxBertForSequenceClassification
    return cls, cls(cfg, seed=0)


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_sharded_save_pretrained_reads_as_flax_reads_it(tmp_path, kind):
    cls, model = _tiny_flax_model(kind)
    total = sum(int(np.asarray(x).nbytes) for x in jax.tree_util.tree_leaves(model.params))
    model.save_pretrained(str(tmp_path), max_shard_size=total // 4)
    index = json.loads((tmp_path / fm.INDEX_NAME).read_text())
    assert len(set(index["weight_map"].values())) >= 3
    assert not (tmp_path / fm.WEIGHTS_NAME).exists()
    want = cls.from_pretrained(str(tmp_path), local_files_only=True).params
    _assert_trees_equal(fm.read_pretrained_dir(str(tmp_path)), jax.device_get(want))


def _sharded_dir(path):
    """A hand-written two-shard directory: leaves a and b/c."""
    names = ["flax_model-00001-of-00002.msgpack", "flax_model-00002-of-00002.msgpack"]
    (path / names[0]).write_bytes(serialization.msgpack_serialize({"a": np.ones(2, np.float32)}))
    (path / names[1]).write_bytes(
        serialization.msgpack_serialize({"b": {"c": np.zeros(3, np.float32)}}))
    index = {"metadata": {"total_size": 20}, "weight_map": {"a": names[0], "b/c": names[1]}}
    (path / fm.INDEX_NAME).write_text(json.dumps(index))
    return names, index


@pytest.mark.parametrize("fault", ["missing_shard", "leaf_in_two_shards", "unindexed_leaf"])
def test_malformed_sharded_directories_raise_named_errors(tmp_path, fault):
    names, index = _sharded_dir(tmp_path)
    _assert_trees_equal(fm.read_pretrained_dir(str(tmp_path)),
                        {"a": np.ones(2, np.float32), "b": {"c": np.zeros(3, np.float32)}})
    if fault == "missing_shard":
        (tmp_path / names[1]).unlink()
        err, match = fm.MissingShardError, "missing"
    elif fault == "leaf_in_two_shards":
        (tmp_path / names[1]).write_bytes(serialization.msgpack_serialize(
            {"a": np.ones(2, np.float32), "b": {"c": np.zeros(3, np.float32)}}))
        err, match = fm.DuplicateLeafError, "in both"
    else:
        (tmp_path / names[0]).write_bytes(serialization.msgpack_serialize(
            {"a": np.ones(2, np.float32), "d": np.ones(1, np.float32)}))
        err, match = fm.UnindexedLeafError, "does not name"
    assert issubclass(err, fm.FlaxMsgpackError)
    with pytest.raises(err, match=match):
        fm.read_pretrained_dir(str(tmp_path))


def test_directory_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match=fm.WEIGHTS_NAME):
        fm.read_pretrained_dir(str(tmp_path))


@pytest.mark.parametrize("case", ["npscalar", "complex", "other_ext", "dtype", "int_key",
                                  "truncated", "trailing", "not_a_map"])
def test_what_is_not_read_raises(case):
    if case == "npscalar":  # flax packs a numpy scalar as ext 3
        data = serialization.msgpack_serialize({"s": np.float32(2.0)})
    elif case == "complex":  # and a Python complex as ext 2
        data = serialization.msgpack_serialize({"c": 1 + 2j})
    elif case == "other_ext":
        data = msgpack.packb({"e": msgpack.ExtType(7, b"xyz")})
    elif case == "dtype":
        payload = msgpack.packb(((2,), "float8_e4m3fn", b"\x00\x01"), use_bin_type=True)
        data = msgpack.packb({"w": msgpack.ExtType(1, payload)})
    elif case == "int_key":
        data = msgpack.packb({1: np.float32(1).tobytes()}, use_bin_type=True)
    elif case == "truncated":
        data = serialization.msgpack_serialize({"w": np.ones((4, 4), np.float32)})[:-7]
    elif case == "trailing":
        data = serialization.msgpack_serialize({"w": np.ones(2, np.float32)}) + b"\xc0"
    else:
        data = msgpack.packb([1, 2])
    with pytest.raises(fm.FlaxMsgpackError):
        fm.read_msgpack(data)
