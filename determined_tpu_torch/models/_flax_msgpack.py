"""A reader of the ``flax_model.msgpack`` that a Flax ``save_pretrained``
writes, in the port's own code: no ``msgpack``, ``flax`` or ``transformers``.

The file is ``flax.serialization.msgpack_serialize`` of the model's param
tree (``FlaxXxx.from_pretrained(dir, local_files_only=True)`` reads it).
Of msgpack it holds maps with string keys, strings, binaries, ints, floats,
booleans, nil and arrays, and one extension:

- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
- a leaf over 2**30 bytes as flax's chunked form, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": n0, ...},
  "chunks": {"0": flat chunk, ...}}``, joined back here.

``read_msgpack`` returns the nested dict with numpy leaves (each owning its
memory).  ``bfloat16``, which numpy lacks, is widened to float32, exactly.
Any other type (ext 2 or 3, a dtype numpy does not name, a non-string key)
raises ``FlaxMsgpackError``.  Nothing is guessed.

A sharded directory (``save_pretrained(..., max_shard_size=...)``) holds
``flax_model.msgpack.index.json``, whose ``weight_map`` names the shard
file of every leaf ("/"-joined path), and the shards, each a param tree of
its own leaves.  ``read_pretrained_dir`` reads every shard the index names
and joins them into one tree, as ``load_flax_sharded_weights`` does; a
shard that is missing (``MissingShardError``), a leaf held by two shards
(``DuplicateLeafError``), or a leaf that its shard holds and the index does
not give it, or gives it and the shard lacks (``UnindexedLeafError``),
raises.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

WEIGHTS_NAME = "flax_model.msgpack"
INDEX_NAME = "flax_model.msgpack.index.json"
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1
_EXT_NAMES = {2: "a native complex (ext 2)", 3: "a numpy scalar (ext 3)"}


class FlaxMsgpackError(ValueError):
    """The bytes are not the msgpack subset a Flax ``save_pretrained`` writes."""


class MissingShardError(FlaxMsgpackError):
    """A shard that the index names is not in the directory."""


class DuplicateLeafError(FlaxMsgpackError):
    """Two shards of one checkpoint hold the same leaf."""


class UnindexedLeafError(FlaxMsgpackError):
    """A shard holds a leaf that the index does not give it, or lacks one
    that the index does."""


class _Reader:
    """msgpack decoding over one buffer; ``obj()`` decodes the next object."""

    def __init__(self, buf: bytes) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise FlaxMsgpackError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def obj(self) -> Any:
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(self.unpack(">b"), n)
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            return self.mapping(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        raise FlaxMsgpackError(f"msgpack marker 0x{b:02x} at offset {at} is not read")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def mapping(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            at = self.pos
            key = self.obj()
            if not isinstance(key, str):
                raise FlaxMsgpackError(f"map key {key!r} at offset {at} is not a string")
            out[key] = self.obj()
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        at = self.pos
        data = self.take(n)
        if code != _EXT_NDARRAY:
            what = _EXT_NAMES.get(code, f"ext type {code}")
            raise FlaxMsgpackError(f"{what} at offset {at} is not read")
        return _ndarray(bytes(data))


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """The numpy dtype of a flax dtype name, and whether it is bfloat16 (read
    as its uint16 bits and widened)."""
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    try:
        dt = np.dtype(name)
    except TypeError:
        raise FlaxMsgpackError(f"array dtype {name!r} is not read") from None
    # numpy's own bool, integer, float and complex types only: a dtype that
    # another package (ml_dtypes) registers is not read
    if dt.name != name or dt.isbuiltin != 1 or dt.kind not in "biufc":
        raise FlaxMsgpackError(f"array dtype {name!r} is not read")
    return dt, False


def _ndarray(payload: bytes) -> np.ndarray:
    inner = _Reader(payload)
    tpl = inner.obj()
    if inner.pos != len(payload) or not (isinstance(tpl, list) and len(tpl) == 3):
        raise FlaxMsgpackError("an ndarray extension is not (shape, dtype, bytes)")
    shape, name, data = tpl
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if not (isinstance(shape, list) and all(isinstance(d, int) for d in shape)
            and isinstance(name, str) and isinstance(data, bytes)):
        raise FlaxMsgpackError("an ndarray extension is not (shape, dtype, bytes)")
    dt, bf16 = _dtype(name)
    if len(data) != int(np.prod(shape, dtype=np.int64)) * dt.itemsize:
        raise FlaxMsgpackError(f"an ndarray of shape {shape} and dtype {name} holds "
                               f"{len(data)} bytes")
    arr = np.frombuffer(data, dtype=dt).reshape(shape).copy()
    if bf16:  # the high half of an f32: exact
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(node: Any) -> Any:
    """Flax's chunked leaves joined back into arrays, recursively."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        try:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        except (KeyError, TypeError):
            raise FlaxMsgpackError("a chunked array lacks its shape or a chunk") from None
        if not all(isinstance(c, np.ndarray) and c.ndim == 1 for c in chunks):
            raise FlaxMsgpackError("a chunked array's chunks are not flat arrays")
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def read_msgpack(data: bytes) -> Dict[str, Any]:
    """The param tree ``flax.serialization.msgpack_restore`` would return,
    as nested dicts of numpy arrays."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise FlaxMsgpackError(f"{len(reader.buf) - reader.pos} bytes follow the tree")
    if not isinstance(tree, dict):
        raise FlaxMsgpackError(f"the file holds a {type(tree).__name__}, not a param tree")
    return _unchunk(tree)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _read_file(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return read_msgpack(f.read())


def _read_sharded(path: str) -> Dict[str, Any]:
    """The tree of a sharded directory: every shard of the index's
    ``weight_map``, each leaf where the index puts it."""
    with open(os.path.join(path, INDEX_NAME)) as f:
        index = json.load(f)
    weight_map = index.get("weight_map") if isinstance(index, dict) else None
    if not isinstance(weight_map, dict) or not weight_map:
        raise FlaxMsgpackError(f"{INDEX_NAME} in {path} has no weight_map")
    flat: Dict[str, Any] = {}
    owner: Dict[str, str] = {}
    for shard in sorted(set(weight_map.values())):
        file = os.path.join(path, shard)
        if not os.path.isfile(file):
            raise MissingShardError(f"{path}: the shard {shard} that {INDEX_NAME} names is "
                                    "missing")
        leaves = _flatten(_read_file(file))
        for name, leaf in leaves.items():
            if name in owner:
                raise DuplicateLeafError(
                    f"{path}: the leaf {name} is in both {owner[name]} and {shard}")
            if weight_map.get(name) != shard:
                raise UnindexedLeafError(
                    f"{path}: {shard} holds the leaf {name}, which {INDEX_NAME} "
                    f"{'gives to ' + weight_map[name] if name in weight_map else 'does not name'}")
            owner[name] = shard
            flat[name] = leaf
    absent = sorted(set(weight_map) - set(flat))
    if absent:
        raise UnindexedLeafError(f"{path}: {INDEX_NAME} names leaves no shard holds: "
                                 f"{absent[:5]}")
    return _unflatten(flat)


def read_pretrained_dir(path: str) -> Dict[str, Any]:
    """The param tree of a Flax ``save_pretrained`` directory: its
    ``flax_model.msgpack``, or the shards its index names."""
    if os.path.exists(os.path.join(path, INDEX_NAME)):
        return _read_sharded(path)
    file = os.path.join(path, WEIGHTS_NAME)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no {WEIGHTS_NAME} in {path}")
    return _read_file(file)
