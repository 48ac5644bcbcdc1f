"""Checkpoint serialization of the port's training state.

The layout of ``determined_tpu/train/serialization.py`` inside one
checkpoint directory::

    state/               the array state, one file per part
    trainer_state.json   loop counters, loader state, callbacks state

The JAX package writes ``state/`` with orbax, which the port cannot import.
Here each part of the array state (``step``, ``params``, ``opt_state``,
``rng``) is one ``torch.save`` file, ``state/<part>.pt``, of a flat
``{name: tensor}`` dict.  Names are paths through the live structure joined
by "/": ``params`` holds the ``model.named_parameters()`` names (the port's
``state_dict`` layout that ``convert.flax_from_state_dict`` maps to the JAX
param tree), ``opt_state`` holds ``count``, ``mu/<name>`` and ``nu/<name>``
(what ``convert.flax_from_opt_state`` reads), each tensor in its own dtype
(a bf16 first moment stays bf16, byte for byte).  Optimizer-state
NamedTuples and dataclasses are flattened on the way out and the live ones
are filled on the way in: nothing is pickled, and files are read with
``torch.load(weights_only=True)``.  A ``torch.Generator`` is stored as its
``get_state()`` bytes.

A world of more than one rank writes the sharded format instead, beside
the same ``trainer_state.json``::

    state/layout.json           every leaf's whole shape, dtype and pieces
    state/shards/rank<r>.pt     rank r's pieces, {part/name: tensor}

Each rank describes the leaves it holds (``describe``: the whole shape, the
dtype and its box, ``parallel.sharding.Box``); ``build_layout`` joins every
rank's description and names one writer for each distinct piece, the
lowest rank that holds it, so a leaf that several ranks hold the same
(a data replica, a replicated leaf) is written once.  A pipeline rank
holds its stage's leaves only, under the whole model's names: a leaf's
pieces come from the ranks that hold it.  Every rank writes its own file
(``save_shard``), the chief writes the layout.  A whole-state part is
written through ``storage.DigestingWriter``: the save's finalize takes its
md5 from the write instead of reading it back (a rank's shard is digested
by the rank the finalize assigns it, which may be another process).

``restore_arrays`` reads either format and copies the stored values INTO
the live tensors (``copy_``), so the module's parameters, the optimizer's
pairing of its state with them, and every reference the Trainer holds stay
valid, and the device holds no second copy of the state.  The files are
memory-mapped (``torch.load(mmap=True)``) and read one leaf at a time:
``place(part, name, leaf)`` gives the whole shape and the box of a leaf
the live rank holds part of (None: the whole leaf), and the box is cut
from the whole stored tensor or assembled from the stored pieces that
overlap it.  On the mesh that wrote it a rank's box is one stored piece;
on another mesh, or on one device, the pieces are joined on the host, a
leaf at a time, so no rank holds the whole state.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from determined_tpu_torch.storage.base import DigestingWriter

ARRAY_SUBDIR = "state"
TRAINER_STATE_FILE = "trainer_state.json"
LAYOUT_FILE = "layout.json"
SHARD_SUBDIR = "shards"
LAYOUT_VERSION = 1
SEP = "/"

# (start, stop) a dim: the part of a whole tensor (parallel.sharding.Box)
Box = Tuple[Tuple[int, int], ...]
# (whole shape, box) of a leaf the live rank holds part of
Placement = Tuple[Tuple[int, ...], Box]
PlaceFn = Callable[[str, str, Any], Optional[Placement]]


def _children(node: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        return ((str(k), v) for k, v in node.items())
    if hasattr(node, "_fields"):  # NamedTuple
        return ((f, getattr(node, f)) for f in node._fields)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return ((f.name, getattr(node, f.name)) for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(node))
    raise TypeError(f"cannot serialize a {type(node).__name__} in the array state")


def flatten(node: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` over a tree of dicts, NamedTuples, dataclasses and
    sequences whose leaves are tensors or ``torch.Generator``s."""
    if isinstance(node, (torch.Tensor, torch.Generator)):
        return {prefix: node}
    out: Dict[str, Any] = {}
    for key, child in _children(node):
        out.update(flatten(child, f"{prefix}{SEP}{key}" if prefix else key))
    return out


def _stored(leaf: Any) -> torch.Tensor:
    return leaf.get_state() if isinstance(leaf, torch.Generator) else leaf


def _part_path(ckpt_dir: str, part: str) -> str:
    return os.path.join(ckpt_dir, ARRAY_SUBDIR, f"{part}.pt")


def save_arrays(ckpt_dir: str, tree: Dict[str, Any]) -> None:
    """Write each top-level part of ``tree`` as ``state/<part>.pt``.  The
    tensors may live on any device; ``torch.save`` stores them with it."""
    os.makedirs(os.path.join(ckpt_dir, ARRAY_SUBDIR), exist_ok=True)
    for part, node in tree.items():
        flat = {k: _stored(v) for k, v in flatten(node).items()}
        with DigestingWriter(_part_path(ckpt_dir, part)) as f:
            torch.save(flat, f)


def _mmap(path: str) -> Dict[str, torch.Tensor]:
    """A saved flat dict, memory-mapped: a tensor's bytes are read when it
    is."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def part_files(ckpt_dir: str, parts: Sequence[str]) -> List[str]:
    """The files (relative to ``ckpt_dir``) a restore of ``parts`` reads:
    their ``state/<part>.pt`` files, or in the sharded format the layout
    and every rank's file (each holds all of that rank's parts)."""
    if load_layout(ckpt_dir) is not None:
        shards = os.path.join(ckpt_dir, ARRAY_SUBDIR, SHARD_SUBDIR)
        return [os.path.join(ARRAY_SUBDIR, LAYOUT_FILE)] + sorted(
            os.path.join(ARRAY_SUBDIR, SHARD_SUBDIR, f) for f in os.listdir(shards))
    return [os.path.join(ARRAY_SUBDIR, f"{part}.pt") for part in parts]


def load_arrays(ckpt_dir: str, part: str) -> Dict[str, torch.Tensor]:
    """One part's flat ``{name: tensor}`` dict of a whole-state checkpoint,
    read onto the host."""
    return torch.load(_part_path(ckpt_dir, part), map_location="cpu", weights_only=True)


def _whole(shape: Any) -> Box:
    return tuple((0, int(n)) for n in shape)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def describe(tree: Dict[str, Any], place: Optional[PlaceFn] = None) -> Dict[str, Any]:
    """``{part/name: (whole shape, dtype name, box)}`` of every leaf of the
    live tree on this rank (``place`` as for ``restore_arrays``)."""
    out: Dict[str, Any] = {}
    for part, node in tree.items():
        for name, leaf in flatten(node).items():
            t = _stored(leaf)
            pl = place(part, name, leaf) if place is not None else None
            shape, box = pl if pl is not None else (tuple(t.shape), _whole(t.shape))
            out[f"{part}{SEP}{name}"] = (tuple(int(n) for n in shape), _dtype_name(t),
                                         tuple(tuple(b) for b in box))
    return out


def build_layout(descriptions: List[Dict[str, Any]]) -> Tuple[Dict[str, Any], List[Set[str]]]:
    """Every rank's ``describe`` joined: the layout (each leaf's whole
    shape, dtype and distinct pieces, each with the rank that writes it,
    the lowest that holds it) and, for each rank, the keys it writes.  A
    leaf may be held by some ranks only (a pipeline stage's)."""
    keys = set().union(*descriptions)
    leaves: Dict[str, Any] = {}
    writes: List[Set[str]] = [set() for _ in descriptions]
    for key in sorted(keys):
        holders = [r for r, d in enumerate(descriptions) if key in d]
        shape, dtype, _ = descriptions[holders[0]][key]
        pieces: Dict[Box, int] = {}
        for r in holders:
            d = descriptions[r]
            if d[key][:2] != (shape, dtype):
                raise ValueError(f"{key}: rank {r} holds {d[key][1]}{list(d[key][0])}, "
                                 f"rank {holders[0]} {dtype}{list(shape)}")
            if d[key][2] not in pieces:
                pieces[d[key][2]] = r
                writes[r].add(key)
        leaves[key] = {"shape": list(shape), "dtype": dtype,
                       "pieces": [{"rank": r, "box": [list(b) for b in box]}
                                  for box, r in pieces.items()]}
    return {"version": LAYOUT_VERSION, "world": len(descriptions), "leaves": leaves}, writes


def shard_path(ckpt_dir: str, rank: int) -> str:
    return os.path.join(ckpt_dir, ARRAY_SUBDIR, SHARD_SUBDIR, f"rank{rank:05d}.pt")


def select(tree: Dict[str, Any], keys: Set[str]) -> Dict[str, Any]:
    """``{part/name: leaf}`` of the leaves of ``tree`` that ``keys`` name."""
    out: Dict[str, Any] = {}
    for part, node in tree.items():
        for name, leaf in flatten(node).items():
            key = f"{part}{SEP}{name}"
            if key in keys:
                out[key] = leaf
    return out


def save_shard(ckpt_dir: str, rank: int, flat: Dict[str, Any]) -> None:
    """Write ``{part/name: leaf}`` (``select``) as rank ``rank``'s file;
    nothing when it is empty."""
    if flat:
        os.makedirs(os.path.dirname(shard_path(ckpt_dir, rank)), exist_ok=True)
        torch.save({k: _stored(v) for k, v in flat.items()}, shard_path(ckpt_dir, rank))


def save_layout(ckpt_dir: str, layout: Dict[str, Any]) -> None:
    os.makedirs(os.path.join(ckpt_dir, ARRAY_SUBDIR), exist_ok=True)
    with open(os.path.join(ckpt_dir, ARRAY_SUBDIR, LAYOUT_FILE), "w") as f:
        json.dump(layout, f, sort_keys=True)


def load_layout(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The layout of a sharded checkpoint; None for a whole-state one."""
    path = os.path.join(ckpt_dir, ARRAY_SUBDIR, LAYOUT_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class _Pieces:
    """The stored pieces of a sharded checkpoint, by leaf, with each
    rank's file mapped once."""

    def __init__(self, ckpt_dir: str, layout: Dict[str, Any]) -> None:
        self.ckpt_dir = ckpt_dir
        self.leaves = layout["leaves"]
        self._files: Dict[int, Dict[str, torch.Tensor]] = {}

    def _file(self, rank: int) -> Dict[str, torch.Tensor]:
        if rank not in self._files:
            self._files[rank] = _mmap(shard_path(self.ckpt_dir, rank))
        return self._files[rank]

    def read(self, key: str, box: Box) -> torch.Tensor:
        """The values of ``box`` of the whole leaf ``key``, joined from the
        stored pieces that overlap it."""
        entry = self.leaves[key]
        out = torch.empty([b - a for a, b in box], dtype=getattr(torch, entry["dtype"]))
        if not out.numel() and out.dim():
            return out
        covered = 0
        for piece in entry["pieces"]:
            pbox = [tuple(b) for b in piece["box"]]
            inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, pbox)]
            if any(lo >= hi for lo, hi in inter):
                continue
            stored = self._file(piece["rank"])[key]
            src = stored[tuple(slice(lo - c, hi - c) for (lo, hi), (c, _) in zip(inter, pbox))]
            out[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(inter, box))] = src
            covered += src.numel()
            if box == tuple(pbox):
                break
        if covered != out.numel():
            raise ValueError(f"the stored pieces of {key} cover {covered} of the "
                             f"{out.numel()} values of {list(box)}")
        return out


@torch.no_grad()
def restore_arrays(
    ckpt_dir: str,
    live: Dict[str, Any],
    place: Optional[PlaceFn] = None,
    partial: bool = False,
) -> None:
    """Fill the live tree in place from the checkpoint, either format: the
    same names (with ``partial``, a pipeline rank's, some of them), every
    leaf the same whole shape and dtype as stored, and each live tensor
    filled with its box of the stored leaf (``place``; None, or no
    placement for a leaf: the whole leaf)."""
    layout = load_layout(ckpt_dir)
    pieces = _Pieces(ckpt_dir, layout) if layout is not None else None
    for part, node in live.items():
        want = flatten(node)
        if pieces is not None:
            prefix = f"{part}{SEP}"
            names = {k[len(prefix):] for k in pieces.leaves if k.startswith(prefix)}
            stored = None
        else:
            stored = _mmap(_part_path(ckpt_dir, part))
            names = set(stored)
        if names != set(want) and not (partial and set(want) <= names):
            missing, extra = sorted(set(want) - names), sorted(names - set(want))
            raise ValueError(
                f"checkpoint part {part!r} does not match the live state: "
                f"missing {missing[:5]}, unexpected {extra[:5]}"
            )
        for name, leaf in want.items():
            key = f"{part}{SEP}{name}"
            pl = place(part, name, leaf) if place is not None else None
            shape = (pieces.leaves[key]["shape"] if pieces is not None
                     else stored[name].shape)
            whole, box = pl if pl is not None else (tuple(_stored(leaf).shape), _whole(shape))
            if tuple(shape) != tuple(whole):
                raise ValueError(f"checkpoint {key} is {list(shape)} whole, the live leaf "
                                 f"{list(whole)}")
            if pieces is not None:
                value = pieces.read(key, box)
            else:
                value = stored[name][tuple(slice(a, b) for a, b in box)]
            if isinstance(leaf, torch.Generator):
                leaf.set_state(value.clone())
                continue
            if value.shape != leaf.shape or value.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint {key} is {value.dtype}{list(value.shape)}, "
                    f"the live tensor {leaf.dtype}{list(leaf.shape)}"
                )
            leaf.copy_(value)


def save_trainer_state(ckpt_dir: str, state: Dict[str, Any]) -> None:
    with open(os.path.join(ckpt_dir, TRAINER_STATE_FILE), "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)


def load_trainer_state(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, TRAINER_STATE_FILE)) as f:
        return json.load(f)
