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

``restore_arrays`` reads each part onto the host and copies the stored
values INTO the live tensors (``copy_``), so the module's parameters, the
optimizer's pairing of its state with them, and every reference the Trainer
holds stay valid, and the device holds no second copy of the state.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

ARRAY_SUBDIR = "state"
TRAINER_STATE_FILE = "trainer_state.json"
SEP = "/"


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
        torch.save(flat, _part_path(ckpt_dir, part))


def load_arrays(ckpt_dir: str, part: str) -> Dict[str, torch.Tensor]:
    """One part's flat ``{name: tensor}`` dict, read onto the host."""
    return torch.load(_part_path(ckpt_dir, part), map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_arrays(
    ckpt_dir: str,
    live: Dict[str, Any],
    reshape: Optional[Callable[[str, str, torch.Tensor], torch.Tensor]] = None,
) -> None:
    """Fill the live tree in place from the checkpoint: the same names, and
    every tensor the same shape and dtype as the live one it replaces.
    ``reshape(part, name, stored)`` maps a stored tensor first (on a mesh:
    the whole tensor to this rank's shard)."""
    for part, node in live.items():
        want = flatten(node)
        # on the host: copy_ moves each tensor to its live device, so the
        # device never holds a second copy of the state
        stored = load_arrays(ckpt_dir, part)
        if set(stored) != set(want):
            missing, extra = sorted(set(want) - set(stored)), sorted(set(stored) - set(want))
            raise ValueError(
                f"checkpoint part {part!r} does not match the live state: "
                f"missing {missing[:5]}, unexpected {extra[:5]}"
            )
        for name, leaf in want.items():
            value = stored[name]
            if reshape is not None and not isinstance(leaf, torch.Generator):
                value = reshape(part, name, value)
            if isinstance(leaf, torch.Generator):
                leaf.set_state(value.cpu())
                continue
            if value.shape != leaf.shape or value.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint {part}{SEP}{name} is {value.dtype}{list(value.shape)}, "
                    f"the live tensor {leaf.dtype}{list(leaf.shape)}"
                )
            leaf.copy_(value)


def save_trainer_state(ckpt_dir: str, state: Dict[str, Any]) -> None:
    with open(os.path.join(ckpt_dir, TRAINER_STATE_FILE), "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)


def load_trainer_state(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, TRAINER_STATE_FILE)) as f:
        return json.load(f)
