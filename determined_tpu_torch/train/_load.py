"""Rebuild a Trial and a Trainer from a stored checkpoint, no experiment
needed (a port of ``determined_tpu/train/_load.py``).

The Trainer writes ``trial_class``, ``hparams``, ``exp_config`` and ``seed``
into ``trainer_state.json``, so inference or fine-tune scripts can do::

    trial, trainer = train.load_trial_from_checkpoint("/ckpts/<uuid>")
    model = trainer.model  # weights of the checkpoint's step

Unlike the JAX function, the load first checks the directory against its
integrity manifest (md5 and size of every file), as a Trainer's restore
does: a serving replica must not load a truncated or bit-flipped file.

The trial is rebuilt on one device whatever mesh trained it: a sharded
checkpoint (``serialization``'s layout) is joined leaf by leaf on the
host, so a model trained on a mesh serves from its own checkpoint.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional, Sequence, Tuple

from determined_tpu_torch._device import DeviceLike
from determined_tpu_torch.core import verify_manifest
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.train import serialization
from determined_tpu_torch.train._trainer import Trainer, init as train_init
from determined_tpu_torch.train._trial import TorchTrial


def load_trial_from_checkpoint(
    path: str,
    trial_class: Optional[type] = None,
    core_context: Any = None,
    device: DeviceLike = None,
    parts: Optional[Sequence[str]] = None,
) -> Tuple[TorchTrial, Trainer]:
    """Reconstruct the Trial and a ready Trainer from a local checkpoint
    directory, on ``device`` (CUDA unless named).

    ``trial_class`` overrides the recorded class (when the original module
    is not importable).  The directory is checked against its manifest
    first (``CheckpointCorruptError`` on a mismatch; a checkpoint without
    one loads with a warning).  The returned trainer has
    its params, optimizer state and generator restored at the checkpoint's
    step; call ``trainer.fit`` to continue training or use ``trainer.model``.

    ``parts`` (``("params",)`` for serving) restores those parts of the
    array state alone, and reads and verifies only the files that hold
    them (``serialization.part_files``) with the trainer state: the
    optimizer's moments of a whole-state checkpoint are never read.
    """
    only = None
    if parts is not None:
        keep = set(serialization.part_files(path, parts)) | {serialization.TRAINER_STATE_FILE}
        only = keep.__contains__
    with get_tracer().span("checkpoint.verify", cat="restore"):
        verify_manifest(path, only=only)
    tstate = serialization.load_trainer_state(path)
    if trial_class is None:
        ref = tstate.get("trial_class")
        if not ref or ":" not in ref:
            raise ValueError("checkpoint does not record its trial class; pass trial_class=")
        module_name, _, qualname = ref.partition(":")
        obj: Any = importlib.import_module(module_name)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        trial_class = obj

    from determined_tpu_torch import core
    from determined_tpu_torch.config.experiment import ExperimentConfig, MeshConfig

    exp_config = (
        ExperimentConfig.parse(tstate["exp_config"]) if tstate.get("exp_config") else None
    )
    ctx = train_init(
        hparams=tstate.get("hparams") or {},
        exp_config=exp_config,
        core_context=core_context or core._dummy_init(),
        seed=int(tstate.get("seed") or 0),
        device=device,
        # one device, not the recorded resources.mesh
        mesh_config=MeshConfig(),
    )
    trial = trial_class(ctx)
    trainer = Trainer(trial)
    trainer._setup()
    trainer.restore_from_path(path, parts=parts)
    return trial, trainer
