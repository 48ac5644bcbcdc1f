"""Device mesh: the parallelism topology of one trial over torch.distributed.

Port of ``determined_tpu/parallel/mesh.py``.  Where the JAX package builds a
``jax.sharding.Mesh`` over every device of one controller, the port runs one
process per device (torchrun) and builds a ``DeviceMesh`` with
``init_device_mesh`` over the world of its process group, in the JAX mesh's
axis order ``(dcn, pipe, data, fsdp, expert, seq, tensor)``, so rank ``r``
sits at the coordinate of the JAX mesh's device ``r``.  ``dcn``
(``num_slices``) is outermost and slice-major, as JAX's
``_slice_major_order`` lays it: the ranks of slice ``s`` are the ``s``-th
contiguous block of the world (JAX's virtual slices on the CPU, and on one
host a block of its GPUs; through the master a gang's node ranks follow its
agents' order, so agents are numbered slice by slice).  The Trainer runs
every axis and every composition of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from determined_tpu_torch.config.experiment import MeshConfig


class MeshAxes:
    """Canonical mesh-axis names used across the framework."""

    DCN = "dcn"          # cross-slice data parallelism (slow DCN links)
    DATA = "data"        # pure data parallelism (gradients averaged)
    FSDP = "fsdp"        # data parallelism with sharded params/opt-state
    TENSOR = "tensor"    # tensor (megatron-style) parallelism
    SEQUENCE = "seq"     # sequence / context parallelism (ring attention)
    EXPERT = "expert"    # MoE expert parallelism
    PIPELINE = "pipe"    # pipeline stages

    ALL = (DCN, DATA, FSDP, TENSOR, SEQUENCE, EXPERT, PIPELINE)
    # Axes over which a batch is split (used to compute per-shard batch).
    BATCH_AXES = (DCN, DATA, FSDP)
    # Batch axes that stay within one slice (ICI-reachable); the hierarchical
    # gradient sync reduce-scatters over these and crosses `dcn` with only
    # the resulting 1/N_ici fragment.
    ICI_BATCH_AXES = (DATA, FSDP)


# init_device_mesh's dims: the JAX mesh's order
MESH_ORDER = (
    MeshAxes.DCN, MeshAxes.PIPELINE, MeshAxes.DATA, MeshAxes.FSDP, MeshAxes.EXPERT,
    MeshAxes.SEQUENCE, MeshAxes.TENSOR,
)


@dataclasses.dataclass
class Mesh:
    """A resolved ``MeshConfig`` and its ``DeviceMesh`` (``device_mesh``);
    ``shape`` maps every axis name to its size, as a JAX mesh's does."""

    config: MeshConfig
    device_mesh: Any

    @property
    def shape(self) -> Dict[str, int]:
        return self.config.shape

    @property
    def size(self) -> int:
        return self.config.num_devices

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str) -> Any:
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)


def make_mesh(config: MeshConfig, device_type: str = "cuda") -> Mesh:
    """Resolve ``config`` against the process group's world size and build
    its ``DeviceMesh`` (every axis present, size-1 ones included)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a torch.distributed process group: launch the "
            "ranks with torchrun and call core.init() (or "
            "DistributedContext.from_torch()) first"
        )
    config = config.resolve(tdist.get_world_size())
    shape = config.shape
    device_mesh = init_device_mesh(
        device_type, tuple(shape[a] for a in MESH_ORDER), mesh_dim_names=MESH_ORDER
    )
    return Mesh(config, device_mesh)


def resolve_mesh(config: Optional[MeshConfig], device_type: str) -> Optional[Mesh]:
    """``train.init``'s mesh: None without a config, and for a config
    that resolves to one device in a process without a process group (the
    single-device path); else ``make_mesh``."""
    import torch.distributed as tdist

    if config is None:
        return None
    if not tdist.is_initialized():
        config.resolve(1)  # a mesh of more devices raises here
        return None
    return make_mesh(config, device_type)
