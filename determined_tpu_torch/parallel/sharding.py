"""Logical-axis sharding rules, and how the Trainer places a model on a mesh.

Port of ``determined_tpu/parallel/sharding.py``.  ``DEFAULT_RULES`` and
``logical_to_mesh_spec`` are the JAX package's: a logical spec (one logical
axis name a dim) becomes a tuple of mesh axes (the ``PartitionSpec``'s
entries), size-1 and absent axes dropped and no mesh axis used twice.
``batch_sharding`` is the batch's spec: over ``(data, fsdp)``.

Where XLA places the arrays from those specs in the JAX package, the port
places them itself (``shard_model``), one process per device:

- ``expert``: every module with ``shard_experts`` (``models/moe.py``'s
  ``MoE``) keeps its ``e / n`` experts of the stacked leaves (the rule
  ``expert -> expert`` on their leading dim) and all-reduces its combine
  over the expert group; every other parameter is replicated over it.
  Modules with ``shard_batch`` learn their slice of the global batch and
  the group of the ranks that hold the others (``batch_group``);
- ``tensor``: every module with ``shard_tensor`` (the LM's attention, MLP,
  embedding and head; the MNIST models' hidden layer) keeps its rank's rows
  or columns of the leaves the rules ``heads``, ``mlp`` and ``vocab ->
  tensor`` shard, as plain parameters, and puts Megatron's collectives in
  its forward (``parallel/tensor_parallel.py``).  Every other parameter is
  replicated over tensor and gets a whole gradient there;
- ``seq``: every module with ``shard_seq`` (the LM) runs on its rank's
  contiguous part of each sequence, attention through the ring (on a mesh
  whose seq axis is 1 it learns that too: ``attention: ring`` is then
  whole-sequence attention, JAX's fallback).  Every
  parameter is replicated over seq (JAX's rules shard none over it), and
  each seq rank's gradient covers its own tokens: they are averaged;
- ``data``, ``fsdp`` and ``seq``: FSDP2 ``fully_shard`` on the batch-like
  axes, each block and then the root, on a mesh that excludes ``tensor``
  and ``expert``.  ``fsdp`` and ``seq`` are flattened into FSDP's one shard
  dim (torchtitan's ``dp_shard_cp``): FSDP's reduce-scatter then averages
  over the seq ranks as over the batch shards, and the optimizer state is
  sharded over seq too, where HSDP with seq as a replicate dim would keep a
  copy of it on every seq rank.  With ``data`` and a shard dim both over 1
  it is HSDP, replicated over ``data``; otherwise one flat shard group over
  every batch-like axis over 1.  Each parameter is sharded on the dim the
  JAX Trainer's auto-FSDP would choose (``fsdp_shard_dim``, its
  ``_infer_fsdp_specs``: the largest dim the shard count divides), else on
  dim 0, which FSDP2 pads.

``ShardPlan`` carries what the Trainer needs of that placement: each
rank's local shards for the optimizer (``local``), the global gradient norm
(``global_norm``), the whole tensor of a leaf (``full`` gathers it), and
the layout a sharded checkpoint carries: a leaf's whole shape (``full_shape``) and the box of
it this rank holds (``box``: a ``(start, stop)`` a dim, through the tensor
split, the expert split and FSDP2's ``torch.chunk`` of its shard dim,
uneven chunks and empty ones included).  Ranks whose boxes of a leaf are
equal (data replicas, a whole ``wk``/``wv`` on the tensor ranks, a dense
leaf on the expert ranks) hold the same values.

``pipe`` (``parallel/pipeline.py``): first the model keeps its pipe rank's
stage (``shard_pipe``: its chunks of layers, embed on the first rank, the
final norm and the head on the last, all under the whole model's names),
then the other axes place what it kept.  FSDP2 shards each of the stage's
blocks over the batch-like axes of the rank's own pipe coordinate, with
``reshard_after_forward`` off (the schedule reduces and reshards at each
chunk's last backward unit, so a step gathers a block once, not once a
microbatch); the outer leaves stay whole and their gradients are averaged
over the same ranks (``sync_grads``).  A stage's MoE blocks route their
own tokens (no ``shard_batch``), as JAX's do inside its ``shard_map``.  The
clip's norm is summed over the pipe group too.  The mesh axis ``dcn``, MoE
blocks on ``tensor`` or ``seq`` (``pipe`` x ``seq`` x ``expert`` with them)
and ``tensor`` beside ``pipe`` raise ``NotImplementedError``
(``check_ported``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

import torch

from determined_tpu_torch.parallel.mesh import MeshAxes

# A logical spec is a tuple of logical axis names (or None), one per dim.
# The part of a whole tensor a rank holds: (start, stop) a dim.
Box = Tuple[Tuple[int, int], ...]

LogicalSpec = Tuple[Optional[str], ...]

# Rules: logical axis name -> mesh axis (str), tuple of mesh axes, or None.
LogicalAxisRules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rules: batch over (data, fsdp); params sharded over fsdp on their
# largest dim; tensor-parallel on heads/mlp; sequence activations over seq.
DEFAULT_RULES: LogicalAxisRules = {
    "batch": (MeshAxes.DCN, MeshAxes.DATA, MeshAxes.FSDP),
    "length": MeshAxes.SEQUENCE,
    "embed": None,
    "mlp": MeshAxes.TENSOR,
    "heads": MeshAxes.TENSOR,
    "kv": None,
    "head_dim": None,
    "vocab": MeshAxes.TENSOR,
    "expert": MeshAxes.EXPERT,
    "stage": MeshAxes.PIPELINE,
    # FSDP: weight dims tagged "fsdp_shard" get scattered over the fsdp axis.
    "fsdp_shard": MeshAxes.FSDP,
}

# the mesh axes the port does not run yet beside ``pipe``, and the slice
# each comes with
_LATER_BESIDE_PIPE = {
    MeshAxes.DCN: "num_slices beside 'pipe' (a pipeline stage's blocks over dcn)",
    MeshAxes.TENSOR: "the 'tensor' mesh axis beside 'pipe' (JAX's stages replicate over tensor)",
}
# the axes MoE blocks do not run on yet
_MOE_LATER_AXES = (MeshAxes.TENSOR, MeshAxes.SEQUENCE)


def _axis_sizes(mesh: Any) -> Optional[Dict[str, int]]:
    if mesh is None:
        return None
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def logical_to_mesh_spec(
    logical: Optional[LogicalSpec],
    rules: LogicalAxisRules,
    mesh: Any = None,
) -> Tuple[Any, ...]:
    """Translate a logical spec into mesh axes, one entry a dim (a name, a
    tuple of names, or None).  ``mesh`` is anything with a ``shape`` axis
    dict (``Mesh``, ``MeshConfig``) or the dict itself; mesh axes that are
    absent or of size 1 are dropped, so the same model and rules run on any
    topology."""
    if logical is None:
        return ()
    axis_sizes = _axis_sizes(mesh)

    def resolve(name: Optional[str]):
        if name is None:
            return None
        target = rules.get(name, None)
        if target is None:
            return None
        targets = target if isinstance(target, tuple) else (target,)
        if axis_sizes is not None:
            targets = tuple(t for t in targets if axis_sizes.get(t, 1) > 1)
        if not targets:
            return None
        return targets if len(targets) > 1 else targets[0]

    resolved = [resolve(n) for n in logical]
    # a mesh axis shards at most one dim; keep the first occurrence
    seen: Set[str] = set()
    out = []
    for r in resolved:
        flat = r if isinstance(r, tuple) else (r,) if r else ()
        if any(f in seen for f in flat):
            out.append(None)
            continue
        seen.update(flat)
        out.append(r)
    return tuple(out)


def batch_sharding(
    mesh: Any, rules: Optional[LogicalAxisRules] = None, extra_dims: int = 1
) -> Tuple[Any, ...]:
    """The spec of an input batch: ``('batch', None, ...)`` resolved."""
    logical: LogicalSpec = ("batch",) + (None,) * extra_dims
    return logical_to_mesh_spec(logical, rules if rules is not None else DEFAULT_RULES, mesh)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh axes the batch is split over, outermost first."""
    first = batch_sharding(mesh, extra_dims=0)[0]
    if first is None:
        return ()
    return first if isinstance(first, tuple) else (first,)


def batch_shard(mesh: Any) -> Tuple[int, int]:
    """``(shard_rank, num_shards)`` of this rank's slice of a global batch:
    its row-major index over the batch axes (data outer, fsdp inner), the
    order in which JAX's ``to_global`` lays a batch over a mesh's devices."""
    sizes = _axis_sizes(mesh)
    idx, n = 0, 1
    for axis in batch_axes(mesh):
        idx = idx * sizes[axis] + mesh.coordinate(axis)
        n *= sizes[axis]
    return idx, n


def batch_group(mesh: Any) -> Any:
    """The process group of the ranks that hold the other slices of this
    rank's global batch, ranked in batch order (None: one slice)."""
    import torch.distributed as tdist

    axes = batch_axes(mesh)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.group(axes[0])
    dm = mesh.device_mesh
    names = list(dm.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    mine = None
    # every rank creates every group, in the same order (new_group's rule)
    for row in dm.mesh.permute(*rest, *keep).reshape(-1, n).tolist():
        group = tdist.new_group(row)  # ascending rank order is batch order
        if tdist.get_rank() in row:
            mine = group
    return mine


def fsdp_shard_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """Auto-FSDP (the JAX Trainer's ``_infer_fsdp_specs``): the largest dim
    of ``shape`` that ``n`` shards divide, None when none does or ``n`` is
    1."""
    if n <= 1 or not len(shape):
        return None
    divisible = [d for d in range(len(shape)) if shape[d] % n == 0 and shape[d] >= n]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def chunk_range(lo: int, hi: int, n: int, i: int) -> Tuple[int, int]:
    """The ``i``-th of ``torch.chunk``'s ``n`` chunks of ``[lo, hi)``:
    chunks of ``ceil(len / n)``, the last ones short or empty."""
    size = hi - lo
    step = -(-size // n) if size else 0
    return lo + min(i * step, size), lo + min((i + 1) * step, size)


def check_ported(axis_sizes: Mapping[str, int], moe: bool = False) -> None:
    """Raise ``NotImplementedError`` for a composition of mesh axes that the
    port does not run yet: ``dcn`` or ``tensor`` beside ``pipe``, and with
    ``moe`` (a model with MoE blocks) MoE blocks on ``tensor`` or ``seq``."""
    pipe = int(axis_sizes.get(MeshAxes.PIPELINE, 1)) > 1
    for axis in _MOE_LATER_AXES if moe else ():
        if int(axis_sizes.get(axis, 1)) > 1:
            also = (" (pipe x seq x expert waits for MoE x seq)"
                    if pipe and axis == MeshAxes.SEQUENCE else "")
            raise NotImplementedError(
                f"MoE blocks on the {axis!r} mesh axis are not ported to determined_tpu_torch "
                f"yet{also}; they come with a later slice of the port (ROADMAP.md, Queue 1)"
            )
    for axis, what in _LATER_BESIDE_PIPE.items() if pipe else ():
        if int(axis_sizes.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"{what} is not ported to determined_tpu_torch yet; it comes with a later "
                "slice of the port (ROADMAP.md, Queue 1)"
            )


def grad_sync_spec(shape: Sequence[int], param_spec: Sequence[Any], mesh: Any,
                   sync_axes: Sequence[str]) -> Optional[Tuple[Any, ...]]:
    """The spec of a gradient leaf synced by reduce-scatter
    (``train/_overlap.py``), JAX's ``grad_sync_spec``: the leaf sharded over
    ``sync_axes`` on a dim already carrying one of them in ``param_spec``,
    else on its largest free dim; the dim's whole shard count must divide
    its size.  None when the leaf is already sharded over every sync axis,
    when the missing axes hold one device, or when no dim fits (the leaf
    rides the final all-reduce).  ``mesh`` is anything ``logical_to_mesh_spec``
    takes; a spec entry is a mesh axis, a tuple of them, or None."""
    sizes = _axis_sizes(mesh) or {}
    entries = list(param_spec or ())
    entries += [None] * (len(shape) - len(entries))
    norm = [tuple(e) if isinstance(e, (tuple, list)) else ((e,) if e else ()) for e in entries]
    used = {a for e in norm for a in e}
    missing = [a for a in sync_axes if a not in used]
    if not missing:
        return None
    missing_n = 1
    for a in missing:
        missing_n *= sizes.get(a, 1)
    if missing_n <= 1:
        return None

    def dim_ok(d: int, extra: int) -> bool:
        have = 1
        for a in norm[d]:
            have *= sizes.get(a, 1)
        return shape[d] >= have * extra and shape[d] % (have * extra) == 0

    carrier = None
    for d in range(len(shape)):
        if any(a in sync_axes for a in norm[d]) and dim_ok(d, missing_n):
            carrier = d
            break
    if carrier is None:
        free = [d for d in range(len(shape)) if not norm[d] and dim_ok(d, missing_n)]
        if not free:
            return None
        carrier = max(free, key=lambda d: shape[d])
    out = list(norm)
    out[carrier] = out[carrier] + tuple(missing)
    return tuple(e if len(e) > 1 else (e[0] if e else None) for e in out)


class ShardPlan:
    """Where each parameter of a sharded model lives (``shard_model``)."""

    def __init__(self, model: torch.nn.Module, mesh: Any, expert_params: Set[str],
                 tensor_dims: Optional[Dict[str, int]] = None,
                 synced: Sequence[str] = (), sync_group: Any = None) -> None:
        self.mesh = mesh
        self.params: Dict[str, torch.nn.Parameter] = dict(model.named_parameters())
        self.expert_params = expert_params
        self.expert_size = mesh.shape[MeshAxes.EXPERT]
        self.expert_group = mesh.group(MeshAxes.EXPERT) if self.expert_size > 1 else None
        self.expert_rank = mesh.coordinate(MeshAxes.EXPERT)
        # the leaves split over tensor, and the dim of each
        self.tensor_dims: Dict[str, int] = dict(tensor_dims or {})
        self.tensor_size = mesh.shape[MeshAxes.TENSOR]
        self.tensor_group = mesh.group(MeshAxes.TENSOR) if self.tensor_dims else None
        self.tensor_rank = mesh.coordinate(MeshAxes.TENSOR)
        # a pipeline stage: its whole (not FSDP) leaves whose gradients are
        # averaged over ``sync_group``, and the pipe group the norm sums over
        self.pipe_size = mesh.shape[MeshAxes.PIPELINE]
        self.pipe_group = mesh.group(MeshAxes.PIPELINE) if self.pipe_size > 1 else None
        self.synced = [k for k in synced if k in self.params]
        self.sync_group = sync_group
        # FSDP2's units as shard_model made them: (their leaves, whether a
        # step gathers them twice: resharded after the forward, gathered
        # again for the backward), the shard and replicate axes
        self.units: List[Tuple[List[str], bool]] = []
        self.dp_axes: Tuple[List[str], Optional[str]] = ([], None)

    @torch.no_grad()
    def sync_grads(self, params: Dict[str, torch.nn.Parameter]) -> None:
        """Average the gradients of the stage's whole leaves over the ranks
        of its pipe coordinate that read other tokens (FSDP2 averages the
        blocks')."""
        import torch.distributed as tdist

        if self.sync_group is None:
            return
        n = tdist.get_world_size(self.sync_group)
        for k in self.synced:
            g = params[k].grad
            if g is not None:
                tdist.all_reduce(g, group=self.sync_group)
                g.div_(n)

    @staticmethod
    def local(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each DTensor's local shard (a view of its storage), others as
        they are."""
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            return {k: v.to_local() if isinstance(v, DTensor) else v for k, v in tree.items()}

    def _shard_group(self, name: str) -> Any:
        """The process group a parameter's shards span (None: unsharded)."""
        from torch.distributed.tensor import DTensor, Shard

        p = self.params[name]
        if not isinstance(p, DTensor):
            return None
        dims = [i for i, pl in enumerate(p.placements) if isinstance(pl, Shard)]
        if not dims or p.device_mesh.size(dims[0]) == 1:
            return None
        return p.device_mesh.get_group(dims[0])

    @torch.no_grad()
    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The f32 global norm of the local gradient shards ``grads``: the
        sum of squares over every leaf's FSDP shards, then over the expert
        group for the expert leaves and over the tensor group for the
        tensor-split leaves (a replicated leaf is the same on every rank of
        those groups and counts once), then over the pipe group (each stage
        holds other leaves)."""
        import torch.distributed as tdist

        first = next(iter(grads.values()))
        # rows: FSDP-sharded, whole on this rank; columns: [replicated,
        # expert, tensor]
        sq = torch.zeros(2, 3, dtype=torch.float32, device=first.device)
        group = None
        for k, g in grads.items():
            cat = 1 if k in self.expert_params else 2 if k in self.tensor_dims else 0
            shard_group = self._shard_group(k)
            group = group or shard_group
            sq[0 if shard_group is not None else 1, cat] += g.float().square().sum()
        if group is not None:
            part = sq[0].clone()
            tdist.all_reduce(part, group=group)
            sq[0] = part
        sq = sq.sum(dim=0)
        for i, split_over in ((1, self.expert_group), (2, self.tensor_group)):
            if split_over is not None:
                part = sq[i:i + 1].clone()
                tdist.all_reduce(part, group=split_over)
                sq[i:i + 1] = part
        total = sq.sum()
        if self.pipe_group is not None:
            tdist.all_reduce(total, group=self.pipe_group)
        return torch.sqrt(total)

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a parameter-shaped leaf (the parameter, or a
        moment kept beside its shard) from this rank's shard ``local``:
        FSDP shards gathered, then expert slices in expert order, then
        tensor slices in tensor order along their dim.  A collective:
        every rank calls it, leaf for leaf."""
        import torch.distributed as tdist
        from torch.distributed.tensor import DTensor

        p = self.params[name]
        t = local
        if isinstance(p, DTensor):
            t = DTensor.from_local(
                local.contiguous(), p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride(),
            ).full_tensor()
        if name in self.expert_params and self.expert_group is not None:
            parts = [torch.empty_like(t) for _ in range(self.expert_size)]
            tdist.all_gather(parts, t.contiguous(), group=self.expert_group)
            t = torch.cat(parts, dim=0)
        if name in self.tensor_dims:
            parts = [torch.empty_like(t) for _ in range(self.tensor_size)]
            tdist.all_gather(parts, t.contiguous(), group=self.tensor_group)
            t = torch.cat(parts, dim=self.tensor_dims[name])
        return t

    def full_shape(self, name: str) -> Tuple[int, ...]:
        """The whole shape of a parameter-shaped leaf: its FSDP2 global
        shape with the expert and tensor splits undone."""
        shape = list(self.params[name].shape)
        if name in self.expert_params and self.expert_group is not None:
            shape[0] *= self.expert_size
        if name in self.tensor_dims:
            shape[self.tensor_dims[name]] *= self.tensor_size
        return tuple(shape)

    def box(self, name: str, shape: Optional[Sequence[int]] = None) -> Box:
        """The part of the whole leaf ``name`` (of ``shape``, by default
        ``full_shape``) that this rank holds: its tensor slice or its
        experts' rows, then its FSDP chunk along each sharded dim."""
        from torch.distributed.tensor import DTensor, Shard

        box: List[Tuple[int, int]] = [(0, int(n)) for n in (shape or self.full_shape(name))]
        if name in self.tensor_dims:
            d = self.tensor_dims[name]
            box[d] = chunk_range(*box[d], self.tensor_size, self.tensor_rank)
        if name in self.expert_params and self.expert_group is not None:
            box[0] = chunk_range(*box[0], self.expert_size, self.expert_rank)
        p = self.params[name]
        if isinstance(p, DTensor):
            for mesh_dim, pl in enumerate(p.placements):
                if isinstance(pl, Shard):
                    box[pl.dim] = chunk_range(*box[pl.dim], p.device_mesh.size(mesh_dim),
                                              p.device_mesh.get_local_rank(mesh_dim))
        return tuple(box)


def dp_axes(sizes: Mapping[str, int],
            hierarchical: bool = False) -> Tuple[List[str], Optional[str]]:
    """FSDP2's shard axes over the batch-like axes (module docstring) and
    its replicate axis, if any.  On a mesh of several slices (``dcn`` over
    1) the shard dim is every batch-like axis, or with ``hierarchical`` the
    slice's own (``data``, ``fsdp``, ``seq``) with ``dcn`` the replicate
    dim: HSDP's reduce-scatter within a slice and all-reduce of the
    fragment across slices, JAX's two-level sync."""
    ici = [a for a in (MeshAxes.FSDP, MeshAxes.SEQUENCE) if sizes[a] > 1]
    if sizes[MeshAxes.DCN] > 1:
        in_slice = [a for a in (MeshAxes.DATA, *ici) if sizes[a] > 1]
        replicate = MeshAxes.DCN if hierarchical and in_slice else None
        return (in_slice if replicate else [MeshAxes.DCN, *in_slice]), replicate
    replicate = MeshAxes.DATA if sizes[MeshAxes.DATA] > 1 and ici else None
    return (ici if replicate else [a for a in (MeshAxes.DATA, *ici) if sizes[a] > 1]
            or [MeshAxes.FSDP]), replicate


def _dp_mesh(mesh: Any, hierarchical: bool = False) -> Tuple[Any, int]:
    """FSDP2's mesh over ``dp_axes`` and the size of its shard dim."""
    sizes = mesh.shape
    shard, replicate = dp_axes(sizes, hierarchical)
    n = 1
    for a in shard:
        n *= sizes[a]
    dm, name = mesh.device_mesh, "_".join(shard)
    if len(shard) > 1:
        flat = dm[tuple(shard)]._flatten(name)
        if replicate is None:
            return flat, n
    return (dm[replicate, name] if replicate else dm[name]), n


def _group_over(mesh: Any, axes: Sequence[str]) -> Any:
    """The process group of this rank's ranks along ``axes`` together
    (None when they hold one rank)."""
    axes = [a for a in axes if mesh.shape[a] > 1]
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.group(axes[0])
    return mesh.device_mesh[tuple(axes)]._flatten("_".join(axes)).get_group()


def shard_model(model: torch.nn.Module, mesh: Any, *, hierarchical: bool = False,
                units: Sequence[Sequence[str]] = ()) -> ShardPlan:
    """Place ``model`` on ``mesh`` in place: its pipe rank's stage over
    ``pipe``, expert parallelism over ``expert``, tensor parallelism over
    ``tensor``, the sequence over ``seq``, then FSDP2 over the batch-like
    axes (module docstring; ``hierarchical`` as ``_dp_mesh``).  ``units``
    are the overlapped sync's buckets (``train/_overlap.py``
    ``fsdp_units``): each list of blocks becomes one FSDP2 unit, one
    reduce-scatter issued when the backward has produced its gradients; the
    other blocks are a unit each and the root takes what is left."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from determined_tpu_torch.models.moe import EXPERT_PARAMS

    sizes = mesh.shape
    check_ported(sizes)
    n_pipe = sizes[MeshAxes.PIPELINE]
    if n_pipe > 1:
        from determined_tpu_torch.parallel.pipeline import PipeGroup

        if not hasattr(model, "shard_pipe"):
            raise ValueError(f"{type(model).__name__} has no pipeline stages (shard_pipe): "
                             "it cannot run on a 'pipe' mesh axis")
        model.shard_pipe(PipeGroup(mesh.group(MeshAxes.PIPELINE), n_pipe,
                                   mesh.coordinate(MeshAxes.PIPELINE)))
    expert_params: Set[str] = set()
    n_exp = sizes[MeshAxes.EXPERT]
    if n_exp > 1:
        group, idx = mesh.group(MeshAxes.EXPERT), mesh.coordinate(MeshAxes.EXPERT)
        for name, mod in model.named_modules():
            if hasattr(mod, "shard_experts"):
                mod.shard_experts(group, n_exp, idx)
                expert_params.update(f"{name}.{p}" if name else p for p in EXPERT_PARAMS)
    tensor_dims: Dict[str, int] = {}
    if sizes[MeshAxes.TENSOR] > 1:
        group, idx = mesh.group(MeshAxes.TENSOR), mesh.coordinate(MeshAxes.TENSOR)
        for name, mod in model.named_modules():
            if hasattr(mod, "shard_tensor"):
                for p, dim in mod.shard_tensor(group, sizes[MeshAxes.TENSOR], idx).items():
                    tensor_dims[f"{name}.{p}" if name else p] = dim
    # every mesh, a seq axis of 1 included ('ring' falls back to
    # whole-sequence attention on a mesh and raises off one)
    group, idx = mesh.group(MeshAxes.SEQUENCE), mesh.coordinate(MeshAxes.SEQUENCE)
    for mod in model.modules():
        if hasattr(mod, "shard_seq"):
            mod.shard_seq(group, sizes[MeshAxes.SEQUENCE], idx)
    b_rank, b_shards = batch_shard(mesh)
    if b_shards > 1 and n_pipe == 1:
        group = batch_group(mesh)
        for mod in model.modules():
            if hasattr(mod, "shard_batch"):
                mod.shard_batch(group, b_shards, b_rank)
    dp_mesh, n_shard = _dp_mesh(mesh, hierarchical)

    def placement(param: torch.nn.Parameter) -> Any:
        return Shard(fsdp_shard_dim(param.shape, n_shard) or 0)

    def leaves(prefixes: Sequence[str]) -> List[str]:
        return [k for k, _ in model.named_parameters()
                if any(k.startswith(p + ".") for p in prefixes)]

    made: List[Tuple[List[str], bool]] = []
    if n_pipe == 1:
        for unit in units:
            mods = [model.get_submodule(name) for name in unit]
            fully_shard(mods if len(mods) > 1 else mods[0], mesh=dp_mesh,
                        shard_placement_fn=placement)
            made.append((leaves(unit), True))
        in_units = {name for unit in units for name in unit}
        for name, blk in getattr(model, "blocks", torch.nn.Module()).named_children():
            if f"blocks.{name}" in in_units:
                continue
            fully_shard(blk, mesh=dp_mesh, shard_placement_fn=placement)
            made.append((leaves([f"blocks.{name}"]), True))
        fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
        # the root is not resharded after its forward: the backward starts
        # with it
        taken = {k for unit, _ in made for k in unit}
        made.append(([k for k, _ in model.named_parameters() if k not in taken], False))
        plan = ShardPlan(model, mesh, expert_params, tensor_dims)
    else:
        # a pipeline stage: FSDP2 on its blocks only, the outer leaves whole
        batch_like = (MeshAxes.DATA, MeshAxes.FSDP, MeshAxes.SEQUENCE)
        sync_group = _group_over(mesh, batch_like)
        in_blocks: Set[str] = set()
        if sync_group is not None:
            for name, blk in model.blocks.named_children():
                fully_shard(blk, mesh=dp_mesh, shard_placement_fn=placement,
                            reshard_after_forward=False)
                made.append((leaves([f"blocks.{name}"]), False))
                in_blocks.update(made[-1][0])
        synced = [k for k, _ in model.named_parameters() if k not in in_blocks]
        plan = ShardPlan(model, mesh, expert_params, tensor_dims, synced, sync_group)
    plan.units = made
    plan.dp_axes = dp_axes(sizes, hierarchical)
    return plan
