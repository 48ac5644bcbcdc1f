"""Overlapped gradient synchronization: the bucket plan and its comm ledger.

Port of ``determined_tpu/train/_overlap.py``.  ``build_plan`` is JAX's: it
walks a model's leaves in the JAX tree's flatten order (sorted names, path
component by path component: ``leaf_order``), gives each leaf of at least
``_MIN_SYNC_BYTES`` a sync spec over the batch axes
(``parallel/sharding.py`` ``grad_sync_spec``), packs the synced leaves into
buckets of at most ``bucket_bytes`` in reverse order (the order the backward
produces them), and counts each hop's ring bytes: ``2 (n - 1) / n`` of the
f32 payload within a slice, and across slices the whole payload when the
sync is flat or the ``1 / n_ici`` fragment when it is hierarchical.  It
returns None when the mesh has no gradient-reduction axis.

Where JAX marks each bucket with a ``custom_vjp`` whose backward pins the
cotangents to a sharded layout (XLA then issues one reduce-scatter a bucket
as the backward produces it, and the optimizer state mirrors the gradient
shardings), the port gives each bucket to FSDP2 as one ``fully_shard``
unit (``fsdp_units``: the blocks the bucket reaches, a list of modules
FSDP2 takes as one group).  FSDP2 reduce-scatters a unit on its own stream
as soon as the backward has produced the unit's gradients, and the
optimizer updates each rank's shards: the same schedule, and the ZeRO layout
of JAX's ``opt_shardings``.  FSDP2 cannot split a block: a block whose
leaves fall in two buckets goes whole to the first, and the leaves outside
the blocks ride the root's reduce-scatter (ROADMAP.md, Queue 3).

``CommModel`` is JAX's ledger model (bytes a step over each link's
bandwidth, bucket k's share hideable behind the backward of the buckets
after it, the cross-slice hop first).  The plan's is JAX's accounting of
its schedule; the ``step.comm`` counters the Trainer emits at each report
come from ``fsdp_comm``, the same model over what the port runs: FSDP2's
units, their all-gathers and reduce-scatters, with the knob on or off.  ``link_bandwidths`` keys its table by
``torch.cuda.get_device_name()``; ``DTPU_COMM_BW_GBPS`` overrides it
(``ici:<GB/s>,dcn:<GB/s>`` or one number for both).  The within-slice link
of an H100 host is NVLink: its figure is the all-reduce bus bandwidth that
``mesh_smoke.py`` part O measures on four H100s.  Slices of one host share
that NVLink, so the cross-slice link has no measured figure: it is
``DTPU_COMM_BW_GBPS``'s or a labelled placeholder.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from determined_tpu_torch.parallel.mesh import MeshAxes
from determined_tpu_torch.parallel.sharding import grad_sync_spec

#: axes a gradient reduction runs over: every batch-carrying axis
SYNC_AXES = MeshAxes.BATCH_AXES

#: batch axes within one slice: the hierarchical sync reduce-scatters over
#: these and crosses ``dcn`` with the fragment
ICI_SYNC_AXES = MeshAxes.ICI_BATCH_AXES

#: leaves below this ride the final all-reduce: a reduce-scatter of a few
#: KiB is launch overhead (norm scales, biases)
_MIN_SYNC_BYTES = 64 * 1024

# Within-slice link bandwidth (bytes/s, the all-reduce bus bandwidth) by
# torch.cuda.get_device_name(), longest prefix first: NVLink's, as
# mesh_smoke.py part O measures it (an NCCL all-reduce of 256 MiB over four
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit: 337.3 GB/s on the
# slowest rank).
ICI_BW_BY_KIND: Dict[str, float] = {
    "NVIDIA H100": 337.3e9,
}
_DEFAULT_BW = 10e9  # unknown device (the CPU's gloo ranks): placeholder, labelled

# Cross-slice bandwidth: no measured figure (slices of one host share its
# NVLink); DTPU_COMM_BW_GBPS sets it.
DCN_BW_BY_KIND: Dict[str, float] = {}
_DEFAULT_DCN_BW = 1e9  # placeholder, labelled


def _parse_bw_env(raw: str) -> Dict[str, float]:
    """Parse ``DTPU_COMM_BW_GBPS``: one number (every link) or the per-link
    form ``ici:90,dcn:12``, in GB/s; anything else raises."""
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    if not parts:
        raise ValueError("DTPU_COMM_BW_GBPS is set but empty")
    out: Dict[str, float] = {}
    if len(parts) == 1 and ":" not in parts[0]:
        try:
            v = float(parts[0])
        except ValueError:
            raise ValueError(
                f"DTPU_COMM_BW_GBPS={raw!r}: expected a number (GB/s) or "
                "per-link 'ici:90,dcn:12'"
            ) from None
        if v <= 0:
            raise ValueError(f"DTPU_COMM_BW_GBPS={raw!r}: bandwidth must be > 0")
        return {"ici": v * 1e9, "dcn": v * 1e9}
    for part in parts:
        link, sep, val = part.partition(":")
        link = link.strip().lower()
        if not sep or link not in ("ici", "dcn"):
            raise ValueError(
                f"DTPU_COMM_BW_GBPS={raw!r}: bad entry {part!r} "
                "(expected 'ici:<GB/s>' or 'dcn:<GB/s>')"
            )
        if link in out:
            raise ValueError(f"DTPU_COMM_BW_GBPS={raw!r}: duplicate link {link!r}")
        try:
            v = float(val)
        except ValueError:
            raise ValueError(
                f"DTPU_COMM_BW_GBPS={raw!r}: {val!r} is not a number (GB/s)"
            ) from None
        if v <= 0:
            raise ValueError(f"DTPU_COMM_BW_GBPS={raw!r}: bandwidth must be > 0")
        out[link] = v * 1e9
    return out


def _table_bw(device_kind: str, table: Mapping[str, float], default: float) -> float:
    for prefix in sorted(table, key=len, reverse=True):
        if device_kind.startswith(prefix):
            return table[prefix]
    return default


def link_bandwidths(device_kind: str) -> Tuple[float, float]:
    """(within-slice, cross-slice) bandwidth in bytes/s for the comm model,
    ``DTPU_COMM_BW_GBPS`` over the tables."""
    env = os.environ.get("DTPU_COMM_BW_GBPS")
    override = _parse_bw_env(env) if env else {}
    ici = override.get("ici") or _table_bw(device_kind, ICI_BW_BY_KIND, _DEFAULT_BW)
    dcn = override.get("dcn") or _table_bw(device_kind, DCN_BW_BY_KIND, _DEFAULT_DCN_BW)
    return ici, dcn


@dataclasses.dataclass(frozen=True)
class CommModel:
    """The bucket schedule's exposure model for the ``step.comm`` rows: a
    within-slice hop and, on several slices, a cross-slice one."""

    bytes_per_step: int      # within-slice ring bytes a step
    n_buckets: int           # 1: one reduction at the end of the backward
    bandwidth: float         # within-slice bytes/s
    bwd_frac: float = 0.6    # share of a step that is backward compute
    dcn_bytes_per_step: int = 0   # cross-slice ring bytes a step
    dcn_bandwidth: float = _DEFAULT_DCN_BW

    def split_hops(self, avg_step_s: float) -> Dict[str, Tuple[float, float]]:
        """``{hop: (exposed_s, hidden_s)}`` a step: with one bucket all is
        exposed; with B buckets up to (B - 1) / B of each hop hides behind
        the backward still to run, bounded by the backward's time, the
        cross-slice hop first."""
        ici_s = self.bytes_per_step / max(self.bandwidth, 1.0)
        dcn_s = self.dcn_bytes_per_step / max(self.dcn_bandwidth, 1.0)
        if self.n_buckets <= 1:
            return {"ici": (ici_s, 0.0), "dcn": (dcn_s, 0.0)}
        frac = (self.n_buckets - 1) / self.n_buckets
        budget = max(avg_step_s, 0.0) * self.bwd_frac
        out: Dict[str, Tuple[float, float]] = {}
        for hop, comm_s in (("dcn", dcn_s), ("ici", ici_s)):
            hidden = min(comm_s * frac, budget)
            budget -= hidden
            out[hop] = (comm_s - hidden, hidden)
        return out

    def split(self, avg_step_s: float) -> Tuple[float, float]:
        """(exposed_s, hidden_s) a step, both hops summed."""
        hops = self.split_hops(avg_step_s)
        return sum(e for e, _ in hops.values()), sum(h for _, h in hops.values())

    @property
    def total_bytes_per_step(self) -> int:
        return self.bytes_per_step + self.dcn_bytes_per_step


@dataclasses.dataclass
class GradSyncPlan:
    """A model's overlapped-sync plan: its leaves in the JAX flatten order,
    each one's sync spec (None: not synced by a bucket), the buckets (leaf
    indices in reverse order), the comm model."""

    enabled: bool
    names: List[str]
    shapes: List[Tuple[int, ...]]
    sync_specs: List[Optional[Tuple[Any, ...]]]
    buckets: List[Tuple[int, ...]]
    comm: CommModel
    synced_leaves: int
    # the two-level sync's dcn size (0: flat)
    hierarchical_dcn: int = 0

    def bucket_names(self) -> List[List[str]]:
        return [[self.names[i] for i in b] for b in self.buckets]

    def bucket_bytes(self) -> List[int]:
        """Each bucket's f32 gradient payload."""
        return [sum(4 * math.prod(self.shapes[i]) for i in b) for b in self.buckets]

    def fingerprint(self) -> str:
        """JAX's plan fingerprint: what changes the collective structure."""
        if not self.enabled:
            return "overlap:off"
        hier = f":hier=dcn{self.hierarchical_dcn}" if self.hierarchical_dcn > 1 else ":flat"
        return f"overlap:on:buckets={len(self.buckets)}:synced={self.synced_leaves}{hier}"


def sync_axis_size(mesh: Any) -> int:
    """The devices a gradient is reduced over: the batch axes' product."""
    shape = dict(getattr(mesh, "shape", mesh))
    n = 1
    for a in SYNC_AXES:
        n *= int(shape.get(a, 1))
    return n


def leaf_order(names: Sequence[str]) -> List[str]:
    """``names`` in the flatten order of the JAX package's param tree: its
    dicts' sorted keys, level by level, which the port's dotted names
    follow component by component (``blocks.3`` ~ ``block_3``, ``embed``,
    ``lm_head``, ``ln_f``)."""
    return sorted(names, key=lambda n: n.split("."))


def build_plan(
    leaves: Sequence[Tuple[str, Sequence[int], Sequence[Any]]],
    mesh: Any,
    *,
    enabled: bool,
    bucket_bytes: int = 4 * 1024 * 1024,
    min_sync_bytes: int = _MIN_SYNC_BYTES,
    hierarchical: bool = False,
    device_kind: str = "",
) -> Optional[GradSyncPlan]:
    """The plan over ``leaves`` (``(name, whole shape, param spec)`` in the
    JAX flatten order) on ``mesh`` (a ``Mesh``, ``MeshConfig`` or axis
    dict); None when the mesh has no gradient-reduction axis.

    ``hierarchical`` (``optimizations.hierarchical_collectives``) on a mesh
    of several slices with more than one device a slice syncs within the
    slice first and crosses ``dcn`` with the ``1 / n_ici`` fragment; else
    the sync is flat and the whole payload crosses."""
    shape = dict(getattr(mesh, "shape", mesh))
    n_sync = sync_axis_size(shape)
    if n_sync <= 1:
        return None
    n_dcn = int(shape.get(MeshAxes.DCN, 1))
    n_ici = max(1, n_sync // max(1, n_dcn))
    hier = bool(hierarchical) and n_dcn > 1 and n_ici > 1
    sync_axes = ICI_SYNC_AXES if hier else SYNC_AXES
    grad_itemsize = 4  # gradients reduce in f32
    names, shapes, specs = [], [], []
    ici_bytes = dcn_bytes = 0
    for name, leaf_shape, spec in leaves:
        leaf_shape = tuple(int(d) for d in leaf_shape)
        nbytes = math.prod(leaf_shape) * grad_itemsize
        ici_bytes += int(2 * (n_ici - 1) / n_ici * nbytes)
        if n_dcn > 1:
            dcn_payload = nbytes // n_ici if hier else nbytes
            dcn_bytes += int(2 * (n_dcn - 1) / n_dcn * dcn_payload)
        sync = None
        if enabled and nbytes >= min_sync_bytes:
            sync = grad_sync_spec(leaf_shape, spec, shape, sync_axes)
        names.append(name)
        shapes.append(leaf_shape)
        specs.append(sync)
    # buckets in reverse flatten order: the backward produces the last
    # used leaves' gradients first
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(names))):
        if specs[i] is None:
            continue
        nbytes = math.prod(shapes[i]) * grad_itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
    ici_bw, dcn_bw = link_bandwidths(device_kind)
    comm = CommModel(
        bytes_per_step=ici_bytes, n_buckets=len(buckets) if enabled else 1,
        bandwidth=ici_bw, dcn_bytes_per_step=dcn_bytes, dcn_bandwidth=dcn_bw,
    )
    return GradSyncPlan(
        enabled=enabled, names=names, shapes=shapes, sync_specs=specs, buckets=buckets,
        comm=comm, synced_leaves=sum(1 for s in specs if s is not None),
        hierarchical_dcn=n_dcn if hier else 0,
    )


def fsdp_units(plan: GradSyncPlan, model: Any) -> List[List[str]]:
    """FSDP2's units for the plan's buckets: the model's blocks that each
    bucket reaches, in the bucket's order, a block whose leaves span
    buckets in the first of them; a bucket that reaches no block not taken
    yet gives no unit.  A unit is whole blocks because FSDP2 gathers a
    unit's params in its modules' forward hooks, and the LM reads the
    embedding, the head and its projections' weights outside their own
    modules' forward; the leaves outside the blocks ride the root's
    reduce-scatter (ROADMAP.md, Queue 3)."""
    blocks = [f"blocks.{name}" for name, _ in getattr(model, "blocks", {}).named_children()]
    taken: set = set()
    units: List[List[str]] = []
    for bucket in plan.bucket_names():
        unit: List[str] = []
        for name in bucket:
            owner = next((b for b in blocks if name.startswith(b + ".")), None)
            if owner is not None and owner not in taken:
                taken.add(owner)
                unit.append(owner)
        if unit:
            units.append(unit)
    return units


def fsdp_comm(shard_plan: Any, device_kind: str = "") -> Optional[CommModel]:
    """The comm model of what the port runs (``step.comm``'s counters):
    FSDP2's units as ``shard_model`` made them (``ShardPlan.units``),
    whatever the knob, rather than JAX's schedule.  A step all-gathers a
    unit's params over the shard group once, or twice when it is
    resharded after the forward, and reduce-scatters its gradients there
    ((n - 1) / n of the bytes each); HSDP all-reduces the fragment over
    the replicate group, and a pipeline stage its whole leaves over its
    batch group.  A group that spans ``dcn`` is the cross-slice hop (a ring
    is as fast as its slowest link), one within a slice the other.  Each
    unit but the last is one bucket the backward can hide.  None when
    nothing is reduced."""
    sizes = dict(shard_plan.mesh.shape)
    shard, replicate = shard_plan.dp_axes
    n_shard = math.prod(int(sizes.get(a, 1)) for a in shard)
    n_rep = int(sizes.get(replicate, 1)) if replicate else 1
    params = shard_plan.params
    hop = {"ici": 0, "dcn": 0}
    shard_hop = "dcn" if MeshAxes.DCN in shard else "ici"
    for names, twice in shard_plan.units:
        nbytes = sum(params[k].numel() * params[k].element_size() for k in names)
        hop[shard_hop] += int((n_shard - 1) / n_shard * nbytes * (3 if twice else 2))
        hop["dcn" if replicate == MeshAxes.DCN else "ici"] += int(
            2 * (n_rep - 1) / n_rep * nbytes / n_shard)
    n_units = len(shard_plan.units)
    if shard_plan.sync_group is not None and shard_plan.synced:
        nbytes = sum(params[k].numel() * params[k].element_size() for k in shard_plan.synced)
        n = math.prod(int(sizes.get(a, 1)) for a in (MeshAxes.DATA, MeshAxes.FSDP,
                                                     MeshAxes.SEQUENCE))
        hop["ici"] += int(2 * (n - 1) / n * nbytes)
        n_units += 1
    if not hop["ici"] and not hop["dcn"]:
        return None
    ici_bw, dcn_bw = link_bandwidths(device_kind)
    return CommModel(bytes_per_step=hop["ici"], n_buckets=max(n_units, 1), bandwidth=ici_bw,
                     dcn_bytes_per_step=hop["dcn"], dcn_bandwidth=dcn_bw)


def model_leaves(model: Any) -> List[Tuple[str, Tuple[int, ...], Tuple]]:
    """``build_plan``'s leaves for a whole (unsharded) model: each
    parameter's name, shape and an empty param spec, in the JAX flatten
    order.  The JAX LM's params carry no fsdp, data or dcn axis (its
    logical rules put them on tensor and expert only), so the sync specs
    are JAX's; a model that the JAX Trainer auto-shards over fsdp gets
    buckets here where JAX's plan skips the leaves already sharded (ROADMAP.md,
    Queue 3)."""
    params = dict(model.named_parameters())
    return [(name, tuple(params[name].shape), ()) for name in leaf_order(list(params))]
