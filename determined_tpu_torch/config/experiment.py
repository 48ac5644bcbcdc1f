"""Experiment configuration: a copy of ``determined_tpu/config/experiment.py``.

Typed dataclasses with explicit validation are both the schema and the
parser of the versioned experiment YAML, section by section, as in the JAX
package; the same YAML gives the same fields in both.  ``resources.mesh`` is
this module's own ``MeshConfig``: the axis sizes and the one ``-1``
wildcard, resolved against the world size by ``train.init`` (the Trainer
runs every axis but ``dcn``).  ``pipeline_problems`` is the pipeline part of
the JAX ``preflight_experiment_config``.  ``yaml`` is imported only
where a file or a YAML string is read.  ``lint.suppress`` must name rule ids
of the JAX package's lint registry (``LINT_RULE_IDS``, this module's own copy
of the ids: the lint package itself is not ported).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.config.hyperparameters import parse_hyperparameters


class InvalidExperimentConfig(ValueError):
    pass


#: quantized-matmul modes
QUANT_MODES = ("none", "int8", "fp8")

#: pipeline microbatch schedules
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism topology of one trial: the axis sizes of
    ``determined_tpu/parallel/mesh.py``'s ``MeshConfig``.  A size of -1 for
    exactly one axis means "absorb all remaining devices"; ``num_slices``
    multiplies on top.  ``parallel/mesh.py`` builds the device mesh from
    it (``make_mesh``)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    num_slices: int = 1

    def sizes(self) -> Tuple[int, ...]:
        """Per-slice axis sizes; ``num_slices`` multiplies on top."""
        return (self.data, self.fsdp, self.tensor, self.seq, self.expert, self.pipe)

    def axes(self) -> Dict[str, int]:
        """The axis dict, ``num_slices`` included."""
        return dataclasses.asdict(self)

    @property
    def num_devices(self) -> int:
        n = max(1, self.num_slices)
        for s in self.sizes():
            if s != -1:
                n *= s
        return n

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size under the JAX mesh's names (``dcn`` is
        ``num_slices``), what ``parallel.sharding`` reads."""
        return {
            "dcn": self.num_slices, "data": self.data, "fsdp": self.fsdp,
            "tensor": self.tensor, "seq": self.seq, "expert": self.expert, "pipe": self.pipe,
        }

    def resolve(self, total_devices: int) -> "MeshConfig":
        """Fill in a single -1 axis from the total device count."""
        if self.num_slices < 1:
            raise ValueError("num_slices must be >= 1 (it is never a wildcard)")
        sizes = list(self.sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wild:
            fixed = self.num_slices * math.prod(s for s in sizes if s != -1)
            if total_devices % fixed:
                raise ValueError(
                    f"{total_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = total_devices // fixed
        resolved = MeshConfig(*sizes, num_slices=self.num_slices)
        if resolved.num_devices != total_devices:
            raise ValueError(
                f"mesh {resolved.sizes()} x {resolved.num_slices} slice(s) needs "
                f"{resolved.num_devices} devices, got {total_devices}"
            )
        return resolved


_LENGTH_UNITS = ("batches", "epochs", "records")


@dataclasses.dataclass(frozen=True)
class Length:
    """Training length in batches/epochs/records — reference TrainUnit
    (``harness/determined/pytorch/_trainer_utils.py:9-151``)."""

    units: int
    unit: str = "batches"

    def __post_init__(self):
        if self.unit not in _LENGTH_UNITS:
            raise InvalidExperimentConfig(f"length unit {self.unit!r} not in {_LENGTH_UNITS}")
        if self.units < 0:
            raise InvalidExperimentConfig(f"length must be >= 0, got {self.units}")

    @classmethod
    def parse(cls, raw: Any, default_unit: str = "batches") -> "Length":
        if isinstance(raw, Length):
            return raw
        if isinstance(raw, int):
            return cls(raw, default_unit)
        if isinstance(raw, dict):
            if len(raw) != 1:
                raise InvalidExperimentConfig(f"length must have one key, got {raw}")
            (unit, units), = raw.items()
            return cls(int(units), unit)
        raise InvalidExperimentConfig(f"cannot parse length {raw!r}")

    @classmethod
    def batches(cls, n: int) -> "Length":
        return cls(n, "batches")

    @classmethod
    def epochs(cls, n: int) -> "Length":
        return cls(n, "epochs")

    @classmethod
    def records(cls, n: int) -> "Length":
        return cls(n, "records")


def clone_extended_length(max_length: Length, inherited_steps: int,
                          logger: Any = None, context: str = "") -> Length:
    """A clone-resumed trial's budget is ``max_length`` BEYOND the steps
    inherited from its source checkpoint: the trainer's step horizon is
    absolute and the restored state already carries the parent's count
    (``experiment/local.py``; the JAX package's cluster harness applies the
    same rule).  Only batch budgets extend; others stay absolute with a
    warning."""
    if not inherited_steps or inherited_steps <= 0:
        return max_length
    if max_length.unit != "batches":
        if logger is not None:
            logger.warning(
                "%sclone budget extension needs a batches max_length; "
                "%s budget left absolute", context, max_length.unit,
            )
        return max_length
    return Length.batches(max_length.units + int(inherited_steps))


@dataclasses.dataclass(frozen=True)
class SearcherConfig:
    """Searcher section — reference ``schemas/expconf/v0/searcher.json``.

    name: single | random | grid | asha | adaptive_asha | hyperband | pbt |
    driver

    ``driver`` is execution-only: the search loop lives in a remote
    cluster-experiment driver (``experiment/cluster.py``), which submits
    each trial it creates to the master; a driver config never builds a
    local SearchMethod.
    """

    name: str = "single"
    metric: str = "validation_loss"
    smaller_is_better: bool = True
    max_trials: int = 1
    max_length: Optional[Length] = None          # per-trial budget
    max_concurrent_trials: int = 16
    # ASHA knobs (reference asha_stopping.go / adaptive_asha.go); divisor
    # doubles as hyperband's eta
    num_rungs: int = 5
    divisor: int = 4
    mode: str = "standard"                        # conservative|standard|aggressive
    max_time: Optional[int] = None                # asha/hyperband max units per trial
    time_metric: Optional[str] = None
    bracket_rungs: Optional[List[int]] = None
    source_trial_id: Optional[int] = None
    # PBT knobs (Jaderberg et al.; searcher/_pbt.py).  One generation's
    # training budget is max_length — the same per-trial budget knob every
    # other method uses.
    population_size: Optional[int] = None         # default: max_trials
    num_generations: int = 4
    truncate_fraction: float = 0.25
    perturb_factor: float = 1.2
    resample_probability: float = 0.25

    _NAMES = ("single", "random", "grid", "asha", "adaptive_asha",
              "hyperband", "pbt", "driver")

    def __post_init__(self):
        if self.name not in self._NAMES:
            raise InvalidExperimentConfig(f"unknown searcher {self.name!r}")
        if self.mode not in ("conservative", "standard", "aggressive"):
            raise InvalidExperimentConfig(f"unknown adaptive mode {self.mode!r}")
        if self.max_trials < 1:
            raise InvalidExperimentConfig("searcher.max_trials must be >= 1")
        if self.population_size is not None and self.population_size < 1:
            raise InvalidExperimentConfig("searcher.population_size must be >= 1")
        if self.num_generations < 1:
            raise InvalidExperimentConfig("searcher.num_generations must be >= 1")
        if not 0.0 <= self.truncate_fraction <= 0.5:
            raise InvalidExperimentConfig(
                "searcher.truncate_fraction must be in [0, 0.5]"
            )
        if self.perturb_factor <= 1.0:
            raise InvalidExperimentConfig("searcher.perturb_factor must be > 1")
        if not 0.0 <= self.resample_probability <= 1.0:
            raise InvalidExperimentConfig(
                "searcher.resample_probability must be in [0, 1]"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "SearcherConfig":
        raw = dict(raw or {})
        if "max_length" in raw and raw["max_length"] is not None:
            raw["max_length"] = Length.parse(raw["max_length"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown searcher fields: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic gang policy (``docs/cluster.md`` "Elastic gang training").

    The master may resize the trial's gang at runtime between a floor and
    the configured full size: slice/agent loss shrinks it (a capacity
    event — ``max_restarts`` is never spent), and stable returning
    capacity grows it back, slice-quantum aligned, through WAL-journaled
    checkpoint-restore-reshard transitions.  ``max_slots`` is the gang's
    full size — the wildcard mesh axis absorbs whatever width the master
    actually placed (``DTPU_ELASTIC_SLOTS``).  The floor is ``min_slots``
    (chips) or ``min_slices`` (topology slices, resolved against the live
    slice size at schedule time); ``resize_cooldown_s`` + a >= 1 slice
    minimum-gain gate stop a flapping agent from thrashing the trial
    through restore loops.  Requires a wildcard (-1) mesh axis so the
    restored mesh can absorb the new device count.
    """

    max_slots: int = 1
    min_slots: Optional[int] = None
    min_slices: Optional[int] = None
    resize_cooldown_s: int = 60

    def __post_init__(self):
        if self.max_slots < 1:
            raise InvalidExperimentConfig("elastic.max_slots must be >= 1")
        if self.min_slots is not None and self.min_slots > self.max_slots:
            raise InvalidExperimentConfig(
                f"elastic.min_slots={self.min_slots} exceeds "
                f"max_slots={self.max_slots}"
            )
        if self.min_slots is not None and self.min_slots < 1:
            raise InvalidExperimentConfig("elastic.min_slots must be >= 1")
        if self.min_slices is not None and self.min_slices < 1:
            raise InvalidExperimentConfig("elastic.min_slices must be >= 1")
        if self.resize_cooldown_s < 0:
            raise InvalidExperimentConfig(
                "elastic.resize_cooldown_s must be >= 0"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "ElasticConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(
                f"unknown elastic fields: {sorted(unknown)}"
            )
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class ResourcesConfig:
    """Resources — replaces reference ``slots_per_trial`` with a mesh.

    ``mesh`` axes multiply to the chip count of the trial; ``slots_per_trial``
    is still accepted as sugar for ``mesh: {data: N}``.
    """

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    resource_pool: str = "default"
    priority: int = 42                            # reference default priority
    weight: float = 1.0                           # fair-share weight
    single_slice: bool = False                    # refuse DCN-spanning gang splits
    elastic: Optional[ElasticConfig] = None       # resizable-gang policy

    def __post_init__(self):
        if self.elastic is not None and -1 not in self.mesh.sizes():
            raise InvalidExperimentConfig(
                "resources.elastic requires a wildcard (-1) mesh axis: a "
                "resize changes the device count, and a fully pinned mesh "
                "cannot absorb it (e.g. mesh: {data: -1})"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "ResourcesConfig":
        raw = dict(raw or {})
        slots = raw.pop("slots_per_trial", None)
        elastic_raw = raw.pop("elastic", None)
        if elastic_raw is not None:
            raw["elastic"] = ElasticConfig.parse(elastic_raw)
        mesh_raw = raw.pop("mesh", None)
        if mesh_raw is not None and slots is not None:
            raise InvalidExperimentConfig(
                "resources.slots_per_trial and resources.mesh are mutually exclusive"
            )
        if mesh_raw is not None:
            try:
                mesh = MeshConfig(**mesh_raw)
            except TypeError:
                known_axes = [f.name for f in dataclasses.fields(MeshConfig)]
                raise InvalidExperimentConfig(
                    f"unknown mesh axes {sorted(set(mesh_raw) - set(known_axes))}; "
                    f"valid axes: {known_axes}"
                ) from None
        elif slots is not None:
            mesh = MeshConfig(data=int(slots))
        else:
            mesh = MeshConfig()
        known = {f.name for f in dataclasses.fields(cls)} - {"mesh"}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown resources fields: {sorted(unknown)}")
        return cls(mesh=mesh, **raw)

    @property
    def slots_per_trial(self) -> int:
        # elastic gangs size by their policy ceiling: the wildcard mesh
        # axis makes the axis product meaningless as a gang size
        if self.elastic is not None:
            return self.elastic.max_slots
        return self.mesh.num_devices


@dataclasses.dataclass(frozen=True)
class CheckpointStorageConfig:
    """Checkpoint storage — reference ``schemas/expconf/v0/checkpoint-storage.json``.

    type: shared_fs | directory | s3 | gcs | azure
    """

    type: str = "shared_fs"
    host_path: Optional[str] = None               # shared_fs
    storage_path: Optional[str] = None
    container_path: Optional[str] = None          # directory
    bucket: Optional[str] = None                  # s3/gcs
    prefix: Optional[str] = None
    save_experiment_best: int = 0
    save_trial_best: int = 1
    save_trial_latest: int = 1

    def to_url(self) -> str:
        if self.type in ("shared_fs", "directory"):
            base = self.host_path or self.container_path or "/tmp/determined_tpu/checkpoints"
            if self.storage_path:
                base = f"{base.rstrip('/')}/{self.storage_path}"
            return base
        if self.type in ("s3", "gcs"):
            if not self.bucket:
                raise InvalidExperimentConfig(f"{self.type} storage requires `bucket`")
            url = f"{self.type}://{self.bucket}"
            if self.prefix:
                url += f"/{self.prefix}"
            return url
        raise InvalidExperimentConfig(f"unknown checkpoint storage type {self.type!r}")

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "CheckpointStorageConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown checkpoint_storage fields: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class ReproducibilityConfig:
    experiment_seed: int = 0


@dataclasses.dataclass(frozen=True)
class OptimizationsConfig:
    """Gradient accumulation — reference ``optimizations.aggregation_frequency``
    (``_pytorch_context.py:708-914``).  Each optimizer step consumes
    ``aggregation_frequency`` microbatches of ``global_batch_size`` via an
    on-device ``lax.scan`` (no host round-trips between microbatches)."""

    aggregation_frequency: int = 1
    average_aggregated_gradients: bool = True
    # Overlapped checkpointing (on by default — a beat-the-reference item,
    # SURVEY §7(b)): array serialization runs on a background thread while
    # training continues; the collective finalize lands at the next save,
    # preemption, or exit.  False restores fully synchronous saves.
    async_checkpointing: bool = True
    # Overlapped input pipeline (docs/input-pipeline.md).  prefetch_depth:
    # how many host batches the background fetch worker may run ahead of
    # the trainer (0 = fetch synchronously on the main thread, the
    # reference DataLoader's num_workers=0 analog).  device_prefetch: how
    # many batches to hold on-device ahead of the step (2 = double
    # buffering; <=1 = synchronous host->device transfer).  fetch_workers:
    # thread-pool width for per-item map-style dataset reads (0 = the
    # sequential loop; irrelevant for InMemoryDataset's columnar gather).
    prefetch_depth: int = 2
    device_prefetch: int = 2
    fetch_workers: int = 0
    # Persistent XLA compilation cache directory (also DTPU_COMPILATION_CACHE
    # env): a supervised restart after a crash re-jits from disk instead of
    # paying the full compile.  None disables.
    compilation_cache_dir: Optional[str] = None
    # Cross-trial jit-reuse cache (train/_jit_cache.py): same-architecture
    # trials in one process share compiled train/eval steps instead of
    # re-tracing identical programs.  In-process complement of the
    # persistent cache above (which covers cross-process reuse).
    jit_cache: bool = True
    # Overlapped gradient synchronization (train/_overlap.py, docs/
    # performance.md): partition the grad pytree into size-bounded buckets
    # and stage each bucket's reduce-scatter at its production point in
    # the backward pass (custom_vjp markers + sharding constraints), with
    # the optimizer consuming SHARDED grads/state and params all-gathered
    # after the update — XLA's latency-hiding scheduler then interleaves
    # the collectives with remaining backward compute instead of exposing
    # one end-of-backward reduction.  Off by default; numerically
    # equivalent to the baseline reduction (tests pin allclose after N
    # steps).  overlap_bucket_mb bounds one bucket's payload.
    overlap_grad_sync: bool = False
    overlap_bucket_mb: int = 4
    # Hierarchical ICI/DCN collectives (train/_overlap.py, docs/
    # performance.md "Multi-slice"): on a multi-slice mesh
    # (resources.mesh.num_slices > 1) restructure each bucket's gradient
    # sync into reduce-scatter over the intra-slice ICI axes, cross-slice
    # all-reduce over ``dcn`` carrying only the 1/N_ici sharded fragment,
    # and a closing all-gather within the slice — instead of the flat
    # treatment that rings full-gradient payload across the slow DCN
    # links.  Requires overlap_grad_sync (it reshapes the bucket sync
    # shardings); inert on a single-slice mesh.
    hierarchical_collectives: bool = False
    # Quantized matmul arithmetic (train/_quant.py): route the
    # transformer's dense/attention projection matmuls through int8 (or
    # fp8 where the platform supports it) with per-channel dynamic
    # scaling.  Master weights and optimizer state stay fp32; backward
    # runs in full precision (straight-through).  fp8 on an unsupported
    # platform is rejected at trainer setup with InvalidExperimentConfig.
    quantized_matmul: str = "none"
    # Pipeline microbatch schedule on the ``pipe`` mesh axis
    # (parallel/pipeline.py, docs/performance.md "Pipeline schedules"):
    # ``gpipe`` is the plain M+P-1 drain; ``1f1b`` keeps the same bubble
    # but caps live activations at P microbatches instead of M (custom
    # combined fwd/bwd schedule — the memory headroom that buys larger M);
    # ``interleaved`` gives each pipe rank ``virtual_stages`` non-adjacent
    # layer chunks via a circular rotation, shrinking the bubble fraction
    # from (P-1)/(M+P-1) toward (P-1)/(V*M+P-1).  Inert when the mesh has
    # no pipe axis (except interleaved, which requires one).
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1

    _QUANT_MODES = QUANT_MODES

    def __post_init__(self):
        if self.aggregation_frequency < 1:
            raise InvalidExperimentConfig(
                "optimizations.aggregation_frequency must be >= 1"
            )
        for knob in ("prefetch_depth", "device_prefetch", "fetch_workers"):
            if getattr(self, knob) < 0:
                raise InvalidExperimentConfig(f"optimizations.{knob} must be >= 0")
        if self.overlap_bucket_mb < 1:
            raise InvalidExperimentConfig(
                "optimizations.overlap_bucket_mb must be >= 1"
            )
        if self.quantized_matmul not in self._QUANT_MODES:
            raise InvalidExperimentConfig(
                f"optimizations.quantized_matmul {self.quantized_matmul!r} "
                f"not in {self._QUANT_MODES}"
            )
        if self.pipeline_schedule not in PIPELINE_SCHEDULES:
            raise InvalidExperimentConfig(
                f"optimizations.pipeline_schedule {self.pipeline_schedule!r} "
                f"not in {PIPELINE_SCHEDULES}"
            )
        if self.virtual_stages < 1:
            raise InvalidExperimentConfig(
                f"optimizations.virtual_stages must be >= 1 "
                f"(got {self.virtual_stages})"
            )
        if self.pipeline_schedule == "interleaved" and self.virtual_stages < 2:
            raise InvalidExperimentConfig(
                "optimizations.pipeline_schedule: interleaved needs "
                f"virtual_stages >= 2 (got {self.virtual_stages}); with one "
                "virtual stage it IS gpipe"
            )
        if self.pipeline_schedule != "interleaved" and self.virtual_stages != 1:
            raise InvalidExperimentConfig(
                f"optimizations.virtual_stages={self.virtual_stages} only "
                "applies to pipeline_schedule: interleaved "
                f"(got {self.pipeline_schedule!r})"
            )
        if self.hierarchical_collectives and not self.overlap_grad_sync:
            raise InvalidExperimentConfig(
                "optimizations.hierarchical_collectives requires "
                "overlap_grad_sync: true (the two-level sync is expressed "
                "through the bucketed sync shardings)"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "OptimizationsConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown optimizations fields: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    """Supervised-restart + checkpoint-integrity knobs.

    ``max_restarts`` (top-level, reference expconf) bounds how many
    TRANSIENT failures the trial supervisor absorbs; these fields shape
    the behavior of each restart: exponential backoff (base * 2^restarts,
    capped, jittered so a gang's processes don't stampede the master) and
    whether resume requires a verified integrity manifest.
    """

    restart_backoff_base: float = 1.0     # seconds before the first restart
    restart_backoff_cap: float = 60.0     # ceiling on any single delay
    restart_backoff_jitter: float = 0.25  # +/- fraction applied to the delay
    verify_checkpoints: bool = True       # manifest-verify on resume
    heartbeat_failure_threshold: int = 5  # consecutive misses -> master_unreachable
    # Cluster-driver outage tolerance: how long a trial watcher retries
    # master connection failures / 5xx (capped exponential backoff, the
    # failure-streak pattern) before declaring the trial lost.  Sized to
    # ride out a master crash + restart + journal replay, not a real
    # outage — the master WAL makes restarts re-attachable, so watchers
    # that outwait the restart resume polling as if nothing happened.
    master_unreachable_grace_s: float = 120.0
    # Experiment-level crash recovery (docs/fault-tolerance.md, "Experiment
    # recovery & preemption"): write-ahead journal of searcher snapshots +
    # trial lifecycle under checkpoint_dir/experiment.journal, enabling
    # LocalExperiment.resume() after a driver crash/preemption.
    journal: bool = True
    journal_compact_interval: int = 64    # appends between compactions (0 = never)
    # Graceful preemption: SIGTERM/SIGINT flags every in-flight trial's
    # PreemptContext; the driver waits up to this long for trials to
    # checkpoint-and-exit before journaling final state and exiting
    # "preempted, resumable".
    preempt_drain_seconds: float = 300.0
    # Apply the checkpoint retention policy (exec/gc_checkpoints.py:
    # latest-per-trial + top-k best, parents of kept checkpoints protected)
    # at journal-compaction points.
    gc_on_compaction: bool = True

    def __post_init__(self):
        if self.restart_backoff_base < 0 or self.restart_backoff_cap < 0:
            raise InvalidExperimentConfig("fault_tolerance backoff values must be >= 0")
        if not (0 <= self.restart_backoff_jitter <= 1):
            raise InvalidExperimentConfig(
                "fault_tolerance.restart_backoff_jitter must be in [0, 1]"
            )
        if self.heartbeat_failure_threshold < 1:
            raise InvalidExperimentConfig(
                "fault_tolerance.heartbeat_failure_threshold must be >= 1"
            )
        if self.master_unreachable_grace_s < 0:
            raise InvalidExperimentConfig(
                "fault_tolerance.master_unreachable_grace_s must be >= 0"
            )
        if self.journal_compact_interval < 0:
            raise InvalidExperimentConfig(
                "fault_tolerance.journal_compact_interval must be >= 0"
            )
        if self.preempt_drain_seconds < 0:
            raise InvalidExperimentConfig(
                "fault_tolerance.preempt_drain_seconds must be >= 0"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "FaultToleranceConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown fault_tolerance fields: {sorted(unknown)}")
        return cls(**raw)


#: the rule ids of the lint registry (``determined_tpu/lint/rules``), which
#: ``lint.suppress`` may name; a CPU test holds this tuple to the registry
LINT_RULE_IDS = (
    "block-until-ready",
    "blocking-under-lock",
    "conditional-collective-escape",
    "fake-master-conformance",
    "host-sync",
    "lock-order-cycle",
    "metric-undocumented",
    "mutable-default",
    "python-rng",
    "rank-dependent-collective",
    "rank-guarded-io-missing-barrier",
    "route-unbound",
    "route-undocumented",
    "signal-handler-unsafe",
    "trace-side-effect",
    "traced-control-flow",
    "traced-print",
    "unlocked-shared-state",
    "unordered-iteration-feeding-collective",
    "wal-fuzz-gap",
    "wal-replay-gap",
    "wal-snapshot-gap",
    "wall-clock",
    "wall-clock-divergence",
    "wire-field-unread",
)


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Trial preflight analyzer knobs (``determined_tpu/lint``).

    ``preflight``: run the static AST pass over the trial class before any
    device is allocated (LocalExperiment; the trial supervisor does the
    same before building the Trainer).  Warn-only unless ``strict``, which
    fails the experiment on ANY finding — the cheap way to protect a
    search's TPU-hours from a host-syncing or retrace-prone trial.
    ``retrace_sentinel``: wrap the jitted step functions and warn when one
    logical step compiles more than once (guards the jit-reuse cache's
    throughput win).  ``thread_sentinel``: run the trial under the
    thread-leak checker (warn mode) so leaked prefetch/scheduler workers
    surface in logs.  ``collective_sentinel``: wrap the control-plane
    collective entry points with the collective-sequence sentinel — every
    rank digests its (op, payload-structure) sequence and the digests ride
    the collectives themselves, so a rank that takes a divergent code path
    raises a named ``CollectiveDivergenceError`` at the next exchange
    instead of hanging the gang to the 600 s collective timeout (must be
    on for EVERY rank of a gang or none; the ``DTPU_COLLECTIVE_SENTINEL``
    env is the launch-layer override).  ``suppress``: rule ids disabled
    for this experiment (the per-line ``# dtpu: lint-ok[rule]`` comment is
    preferred — it keeps the audit local).
    """

    preflight: bool = True
    strict: bool = False
    retrace_sentinel: bool = False
    thread_sentinel: bool = False
    collective_sentinel: bool = False
    suppress: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # validate rule ids at parse time: a typo'd suppression silently
        # linting everything would defeat the audit
        suppress = self.suppress
        if suppress is None:  # YAML `suppress:` with no value
            suppress = []
            object.__setattr__(self, "suppress", suppress)
        if isinstance(suppress, str) or not isinstance(suppress, (list, tuple)):
            raise InvalidExperimentConfig(
                f"lint.suppress must be a list of rule ids, got {suppress!r}"
            )
        unknown = set(suppress) - set(LINT_RULE_IDS)
        if unknown:
            raise InvalidExperimentConfig(
                f"lint.suppress names unknown rules: {sorted(unknown)}"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "LintConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown lint fields: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Experiment-wide tracing knobs (``determined_tpu/observability``).

    ``enabled``: record spans/counters from every subsystem (trainer loop,
    prefetch workers, scheduler, journal, checkpoint writers, restarts)
    into per-thread ring buffers — lock-free, non-blocking, <2% step-time
    overhead (the DTPU_BENCH_TRACE A/B).  ``trace_export``: additionally
    stream the events as Chrome trace JSON under
    ``checkpoint_dir/traces/`` (Perfetto-loadable; feeds
    ``dtpu experiment profile``).  ``ring_capacity``: events buffered per
    thread between shipper drains — overflow drops (counted) rather than
    blocking.  ``flush_interval_s``: shipper drain cadence.
    ``max_events``: in-memory event cap for the end-of-run ledger.
    """

    enabled: bool = True
    trace_export: bool = False
    ring_capacity: int = 8192
    flush_interval_s: float = 0.5
    max_events: int = 1_000_000

    def __post_init__(self):
        if self.ring_capacity < 16:
            raise InvalidExperimentConfig(
                "observability.ring_capacity must be >= 16"
            )
        if self.flush_interval_s <= 0:
            raise InvalidExperimentConfig(
                "observability.flush_interval_s must be > 0"
            )
        if self.max_events < 1:
            raise InvalidExperimentConfig("observability.max_events must be >= 1")

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "ObservabilityConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(
                f"unknown observability fields: {sorted(unknown)}"
            )
        return cls(**raw)


_LOG_POLICY_ACTIONS = ("cancel_retries", "exclude_node")


@dataclasses.dataclass(frozen=True)
class LogPolicy:
    """Regex monitor on task logs — reference ``logpattern.go:27-247`` and
    ``expconf log_policies``.  ``cancel_retries``: a later trial failure is
    terminal (no restarts); ``exclude_node``: restarts avoid the agent whose
    logs matched."""

    pattern: str
    action: str
    name: Optional[str] = None

    def __post_init__(self):
        if not self.pattern:
            raise InvalidExperimentConfig("log_policies entries require a `pattern`")
        if self.action not in _LOG_POLICY_ACTIONS:
            raise InvalidExperimentConfig(
                f"log_policies action {self.action!r} not in {_LOG_POLICY_ACTIONS}"
            )
        import re

        try:
            re.compile(self.pattern)
        except re.error as e:
            raise InvalidExperimentConfig(
                f"log_policies pattern {self.pattern!r} is not a valid regex: {e}"
            ) from None

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "LogPolicy":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown log_policies fields: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class RegistryConfig:
    """Model-registry promotion (``docs/registry.md``).

    ``model``: the registry model name this experiment promotes into.
    ``auto_promote``: when the search completes, register the best trial's
    final manifest-verified checkpoint as the model's next version
    (``name@vN``) with lineage back to the trial and experiment — the
    driver's ``on_search_complete`` hook does the registration, so an
    ASHA/PBT search ends with its winner in the registry, ready for
    ``dtpu serve --model name@latest`` and a rolling deploy.  ``labels``
    ride on every version this experiment registers.  A registered
    version's checkpoint is pinned against checkpoint GC (both the
    driver's retention pass and the master's best-k rotation).
    """

    model: Optional[str] = None
    auto_promote: bool = False
    labels: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.auto_promote and not self.model:
            raise InvalidExperimentConfig(
                "registry.auto_promote requires registry.model"
            )
        if self.model is not None:
            if not isinstance(self.model, str) or not self.model:
                raise InvalidExperimentConfig("registry.model must be a string")
            # "@" is the name/version separator in model refs; whitespace
            # and "/" would break the CLI and the master's routes
            bad = set("@/ \t\n")
            if set(self.model) & bad:
                raise InvalidExperimentConfig(
                    f"registry.model {self.model!r} may not contain "
                    "'@', '/', or whitespace"
                )
        if isinstance(self.labels, str) or not isinstance(self.labels, (list, tuple)):
            raise InvalidExperimentConfig(
                f"registry.labels must be a list, got {self.labels!r}"
            )

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "RegistryConfig":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise InvalidExperimentConfig(f"unknown registry fields: {sorted(unknown)}")
        return cls(**raw)


_CHECKPOINT_POLICIES = ("best", "all", "none")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment config — reference ``expconf/v0/experiment.json``."""

    name: str = "unnamed"
    entrypoint: Optional[str] = None
    description: str = ""
    labels: List[str] = dataclasses.field(default_factory=list)
    workspace: str = "Uncategorized"
    project: str = "Uncategorized"
    hyperparameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    searcher: SearcherConfig = dataclasses.field(default_factory=SearcherConfig)
    resources: ResourcesConfig = dataclasses.field(default_factory=ResourcesConfig)
    checkpoint_storage: CheckpointStorageConfig = dataclasses.field(
        default_factory=CheckpointStorageConfig
    )
    checkpoint_policy: str = "best"
    min_validation_period: Optional[Length] = None
    min_checkpoint_period: Optional[Length] = None
    records_per_epoch: int = 0
    max_restarts: int = 5
    fault_tolerance: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig
    )
    lint: LintConfig = dataclasses.field(default_factory=LintConfig)
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    reproducibility: ReproducibilityConfig = dataclasses.field(
        default_factory=ReproducibilityConfig
    )
    optimizations: OptimizationsConfig = dataclasses.field(
        default_factory=OptimizationsConfig
    )
    registry: RegistryConfig = dataclasses.field(default_factory=RegistryConfig)
    environment: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    profiling: Dict[str, Any] = dataclasses.field(default_factory=dict)
    log_policies: List[LogPolicy] = dataclasses.field(default_factory=list)
    unmanaged: bool = False
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.checkpoint_policy not in _CHECKPOINT_POLICIES:
            raise InvalidExperimentConfig(
                f"checkpoint_policy {self.checkpoint_policy!r} not in {_CHECKPOINT_POLICIES}"
            )
        if self.searcher.name == "grid":
            # a grid over a continuous axis without `count` would silently
            # collapse to one point; reject at parse time (master re-checks
            # at submit: master.cpp validate_config)
            from determined_tpu_torch.config.hyperparameters import Double, Log

            def walk(hp: Any, path: str) -> None:
                if isinstance(hp, dict):
                    for k, v in hp.items():
                        walk(v, f"{path}.{k}" if path else str(k))
                elif isinstance(hp, (Double, Log)) and hp.count is None:
                    raise InvalidExperimentConfig(
                        f"grid search over continuous hyperparameter {path!r} "
                        "requires an explicit `count`"
                    )

            walk(self.hyperparameters, "")

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        raw = dict(raw or {})
        # schema versioning (reference: versioned expconf union types):
        # v1 is the only version; an explicit other value is a config from
        # a different era and must fail loudly, not half-parse
        version = raw.pop("version", 1)
        if not (
            isinstance(version, (int, float))
            and not isinstance(version, bool)  # YAML true would == 1
            and version == 1
        ):
            raise InvalidExperimentConfig(
                f"unsupported experiment config version {version!r} (supported: 1)"
            )
        kwargs: Dict[str, Any] = {"raw": dict(raw)}
        if "hyperparameters" in raw:
            kwargs["hyperparameters"] = parse_hyperparameters(raw.pop("hyperparameters"))
        if "searcher" in raw:
            kwargs["searcher"] = SearcherConfig.parse(raw.pop("searcher"))
        if "resources" in raw:
            kwargs["resources"] = ResourcesConfig.parse(raw.pop("resources"))
        if "checkpoint_storage" in raw:
            kwargs["checkpoint_storage"] = CheckpointStorageConfig.parse(
                raw.pop("checkpoint_storage")
            )
        if "reproducibility" in raw:
            kwargs["reproducibility"] = ReproducibilityConfig(**raw.pop("reproducibility"))
        if "optimizations" in raw:
            kwargs["optimizations"] = OptimizationsConfig.parse(raw.pop("optimizations"))
        if "fault_tolerance" in raw:
            kwargs["fault_tolerance"] = FaultToleranceConfig.parse(raw.pop("fault_tolerance"))
        if "registry" in raw:
            kwargs["registry"] = RegistryConfig.parse(raw.pop("registry"))
        if "lint" in raw:
            kwargs["lint"] = LintConfig.parse(raw.pop("lint"))
        if "observability" in raw:
            kwargs["observability"] = ObservabilityConfig.parse(
                raw.pop("observability")
            )
        if "log_policies" in raw:
            policies = raw.pop("log_policies") or []
            if not isinstance(policies, list):
                raise InvalidExperimentConfig("log_policies must be a list")
            kwargs["log_policies"] = [LogPolicy.parse(p) for p in policies]
        for period in ("min_validation_period", "min_checkpoint_period"):
            if raw.get(period) is not None:
                kwargs[period] = Length.parse(raw.pop(period))
        known = {f.name for f in dataclasses.fields(cls)}
        for k in list(raw):
            if k in known and k != "raw":
                kwargs[k] = raw.pop(k)
        if raw:
            raise InvalidExperimentConfig(f"unknown experiment config fields: {sorted(raw)}")
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "ExperimentConfig":
        import yaml

        with open(path) as f:
            return cls.parse(yaml.safe_load(f) or {})

    @classmethod
    def from_yaml_str(cls, text: str) -> "ExperimentConfig":
        import yaml

        return cls.parse(yaml.safe_load(text) or {})

    def with_hyperparameters(self, hparams: Dict[str, Any]) -> "ExperimentConfig":
        """A copy whose hp space is collapsed to concrete Const values
        (what a trial sees after the searcher samples)."""
        const = parse_hyperparameters(hparams)
        return dataclasses.replace(self, hyperparameters=const)


def pipeline_problems(cfg: "ExperimentConfig") -> List[str]:
    """The pipeline checks of the JAX ``preflight_experiment_config``
    (``determined_tpu/config/experiment.py``), with its texts: an
    interleaved schedule without a pipe axis, layers that the chunks do not
    divide, a global batch that ``pipe_microbatches`` does not divide.  Only
    concrete (Const/int) hyperparameters take part."""
    problems: List[str] = []
    opt = cfg.optimizations
    pipe = getattr(cfg.resources.mesh, "pipe", 1)

    def hp_int(name: str) -> Optional[int]:
        v = cfg.hyperparameters.get(name)
        v = getattr(v, "val", v)
        return v if isinstance(v, int) and not isinstance(v, bool) else None

    if opt.pipeline_schedule == "interleaved" and 0 <= pipe <= 1:
        problems.append(
            "optimizations.pipeline_schedule: interleaved needs a "
            f"resources.mesh pipe axis > 1 (mesh pipe={pipe})"
        )
    if pipe > 1:
        chunks = pipe * opt.virtual_stages
        n_layers = hp_int("n_layers")
        if n_layers is not None and n_layers % chunks:
            problems.append(
                f"hyperparameters.n_layers={n_layers} does not divide into "
                f"{chunks} pipeline chunks (pipe={pipe} x "
                f"virtual_stages={opt.virtual_stages}) for "
                f"pipeline_schedule {opt.pipeline_schedule!r}"
            )
        gbs = hp_int("global_batch_size")
        m = hp_int("pipe_microbatches")
        if gbs is not None and m is not None and m > 0 and gbs % m:
            problems.append(
                f"hyperparameters.global_batch_size={gbs} not divisible by "
                f"pipe_microbatches={m}: the pipeline schedule would reject "
                "it at the first step"
            )
    return problems
