"""Checkpoint-GC task body + experiment retention policy: a copy of
``determined_tpu/exec/gc_checkpoints.py``.

The master marks checkpoints deleted and dispatches a ``gc`` work item to
an agent; the agent runs this module (through the port's launcher) with the
work item in ``DTPU_GC_SPEC``, and deletion goes through the same
StorageManager family the trial saved with (``main``).

The retention half (``RetentionPolicy`` / ``plan_retention`` /
``apply_retention``) applies to a LocalExperiment's directory:
keep the newest N checkpoints of every trial plus the latest checkpoint of
the top-k trials by searcher metric, and NEVER delete (a) the
manifest-referenced parent of any kept checkpoint (the verified-resume
fallback needs one step of lineage) or (b) a directory without a manifest,
which may be an upload still in flight.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import sys
from typing import Any, Dict, List, Optional, Set, Tuple

logger = logging.getLogger("determined_tpu_torch.gc")


# -- retention policy --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    keep_trial_latest: int = 1       # newest checkpoints kept per trial
    keep_experiment_best: int = 0    # top-k trials (by metric) keep latest
    smaller_is_better: bool = True

    def __post_init__(self) -> None:
        if self.keep_trial_latest < 0 or self.keep_experiment_best < 0:
            raise ValueError("retention keep counts must be >= 0")


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    """One checkpoint as the retention planner sees it."""

    uuid: str
    trial_id: int
    steps_completed: int
    parent: Optional[str] = None     # manifest/metadata lineage pointer
    has_manifest: bool = True        # manifest-less = possibly mid-write


def scan_experiment_checkpoints(checkpoint_dir: str) -> List[CheckpointInfo]:
    """Walk a LocalExperiment's ``trial_<rid>/<uuid>/`` layout."""
    infos: List[CheckpointInfo] = []
    if not os.path.isdir(checkpoint_dir):
        return infos
    for entry in sorted(os.listdir(checkpoint_dir)):
        if not entry.startswith("trial_"):
            continue
        try:
            rid = int(entry.split("_", 1)[1])
        except ValueError:
            continue
        trial_dir = os.path.join(checkpoint_dir, entry)
        for uuid in sorted(os.listdir(trial_dir)):
            path = os.path.join(trial_dir, uuid)
            if not os.path.isdir(path):
                continue
            meta: Dict[str, Any] = {}
            manifest: Dict[str, Any] = {}
            for name, target in (("metadata.json", meta), ("manifest.json", manifest)):
                try:
                    with open(os.path.join(path, name)) as f:
                        target.update(json.load(f))
                except (OSError, ValueError):
                    pass
            infos.append(
                CheckpointInfo(
                    uuid=uuid,
                    trial_id=rid,
                    steps_completed=int(meta.get("steps_completed") or 0),
                    parent=manifest.get("parent") or meta.get("parent_storage_id"),
                    has_manifest=bool(manifest),
                )
            )
    return infos


def plan_retention(
    checkpoints: List[CheckpointInfo],
    policy: RetentionPolicy,
    metric_by_trial: Optional[Dict[int, float]] = None,
    protected: Optional[Set[str]] = None,
    protected_trials: Optional[Set[int]] = None,
) -> Tuple[Set[str], Set[str]]:
    """Decide (keep, delete) uuid sets under the policy.

    Kept: newest ``keep_trial_latest`` per trial (by steps_completed, uuid
    as tiebreak), the latest checkpoint of the ``keep_experiment_best``
    best trials by metric, every manifest-referenced parent of a kept
    checkpoint, anything without a manifest (mid-write safety), any
    explicitly ``protected`` uuid (the experiment passes its journaled
    resume points — the WAL references them by id, so deleting one would
    turn a crash-resume into a from-scratch retrain), and the latest
    checkpoint of every ``protected_trials`` member — live PBT clone
    sources: a current-generation survivor may be exploit-cloned at the
    next turnover, and metric-ranked retention deleting its checkpoint
    mid-generation would turn the clone into a from-scratch child.

    A uuid shared across trials (a materialized PBT clone keeps its
    source's uuid in the child's namespace) is kept or deleted as a unit.
    """
    metric_by_trial = metric_by_trial or {}
    by_trial: Dict[int, List[CheckpointInfo]] = {}
    for ci in checkpoints:
        by_trial.setdefault(ci.trial_id, []).append(ci)
    for infos in by_trial.values():
        infos.sort(key=lambda c: (c.steps_completed, c.uuid), reverse=True)

    keep: Set[str] = {c.uuid for c in checkpoints if c.uuid in (protected or set())}
    for infos in by_trial.values():
        keep.update(c.uuid for c in infos[: policy.keep_trial_latest])
        # never delete an upload that may still be in flight
        keep.update(c.uuid for c in infos if not c.has_manifest)

    if policy.keep_experiment_best and metric_by_trial:
        ranked = sorted(
            (rid for rid in metric_by_trial if rid in by_trial),
            key=lambda rid: metric_by_trial[rid],
            reverse=not policy.smaller_is_better,
        )
        for rid in ranked[: policy.keep_experiment_best]:
            keep.add(by_trial[rid][0].uuid)

    # live clone sources: the newest checkpoint of each protected trial is
    # a candidate PBT exploit parent until its generation turns over
    for rid in protected_trials or set():
        if rid in by_trial:
            keep.add(by_trial[rid][0].uuid)

    # a kept checkpoint's manifest-referenced parent is its verified-resume
    # fallback: protect it even when the per-trial count would drop it
    by_uuid = {c.uuid: c for c in checkpoints}
    for uuid in list(keep):
        parent = by_uuid[uuid].parent if uuid in by_uuid else None
        if parent and parent in by_uuid:
            keep.add(parent)

    delete = {c.uuid for c in checkpoints} - keep
    return keep, delete


def apply_retention(
    checkpoint_dir: str,
    policy: RetentionPolicy,
    metric_by_trial: Optional[Dict[int, float]] = None,
    protected: Optional[Set[str]] = None,
    protected_trials: Optional[Set[int]] = None,
) -> Dict[str, List[str]]:
    """Scan, plan, and delete under ``checkpoint_dir``; returns what was
    kept/deleted.  Deletion failures are logged and skipped — GC must
    never take down the search it is cleaning up after."""
    checkpoints = scan_experiment_checkpoints(checkpoint_dir)
    keep, delete = plan_retention(
        checkpoints, policy, metric_by_trial, protected, protected_trials
    )
    deleted: List[str] = []
    # iterate the scan, not a uuid index: a clone-shared uuid names one
    # directory per trial and every copy must go
    for ci in sorted(checkpoints, key=lambda c: (c.uuid, c.trial_id)):
        if ci.uuid not in delete:
            continue
        path = os.path.join(checkpoint_dir, f"trial_{ci.trial_id}", ci.uuid)
        try:
            shutil.rmtree(path)
            deleted.append(ci.uuid)
        except OSError:
            logger.exception("retention: failed to delete checkpoint %s", ci.uuid)
    if deleted:
        logger.info(
            "retention: deleted %d checkpoint(s), kept %d", len(deleted), len(keep)
        )
    return {"kept": sorted(keep), "deleted": deleted}


def storage_manager_from_spec(storage: dict, fallback_dir: str):
    from determined_tpu_torch.config.experiment import CheckpointStorageConfig
    from determined_tpu_torch.storage import from_string

    if storage:
        cfg = CheckpointStorageConfig.parse(dict(storage))
        return from_string(cfg.to_url())
    return from_string(fallback_dir)


def main() -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    spec = json.loads(os.environ["DTPU_GC_SPEC"])
    manager = storage_manager_from_spec(
        spec.get("storage") or {}, spec.get("checkpoint_dir") or "/tmp/dtpu-checkpoints"
    )
    failed = 0
    for uuid in spec.get("uuids", []):
        try:
            deleted = manager.delete(uuid)
            logger.info("gc: deleted checkpoint %s (%d files)", uuid, len(deleted))
        except Exception:  # noqa: BLE001 - keep deleting the rest
            logger.exception("gc: failed to delete checkpoint %s", uuid)
            failed += 1
    # experiment deletion also clears profiler trace dirs ("traces/trial_N"
    # storage-relative prefixes; same delete path as checkpoints)
    from determined_tpu_torch.utils.errors import CheckpointNotFoundError

    for rel in spec.get("trace_dirs", []):
        try:
            manager.delete(rel)
            logger.info("gc: deleted traces %s", rel)
        except CheckpointNotFoundError:
            pass  # trial never traced
        except Exception:  # noqa: BLE001
            logger.exception("gc: failed to delete traces %s", rel)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
