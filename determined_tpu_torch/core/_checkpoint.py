"""CheckpointContext: durable checkpoint upload and restore with integrity
manifests.

A copy of ``determined_tpu/core/_checkpoint.py``: upload / store_path /
store_path_async / restore_path / delete against a StorageManager, and the
manifest (per-file sizes and md5 digests, written as the last step of
finalize, with a parent pointer for the fallback walk).

``shard=False`` is the chief's call: one rank writes the checkpoint.
``shard=True`` is collective, with the JAX semantics: every rank calls,
the chief's storage id is broadcast, every rank writes its own files into
the one checkpoint, the chief merges every rank's file list, digests and
metadata (``merge_resources``, ``merge_metadata``: a file two ranks wrote
must be bit-identical, a metadata key must agree) and writes the metadata
and the manifest last, and every rank returns only after that.  Where the
JAX package has each host's local chief digest the whole shared
directory, here each rank digests its own share of it (``upload``: the
files it uploaded; ``store_path``: every ``size``-th file of the listing,
offset by its rank), so no rank hashes the whole checkpoint.  The
asynchronous variant's ``finish`` is the same collective, run at the next
drain point.  A rank that dies before the chief's manifest leaves a
checkpoint without one, which verification rejects.  The array files
themselves are written by ``determined_tpu_torch.train.serialization``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import tempfile
import uuid as uuid_mod
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.storage.base import (
    StorageManager,
    file_md5,
    list_directory,
    md5_files,
)
from determined_tpu_torch.utils.errors import (
    CheckpointCorruptError,
    CheckpointNotFoundError,
    ShardMergeConflictError,
)

logger = logging.getLogger("determined_tpu_torch.core.checkpoint")

METADATA_FILE = "metadata.json"
MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1

def build_manifest(
    resources: Dict[str, int],
    digests: Dict[str, str],
    parent: Optional[str] = None,
) -> Dict[str, Any]:
    """Integrity manifest for one checkpoint: per-file sizes + md5 digests.

    Uploaded as the ATOMIC LAST step of finalize, so its presence asserts
    every listed file landed completely — a trial killed mid-upload leaves
    no manifest and the checkpoint is visibly incomplete (the reference
    never resumes from a checkpoint the master hasn't recorded as
    COMPLETED; the manifest is the storage-plane analog of that record).
    ``parent`` names the previous good checkpoint so a verifier that
    rejects this one can fall back.
    """
    files: Dict[str, Any] = {}
    for rel, size in resources.items():
        if rel.endswith("/") or rel == MANIFEST_FILE:
            continue
        entry: Dict[str, Any] = {"size": int(size)}
        if digests.get(rel):
            entry["md5"] = digests[rel]
        files[rel] = entry
    return {"version": MANIFEST_VERSION, "parent": parent, "files": files}


def verify_manifest(path: str, require_manifest: bool = False,
                    only: Optional[Callable[[str], bool]] = None) -> bool:
    """Check a local checkpoint directory against its manifest.

    Returns True when verified, False when no manifest exists (legacy /
    foreign checkpoint) and ``require_manifest`` is unset.  Raises
    ``CheckpointCorruptError`` on a missing-but-required manifest, an
    unreadable manifest, or any size/digest mismatch — the caller must
    treat the checkpoint as poison and fall back.  ``only`` checks the
    manifest's files it accepts (the ones a partial load reads) and no
    other.
    """
    mf = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mf):
        if require_manifest:
            raise CheckpointCorruptError(
                f"checkpoint at {path} has no {MANIFEST_FILE}: finalize never "
                "completed (killed mid-upload?)"
            )
        logger.warning(
            "checkpoint at %s has no %s; skipping integrity verification", path, MANIFEST_FILE
        )
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        files = dict(manifest["files"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptError(f"unreadable manifest at {mf}: {e}") from e
    problems: List[str] = []
    to_hash: List[str] = []
    for rel, entry in files.items():
        if only is not None and not only(rel):
            continue
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(full)
        if size != entry.get("size"):
            problems.append(f"{rel}: size {size} != manifest {entry.get('size')}")
            continue
        if entry.get("md5"):
            to_hash.append(rel)
    for rel, got in md5_files(path, to_hash).items():
        if got != files[rel]["md5"]:
            problems.append(f"{rel}: md5 mismatch")
    if problems:
        raise CheckpointCorruptError(
            f"checkpoint at {path} failed manifest verification: {'; '.join(problems)}"
        )
    return True


def merge_resources(
    all_resources: List[Dict[str, int]],
    all_digests: List[Dict[str, str]],
) -> Dict[str, int]:
    """Merge per-rank file lists; duplicate paths must be bit-identical.

    Mirrors reference semantics (``_checkpoint.py merge_resources:127``):
    directories may repeat freely; files may repeat only with equal md5.
    """
    merged: Dict[str, int] = {}
    owner: Dict[str, int] = {}
    digests: Dict[str, str] = {}
    for rank, (resources, rank_digests) in enumerate(zip(all_resources, all_digests)):
        for rel, size in resources.items():
            if rel.endswith("/"):
                merged.setdefault(rel, 0)
                continue
            if rel == METADATA_FILE:
                continue
            if rel in merged:
                if digests.get(rel) != rank_digests.get(rel):
                    raise ShardMergeConflictError(
                        f"file '{rel}' uploaded by ranks {owner[rel]} and {rank} "
                        "with different contents"
                    )
                continue
            merged[rel] = size
            owner[rel] = rank
            digests[rel] = rank_digests.get(rel, "")
    return merged


def _merge_digests(all_digests: List[Dict[str, str]]) -> Dict[str, str]:
    """First-writer-wins union of per-rank digest maps; conflicts were
    already rejected by ``merge_resources``."""
    merged: Dict[str, str] = {}
    for rank_digests in all_digests:
        for rel, digest in rank_digests.items():
            merged.setdefault(rel, digest)
    return merged


def merge_metadata(all_metadata: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Key-wise merge; the same key must carry the same value on all ranks
    (reference ``merge_metadata:84``)."""
    merged: Dict[str, Any] = {}
    owner: Dict[str, int] = {}
    for rank, md in enumerate(all_metadata):
        if not md:
            continue
        for k, v in md.items():
            if k in merged and merged[k] != v:
                raise ShardMergeConflictError(
                    f"metadata key '{k}' set to conflicting values by ranks "
                    f"{owner[k]} and {rank}"
                )
            merged.setdefault(k, v)
            owner.setdefault(k, rank)
    return merged


def file_stats(path: str) -> Dict[str, Tuple[int, int]]:
    """(size, mtime_ns) of every file under a checkpoint directory: what a
    manifest check is held to until the checkpoint is read
    (``CheckpointContext.accept_verified``)."""
    out: Dict[str, Tuple[int, int]] = {}
    for dirpath, _dirnames, filenames in os.walk(path):
        for fn in filenames:
            st = os.stat(os.path.join(dirpath, fn))
            out[os.path.relpath(os.path.join(dirpath, fn), path)] = (st.st_size, st.st_mtime_ns)
    return out


class CheckpointContext:
    """Checkpoints written by the chief (``shard=False``) or by every rank
    together (``shard=True``, collective)."""

    def __init__(
        self,
        dist: Any,
        storage_manager: StorageManager,
        session: Optional[Any] = None,
        trial_id: Optional[int] = None,
        staging_dir: Optional[str] = None,
    ) -> None:
        self._dist = dist
        self._storage = storage_manager
        self._session = session
        self._trial_id = trial_id
        self._staging_dir = staging_dir or tempfile.gettempdir()
        # storage_id -> file_stats of a checkpoint whose manifest was checked
        # outside this context (accept_verified); consumed by restore_path
        self._verified: Dict[str, Dict[str, Tuple[int, int]]] = {}

    def _check_chief(self, what: str) -> None:
        if not self._dist.is_chief:
            raise RuntimeError(f"{what}(shard=False) must only be called on the chief")

    def _shared_storage_id(self) -> str:
        """The chief's new storage id, on every rank (a collective)."""
        return self._dist.broadcast(str(uuid_mod.uuid4()) if self._dist.is_chief else None)

    # -- write path --------------------------------------------------------

    def upload(
        self,
        ckpt_dir: Optional[str],
        metadata: Optional[Dict[str, Any]] = None,
        *,
        shard: bool = False,
        selector: Optional[Callable[[str], bool]] = None,
    ) -> str:
        """Upload a directory as one checkpoint; returns its storage id.

        Non-sharded: chief-only call.  Sharded: collective, every rank
        calls (``ckpt_dir=None`` for a rank with nothing to add)."""
        if shard:
            return self._upload_sharded(ckpt_dir, metadata, selector)
        self._check_chief("upload")
        if ckpt_dir is None:
            raise ValueError("chief upload requires ckpt_dir")
        storage_id = str(uuid_mod.uuid4())
        resources, digests, paths = self._digest_selected(ckpt_dir, selector)
        self._storage.upload(ckpt_dir, storage_id, paths=paths)
        self._finalize(storage_id, resources, dict(metadata or {}), digests)
        return storage_id

    def _digest_selected(self, ckpt_dir: str, selector: Optional[Callable[[str], bool]]):
        paths = self._selected(ckpt_dir, selector)
        selected = set(paths)
        resources = {p: sz for p, sz in list_directory(ckpt_dir).items() if p in selected}
        digests = md5_files(
            ckpt_dir, [p for p in paths if not p.endswith("/") and p != METADATA_FILE]
        )
        return resources, digests, paths

    def _upload_sharded(
        self,
        ckpt_dir: Optional[str],
        metadata: Optional[Dict[str, Any]],
        selector: Optional[Callable[[str], bool]],
    ) -> str:
        storage_id = self._shared_storage_id()
        resources: Dict[str, int] = {}
        digests: Dict[str, str] = {}
        if ckpt_dir is not None:
            resources, digests, paths = self._digest_selected(ckpt_dir, selector)
            self._storage.upload(ckpt_dir, storage_id, paths=paths)
        self._merge_and_finalize(storage_id, resources, digests, dict(metadata or {}))
        return storage_id

    def _selected(self, ckpt_dir: str, selector: Optional[Callable[[str], bool]]) -> List[str]:
        names = list(list_directory(ckpt_dir))
        if selector is None:
            return names
        return [n for n in names if n.endswith("/") or selector(n)]

    def _finalize(
        self,
        storage_id: str,
        resources: Dict[str, int],
        metadata: Dict[str, Any],
        digests: Dict[str, str],
    ) -> None:
        """Write the metadata, then the integrity manifest (the ATOMIC last
        step: its presence certifies the whole upload), then report to the
        master."""
        metadata = dict(metadata)
        metadata.setdefault("format", "determined_tpu_torch")
        with tempfile.TemporaryDirectory() as td:
            md_path = os.path.join(td, METADATA_FILE)
            with open(md_path, "w") as f:
                json.dump(metadata, f, indent=2, sort_keys=True)
            self._storage.upload(td, storage_id, paths=[METADATA_FILE])
            # the manifest covers the data files AND the metadata file just
            # written; anything that dies between here and the manifest
            # upload leaves a checkpoint that verification rejects
            full = dict(resources)
            full[METADATA_FILE] = os.path.getsize(md_path)
            all_digests = dict(digests)
            all_digests[METADATA_FILE] = file_md5(md_path)
            manifest = build_manifest(
                full, all_digests, parent=metadata.get("parent_storage_id")
            )
            with open(os.path.join(td, MANIFEST_FILE), "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            self._storage.upload(td, storage_id, paths=[MANIFEST_FILE])
        self._report_checkpoint(storage_id, resources, metadata)

    def _report_checkpoint(
        self, storage_id: str, resources: Dict[str, int], metadata: Dict[str, Any]
    ) -> None:
        """Record the checkpoint with the master; no-op off-cluster."""
        if self._session is None:
            return
        try:
            # keyed by uuid server-side, so a duplicate report is a no-op:
            # safe to opt this POST into transport retries
            self._session.post(
                "/api/v1/checkpoints",
                json={
                    "uuid": storage_id,
                    "trial_id": self._trial_id,
                    "resources": resources,
                    "metadata": metadata,
                },
                retry=True,
            )
        except Exception:  # noqa: BLE001 - reporting must not kill training
            logger.exception("failed to report checkpoint %s to master", storage_id)

    def _merge_and_finalize(self, storage_id: str, resources: Dict[str, int],
                            digests: Dict[str, str], metadata: Dict[str, Any]) -> None:
        """The sharded tail, collective: every rank's files, digests and
        metadata go to the chief, which merges them and finalizes; no rank
        returns before the manifest is written."""
        gathered = self._dist.gather((resources, digests, metadata))
        if self._dist.is_chief:
            merged = merge_resources([g[0] for g in gathered], [g[1] for g in gathered])
            merged_md = merge_metadata([g[2] for g in gathered])
            self._finalize(storage_id, merged, merged_md,
                           _merge_digests([g[1] for g in gathered]))
        self._dist.barrier()

    @contextlib.contextmanager
    def store_path(
        self, metadata: Optional[Dict[str, Any]] = None, *, shard: bool = False
    ) -> Iterator[Tuple[str, str]]:
        """Yield (path, storage_id); whatever the caller writes there is the
        checkpoint.  The sharded variant is collective like
        ``upload(shard=True)``: every rank writes its own files into
        ``path``."""
        if not shard:
            self._check_chief("store_path")
            storage_id = str(uuid_mod.uuid4())
            with self._storage.store_path(storage_id, self._staging_dir) as path:
                yield path, storage_id
                resources, digests = self._list_and_digest(path)
            self._finalize(storage_id, resources, dict(metadata or {}), digests)
            return
        path, storage_id, finish = self.store_path_async(metadata, shard=True)
        yield path, storage_id
        finish()

    def store_path_async(
        self, metadata: Optional[Dict[str, Any]] = None, *, shard: bool = False
    ):
        """Overlapped-checkpointing variant of ``store_path``: returns
        ``(path, storage_id, finish)``.

        The caller may write into ``path`` from a BACKGROUND thread while
        training continues; once the writes are done, ``finish()`` must be
        called from the MAIN thread (at the next save, preemption, or exit;
        with ``shard`` at a point every rank reaches in the same loop
        position, since it is the collective merge): it digests the files and
        writes the metadata and the manifest, as ``store_path``'s exit does.
        Until then the checkpoint has no manifest, so no resume can take it.
        """
        metadata = dict(metadata or {})
        if not shard:
            self._check_chief("store_path_async")
            storage_id = str(uuid_mod.uuid4())
            cm = self._storage.store_path(storage_id, self._staging_dir)
            path = cm.__enter__()

            def finish() -> None:
                try:
                    resources, digests = self._list_and_digest(path)
                finally:
                    cm.__exit__(None, None, None)
                self._finalize(storage_id, resources, metadata, digests)

            return path, storage_id, finish

        storage_id = self._shared_storage_id()
        dist = self._dist
        if self._storage.direct_store:
            # shared fs: every rank writes straight into the one durable dir
            cm = self._storage.store_path(storage_id, self._staging_dir)
            path = cm.__enter__()

            def finish() -> None:
                try:
                    # every rank's files are complete before any is hashed
                    dist.barrier()
                    resources, digests = self._list_and_digest(path, dist.rank, dist.size)
                finally:
                    cm.__exit__(None, None, None)
                self._merge_and_finalize(storage_id, resources, digests, metadata)

            return path, storage_id, finish

        # a staged backend: the ranks of a host stage into one directory per
        # storage id, and its local chief uploads it once
        path = self._storage.stage_path(storage_id, self._staging_dir)

        def finish() -> None:
            try:
                dist.barrier()
                resources, digests = self._list_and_digest(
                    path, dist.local_rank, dist.local_size)
                if dist.is_local_chief:
                    self._storage.upload(path, storage_id)
                # the uploads on every host land before any rank goes on
                dist.barrier()
            finally:
                if dist.is_local_chief:
                    shutil.rmtree(path, ignore_errors=True)
            self._merge_and_finalize(storage_id, resources, digests, metadata)

        return path, storage_id, finish

    def _list_and_digest(self, path: str, rank: int = 0, size: int = 1):
        """The files under ``path`` and the md5 of this rank's share of them
        (every ``size``-th file, from ``rank``): with ``size`` 1, all."""
        with get_tracer().span("checkpoint.digest", cat="checkpoint"):
            listed = list_directory(path)
            files = sorted(p for p in listed if not p.endswith("/") and p != METADATA_FILE)
            mine = files[rank::size]
            resources = {p: listed[p] for p in mine}
            resources.update({p: sz for p, sz in listed.items() if p.endswith("/")})
            digests = md5_files(path, mine, written=True)
        return resources, digests

    # -- read path ---------------------------------------------------------

    def download(
        self,
        storage_id: str,
        ckpt_dir: str,
        selector: Optional[Callable[[str], bool]] = None,
    ) -> None:
        os.makedirs(ckpt_dir, exist_ok=True)
        self._storage.download(storage_id, ckpt_dir, selector=selector)

    def accept_verified(self, storage_id: str, stats: Dict[str, Tuple[int, int]]) -> None:
        """Take a manifest check made outside this context (the local
        experiment checks a resume point before the trial starts): the next
        ``restore_path`` of ``storage_id`` skips its own md5 pass when every
        file still has the size and mtime in ``stats`` (``file_stats``,
        taken before that check), and verifies in full otherwise."""
        self._verified[storage_id] = dict(stats)

    @contextlib.contextmanager
    def restore_path(
        self,
        storage_id: str,
        selector: Optional[Callable[[str], bool]] = None,
        *,
        verify: bool = True,
        require_manifest: bool = False,
    ) -> Iterator[str]:
        """Yield a local path containing the checkpoint (the durable
        directory itself on shared_fs).

        The integrity manifest is verified before the caller sees the path
        (skipped for partial ``selector`` restores).  With
        ``require_manifest`` a manifest-less checkpoint (one whose writer
        was killed before finalize) is rejected as corrupt rather than
        trusted; resume paths set this so a partial upload can never poison
        a resume.
        """
        checked = self._verified.pop(storage_id, None)
        with self._storage.restore_path(storage_id, self._staging_dir) as path:
            if verify and selector is None and (checked is None or checked != file_stats(path)):
                with get_tracer().span("checkpoint.verify", cat="restore"):
                    verify_manifest(path, require_manifest=require_manifest)
            yield path

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, int]:
        if not self._dist.is_chief:
            raise RuntimeError("delete must only be called on the chief")
        if globs is not None:
            # a partial delete invalidates the integrity manifest; drop it
            # too so the checkpoint reads as "unverified" rather than
            # "corrupt" (resume paths with require_manifest still reject it)
            globs = list(globs) + [MANIFEST_FILE]
        return self._storage.delete(storage_id, globs)

    def get_metadata(self, storage_id: str) -> Dict[str, Any]:
        return self._fetch_json(storage_id, METADATA_FILE)

    def get_manifest(self, storage_id: str) -> Dict[str, Any]:
        """The integrity manifest alone ({} when absent/unreadable)."""
        return self._fetch_json(storage_id, MANIFEST_FILE)

    def get_checkpoint_parent(self, storage_id: str) -> Optional[str]:
        """Previous good checkpoint in this trial's lineage, for fallback
        after a failed verification.  Manifest first; the metadata copy
        covers a checkpoint killed between its metadata and manifest
        uploads."""
        parent = self.get_manifest(storage_id).get("parent")
        if parent:
            return parent
        return self.get_metadata(storage_id).get("parent_storage_id") or None

    def _fetch_json(self, storage_id: str, name: str) -> Dict[str, Any]:
        with tempfile.TemporaryDirectory() as td:
            try:
                self._storage.download(storage_id, td, selector=lambda p: p == name)
            except Exception:
                return {}
            full = os.path.join(td, name)
            if not os.path.exists(full):
                return {}
            try:
                with open(full) as f:
                    return json.load(f)
            except ValueError:
                return {}


class DummyCheckpointContext(CheckpointContext):
    """Off-cluster variant: checkpoints in a local directory."""

    def __init__(self, dist: Any, base_path: str) -> None:
        from determined_tpu_torch.storage.shared_fs import SharedFSStorageManager

        super().__init__(dist, SharedFSStorageManager(base_path))
