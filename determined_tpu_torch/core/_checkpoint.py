"""CheckpointContext: durable checkpoint upload and restore with integrity
manifests.

A copy of ``determined_tpu/core/_checkpoint.py``'s chief path: upload /
store_path / store_path_async / restore_path / delete against a
StorageManager, and the manifest (per-file sizes and md5 digests, written as
the last step of finalize, with a parent pointer for the fallback walk).
On a mesh the Trainer gathers the whole state and the chief alone writes
it through this path.  The merge helpers of a sharded checkpoint
(``merge_resources``, ``merge_metadata``) are copied with the JAX
semantics; the sharded paths that use them (``shard=True``: every rank
writes its own files) raise ``NotImplementedError`` until a later slice of
the port.  The array files themselves are written by
``determined_tpu_torch.train.serialization``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import uuid as uuid_mod
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.storage.base import StorageManager, file_md5, list_directory
from determined_tpu_torch.utils.errors import (
    CheckpointCorruptError,
    CheckpointNotFoundError,
    ShardMergeConflictError,
)

logger = logging.getLogger("determined_tpu_torch.core.checkpoint")

METADATA_FILE = "metadata.json"
MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1

_LATER = "it comes with a later slice of the port (ROADMAP.md, Queue 1)"


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


def verify_manifest(path: str, require_manifest: bool = False) -> bool:
    """Check a local checkpoint directory against its manifest.

    Returns True when verified, False when no manifest exists (legacy /
    foreign checkpoint) and ``require_manifest`` is unset.  Raises
    ``CheckpointCorruptError`` on a missing-but-required manifest, an
    unreadable manifest, or any size/digest mismatch — the caller must
    treat the checkpoint as poison and fall back.
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
    for rel, entry in files.items():
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(full)
        if size != entry.get("size"):
            problems.append(f"{rel}: size {size} != manifest {entry.get('size')}")
            continue
        want = entry.get("md5")
        if want and file_md5(full) != want:
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
    """Checkpoints written by one rank, the chief: every call takes the JAX
    package's non-sharded path; ``shard=True`` raises
    ``NotImplementedError`` (a later slice of the port)."""

    def __init__(
        self,
        dist: Any,
        storage_manager: StorageManager,
        staging_dir: Optional[str] = None,
    ) -> None:
        self._dist = dist
        self._storage = storage_manager
        self._staging_dir = staging_dir or tempfile.gettempdir()
        # storage_id -> file_stats of a checkpoint whose manifest was checked
        # outside this context (accept_verified); consumed by restore_path
        self._verified: Dict[str, Dict[str, Tuple[int, int]]] = {}

    def _check_single_rank(self, shard: bool, what: str) -> None:
        if shard:
            raise NotImplementedError(
                f"{what}(shard=True) (one checkpoint merged from every rank's files) is "
                f"not ported to determined_tpu_torch yet; {_LATER}"
            )
        if not self._dist.is_chief:
            raise RuntimeError(f"{what}(shard=False) must only be called on the chief")

    # -- write path --------------------------------------------------------

    def upload(
        self,
        ckpt_dir: str,
        metadata: Optional[Dict[str, Any]] = None,
        *,
        shard: bool = False,
        selector: Optional[Callable[[str], bool]] = None,
    ) -> str:
        """Upload a directory as one checkpoint; returns its storage id."""
        self._check_single_rank(shard, "upload")
        storage_id = str(uuid_mod.uuid4())
        paths = self._selected(ckpt_dir, selector)
        selected = set(paths)
        self._storage.upload(ckpt_dir, storage_id, paths=paths)
        resources = {p: sz for p, sz in list_directory(ckpt_dir).items() if p in selected}
        digests = {
            p: file_md5(os.path.join(ckpt_dir, p))
            for p in paths
            if not p.endswith("/") and p != METADATA_FILE
        }
        self._finalize(storage_id, resources, dict(metadata or {}), digests)
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
        step: its presence certifies the whole upload)."""
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

    @contextlib.contextmanager
    def store_path(
        self, metadata: Optional[Dict[str, Any]] = None, *, shard: bool = False
    ) -> Iterator[Tuple[str, str]]:
        """Yield (path, storage_id); whatever the caller writes there is the
        checkpoint."""
        self._check_single_rank(shard, "store_path")
        storage_id = str(uuid_mod.uuid4())
        with self._storage.store_path(storage_id, self._staging_dir) as path:
            yield path, storage_id
            resources, digests = self._list_and_digest(path)
        self._finalize(storage_id, resources, dict(metadata or {}), digests)

    def store_path_async(
        self, metadata: Optional[Dict[str, Any]] = None, *, shard: bool = False
    ):
        """Overlapped-checkpointing variant of ``store_path``: returns
        ``(path, storage_id, finish)``.

        The caller may write into ``path`` from a BACKGROUND thread while
        training continues; once the writes are done, ``finish()`` must be
        called from the MAIN thread (at the next save, preemption, or exit):
        it digests the files and writes the metadata and the manifest, as
        ``store_path``'s exit does.  Until then the checkpoint has no
        manifest, so no resume can take it.
        """
        self._check_single_rank(shard, "store_path_async")
        metadata = dict(metadata or {})
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

    def _list_and_digest(self, path: str):
        with get_tracer().span("checkpoint.digest", cat="checkpoint"):
            resources = list_directory(path)
            digests = {
                p: file_md5(os.path.join(path, p))
                for p in resources
                if not p.endswith("/") and p != METADATA_FILE
            }
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
