"""Storage manager interface: a copy of ``determined_tpu/storage/base.py``.

A StorageManager moves checkpoint directories between a local staging path
and durable storage.  The port has the shared_fs and directory backends
(``storage/shared_fs.py``); the S3, GCS and Azure backends raise
``NotImplementedError`` (a later slice of the port).  ``from_string`` parses
"s3://bucket/prefix"-style URLs as the JAX package's does.  ``md5_files``
digests a checkpoint's files at once, a thread a file.
"""

from __future__ import annotations

import abc
import concurrent.futures
import contextlib
import hashlib
import os
import shutil
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from determined_tpu_torch.utils import faults


def file_md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def md5_files(root: str, rels: Iterable[str]) -> Dict[str, str]:
    """``file_md5`` of each file under ``root``, a thread a file (hashlib
    and file reads release the GIL), so a checkpoint's digest takes the
    time of its largest file rather than of all of them."""
    rels = list(rels)
    if len(rels) < 2:
        return {r: file_md5(os.path.join(root, r)) for r in rels}
    workers = min(len(rels), os.cpu_count() or 1, 8)
    with concurrent.futures.ThreadPoolExecutor(workers, thread_name_prefix="dtpu-md5") as pool:
        return dict(zip(rels, pool.map(lambda r: file_md5(os.path.join(root, r)), rels)))


def list_directory(root: str) -> Dict[str, int]:
    """Relative-path -> size map of every file under root (dirs get size 0,
    trailing slash)."""
    out: Dict[str, int] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel != ".":
            out[rel + "/"] = 0
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            out[os.path.join("" if rel == "." else rel, fn)] = os.path.getsize(full)
    return out


class StorageManager(abc.ABC):
    """Upload/download whole checkpoint directories keyed by storage_id.

    ``upload``/``download`` wrap the backend ``_upload``/``_download`` so
    every backend shares the fault-injection hook points
    (``utils/faults.py``).
    """

    # True when store_path/restore_path expose the durable directory itself
    # (shared_fs): no staging copy, and every rank may use the same path.
    direct_store = False

    def upload(
        self,
        src: str,
        storage_id: str,
        paths: Optional[List[str]] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> None:
        faults.fire(
            "storage.upload", manager=self, src=src, storage_id=storage_id, paths=paths
        )
        self._upload(src, storage_id, paths=paths, progress=progress)
        faults.fire(
            "storage.upload.done", manager=self, src=src, storage_id=storage_id, paths=paths
        )

    def download(
        self,
        storage_id: str,
        dst: str,
        selector: Optional[Callable[[str], bool]] = None,
    ) -> None:
        faults.fire("storage.download", manager=self, storage_id=storage_id, dst=dst)
        self._download(storage_id, dst, selector=selector)

    @abc.abstractmethod
    def _upload(
        self,
        src: str,
        storage_id: str,
        paths: Optional[List[str]] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> None:
        ...

    @abc.abstractmethod
    def _download(
        self,
        storage_id: str,
        dst: str,
        selector: Optional[Callable[[str], bool]] = None,
    ) -> None:
        ...

    @abc.abstractmethod
    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, int]:
        """Delete (all or glob-matched) files; returns remaining resources."""

    @abc.abstractmethod
    def list_files(self, storage_id: str) -> Dict[str, int]:
        ...

    @contextlib.contextmanager
    def restore_path(self, storage_id: str, staging_dir: str) -> Iterator[str]:
        """Download into a staging dir, yield it, clean up after."""
        dst = os.path.join(staging_dir, storage_id)
        os.makedirs(dst, exist_ok=True)
        self.download(storage_id, dst)
        try:
            yield dst
        finally:
            shutil.rmtree(dst, ignore_errors=True)

    def stage_path(self, storage_id: str, staging_dir: str) -> str:
        """Deterministic per-storage_id staging dir (every local rank of a
        sharded checkpoint stages into the same one)."""
        path = os.path.join(staging_dir, storage_id)
        os.makedirs(path, exist_ok=True)
        return path

    # Backends that expose checkpoints as plain paths (shared_fs) override
    # store_path to avoid the copy; default stages then uploads.
    @contextlib.contextmanager
    def store_path(self, storage_id: str, staging_dir: str) -> Iterator[str]:
        """Single-process staging: stage, upload on success, clean up."""
        src = self.stage_path(storage_id, staging_dir)
        try:
            yield src
            self.upload(src, storage_id)
        finally:
            shutil.rmtree(src, ignore_errors=True)


def from_string(url: str, **kwargs) -> StorageManager:
    """Build a StorageManager from a URL-ish string.

    - "/abs/path" or "shared_fs:///abs/path" -> SharedFSStorageManager
    - "directory:///abs/path" -> DirectoryStorageManager
    - "s3://bucket/prefix", "gs://...", "azure://..." -> the cloud backends,
      which raise ``NotImplementedError``: a later slice of the port.
    """
    from determined_tpu_torch.storage.shared_fs import (
        DirectoryStorageManager,
        SharedFSStorageManager,
    )

    if url.startswith("shared_fs://"):
        return SharedFSStorageManager(url[len("shared_fs://"):], **kwargs)
    if url.startswith("directory://"):
        return DirectoryStorageManager(url[len("directory://"):], **kwargs)
    if url.startswith(("s3://", "gs://", "gcs://", "azure://")):
        raise NotImplementedError(
            f"cloud checkpoint storage ({url.split('://')[0]}) is not ported to "
            "determined_tpu_torch yet; it comes with a later slice of the port "
            "(ROADMAP.md, Queue 1)"
        )
    if "://" in url:
        raise ValueError(f"unknown storage scheme: {url}")
    return SharedFSStorageManager(url, **kwargs)
