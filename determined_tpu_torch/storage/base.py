"""Storage manager interface: a copy of ``determined_tpu/storage/base.py``.

A StorageManager moves checkpoint directories between a local staging path
and durable storage.  The port has the shared_fs and directory backends
(``storage/shared_fs.py``); the S3, GCS and Azure backends raise
``NotImplementedError`` (a later slice of the port).  ``from_string`` parses
"s3://bucket/prefix"-style URLs as the JAX package's does.  ``md5_files``
digests a checkpoint's files at once, a thread a file.  A file written
through ``DigestingWriter`` is digested as it is written (on a thread of
its own, beside the write), and a save's finalize takes that digest
instead of reading the file again
(``md5_files(..., written=True)``) while the file keeps the size and
mtime it was written with; a restore's verification always reads.
"""

from __future__ import annotations

import abc
import concurrent.futures
import contextlib
import hashlib
import os
import queue
import shutil
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

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


# the files DigestingWriter wrote: real path -> (size, mtime_ns, the writer);
# a save's finalize takes its own files' digests and forgets the rest of its
# directory (the files another process finalizes)
_WRITTEN: Dict[str, Tuple[int, int, "DigestingWriter"]] = {}
_WRITTEN_LOCK = threading.Lock()

#: a write is hashed in pieces of this many bytes, and at most
#: ``_DIGEST_QUEUED`` pieces wait for the hash: a writer that outruns md5
#: waits for it instead of holding copies of the file in memory
_DIGEST_CHUNK = 8 << 20
_DIGEST_QUEUED = 2


class DigestingWriter:
    """A binary file opened for writing whose md5 is taken from what is
    written to it (``torch.save`` takes it as a file object).  Each write
    goes to the file and to a thread of this file's own a piece at a time
    (a copy of at most ``_DIGEST_CHUNK`` bytes, at most ``_DIGEST_QUEUED``
    of them queued), which hashes them in order while the writer goes on:
    the file's digest runs beside its write and beside the next files'
    (md5 is sequential within a file, not across them).  ``close`` records
    the file for ``md5_files``, which waits for the hash."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "wb")
        self._md5 = hashlib.md5()
        self._queue: "queue.Queue" = queue.Queue(maxsize=_DIGEST_QUEUED)
        self._hasher = threading.Thread(target=self._hash, name="dtpu-md5w", daemon=True)
        self._hasher.start()

    def _hash(self) -> None:
        while True:
            chunk = self._queue.get()
            if chunk is None:
                return
            self._md5.update(chunk)

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        for at in range(0, view.nbytes, _DIGEST_CHUNK):
            piece = view[at:at + _DIGEST_CHUNK]
            self._f.write(piece)
            self._queue.put(bytes(piece))
        return view.nbytes

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        self._queue.put(None)
        st = os.stat(self.path)
        with _WRITTEN_LOCK:
            _WRITTEN[os.path.realpath(self.path)] = (st.st_size, st.st_mtime_ns, self)

    def hexdigest(self) -> str:
        """The file's md5, once every write is hashed."""
        self._hasher.join()
        return self._md5.hexdigest()

    def __enter__(self) -> "DigestingWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _written_md5(path: str) -> Optional[str]:
    """The digest ``DigestingWriter`` took of ``path``, if the file still
    has the size and mtime it was written with."""
    real = os.path.realpath(path)
    with _WRITTEN_LOCK:
        known = _WRITTEN.pop(real, None)
    if known is None:
        return None
    digest = known[2].hexdigest()
    st = os.stat(real)
    return digest if (st.st_size, st.st_mtime_ns) == known[:2] else None


def _forget_under(root: str) -> None:
    """Drop what ``DigestingWriter`` recorded under ``root``: the files of a
    finalized save that another process digested."""
    prefix = os.path.realpath(root) + os.sep
    with _WRITTEN_LOCK:
        for real in [p for p in _WRITTEN if p.startswith(prefix)]:
            del _WRITTEN[real]


def md5_files(root: str, rels: Iterable[str], written: bool = False) -> Dict[str, str]:
    """``file_md5`` of each file under ``root``, a thread a file (hashlib
    and file reads release the GIL), so a checkpoint's digest takes the
    time of its largest file rather than of all of them.  With ``written``
    (a save's finalize) a file ``DigestingWriter`` wrote is not read again:
    its digest is the one taken as it was written."""
    out: Dict[str, str] = {}
    rels = list(rels)
    if written:
        for r in rels:
            got = _written_md5(os.path.join(root, r))
            if got is not None:
                out[r] = got
        rels = [r for r in rels if r not in out]
        _forget_under(root)
    if len(rels) < 2:
        out.update({r: file_md5(os.path.join(root, r)) for r in rels})
        return out
    workers = min(len(rels), os.cpu_count() or 1, 8)
    with concurrent.futures.ThreadPoolExecutor(workers, thread_name_prefix="dtpu-md5") as pool:
        out.update(zip(rels, pool.map(lambda r: file_md5(os.path.join(root, r)), rels)))
    return out


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
