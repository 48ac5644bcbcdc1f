"""Filesystem storage backends: a copy of ``determined_tpu/storage/shared_fs.py``."""

from __future__ import annotations

import fnmatch
import os
import shutil
from typing import Callable, Dict, List, Optional

from determined_tpu_torch.storage.base import StorageManager, list_directory
from determined_tpu_torch.utils.errors import CheckpointNotFoundError


class SharedFSStorageManager(StorageManager):
    """Checkpoints live under a shared filesystem root visible to all hosts."""

    direct_store = True

    def __init__(self, base_path: str) -> None:
        self.base_path = os.path.abspath(base_path)

    def _ckpt_dir(self, storage_id: str) -> str:
        return os.path.join(self.base_path, storage_id)

    def _upload(self, src, storage_id, paths=None, progress=None) -> None:
        dst = self._ckpt_dir(storage_id)
        os.makedirs(dst, exist_ok=True)
        names = paths if paths is not None else list(list_directory(src))
        done = 0
        for rel in names:
            s, d = os.path.join(src, rel), os.path.join(dst, rel)
            if rel.endswith("/"):
                os.makedirs(d, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(d), exist_ok=True)
            shutil.copy2(s, d)
            done += 1
            if progress:
                progress(done)

    def _download(
        self, storage_id: str, dst: str, selector: Optional[Callable[[str], bool]] = None
    ) -> None:
        src = self._ckpt_dir(storage_id)
        if not os.path.isdir(src):
            raise CheckpointNotFoundError(f"checkpoint {storage_id} not in {self.base_path}")
        for rel, size in list_directory(src).items():
            if rel.endswith("/"):
                os.makedirs(os.path.join(dst, rel), exist_ok=True)
                continue
            if selector is not None and not selector(rel):
                continue
            d = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(d), exist_ok=True)
            shutil.copy2(os.path.join(src, rel), d)

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, int]:
        root = self._ckpt_dir(storage_id)
        if not os.path.isdir(root):
            raise CheckpointNotFoundError(f"checkpoint {storage_id} not in {self.base_path}")
        if globs is None:
            shutil.rmtree(root)
            return {}
        for rel in list(list_directory(root)):
            if rel.endswith("/"):
                continue
            if any(fnmatch.fnmatch(rel, g) or fnmatch.fnmatch("/" + rel, g) for g in globs):
                os.remove(os.path.join(root, rel))
        # prune empty dirs bottom-up (re-check with listdir: walk's dirnames
        # snapshot predates children we just removed)
        for dirpath, _dirnames, _filenames in os.walk(root, topdown=False):
            if dirpath != root and not os.listdir(dirpath):
                os.rmdir(dirpath)
        return list_directory(root)

    def list_files(self, storage_id: str) -> Dict[str, int]:
        root = self._ckpt_dir(storage_id)
        if not os.path.isdir(root):
            raise CheckpointNotFoundError(f"checkpoint {storage_id} not in {self.base_path}")
        return list_directory(root)

    def store_path(self, storage_id: str, staging_dir: str):
        """Write directly into the shared-fs checkpoint dir (no copy)."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            dst = self._ckpt_dir(storage_id)
            os.makedirs(dst, exist_ok=True)
            yield dst

        return cm()

    def restore_path(self, storage_id: str, staging_dir: str):
        """Read directly from the shared-fs checkpoint dir (no copy)."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            src = self._ckpt_dir(storage_id)
            if not os.path.isdir(src):
                raise CheckpointNotFoundError(
                    f"checkpoint {storage_id} not in {self.base_path}"
                )
            yield src

        return cm()


class DirectoryStorageManager(SharedFSStorageManager):
    """Same as shared_fs but semantically a container-local bind mount
    (reference: common/storage/directory.py)."""
