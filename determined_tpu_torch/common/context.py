"""Experiment context directory: package user code for the cluster (a
copy of ``determined_tpu/common/context.py``).

Reference: ``harness/determined/common/context.py`` (build/upload the
workdir tarball at submit) + ``harness/determined/common/detignore.py``
(exclusion patterns) + ``harness/determined/exec/prep_container.py:28-46``
(download/unpack in the task container).  TPU redesign: the tarball rides
inside the experiment-create request as base64 (one JSON protocol end to
end, no multipart), the master stores it on disk next to its journal, and
the trial process downloads and unpacks it before importing the entrypoint
(there is no container layer on a TPU VM).
"""

from __future__ import annotations

import fnmatch
import gzip
import io
import os
import tarfile
from typing import List

# always excluded, mirroring the reference's implicit excludes
DEFAULT_IGNORE = [
    ".git",
    "__pycache__",
    "*.pyc",
    ".detignore",
    ".pytest_cache",
]

MAX_CONTEXT_BYTES = 64 << 20  # request-body friendly cap (ref caps at ~95MB)

DETIGNORE_FILE = ".detignore"


class ContextTooLargeError(RuntimeError):
    pass


def read_detignore(root: str) -> List[str]:
    """Patterns from <root>/.detignore (gitignore-lite: fnmatch per line,
    '#' comments, blank lines skipped, trailing '/' matches directories)."""
    path = os.path.join(root, DETIGNORE_FILE)
    if not os.path.isfile(path):
        return []
    patterns = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            patterns.append(line)
    return patterns


def _ignored(rel: str, is_dir: bool, patterns: List[str]) -> bool:
    name = os.path.basename(rel)
    for pat in patterns:
        dir_only = pat.endswith("/")
        p = pat.rstrip("/")
        if dir_only and not is_dir:
            continue
        if fnmatch.fnmatch(rel, p) or fnmatch.fnmatch(name, p):
            return True
    return False


def build_context(root: str, max_size: int = MAX_CONTEXT_BYTES) -> bytes:
    """Deterministic tar.gz of the context directory, honoring .detignore."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"context directory not found: {root}")
    patterns = DEFAULT_IGNORE + read_detignore(root)

    entries: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        rel_dir = "" if rel_dir == "." else rel_dir
        # prune ignored dirs in place so walk skips their subtrees
        dirnames[:] = sorted(
            d
            for d in dirnames
            if not _ignored(os.path.join(rel_dir, d) if rel_dir else d, True, patterns)
        )
        # walk(followlinks=False) lists dir-symlinks but never descends or
        # yields them as files.  In-tree links are archived as symlinks
        # (extraction re-links them); out-of-tree links can't survive
        # extraction on another host, so warn loudly instead of silently
        # dropping part of the user's code layout.
        for d in list(dirnames):
            full = os.path.join(dirpath, d)
            if os.path.islink(full):
                dirnames.remove(d)
                rel = os.path.join(rel_dir, d) if rel_dir else d
                target = os.path.realpath(full)
                if target == root or target.startswith(root + os.sep):
                    entries.append(rel)
                else:
                    import warnings

                    warnings.warn(
                        f"context: symlink {rel!r} -> {target!r} points outside "
                        f"the context directory and will NOT be shipped",
                        stacklevel=2,
                    )
        for fn in sorted(filenames):
            rel = os.path.join(rel_dir, fn) if rel_dir else fn
            if not _ignored(rel, False, patterns):
                entries.append(rel)

    buf = io.BytesIO()
    # mtime pinned for deterministic bytes (same tree -> same tarball)
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
        with tarfile.open(fileobj=gz, mode="w") as tar:
            for rel in entries:
                full = os.path.join(root, rel)
                info = tar.gettarinfo(full, arcname=rel)
                info.mtime = 0
                info.uid = info.gid = 0
                info.uname = info.gname = ""
                if info.isreg():
                    with open(full, "rb") as f:
                        tar.addfile(info, f)
                else:
                    tar.addfile(info)
    data = buf.getvalue()
    if len(data) > max_size:
        raise ContextTooLargeError(
            f"context tarball is {len(data)} bytes (cap {max_size}); "
            f"use {DETIGNORE_FILE} to exclude data/artifacts"
        )
    return data


def extract_context(data: bytes, dst: str) -> None:
    """Unpack a context tarball, refusing path traversal."""
    os.makedirs(dst, exist_ok=True)
    dst_real = os.path.realpath(dst)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            target = os.path.realpath(os.path.join(dst_real, member.name))
            if not (target == dst_real or target.startswith(dst_real + os.sep)):
                raise RuntimeError(f"context entry escapes workdir: {member.name}")
            if member.issym() or member.islnk():
                link_target = os.path.realpath(
                    os.path.join(os.path.dirname(target), member.linkname)
                )
                if not link_target.startswith(dst_real + os.sep):
                    raise RuntimeError(
                        f"context link escapes workdir: {member.name} -> {member.linkname}"
                    )
        # "data" filter re-checks traversal/links/permissions kernel-side
        tar.extractall(dst_real, filter="data")
