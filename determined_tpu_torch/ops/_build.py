"""Build and load the port's CUDA kernels.

Each kernel source under ``determined_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``.  The library lands in ``BUILD_DIR``
(``determined_tpu_torch/_build/``, listed in ``.gitignore``, or the
directory given to ``set_build_dir``) under a name keyed on a hash of the source, the
headers it includes from csrc/ (``#include "..."``, e.g. ``hopper.cuh``) and
the compiler flags, so a changed source or header rebuilds and an unchanged
one loads the library already there.  Nothing is built at import: the first
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(PKG_DIR, "_build")
BUILD_DIR = DEFAULT_BUILD_DIR

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# lines of a ptxas -v report: the function the next lines are about, a
# line that names its function, a spill count, a performance warning (C75xx:
# wgmmas serialised, setmaxnreg ignored)
_PTXAS_FUNCTION = re.compile(r"Compiling entry function '([^']+)'|Function properties for (\S+)")
_PTXAS_NAMED = re.compile(r"function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_PERF = re.compile(r"\(C75\d\d\)")

#: a C function's ctypes ``(argtypes, restype)``, by function name
Signatures = Dict[str, Tuple[list, type]]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Set[str] = set()


class NvccError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise NvccError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from csrc/ on the machine with the GPU"
    )


def _hash_with_includes(name: str, digest, seen: Set[str]) -> None:
    """Feed csrc/<name> and, depth first, every csrc/ header it includes
    with quotes into ``digest``, each file once."""
    if name in seen:
        return
    seen.add(name)
    with open(os.path.join(CSRC_DIR, name), "rb") as f:
        text = f.read()
    digest.update(name.encode() + b"\0" + text)
    for inc in _INCLUDE.findall(text):
        _hash_with_includes(inc.decode(), digest, seen)


def set_build_dir(path: str) -> int:
    """Build and load the libraries under ``path`` from now on (a cache that
    outlives the process: ``optimizations.compilation_cache_dir``); returns
    how many libraries are already there."""
    global BUILD_DIR
    os.makedirs(path, exist_ok=True)
    BUILD_DIR = path
    return sum(1 for e in os.scandir(path) if e.is_file() and e.name.endswith(".so"))


def library_path(source: str) -> str:
    """Where ``source`` (a file name under csrc/) builds to."""
    digest = hashlib.sha256()
    _hash_with_includes(source, digest, set())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library path.  The ptxas report (registers, shared memory,
    spills) is kept beside the library as ``<lib>.ptxas.txt``."""
    return build_all([source])[0]


def build_all(sources: Sequence[str]) -> List[str]:
    """Compile every source whose library is not built yet, one ``nvcc``
    process per source, all started together; returns the library paths in
    the order given.  Raises ``NvccError`` naming each source that failed."""
    outs = [library_path(s) for s in sources]
    todo = [(s, out) for s, out in zip(sources, outs) if not os.path.exists(out)]
    if not todo:
        return outs
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for source, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    failures = []
    for source, out, tmp, proc in procs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{stderr}")
            continue
        with open(out + ".ptxas.txt", "w", encoding="utf-8") as f:
            f.write(stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise NvccError("\n".join(failures))
    return outs


def load(source: str, signatures: Optional[Signatures] = None) -> ctypes.CDLL:
    """Build (first use) and load the library of ``csrc/<source>``; the first
    call that passes ``signatures`` sets those functions' ctypes argument
    and result types, once for the library."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _libs[source] = lib
        if signatures and source not in _bound:
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _bound.add(source)
        return lib


def ptxas_report(source: str) -> Optional[str]:
    """The ptxas output saved by the last build of ``source``, if any."""
    path = library_path(source) + ".ptxas.txt"
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return f.read()


def ptxas_faults(report: str, kernel: str) -> List[str]:
    """The lines of a ptxas report that show a function whose (mangled)
    name contains ``kernel`` spilling registers or losing performance
    (C75xx: its wgmmas serialised, its setmaxnreg ignored)."""
    faults, current = [], ""
    for line in report.splitlines():
        m = _PTXAS_FUNCTION.search(line)
        if m:
            current = m.group(1) or m.group(2)
            continue
        named = _PTXAS_NAMED.search(line)
        if kernel not in (named.group(1) if named else current):
            continue
        spill = _PTXAS_SPILL.search(line)
        if _PTXAS_PERF.search(line) or (spill and int(spill.group(1)) + int(spill.group(2))):
            faults.append(line.strip())
    return faults
