"""torch.profiler (Kineto) trace analysis: per-op device-time tables.

The port's counterpart of ``determined_tpu/utils/xplane.py``: the JAX
package folds a ``jax.profiler`` xplane into an op table, the port folds
the Chrome trace that ``torch.profiler`` exports (``core/_profiler.py``
writes one per trace window).  The same functions under the same roles:
``trace_files`` (``xplane_files``), ``op_table`` (``hlo_op_table``),
``split_collectives`` and ``category_totals``; ``collective_bytes`` reads
the bytes each collective moved from the records c10d writes for NCCL.

A device op is a Chrome ``X`` event of category ``kernel``, ``gpu_memcpy``
or ``gpu_memset``; ops merge by name, and each is put in a category from
its name (``kernel_category``): the port's four hand-written kernels, the
cuBLAS/CUTLASS matmuls, NCCL collectives, reductions, and the rest
(PyTorch's elementwise kernels, copies and casts).  A trace with no device
events (a CPU run) falls back to a table of the host's ops, as the JAX
package's ``_host_trace_table`` does.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple, Union

#: Chrome-trace categories of the events that ran on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of the host's op events, for the CPU fallback
HOST_CATS = ("cpu_op", "user_annotation")

# categories that are cross-device communication
COLLECTIVE_CATEGORIES = ("collective",)

# (category, substrings of a lower-cased kernel name), first match wins:
# the port's kernels by their CUDA function names (csrc/), then libraries
_KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_fwd", ("flash_fwd",)),
    ("fused_adamw", ("adamw",)),
    ("collective", ("nccl",)),
    ("matmul", ("gemm", "cutlass", "nvjet", "sm90_xmma", "cublas")),
    ("reductions", ("reduce", "norm")),
)
#: everything else: PyTorch's elementwise kernels, copies, casts, memsets
OTHER_CATEGORY = "elementwise"

TraceSource = Union[str, Sequence[str]]


def kernel_category(name: str) -> str:
    low = name.lower()
    for category, needles in _KERNEL_GROUPS:
        if any(n in low for n in needles):
            return category
    return OTHER_CATEGORY


def trace_files(trace_dir: str) -> List[str]:
    """Every Chrome trace ``torch.profiler`` wrote under ``trace_dir``."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True))


def _events(files: Iterable[str]) -> List[Dict[str, object]]:
    events: List[Dict[str, object]] = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        events.extend(trace.get("traceEvents", []) if isinstance(trace, dict) else trace)
    return events


def _table(events: List[Dict[str, object]], cats: Tuple[str, ...], category) -> List[Dict[str, object]]:
    time_us: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            name = str(e.get("name", "?"))
            time_us[name] += float(e.get("dur") or 0.0)
            count[name] += 1
    return [
        {"name": n, "category": category(n), "expression": n[:160], "time_us": us,
         "count": count[n]}
        for n, us in sorted(time_us.items(), key=lambda kv: -kv[1])
    ]


def op_table(trace_source: TraceSource) -> List[Dict[str, object]]:
    """[{name, category, expression, time_us, count}] from a trace directory
    or a list of trace files, heaviest first.

    Raises RuntimeError when the source holds no trace files.  Without
    device events the rows are the host's ops (category ``host``); nested
    host ops include their children, so that table shows host activity,
    not a roofline."""
    files = (
        list(trace_source)
        if isinstance(trace_source, (list, tuple))
        else trace_files(trace_source)
    )
    if not files:
        raise RuntimeError(f"no torch.profiler trace under {trace_source}")
    events = _events(files)
    ops = _table(events, DEVICE_CATS, kernel_category)
    if ops:
        return ops
    return _table(events, HOST_CATS, lambda _name: "host")


def split_collectives(ops: List[Dict[str, object]]) -> Tuple[float, float]:
    """(collective_us, other_us) for an op table."""
    coll = other = 0.0
    for op in ops:
        hay = (str(op["category"]) + " " + str(op["name"])).lower()
        if any(c in hay for c in COLLECTIVE_CATEGORIES):
            coll += float(op["time_us"])
        else:
            other += float(op["time_us"])
    return coll, other


#: bytes an element of the dtype names a trace's collective records carry
_DTYPE_BYTES = {"float": 4, "float32": 4, "bfloat16": 2, "half": 2, "float16": 2,
                "double": 8, "float64": 8, "int": 4, "int32": 4, "long": 8, "int64": 8,
                "byte": 1, "char": 1, "bool": 1, "uint8": 1, "int8": 1}


def collective_bytes(trace_source: TraceSource) -> Dict[Tuple[str, Tuple[int, ...]], Dict[str, int]]:
    """The collectives of a trace by (name, the ranks of the group): calls,
    and the bytes in and out of each rank's calls, from the collective
    records ``torch.profiler`` writes for c10d's NCCL calls (the device's
    NCCL kernel events, or else the host's ``record_param_comms``: each
    names the collective, its element counts, dtype and group).  Empty for
    a trace without them (gloo's)."""
    files = (
        list(trace_source)
        if isinstance(trace_source, (list, tuple))
        else trace_files(trace_source)
    )
    events = _events(files)
    out: Dict[Tuple[str, Tuple[int, ...]], Dict[str, int]] = {}
    for cats in (DEVICE_CATS, HOST_CATS + ("cuda_runtime",)):
        for e in events:
            args = e.get("args") or {}
            if e.get("ph") != "X" or e.get("cat") not in cats or "In msg nelems" not in args:
                continue
            name = str(args.get("Collective name") or e.get("name"))
            ranks = args.get("Process Group Ranks") or []
            if isinstance(ranks, str):
                ranks = json.loads(ranks) if ranks.startswith("[") else []
            size = _DTYPE_BYTES.get(str(args.get("dtype", "")).lower(), 0)
            row = out.setdefault((name, tuple(int(r) for r in ranks)),
                                 {"calls": 0, "in_bytes": 0, "out_bytes": 0})
            row["calls"] += 1
            row["in_bytes"] += int(args.get("In msg nelems") or 0) * size
            row["out_bytes"] += int(args.get("Out msg nelems") or 0) * size
        if out:
            return out
    return out


def category_totals(ops: List[Dict[str, object]]) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for op in ops:
        out[str(op["category"]) or str(op["name"]).split(".")[0]] += float(op["time_us"])
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def category_counts(ops: List[Dict[str, object]]) -> Dict[str, int]:
    """Launches by category (the op table's counts summed)."""
    out: Dict[str, int] = defaultdict(int)
    for op in ops:
        out[str(op["category"])] += int(op["count"])
    return dict(out)
