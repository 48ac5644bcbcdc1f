"""ProfilerContext: system-metrics sampler and a bounded device-trace window.

Port of ``determined_tpu/core/_profiler.py``.  Collectors sample host
CPU/memory/network/disk plus the CUDA devices' memory (in use, limit and
share, under the JAX package's key names) on a daemon thread, reporting
into the metrics shipper as ``system_metrics`` rows.

Framework-level tracing is separate: ``on(trace=True)`` starts a
``torch.profiler`` capture of CPU ops and, with a GPU, CUDA kernels (where
the JAX package starts ``jax.profiler``).  ``stop_trace()`` ends it (the
Trainer calls it after ``profiling.end_after_batch`` steps), writes the
Chrome trace under ``trace_dir`` and reports the window's op table
(``utils/kineto.py``) as a ``profile`` metrics row.  Stopping the capture
waits for the device, once, at the window's end: that is the profiler's
own flush, and the tracer (``observability``) never does so.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from determined_tpu_torch.core._metrics import MetricsContext

logger = logging.getLogger("determined_tpu_torch.core.profiler")


def _read_proc_stat() -> Optional[Dict[str, float]]:
    try:
        with open("/proc/stat") as f:
            line = f.readline().split()
        vals = [float(v) for v in line[1:8]]
        idle = vals[3] + vals[4]
        total = sum(vals)
        return {"idle": idle, "total": total}
    except (OSError, ValueError, IndexError):
        return None


def _read_meminfo() -> Dict[str, float]:
    out: Dict[str, float] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                out[k.strip()] = float(rest.split()[0]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return out


def _read_net_bytes() -> Dict[str, float]:
    rx = tx = 0.0
    try:
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                name, _, rest = line.partition(":")
                if name.strip() == "lo":
                    continue
                cols = rest.split()
                rx += float(cols[0])
                tx += float(cols[8])
    except (OSError, ValueError, IndexError):
        pass
    return {"rx": rx, "tx": tx}


def _read_disk_bytes() -> Dict[str, float]:
    rd = wr = 0.0
    try:
        with open("/proc/diskstats") as f:
            for line in f:
                cols = line.split()
                if len(cols) < 10:
                    continue
                rd += float(cols[5]) * 512
                wr += float(cols[9]) * 512
    except (OSError, ValueError, IndexError):
        pass
    return {"read": rd, "write": wr}


def _cuda_memory_stats() -> Dict[str, float]:
    """The JAX package's ``_tpu_memory_stats`` keys for each CUDA device:
    bytes the caching allocator has handed out, the card's memory and the
    share.  A process that has not initialised CUDA (the CPU) reports no
    device keys, and the sampler never initialises it."""
    import torch

    out: Dict[str, float] = {}
    if not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        in_use = float(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0))
        out[f"device{i}_bytes_in_use"] = in_use
        _free, limit = torch.cuda.mem_get_info(i)
        if limit:
            out[f"device{i}_bytes_limit"] = float(limit)
            out[f"device{i}_hbm_util_pct"] = 100.0 * in_use / float(limit)
    return out


class ProfilerContext:
    SAMPLE_INTERVAL = 10.0

    def __init__(
        self,
        dist: Any,
        metrics: MetricsContext,
        trace_dir: str,
    ) -> None:
        self._dist = dist
        self._metrics = metrics
        self._trace_dir = trace_dir
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prof: Any = None
        self._steps_fn = lambda: None  # a trainer may install a steps provider

    def set_steps_fn(self, fn) -> None:
        # rebinding a callable the sampler reads: a reference store is
        # atomic under the GIL; the sampler uses either the old or new one
        self._steps_fn = fn

    def on(self, sampling: bool = True, trace: bool = False) -> None:
        if sampling and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._sample_loop, daemon=True, name="profiler-sampler"
            )
            self._thread.start()
        if trace and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            # no shapes, no stacks, no memory events: the window is bounded
            # and its trace stays small
            prof = profile(
                activities=activities, record_shapes=False, with_stack=False,
                profile_memory=False,
            )
            prof.start()
            self._prof = prof

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def _trace_path(self) -> str:
        os.makedirs(self._trace_dir, exist_ok=True)
        # unique across windows, trainers and processes sharing the directory
        return os.path.join(self._trace_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")

    def stop_trace(self) -> None:
        """End the capture window (the trainer calls this after
        ``profiling.end_after_batch`` steps: whole-run traces grow without
        bound), write its Chrome trace and report its op table."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        path = self._trace_path()
        prof.export_chrome_trace(path)
        self._report_trace_summary(path)

    def _report_trace_summary(self, path: str) -> None:
        """Fold the just-written trace into an op table + category totals
        and report them as a ``profile`` metrics row.  Chief-only;
        best-effort: a trace that cannot be read must never fail the
        trial."""
        if getattr(self._dist, "rank", 0) != 0:
            return
        try:
            from determined_tpu_torch.utils import kineto

            ops = kineto.op_table([path])
            if not ops:
                return
            self._metrics.report(
                "profile",
                self._steps_fn(),
                {
                    # top ops only: the row is a UI artifact, not an archive
                    "op_table": ops[:25],
                    "category_totals": kineto.category_totals(ops),
                },
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("trace summary not reported: %s", e)

    def off(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        self.stop_trace()

    def _sample_loop(self) -> None:
        prev_cpu = _read_proc_stat()
        prev_net = _read_net_bytes()
        prev_disk = _read_disk_bytes()
        prev_t = time.time()
        while not self._stop.wait(self.SAMPLE_INTERVAL):
            now = time.time()
            dt = max(now - prev_t, 1e-6)
            sample: Dict[str, Any] = {}
            cpu = _read_proc_stat()
            if cpu and prev_cpu:
                didle = cpu["idle"] - prev_cpu["idle"]
                dtotal = cpu["total"] - prev_cpu["total"]
                if dtotal > 0:
                    sample["cpu_util_pct"] = 100.0 * (1.0 - didle / dtotal)
            prev_cpu = cpu
            mem = _read_meminfo()
            if mem.get("MemTotal"):
                sample["memory_used_bytes"] = mem["MemTotal"] - mem.get("MemAvailable", 0.0)
                sample["memory_util_pct"] = 100.0 * sample["memory_used_bytes"] / mem["MemTotal"]
            net = _read_net_bytes()
            sample["net_rx_Bps"] = (net["rx"] - prev_net["rx"]) / dt
            sample["net_tx_Bps"] = (net["tx"] - prev_net["tx"]) / dt
            prev_net = net
            disk = _read_disk_bytes()
            sample["disk_read_Bps"] = (disk["read"] - prev_disk["read"]) / dt
            sample["disk_write_Bps"] = (disk["write"] - prev_disk["write"]) / dt
            prev_disk = disk
            try:
                sample.update(_cuda_memory_stats())
            except Exception:  # noqa: BLE001 - a sample must never kill the sampler
                logger.exception("device memory sample failed")
            prev_t = now
            try:
                self._metrics.report("system_metrics", self._steps_fn(), sample)
            except RuntimeError:
                return
