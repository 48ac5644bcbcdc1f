"""Observability: experiment-wide tracing and the goodput ledger.

Port of ``determined_tpu/observability``.  Every concurrent subsystem
reports spans/counters into the process tracer (``get_tracer()``); the
timeline exports as Chrome trace-event JSON under
``checkpoint_dir/traces/`` (viewable in Perfetto) and folds into a goodput
ledger attributing every second of wall-clock to a named phase
(``python -m determined_tpu_torch.cli experiment profile <dir>``).

The hot-path contract: recording never locks, never blocks, never syncs
the host with the device; a disabled tracer costs one attribute check.
"""

from determined_tpu_torch.observability._goodput import (
    PEAK_FLOPS_BY_KIND,
    PRODUCTIVE_CATS,
    chip_peak_flops,
    compute_ledger,
    format_ledger_text,
    load_trace_events,
)
from determined_tpu_torch.observability._tracer import Tracer, get_tracer

__all__ = [
    "PEAK_FLOPS_BY_KIND",
    "PRODUCTIVE_CATS",
    "Tracer",
    "chip_peak_flops",
    "compute_ledger",
    "export_experiment_trace",
    "format_ledger_text",
    "get_tracer",
    "load_trace_events",
]


def export_experiment_trace(tracer, out_dir: str) -> dict:
    """Finalize an experiment's trace: write ``trace.json`` (Perfetto) and
    ``goodput.json`` (the ledger) under ``out_dir``.  Returns the ledger."""
    import json
    import os

    trace_path = tracer.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    ledger = compute_ledger(tracer.chrome_events(), dropped=tracer.dropped())
    ledger_path = os.path.join(out_dir, "goodput.json")
    tmp = ledger_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(ledger, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, ledger_path)
    ledger["trace_path"] = trace_path
    return ledger
