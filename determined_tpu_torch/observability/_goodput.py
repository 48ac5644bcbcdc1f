"""Goodput ledger: fold the span timeline into a wall-clock attribution.

Port of ``determined_tpu/observability/_goodput.py`` (the same ledger, rows
and text; it touches no JAX).  Before non-productive time can be fixed it
has to be *attributed*: setup, input, checkpoint, failure recovery, against
the productive time actually spent stepping.  This module digests the
tracer's Chrome events into that ledger, per trial and per experiment.

Attribution model (host timeline): spans within one thread nest (they come
from context managers / paired clock reads), so each span's **self time**
is its duration minus its children's.  Self time is bucketed by the span's
category; the self time of the ``trial.run`` wrapper itself (time inside
a trial not covered by any instrumented phase) lands in ``other``, which
is what the ``attributed_pct`` metric penalizes.  Device compute is
attributed through the host-side proxy (step dispatch + the boundary
metric-fetch block, category ``step``); a ``torch.profiler`` window
(``profiling.trace``, ``core/_profiler.py``) remains the ground truth for
on-device time and can be lined up with this timeline via the exported
wall-clock epoch.

Categories (the ``cat=`` each instrumentation site passes; the port
records those of a single-device run):

- ``step``       step dispatch + boundary block: the productive bucket
- ``compile``    first-call compile of a step (the JAX package's; eager
                 PyTorch steps compile nothing)
- ``setup``      trainer/model build
- ``data``       host-side input wait (and prefetch-worker fetch time)
- ``h2d``        host->device transfer dispatch
- ``checkpoint`` save/drain/stall/finalize
- ``restore``    checkpoint restore (resume replay)
- ``validate``   validation sweeps
- ``scheduler``  slot wait/dispatch (the JAX package's gang scheduler)
- ``rendezvous`` multi-host join wait (the JAX package's cluster path)
- ``remote``     a cluster experiment's view of a gang's run
- ``journal``    experiment WAL append+fsync
- ``restart``    supervisor backoff between attempts
- ``other``      uninstrumented remainder inside a trial/experiment span

``step.comm`` rows: gradient-collective time inside the productive
``step`` bucket, split into exposed vs hidden, from the
``step.comm.{bytes,exposed_us,hidden_us}`` COUNTERS (counters, not spans:
a synthetic span overlapping the real hot-loop spans would corrupt the
self-time nesting).  ``step.bubble`` rows: pipe-axis idle time from the
``step.bubble.*`` counters of a pipeline schedule.  Both come from the JAX
package's multi-device trainer; on the port's one device no counter feeds
them, so the rows stay absent, and the code that folds them is kept so the
two ledgers stay one function.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

PRODUCTIVE_CATS = ("step",)

#: containers whose SELF time is the uninstrumented remainder, not a phase
_WRAPPER_CATS = ("trial", "experiment")

# dense bf16 peak FLOP/s by ``torch.cuda.get_device_name()`` (NVIDIA's
# data sheets); longest-prefix matched.  Each H100 part has its own entry
# (the SXM card names itself by its memory), so a card not listed falls to
# the caller's default rather than to another part's peak.  The Trainer
# uses it for the ledger's mfu_estimate.
PEAK_FLOPS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}


def chip_peak_flops(device_kind: str, default: float = 989e12) -> float:
    for prefix in sorted(PEAK_FLOPS_BY_KIND, key=len, reverse=True):
        if device_kind.startswith(prefix):
            return PEAK_FLOPS_BY_KIND[prefix]
    return default


def _span_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [
        e
        for e in events
        if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))
    ]


def _nest(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Annotate a single thread's spans with self time + owning trial.

    Returns records ``{name, cat, ts, dur, self, trial}`` (microseconds).
    Spans are treated as properly nested per thread; the tiny float
    tolerance absorbs clock-read ordering at span boundaries.
    """
    eps = 0.6  # us: adjacent clock reads can collide at our rounding
    out: List[Dict[str, Any]] = []
    stack: List[Dict[str, Any]] = []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        rec = {
            "name": e["name"],
            "cat": e.get("cat") or "misc",
            "ts": float(e["ts"]),
            "dur": float(e["dur"]),
            "self": float(e["dur"]),
            "trial": (e.get("args") or {}).get("trial"),
        }
        end = rec["ts"] + rec["dur"]
        while stack and rec["ts"] >= stack[-1]["_end"] - eps:
            stack.pop()
        if stack:
            parent = stack[-1]
            parent["self"] = max(parent["self"] - rec["dur"], 0.0)
            if rec["trial"] is None:
                rec["trial"] = parent["trial"]
        rec["_end"] = end
        stack.append(rec)
        out.append(rec)
    for rec in out:
        rec.pop("_end", None)
    return out


def _counter_totals(events: List[Dict[str, Any]]) -> Dict[str, float]:
    totals: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "C":
            continue
        val = float((e.get("args") or {}).get("value", 0.0))
        if e.get("cat") == "gauge":
            totals[e["name"]] = val
        else:
            totals[e["name"]] = totals.get(e["name"], 0.0) + val
    return totals


def _trial_counters(
    events: List[Dict[str, Any]], trial_windows: Dict[Any, List[Tuple[Any, float, float]]]
) -> Dict[Any, Dict[str, float]]:
    """Per-trial counter totals: a counter event belongs to the trial whose
    ``trial.run`` window (same thread) contains its timestamp."""
    out: Dict[Any, Dict[str, float]] = defaultdict(dict)
    for e in events:
        if e.get("ph") != "C":
            continue
        tid = (e.get("pid", 0), e.get("tid", 0))
        ts = float(e.get("ts") or 0.0)
        trial = (e.get("args") or {}).get("trial")
        if trial is None:
            for rid, t0, t1 in trial_windows.get(tid, ()):
                if t0 <= ts <= t1:
                    trial = rid
                    break
        if trial is None:
            continue
        bucket = out[trial]
        val = float((e.get("args") or {}).get("value", 0.0))
        if e.get("cat") == "gauge":
            bucket[e["name"]] = val
        else:
            bucket[e["name"]] = bucket.get(e["name"], 0.0) + val
    return out


def _comm_entry(
    counters: Dict[str, float], step_us: float
) -> Optional[Dict[str, Any]]:
    """Fold step.comm.* counters into an exposed-vs-hidden comm record
    (None when no comm accounting rode the trace)."""
    exposed_us = counters.get("step.comm.exposed_us")
    if exposed_us is None:
        return None
    hidden_us = counters.get("step.comm.hidden_us", 0.0)
    entry: Dict[str, Any] = {
        "exposed_s": round(exposed_us / 1e6, 6),
        "hidden_s": round(hidden_us / 1e6, 6),
        "exposed_pct_of_step": round(
            100.0 * exposed_us / max(step_us, 1e-9), 2
        ),
        "model": "bucket-schedule-v1",
    }
    if "step.comm.bytes" in counters:
        entry["bytes"] = int(counters["step.comm.bytes"])
    # per-hop (ICI vs DCN) sub-records from the link-aware comm model; a
    # single-hop (pre-multi-slice) trace simply has no such counters
    hops: Dict[str, Any] = {}
    for hop in ("ici", "dcn"):
        hop_exposed = counters.get(f"step.comm.{hop}.exposed_us")
        if hop_exposed is None:
            continue
        hops[hop] = {
            "exposed_s": round(hop_exposed / 1e6, 6),
            "hidden_s": round(
                counters.get(f"step.comm.{hop}.hidden_us", 0.0) / 1e6, 6
            ),
        }
        if f"step.comm.{hop}.bytes" in counters:
            hops[hop]["bytes"] = int(counters[f"step.comm.{hop}.bytes"])
    if hops:
        entry["hops"] = hops
    return entry


def _bubble_entry(
    counters: Dict[str, float], step_us: float
) -> Optional[Dict[str, Any]]:
    """Fold step.bubble.* counters into an exposed-bubble record (None
    when no pipeline schedule rode the trace)."""
    exposed_us = counters.get("step.bubble.exposed_us")
    if exposed_us is None:
        return None
    entry: Dict[str, Any] = {
        "exposed_s": round(exposed_us / 1e6, 6),
        "pct_of_step": round(100.0 * exposed_us / max(step_us, 1e-9), 2),
        "model": "pipeline-tick-v1",
    }
    if "step.bubble.fraction" in counters:
        entry["fraction_modeled"] = round(counters["step.bubble.fraction"], 4)
    if "step.bubble.ticks_total" in counters:
        entry["ticks_total"] = int(counters["step.bubble.ticks_total"])
    if "step.bubble.ticks_idle" in counters:
        entry["ticks_idle"] = int(counters["step.bubble.ticks_idle"])
    return entry


def _breakdown(cat_us: Dict[str, float], denom_us: float) -> Dict[str, Dict[str, float]]:
    denom = max(denom_us, 1e-9)
    return {
        cat: {
            "seconds": round(us / 1e6, 6),
            "pct": round(100.0 * us / denom, 2),
        }
        for cat, us in sorted(cat_us.items(), key=lambda kv: -kv[1])
    }


def _rebase_epochs(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Put events from different processes on one timeline.

    A resumed run appends to the same ``events.jsonl`` from a NEW process
    whose span timestamps are relative to its own monotonic epoch — both
    runs' spans would start near ts=0 and falsely nest.  Each process
    writes a ``clock_sync`` metadata record carrying its wall-clock epoch;
    rebasing shifts every pid's timestamps by its epoch delta from the
    earliest process, so resume gaps and orderings come out real.
    No-op when all events share one pid or no clock_sync is present.
    """
    epochs: Dict[Any, float] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "clock_sync":
            unix = (e.get("args") or {}).get("epoch_unix_s")
            if isinstance(unix, (int, float)):
                epochs.setdefault(e.get("pid"), float(unix))
    if len(epochs) < 2:
        return events
    base = min(epochs.values())
    out = []
    for e in events:
        off = epochs.get(e.get("pid"))
        if off is None or "ts" not in e or e.get("ph") == "M":
            out.append(e)
            continue
        e = dict(e)
        e["ts"] = float(e["ts"]) + (off - base) * 1e6
        out.append(e)
    return out


def compute_ledger(
    events: List[Dict[str, Any]], *, dropped: int = 0
) -> Dict[str, Any]:
    """Digest Chrome trace events into the goodput ledger.

    Returns ``{"experiment": {...}, "trials": {rid: {...}}, "counters",
    "threads", "dropped_events"}``.  ``attributed_pct`` is the share of
    trial wall-clock covered by *named* phases (everything except the
    ``other`` remainder) — the acceptance bar is >= 95.
    """
    events = _rebase_epochs(events)
    spans = _span_events(events)
    # tracks key on (pid, tid): a resumed run's process reuses the same
    # thread idents (MainThread, trial threads), which must not merge
    by_tid: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
    for e in spans:
        by_tid[(e.get("pid", 0), e.get("tid", 0))].append(e)

    exp_wall_us = 0.0
    trial_wall_us: Dict[Any, float] = defaultdict(float)
    trial_cat_us: Dict[Any, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    thread_cat_us: Dict[Any, Dict[str, float]] = {}
    trial_windows: Dict[Any, List[Tuple[Any, float, float]]] = defaultdict(list)

    for tid, tspans in by_tid.items():
        recs = _nest(tspans)
        cat_us: Dict[str, float] = defaultdict(float)
        for rec in recs:
            cat = rec["cat"]
            if rec["name"] == "experiment.run":
                exp_wall_us += rec["dur"]
            if rec["name"] == "trial.run" and rec["trial"] is not None:
                trial_wall_us[rec["trial"]] += rec["dur"]
                trial_windows[tid].append(
                    (rec["trial"], rec["ts"], rec["ts"] + rec["dur"])
                )
            bucket = "other" if cat in _WRAPPER_CATS else cat
            cat_us[bucket] += rec["self"]
            if rec["trial"] is not None:
                trial_cat_us[rec["trial"]][bucket] += rec["self"]
        thread_cat_us[tid] = dict(cat_us)

    if exp_wall_us <= 0.0 and spans:
        t0 = min(e["ts"] for e in spans)
        t1 = max(e["ts"] + e["dur"] for e in spans)
        exp_wall_us = t1 - t0

    counters = _counter_totals(events)
    per_trial_counters = _trial_counters(events, trial_windows)
    flops_per_token = counters.get("train.flops_per_token")
    peak_flops = counters.get("device.peak_flops_total")

    trials: Dict[Any, Dict[str, Any]] = {}
    total_trial_us = 0.0
    total_attr_us = 0.0
    total_prod_us = 0.0
    agg_cat_us: Dict[str, float] = defaultdict(float)
    for rid, wall in sorted(trial_wall_us.items(), key=lambda kv: str(kv[0])):
        cats = trial_cat_us.get(rid, {})
        attributed = sum(us for c, us in cats.items() if c != "other")
        productive = sum(cats.get(c, 0.0) for c in PRODUCTIVE_CATS)
        tc = per_trial_counters.get(rid, {})
        steps = tc.get("train.steps")
        samples = tc.get("train.samples")
        tokens = tc.get("train.tokens")
        wall_s = wall / 1e6
        entry: Dict[str, Any] = {
            "wall_s": round(wall_s, 6),
            "attributed_pct": round(100.0 * min(attributed / max(wall, 1e-9), 1.0), 2),
            "productive_pct": round(100.0 * min(productive / max(wall, 1e-9), 1.0), 2),
            "breakdown": _breakdown(dict(cats), wall),
        }
        if steps:
            entry["steps"] = int(steps)
        if samples:
            entry["samples"] = int(samples)
            entry["samples_per_s"] = round(samples / max(wall_s, 1e-9), 2)
        if tokens:
            entry["tokens"] = int(tokens)
            entry["tokens_per_s"] = round(tokens / max(wall_s, 1e-9), 2)
            tfpt = tc.get("train.flops_per_token") or flops_per_token
            tpeak = tc.get("device.peak_flops_total") or peak_flops
            if tfpt and tpeak:
                entry["mfu_estimate"] = round(
                    (tokens / max(wall_s, 1e-9)) * tfpt / tpeak, 4
                )
        comm = _comm_entry(tc, cats.get("step", 0.0))
        if comm is not None:
            entry["step.comm"] = comm
        bubble = _bubble_entry(tc, cats.get("step", 0.0))
        if bubble is not None:
            entry["step.bubble"] = bubble
        trials[rid] = entry
        total_trial_us += wall
        total_attr_us += attributed
        total_prod_us += productive
        for c, us in cats.items():
            agg_cat_us[c] += us

    experiment: Dict[str, Any] = {
        "wall_s": round(exp_wall_us / 1e6, 6),
        "trial_seconds": round(total_trial_us / 1e6, 6),
        "attributed_pct": round(
            100.0 * min(total_attr_us / max(total_trial_us, 1e-9), 1.0), 2
        ),
        "productive_pct": round(
            100.0 * min(total_prod_us / max(total_trial_us, 1e-9), 1.0), 2
        ),
        "breakdown": _breakdown(dict(agg_cat_us), total_trial_us),
        "trials": len(trials),
    }
    exp_comm = _comm_entry(counters, agg_cat_us.get("step", 0.0))
    if exp_comm is not None:
        experiment["step.comm"] = exp_comm
    exp_bubble = _bubble_entry(counters, agg_cat_us.get("step", 0.0))
    if exp_bubble is not None:
        experiment["step.bubble"] = exp_bubble
    tokens_total = sum(t.get("tokens", 0) for t in trials.values())
    if tokens_total and total_trial_us > 0:
        experiment["tokens_per_s"] = round(tokens_total / (total_trial_us / 1e6), 2)

    threads = {
        f"{pid}:{tid}": _breakdown(cats, max(sum(cats.values()), 1e-9))
        for (pid, tid), cats in thread_cat_us.items()
    }

    return {
        "experiment": experiment,
        "trials": trials,
        "threads": threads,
        "counters": counters,
        "dropped_events": dropped,
    }


# -- trace loading (the CLI side) --------------------------------------------


def load_trace_events(traces_dir: str) -> List[Dict[str, Any]]:
    """Load Chrome trace events from an experiment's ``traces/`` directory.

    Prefers ``events.jsonl`` (append-only, survives SIGKILL, spans resumed
    runs) and falls back to ``trace.json`` (the finalized export)."""
    jsonl = os.path.join(traces_dir, "events.jsonl")
    if os.path.exists(jsonl):
        events: List[Dict[str, Any]] = []
        with open(jsonl, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue  # crash-truncated tail line
        return events
    trace = os.path.join(traces_dir, "trace.json")
    if os.path.exists(trace):
        with open(trace, encoding="utf-8") as f:
            return json.load(f).get("traceEvents", [])
    return []


def _comm_line(c: Dict[str, Any]) -> str:
    """The "exposed comm" profile line: how much of the gradient-collective
    time sits on the critical path vs hides behind backward compute, with
    one sub-line per hop where the trace has them."""
    line = (
        f"  exposed comm {c['exposed_s']:>10.3f}s "
        f"({c['exposed_pct_of_step']:.1f}% of step; "
        f"hidden {c['hidden_s']:.3f}s) [{c['model']}]"
    )
    for hop, h in c.get("hops", {}).items():
        size = f", {h['bytes'] / 1e9:.2f} GB" if "bytes" in h else ""
        line += (
            f"\n    {hop:<4} exposed {h['exposed_s']:>8.3f}s "
            f"(hidden {h['hidden_s']:.3f}s{size})"
        )
    return line


def _bubble_line(b: Dict[str, Any]) -> str:
    """The "exposed bubble" profile line: how much of the step a pipeline
    schedule's tick model attributes to pipe-axis idle time."""
    frac = b.get("fraction_modeled")
    ticks = (
        f"; {b['ticks_idle']}/{b['ticks_total']} ticks idle"
        if "ticks_total" in b and "ticks_idle" in b
        else ""
    )
    detail = f" (modeled {100.0 * frac:.1f}%{ticks})" if frac is not None else ""
    return (
        f"  exposed bubble {b['exposed_s']:>8.3f}s "
        f"({b['pct_of_step']:.1f}% of step){detail} [{b['model']}]"
    )


def format_ledger_text(ledger: Dict[str, Any]) -> str:
    """Human-readable ledger (the ``experiment profile`` text view)."""
    exp = ledger["experiment"]
    lines = [
        f"experiment wall-clock: {exp['wall_s']:.2f}s over {exp['trials']} trial(s) "
        f"({exp['trial_seconds']:.2f} trial-seconds)",
        f"attributed: {exp['attributed_pct']:.1f}%   "
        f"productive (step): {exp['productive_pct']:.1f}%",
    ]
    if "tokens_per_s" in exp:
        lines.append(f"tokens/s (per trial-second): {exp['tokens_per_s']:.1f}")
    lines.append("")
    lines.append("phase breakdown (% of trial-seconds):")
    for cat, row in exp["breakdown"].items():
        lines.append(f"  {cat:<12} {row['seconds']:>10.3f}s  {row['pct']:>6.2f}%")
    if "step.comm" in exp:
        lines.append(_comm_line(exp["step.comm"]))
    if "step.bubble" in exp:
        lines.append(_bubble_line(exp["step.bubble"]))
    for rid, t in ledger["trials"].items():
        lines.append("")
        head = (
            f"trial {rid}: {t['wall_s']:.2f}s  attributed {t['attributed_pct']:.1f}%"
            f"  productive {t['productive_pct']:.1f}%"
        )
        extras = []
        if "steps" in t:
            extras.append(f"{t['steps']} steps")
        if "samples_per_s" in t:
            extras.append(f"{t['samples_per_s']:.1f} samples/s")
        if "tokens_per_s" in t:
            extras.append(f"{t['tokens_per_s']:.1f} tokens/s")
        if "mfu_estimate" in t:
            extras.append(f"mfu~{t['mfu_estimate']:.3f}")
        if extras:
            head += "  (" + ", ".join(extras) + ")"
        lines.append(head)
        for cat, row in t["breakdown"].items():
            lines.append(f"  {cat:<12} {row['seconds']:>10.3f}s  {row['pct']:>6.2f}%")
        if "step.comm" in t:
            lines.append(_comm_line(t["step.comm"]))
        if "step.bubble" in t:
            lines.append(_bubble_line(t["step.bubble"]))
    if ledger.get("dropped_events"):
        lines.append("")
        lines.append(
            f"WARNING: {ledger['dropped_events']} events dropped (ring overflow); "
            "percentages under-count the busiest phases"
        )
    return "\n".join(lines)
