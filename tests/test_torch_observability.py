"""The port's observability layer (determined_tpu_torch/observability)
against the JAX package's: the tracer's rings, drops and Chrome/JSONL
export, the goodput ledger on fixed event lists (the two ``compute_ledger``
must give equal dicts and ``format_ledger_text`` equal strings), the
``observability`` configuration's verdicts, and a local experiment on the
CPU with ``trace_export: true`` read by both packages' ledger and CLI.

Wall-clock shares are never asserted on a traced run (they flake under the
suite's load); real runs are held to structure and exact counts.
"""

import json
import os
import threading
import time

import pytest

import determined_tpu.observability as jax_obs
import determined_tpu_torch.observability as port_obs
from determined_tpu_torch.observability import Tracer, get_tracer
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_global_tracer():
    """The process-global tracer must not leak its drain thread, its export
    file or its events into the next test."""
    yield
    tracer = get_tracer()
    tracer.close()
    tracer.configure(enabled=True)
    tracer.reset()


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_spans_thread_safe_under_concurrent_trial_threads():
    """Many threads recording at once lose nothing when the rings are
    sized for the load, and each keeps its own track."""
    tracer = Tracer(ring_capacity=8192, flush_interval=0.05)
    tracer.start()
    n_threads, per_thread = 8, 1000
    # all alive at once: a recycled thread ident would merge tracks
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait(timeout=30)
        for k in range(per_thread):
            t0 = time.monotonic()
            tracer.record_span("work", "step", t0, t0 + 1e-6, {"k": k})
            if k % 100 == 0:
                tracer.counter("work.count", 1.0)

    threads = [threading.Thread(target=worker, name=f"trial-{i}") for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    tracer.stop()
    spans = [e for e in tracer.chrome_events() if e.get("ph") == "X"]
    assert len(spans) == n_threads * per_thread
    assert tracer.dropped() == 0
    assert tracer.counters()["work.count"] == n_threads * (per_thread // 100)
    assert len({e["tid"] for e in spans}) == n_threads
    assert tracer.stats()["threads"] <= n_threads  # dead threads' rings pruned


def test_ring_overflow_drops_counted_never_blocks():
    tracer = Tracer(ring_capacity=16)  # no drain thread: the ring must overflow
    t0 = time.monotonic()
    for _ in range(100):
        tracer.record_span("s", "step", t0, t0 + 1e-6)
    assert time.monotonic() - t0 < 1.0  # a full ring drops; it never blocks
    assert tracer.dropped() == 84
    assert len([e for e in tracer.chrome_events() if e.get("ph") == "X"]) == 16
    assert tracer.stats()["dropped"] == 84
    # the ledger carries the drops and its text warns
    ledger = port_obs.compute_ledger(tracer.chrome_events(), dropped=tracer.dropped())
    assert ledger["dropped_events"] == 84
    assert "84 events dropped" in port_obs.format_ledger_text(ledger)


def test_disabled_tracer_records_nothing():
    tracer = Tracer()
    tracer.configure(enabled=False)
    tracer.record_span("s", "step", 0.0, 1.0)
    tracer.counter("c", 1)
    tracer.gauge("g", 1)
    tracer.instant("i")
    with tracer.span("x", cat="step"):
        pass
    assert tracer.chrome_events() == []
    assert tracer.counters() == {}


def test_chrome_trace_and_jsonl_well_formed(tmp_path):
    out_dir = str(tmp_path / "traces")
    tracer = Tracer()
    tracer.configure(out_dir=out_dir)
    tracer.start()

    def worker():
        with tracer.span("child", cat="data"):
            time.sleep(0.002)
        tracer.gauge("depth", 3.0)

    with tracer.span("parent", cat="trial", trial=7):
        t = threading.Thread(target=worker, name="obs-test-worker")
        t.start()
        t.join(timeout=30)
    tracer.instant("marker", "checkpoint")
    tracer.stop()
    path = tracer.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    tracer.close()

    with open(path) as f:
        payload = json.load(f)
    events = payload["traceEvents"]
    assert payload["otherData"]["dropped_events"] == 0
    for ev in events:
        assert {"ph", "name", "ts", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in events}
    assert {"parent", "child", "marker", "depth", "thread_name"} <= {e["name"] for e in events}
    assert next(e for e in events if e["name"] == "parent")["args"]["trial"] == 7
    # the JSONL export parses line by line, with its clock_sync record first
    with open(os.path.join(out_dir, "events.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["name"] == "clock_sync"
    assert {e["name"] for e in lines if e["ph"] == "X"} == {"parent", "child"}
    # both packages' loaders read the directory the same way
    assert port_obs.load_trace_events(out_dir) == jax_obs.load_trace_events(out_dir) == lines


def _record_sequence(tracer):
    tracer.record_span("data.wait", "data", 1.0, 1.5)
    with tracer.span("trial.run", cat="trial", trial=3):
        tracer.counter("train.steps", 2.0)
        tracer.gauge("device.peak_flops_total", 989e12)
        with tracer.span("checkpoint.save", cat="checkpoint", mode="sync", step=4):
            pass
    tracer.instant("trial.failure", "restart", kind="transient", restarts=1)
    tracer.counter("train.steps", 3.0, trial=3)


def test_tracer_events_match_the_jax_tracer():
    """The same calls on both tracers give the same events (names,
    categories, phases, args, thread) apart from their times."""
    from determined_tpu.observability import Tracer as JaxTracer

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]

    port, ref = Tracer(), JaxTracer()
    _record_sequence(port)
    _record_sequence(ref)
    assert strip(port.chrome_events()) == strip(ref.chrome_events())
    assert port.counters() == ref.counters() == {
        "train.steps": 5.0, "device.peak_flops_total": 989e12}
    assert port.stats() == ref.stats()


# ---------------------------------------------------------------------------
# the goodput ledger against the JAX package's, on fixed event lists
# ---------------------------------------------------------------------------


def _x(name, cat, ts, dur, tid=1, pid=1, **args):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": float(ts), "dur": float(dur),
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _c(name, value, ts, kind="counter", tid=1, pid=1, **args):
    return {"ph": "C", "name": name, "cat": kind, "ts": float(ts), "pid": pid, "tid": tid,
            "args": dict(args, value=value)}


def _trial_events(rid, tid, t0=0.0, pid=1):
    """A trial of 1 s: setup, two steps (data wait, dispatch), a boundary
    block, a validation, a save with its digest, and 50 ms uninstrumented
    (the ``other`` remainder)."""
    return [
        _x("trial.run", "trial", t0, 1e6, tid, pid, trial=rid),
        _x("trainer.setup", "setup", t0 + 10, 100_000, tid, pid),
        _x("data.wait", "data", t0 + 100_010, 20_000, tid, pid),
        _x("step.dispatch", "step", t0 + 120_010, 180_000, tid, pid),
        _x("data.wait", "data", t0 + 300_010, 20_000, tid, pid),
        _x("step.dispatch", "step", t0 + 320_010, 180_000, tid, pid),
        _x("step.boundary_block", "step", t0 + 500_010, 150_000, tid, pid),
        _c("train.steps", 2.0, t0 + 650_020, tid=tid, pid=pid),
        _c("train.samples", 16.0, t0 + 650_020, tid=tid, pid=pid),
        _c("train.tokens", 16.0 * 1024, t0 + 650_020, tid=tid, pid=pid),
        _x("validate", "validate", t0 + 650_030, 100_000, tid, pid, step=2),
        _x("checkpoint.save", "checkpoint", t0 + 750_040, 200_000, tid, pid, mode="sync"),
        _x("checkpoint.digest", "checkpoint", t0 + 800_000, 120_000, tid, pid),
    ]


def _case_nested():
    return _trial_events(1, tid=11) + [
        _c("train.flops_per_token", 3.825e9, 5, kind="gauge", tid=11),
        _c("device.peak_flops_total", 989e12, 5, kind="gauge", tid=11),
    ], 0


def _case_two_trials_and_journal():
    events = [_x("experiment.run", "experiment", 0, 2.5e6, tid=1)]
    events += [_x("journal.append", "journal", 100 + i * 1000, 400, tid=1, type="t")
               for i in range(3)]
    events += _trial_events(1, tid=21, t0=10_000) + _trial_events(2, tid=22, t0=1_200_000)
    # a prefetch worker's fetches and queue gauge: another thread, no trial
    events += [_x("data.fetch", "data", 20_000 + i * 5_000, 2_000, tid=23) for i in range(4)]
    events += [_c("data.queue_depth", float(i), 20_000 + i * 5_000, kind="gauge", tid=23)
               for i in range(4)]
    return events, 0


def _case_restart_and_restore():
    """A crash, the supervisor's backoff and the next attempt's restore
    (the chaos run of the JAX package's tests as fixed events)."""
    events = [
        _x("trial.run", "trial", 0, 2e6, tid=5, trial=9),
        _x("trainer.setup", "setup", 10, 100_000, tid=5),
        _x("step.dispatch", "step", 100_020, 300_000, tid=5),
        {"ph": "i", "s": "t", "name": "trial.failure", "cat": "restart", "ts": 400_030.0,
         "pid": 1, "tid": 5, "args": {"kind": "transient", "restarts": 1}},
        _x("restart.backoff", "restart", 400_040, 250_000, tid=5, restarts=1),
        _x("trainer.setup", "setup", 650_050, 100_000, tid=5),
        _x("checkpoint.restore", "restore", 750_060, 400_000, tid=5, storage_id="u1"),
        _x("checkpoint.verify", "restore", 750_070, 250_000, tid=5),
        _x("checkpoint.load", "restore", 1_000_080, 140_000, tid=5),
        _x("step.dispatch", "step", 1_150_070, 700_000, tid=5),
        _c("train.steps", 6.0, 1_850_080, tid=5),
    ]
    return events, 3


def _case_resumed_epochs():
    """A resumed run appends to events.jsonl from a new process: same
    thread ident, timestamps restarting near 0, a later wall-clock epoch."""

    def run(pid, epoch, rid):
        return [
            {"ph": "M", "name": "clock_sync", "pid": pid, "tid": 0, "ts": 0,
             "args": {"epoch_unix_s": epoch}},
            _x("trial.run", "trial", 0, 1e6, tid=111, pid=pid, trial=rid),
            _x("step.dispatch", "step", 100, 9e5, tid=111, pid=pid),
            _c("train.steps", 3.0, 950_000, tid=111, pid=pid),
        ]

    return run(1000, 1_700_000_000.0, 1) + run(2000, 1_700_000_050.0, 1), 0


def _case_comm_and_bubble_counters():
    """The JAX package's multi-device rows: the port never emits these
    counters, but the folding code is shared."""
    events = _trial_events("t1", tid=3) + [
        _c("step.comm.exposed_us", 40_000.0, 600, tid=3),
        _c("step.comm.hidden_us", 60_000.0, 600, tid=3),
        _c("step.comm.bytes", 1e9, 600, tid=3),
        _c("step.comm.ici.exposed_us", 30_000.0, 600, tid=3),
        _c("step.bubble.exposed_us", 11_000.0, 600, tid=3),
        _c("step.bubble.fraction", 3 / 19, 600, kind="gauge", tid=3),
        _c("step.bubble.ticks_total", 19.0, 600, kind="gauge", tid=3),
        _c("step.bubble.ticks_idle", 3.0, 600, kind="gauge", tid=3),
    ]
    return events, 0


def _case_no_trial():
    """Spans but no trial.run and no experiment.run: the wall is the spans'
    extent and there are no trial rows."""
    return [_x("serve.decode", "serve", 0, 5_000), _x("serve.decode", "serve", 10_000, 5_000)], 0


LEDGER_CASES = {
    "nested": _case_nested,
    "two_trials_and_journal": _case_two_trials_and_journal,
    "restart_and_restore": _case_restart_and_restore,
    "resumed_epochs": _case_resumed_epochs,
    "comm_and_bubble_counters": _case_comm_and_bubble_counters,
    "no_trial": _case_no_trial,
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_equals_the_jax_ledger(case):
    events, dropped = LEDGER_CASES[case]()
    got = port_obs.compute_ledger(json.loads(json.dumps(events)), dropped=dropped)
    want = jax_obs.compute_ledger(json.loads(json.dumps(events)), dropped=dropped)
    assert got == want
    assert port_obs.format_ledger_text(got) == jax_obs.format_ledger_text(want)


def test_ledger_attribution_on_fixed_events():
    """What the parity above compares, held to hand-computed values."""
    events, _ = _case_nested()
    ledger = port_obs.compute_ledger(events)
    trial = ledger["trials"][1]
    bd = trial["breakdown"]
    # the digest is a child of the save: 200 - 120 ms of save self time
    assert bd["checkpoint"]["seconds"] == pytest.approx(0.2)
    assert bd["step"]["seconds"] == pytest.approx(0.51)
    assert bd["other"]["seconds"] == pytest.approx(1.0 - 0.1 - 0.04 - 0.51 - 0.1 - 0.2)
    assert trial["attributed_pct"] == pytest.approx(100 * (1 - bd["other"]["seconds"]))
    assert trial["productive_pct"] == 51.0
    assert trial["steps"] == 2 and trial["tokens"] == 16 * 1024
    assert trial["mfu_estimate"] == round(16 * 1024 * 3.825e9 / 989e12, 4)
    restart = port_obs.compute_ledger(_case_restart_and_restore()[0])["trials"][9]["breakdown"]
    assert restart["restart"]["seconds"] == pytest.approx(0.25)
    assert restart["restore"]["seconds"] == pytest.approx(0.4)
    resumed = port_obs.compute_ledger(_case_resumed_epochs()[0])
    assert resumed["trials"][1]["wall_s"] == pytest.approx(2.0)
    assert len(resumed["threads"]) == 2


def test_peak_flops_table_is_the_h100s():
    assert port_obs.PEAK_FLOPS_BY_KIND == {
        "NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 PCIe": 756e12, "NVIDIA H100 NVL": 835e12,
    }
    assert port_obs.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert port_obs.chip_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert port_obs.chip_peak_flops("NVIDIA H100 NVL") == 835e12
    # a part with no entry gets the caller's default, not another part's peak
    assert port_obs.chip_peak_flops("NVIDIA H100", default=0.0) == 0.0
    assert port_obs.chip_peak_flops("NVIDIA H200", default=0.0) == 0.0
    assert port_obs.chip_peak_flops("", default=0.0) == 0.0
    assert port_obs.chip_peak_flops("TPU v5 lite", default=0.0) == 0.0
    assert port_obs.PRODUCTIVE_CATS == jax_obs.PRODUCTIVE_CATS


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [
    {"enabled": True, "trace_export": True, "ring_capacity": 64},
    {"enabled": False},
    {"flush_interval_s": 0.1, "max_events": 10},
    {"bogus_knob": 1},
    {"ring_capacity": 2},
    {"flush_interval_s": 0},
    {"max_events": 0},
], ids=["good", "disabled", "flush_and_cap", "unknown_field", "small_ring", "zero_flush",
        "no_events"])
def test_observability_config_verdicts_match_the_jax_package(raw):
    from determined_tpu.config import ExperimentConfig as JaxConfig
    from determined_tpu.config.experiment import InvalidExperimentConfig as JaxInvalid
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.config.experiment import InvalidExperimentConfig

    try:
        want = JaxConfig.parse({"observability": raw}).observability
    except JaxInvalid:
        with pytest.raises(InvalidExperimentConfig):
            ExperimentConfig.parse({"observability": raw})
        return
    got = ExperimentConfig.parse({"observability": raw}).observability
    assert {f: getattr(got, f) for f in raw} == {f: getattr(want, f) for f in raw}
    assert got == type(got)(**{k: getattr(want, k) for k in got.__dataclass_fields__})


# ---------------------------------------------------------------------------
# a local experiment on the CPU with trace_export: true
# ---------------------------------------------------------------------------

HP = dict(lr=1e-3, global_batch_size=4, seq_len=32, vocab_size=64, d_model=64, n_layers=2,
          n_heads=4, dataset_size=16, bf16=False, attention="flash")
STEPS = 6


@pytest.fixture(scope="module")
def traced_experiment(tmp_path_factory):
    """One traced local experiment (2-layer LM, 6 steps, validation at 3
    and 6, a best checkpoint), shared by the tests below."""
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.models import LMTrial

    root = str(tmp_path_factory.mktemp("traced") / "exp")
    cfg = ExperimentConfig.parse({
        "name": "traced-lm",
        "hyperparameters": HP,
        "searcher": {"name": "single", "metric": "validation_loss",
                     "max_length": {"batches": STEPS}},
        "min_validation_period": {"batches": 3},
        "observability": {"enabled": True, "trace_export": True},
    })
    summary = LocalExperiment(cfg, LMTrial, checkpoint_dir=root, device="cpu").run()
    tracer = get_tracer()
    events = tracer.chrome_events()
    # the run stopped the drain thread and closed its file
    assert tracer._shipper is None and tracer._jsonl is None
    tracer.reset()
    return root, summary, events


def test_traced_experiment_writes_the_three_trace_files(traced_experiment):
    root, summary, events = traced_experiment
    assert summary["status"] == "completed" and summary["total_steps"] == STEPS
    traces = os.path.join(root, "traces")
    assert {"events.jsonl", "trace.json", "goodput.json"} <= set(os.listdir(traces))
    with open(os.path.join(traces, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"experiment.run", "trial.run", "trainer.setup", "data.wait", "step.dispatch",
            "step.boundary_block", "validate", "journal.append", "checkpoint.dispatch",
            "checkpoint.write", "checkpoint.finalize", "checkpoint.digest"} <= names


def test_traced_experiment_ledger_counts_tokens_exactly(traced_experiment):
    root, _summary, _events = traced_experiment
    with open(os.path.join(root, "traces", "goodput.json")) as f:
        ledger = json.load(f)
    (trial,) = ledger["trials"].values()
    assert trial["steps"] == STEPS
    assert trial["samples"] == STEPS * HP["global_batch_size"]
    assert trial["tokens"] == STEPS * HP["global_batch_size"] * HP["seq_len"]
    assert ledger["dropped_events"] == 0
    assert {"step", "setup", "validate", "data", "checkpoint"} <= set(trial["breakdown"])
    # the CPU has no roofline: the ledger reports no MFU
    assert "mfu_estimate" not in trial
    assert ledger["counters"]["train.flops_per_token"] > 0
    assert "device.peak_flops_total" not in ledger["counters"]
    assert ledger["experiment"]["trials"] == 1


def test_jax_ledger_of_the_port_events_is_the_port_ledger(traced_experiment):
    root, _summary, events = traced_experiment
    traces = os.path.join(root, "traces")
    with open(os.path.join(traces, "goodput.json")) as f:
        exported = json.load(f)
    port_ledger = port_obs.compute_ledger(events)
    assert json.loads(json.dumps(port_ledger)) == exported
    jax_ledger = jax_obs.compute_ledger(jax_obs.load_trace_events(traces))
    assert jax_ledger == port_obs.compute_ledger(port_obs.load_trace_events(traces))
    assert json.loads(json.dumps(jax_ledger)) == exported


def _port_cli(*argv):
    from determined_tpu_torch.cli.main import main

    return main(list(argv))


def test_experiment_profile_prints_the_jax_verbs_text(traced_experiment, capsys):
    import argparse

    from determined_tpu.cli.main import exp_profile_local

    root, _summary, _events = traced_experiment
    assert _port_cli("experiment", "profile", root) == 0
    port_text = capsys.readouterr().out
    assert exp_profile_local(argparse.Namespace(checkpoint_dir=root, json=False,
                                                xplane=None)) == 0
    assert port_text == capsys.readouterr().out
    assert "phase breakdown" in port_text and f"({STEPS} steps" in port_text
    assert _port_cli("experiment", "profile", root, "--json") == 0
    with open(os.path.join(root, "traces", "goodput.json")) as f:
        assert json.loads(capsys.readouterr().out) == {"ledger": json.load(f)}


def test_experiment_profile_exits_2_without_traces(tmp_path, capsys):
    assert _port_cli("experiment", "profile", str(tmp_path)) == 2
    assert "no trace events" in capsys.readouterr().err
    # an explicit --trace-dir that is not a directory is named, not ignored
    assert _port_cli("experiment", "profile", str(tmp_path), "--trace-dir",
                     str(tmp_path / "nowhere")) == 2


def test_experiment_status_gives_the_journal_digest(traced_experiment, capsys):
    import argparse

    from determined_tpu.cli.main import exp_status_local
    from determined_tpu_torch.experiment import experiment_status

    root, _summary, _events = traced_experiment
    assert _port_cli("experiment", "status", root, "--json") == 0
    digest = json.loads(capsys.readouterr().out)
    assert digest == json.loads(json.dumps(experiment_status(root)))
    assert digest["status"] == "completed" and digest["trials_completed"] == 1
    assert _port_cli("experiment", "status", root) == 0
    port_text = capsys.readouterr().out
    assert exp_status_local(argparse.Namespace(checkpoint_dir=root, json=False)) == 0
    assert port_text == capsys.readouterr().out
    assert _port_cli("experiment", "status", str(root) + "-missing") == 2


def test_chip_smoke_observe_is_const_yaml_apart_from_its_cuts():
    import yaml

    import chip_smoke

    with open(os.path.join(REPO, "examples/transformer_lm/const.yaml")) as f:
        const = yaml.safe_load(f)
    got = chip_smoke.observe_raw_config("/tmp/ckpts", 7)
    restored = json.loads(json.dumps(got))
    placeholders = {"<temp dir>": "/tmp/ckpts", "<--seed>": 7}
    for path, file_value, run_value, _why in chip_smoke.OBSERVE_CUTS:
        *parents, leaf = path.split(".")
        node, want = restored, const
        for p in parents:
            node, want = node[p], want.get(p, {})
        if isinstance(run_value, str):
            run_value = placeholders.get(run_value, run_value)
        assert node[leaf] == run_value, path
        assert want.get(leaf) == file_value, path
        if file_value is None:
            del node[leaf]
        else:
            node[leaf] = file_value
    assert {k: v for k, v in restored.items() if v != {}} == const
    from determined_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.parse(got)
    assert cfg.observability.trace_export and cfg.profiling["trace"]
    assert cfg.profiling["end_after_batch"] == chip_smoke.OBSERVE_WINDOW
    assert cfg.searcher.max_length.units == chip_smoke.OBSERVE_STEPS
