"""The port's profiler (determined_tpu_torch/core/_profiler.py), its
metrics shipper (core/_metrics.py) and its op table (utils/kineto.py),
against the JAX package's ProfilerContext, MetricsContext and
utils/xplane.py contracts, on the CPU:

- the system sampler reports ``system_metrics`` rows with the JAX
  sampler's host keys and, on the CPU, no device keys;
- a Trainer with ``profiling.trace`` closes a ``torch.profiler`` window
  after exactly ``end_after_batch`` steps, counted from the resume point,
  and reports a ``profile`` row (``op_table`` with ``time_us``,
  ``category_totals``);
- the op table of a synthetic Chrome trace naming the port's four
  kernels, a cuBLAS gemm, an NCCL all-reduce and host ops has exact
  categories, totals, counts and collective split.
"""

import json
import os
import time

import pytest

from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.core import MetricsContext, ProfilerContext
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.utils import kineto
from tests import torch_threads  # noqa: F401  (one intra-op thread)

HP = dict(lr=1e-3, global_batch_size=4, seq_len=32, vocab_size=64, d_model=64, n_layers=2,
          n_heads=4, dataset_size=32, bf16=False, attention="flash")

# the JAX sampler's host keys (determined_tpu/core/_profiler.py _sample_loop)
HOST_KEYS = {"cpu_util_pct", "memory_used_bytes", "memory_util_pct", "net_rx_Bps",
             "net_tx_Bps", "disk_read_Bps", "disk_write_Bps"}


def _wait_rows(read, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = read()
        if len(rows) >= n:
            return rows
        time.sleep(0.05)
    raise AssertionError(f"fewer than {n} rows after {timeout} s")


# ---------------------------------------------------------------------------
# metrics shipper
# ---------------------------------------------------------------------------


def test_metrics_context_writes_jsonl_like_the_jax_one(tmp_path):
    from determined_tpu.core._metrics import MetricsContext as JaxMetrics

    def ship(cls, path):
        m = cls(local_path=str(path)).start()
        t0 = time.time()
        m.report("training", 3, {"loss": 1.5})
        m.report("profile", None, {"op_table": [{"name": "k", "time_us": 2.0}]})
        t1 = time.time()
        m.close()
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        # each row carries the wall time of its report; the rest must match
        for row in rows:
            assert t0 <= row.pop("report_time") <= t1
        return rows

    port_rows = ship(MetricsContext, tmp_path / "p.jsonl")
    assert port_rows == ship(JaxMetrics, tmp_path / "j.jsonl")
    assert [r["group"] for r in port_rows] == ["training", "profile"]
    # without a file there is no thread, and rows stay readable in memory
    mem = MetricsContext().start()
    mem.report("training", 1, {"loss": 2.0})
    assert mem._thread is None
    assert mem.rows("training") == [("training", 1, {"loss": 2.0})]
    mem.close()
    # with a session the rows go to the master's metrics route instead
    # (tests/test_torch_cluster_trial.py holds them to the JAX shipper's)
    from determined_tpu_torch.api import Session
    from tests.torch_cluster_master import RecordingMaster

    fake = RecordingMaster()
    try:
        shipped = MetricsContext(session=Session(fake.url, token="t"), trial_id=4,
                                 run_id=1).start()
        shipped.report("training", 3, {"loss": 1.5})
        shipped.report("validation", 3, {"validation_loss": 1.25})
        shipped.close()
        rows = fake.metric_rows()
    finally:
        fake.close()
    assert [(r["group"], r["steps_completed"], r["metrics"], r["trial_id"], r["trial_run_id"])
            for r in rows] == [("training", 3, {"loss": 1.5}, 4, 1),
                               ("validation", 3, {"validation_loss": 1.25}, 4, 1)]
    assert shipped.rows("validation") == [("validation", 3, {"validation_loss": 1.25})]


# ---------------------------------------------------------------------------
# the system sampler
# ---------------------------------------------------------------------------


def test_sampler_reports_the_jax_host_keys_and_no_device_keys(monkeypatch, tmp_path):
    from determined_tpu.core._distributed import DummyDistributedContext as JaxDist
    from determined_tpu.core._metrics import MetricsContext as JaxMetrics
    from determined_tpu.core._profiler import ProfilerContext as JaxProfiler

    monkeypatch.setattr(ProfilerContext, "SAMPLE_INTERVAL", 0.2)
    monkeypatch.setattr(JaxProfiler, "SAMPLE_INTERVAL", 0.2)
    metrics = MetricsContext().start()
    prof = ProfilerContext(core.DummyDistributedContext(), metrics, str(tmp_path / "traces"))
    prof.set_steps_fn(lambda: 7)
    jax_path = tmp_path / "jax.jsonl"
    jax_metrics = JaxMetrics(local_path=str(jax_path)).start()
    jax_prof = JaxProfiler(JaxDist(), jax_metrics)
    prof.on(sampling=True)
    jax_prof.on(sampling=True)
    try:
        rows = _wait_rows(lambda: metrics.rows("system_metrics"), 2)
    finally:
        prof.off()
        time.sleep(0.5)
        jax_prof.off()
        jax_metrics.close()
        metrics.close()
    assert prof._thread is None and not prof.tracing
    with open(jax_path) as f:
        jax_rows = [json.loads(line) for line in f]
    assert jax_rows
    for _group, step, sample in rows:
        assert step == 7
        assert HOST_KEYS - {"cpu_util_pct"} <= set(sample) <= HOST_KEYS
        assert not any(k.startswith("device") for k in sample)
    jax_keys = set().union(*(r["metrics"] for r in jax_rows))
    port_keys = set().union(*(sample for _g, _s, sample in rows))
    assert port_keys == jax_keys


def test_cuda_memory_stats_gives_the_jax_device_keys(monkeypatch):
    """The CUDA counterpart of ``_tpu_memory_stats``: for each card, the
    allocator's bytes in use, the card's memory and the share, under the
    JAX sampler's key names; nothing before CUDA is initialised.  The
    card's answers are stood in for here: the sampler only reads them."""
    import torch

    from determined_tpu_torch.core._profiler import _cuda_memory_stats

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert _cuda_memory_stats() == {}

    in_use = {0: 3 << 30, 1: 0}
    limit = 80 << 30
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: {"allocated_bytes.all.current": in_use[i]})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (limit - in_use[i], limit))
    assert _cuda_memory_stats() == {
        "device0_bytes_in_use": float(3 << 30),
        "device0_bytes_limit": float(limit),
        "device0_hbm_util_pct": 100.0 * 3 / 80,
        "device1_bytes_in_use": 0.0,
        "device1_bytes_limit": float(limit),
        "device1_hbm_util_pct": 0.0,
    }
    # an allocator that has handed out nothing yet reports 0 bytes in use
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {})
    assert _cuda_memory_stats()["device0_bytes_in_use"] == 0.0


# ---------------------------------------------------------------------------
# the trace window in the Trainer
# ---------------------------------------------------------------------------


def _traced_trainer(ckpt_dir, end_after_batch):
    cfg = ExperimentConfig.parse({
        "hyperparameters": HP,
        "profiling": {"enabled": True, "trace": True, "end_after_batch": end_after_batch},
        "optimizations": {"async_checkpointing": False},
    })
    core_ctx = core._dummy_init(checkpoint_dir=str(ckpt_dir))
    ctx = train.init(exp_config=cfg, core_context=core_ctx, seed=0, device="cpu")
    trainer = train.Trainer(LMTrial(ctx))
    stops = []
    stop = core_ctx.profiler.stop_trace

    def recorded_stop():
        if core_ctx.profiler.tracing:
            stops.append(trainer.steps_completed)
        stop()

    core_ctx.profiler.stop_trace = recorded_stop
    # the trial's entry point opens the window (as the JAX package's
    # cluster entry point does from the same profiling section)
    core_ctx.profiler.on(sampling=False, trace=True)
    return trainer, core_ctx, stops


def test_trace_window_closes_after_end_after_batch_steps(tmp_path):
    trainer, core_ctx, stops = _traced_trainer(tmp_path, end_after_batch=2)
    summary = trainer.fit(max_length=5, report_period=5, checkpoint_period=3,
                          checkpoint_policy="none")
    assert summary["steps_completed"] == 5
    assert stops == [2] and not core_ctx.profiler.tracing
    # the window's trace lands under the context's trace_dir
    trace_dir = os.path.join(str(tmp_path), "traces", "torch_profiler")
    files = kineto.trace_files(trace_dir)
    assert len(files) == 1
    # its profile row: the top ops, each with time_us, and category totals
    (step, row), = core_ctx.train.metrics("profile")
    assert step is None  # no steps provider installed, as in the JAX Trainer
    assert 0 < len(row["op_table"]) <= 25
    assert all({"name", "category", "expression", "time_us", "count"} <= set(op)
               for op in row["op_table"])
    assert row["category_totals"] == {"host": pytest.approx(
        sum(op["time_us"] for op in kineto.op_table(files)))}
    # a CPU window has host ops only: the steps' matmuls are among them
    names = {op["name"] for op in kineto.op_table(files)}
    assert "aten::mm" in names
    # breaking the hot segment at the window adds no report
    assert [s for s, _ in core_ctx.train.metrics("training")] == [5]

    # resumed from the step-3 checkpoint, the window is counted from there
    sid = core_ctx.checkpoint.get_checkpoint_parent(summary["latest_checkpoint"])
    assert core_ctx.checkpoint.get_metadata(sid)["steps_completed"] == 3
    core_ctx.close()
    resumed, resumed_ctx, resumed_stops = _traced_trainer(tmp_path, end_after_batch=2)
    resumed.fit(max_length=6, report_period=6, latest_checkpoint=sid, checkpoint_policy="none")
    assert resumed_stops == [5]
    resumed_ctx.close()
    assert len(kineto.trace_files(trace_dir)) == 2


def test_window_longer_than_the_run_closes_with_the_context(tmp_path):
    trainer, core_ctx, stops = _traced_trainer(tmp_path, end_after_batch=10)
    trainer.fit(max_length=2, report_period=2, checkpoint_policy="none")
    assert core_ctx.profiler.tracing and stops == []
    core_ctx.close()  # the context's close stops the window and reports it
    assert stops == [2] and not core_ctx.profiler.tracing
    assert len(core_ctx.train.metrics("profile")) == 1


def test_profiling_trace_no_longer_raises_and_other_knobs_still_do():
    cfg = ExperimentConfig.parse({"hyperparameters": HP, "profiling": {"trace": True}})
    train.init(exp_config=cfg, device="cpu")
    cfg = ExperimentConfig.parse({"hyperparameters": HP,
                                  "lint": {"retrace_sentinel": True}})
    with pytest.raises(NotImplementedError, match="later slice"):
        train.init(exp_config=cfg, device="cpu")


# ---------------------------------------------------------------------------
# the op table
# ---------------------------------------------------------------------------

# (name, cat, dur us, launches): a synthetic torch.profiler trace
_SYNTHETIC = [
    ("void flash_fwd_wgmma<128, 2>(CUtensorMap, CUtensorMap, float*, int)", "kernel", 129.0, 8),
    ("void flash_bwd_dq_wgmma<128>(CUtensorMap, CUtensorMap, float const*)", "kernel", 118.5, 8),
    ("void flash_bwd_dkv_wgmma<128>(CUtensorMap, CUtensorMap, float const*)", "kernel", 235.5, 8),
    ("void adamw_kernel<float>(float*, float*, float*, float const*, float const*, long)",
     "kernel", 2.0, 75),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "kernel",
     50.0, 40),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "kernel", 25.0, 16),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     300.0, 2),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)", "kernel", 4.0, 10),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "kernel", 1.5, 100),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10.0, 2),
    ("Memset (Device)", "gpu_memset", 0.5, 4),
    ("aten::mm", "cpu_op", 20.0, 40),
    ("cudaLaunchKernel", "cuda_runtime", 3.0, 271),
    ("ProfilerStep#1", "user_annotation", 1000.0, 1),
]


def _write_trace(path, rows):
    events, ts = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
                   "args": {"name": "python"}}], 0.0
    for name, cat, dur, n in rows:
        for _ in range(n):
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
                           "ts": ts, "dur": dur})
            ts += dur + 1.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return path


def test_op_table_of_a_synthetic_trace(tmp_path):
    path = _write_trace(str(tmp_path / "w" / "1.123.pt.trace.json"), _SYNTHETIC)
    ops = kineto.op_table(str(tmp_path))
    assert kineto.op_table([path]) == ops
    # device events only (kernels, copies, memsets): 11 ops, heaviest first
    assert len(ops) == 11
    assert [op["time_us"] for op in ops] == sorted((op["time_us"] for op in ops), reverse=True)
    by_name = {op["name"]: op for op in ops}
    assert by_name[_SYNTHETIC[0][0]] == {
        "name": _SYNTHETIC[0][0], "category": "flash_fwd", "expression": _SYNTHETIC[0][0],
        "time_us": 8 * 129.0, "count": 8}
    assert kineto.category_counts(ops) == {
        "flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "fused_adamw": 75,
        "matmul": 56, "collective": 2, "reductions": 10, "elementwise": 106}
    assert kineto.category_totals(ops) == {
        "flash_bwd_dkv": 8 * 235.5, "matmul": 40 * 50.0 + 16 * 25.0, "flash_fwd": 8 * 129.0,
        "flash_bwd_dq": 8 * 118.5, "collective": 600.0, "elementwise": 150.0 + 20.0 + 2.0,
        "fused_adamw": 150.0, "reductions": 40.0}
    assert list(kineto.category_totals(ops)) == [
        "matmul", "flash_bwd_dkv", "flash_fwd", "flash_bwd_dq", "collective", "elementwise",
        "fused_adamw", "reductions"]
    coll, other = kineto.split_collectives(ops)
    assert coll == 600.0
    assert other == sum(op["time_us"] for op in ops) - 600.0


def test_op_table_falls_back_to_host_ops_without_device_events(tmp_path):
    path = _write_trace(str(tmp_path / "cpu.pt.trace.json"),
                        [r for r in _SYNTHETIC if r[1] not in kineto.DEVICE_CATS])
    ops = kineto.op_table([path])
    assert [(op["name"], op["category"], op["time_us"], op["count"]) for op in ops] == [
        ("ProfilerStep#1", "host", 1000.0, 1), ("aten::mm", "host", 800.0, 40)]
    assert kineto.category_totals(ops) == {"host": 1800.0}
    assert kineto.split_collectives(ops) == (0.0, 1800.0)


def test_op_table_without_traces_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no torch.profiler trace"):
        kineto.op_table(str(tmp_path))
    with pytest.raises(RuntimeError, match="no torch.profiler trace"):
        kineto.op_table([])


def test_experiment_profile_reads_the_window_op_table(tmp_path, capsys):
    """``experiment profile`` adds the windows' device categories under
    ``--trace-dir`` (default ``<dir>/traces/torch_profiler``)."""
    from determined_tpu_torch.cli.main import main

    traces = tmp_path / "traces"
    traces.mkdir()
    with open(traces / "events.jsonl", "w") as f:
        for ev in ({"ph": "X", "name": "trial.run", "cat": "trial", "ts": 0.0, "dur": 1e6,
                    "pid": 1, "tid": 1, "args": {"trial": 1}},
                   {"ph": "X", "name": "step.dispatch", "cat": "step", "ts": 10.0, "dur": 9e5,
                    "pid": 1, "tid": 1}):
            f.write(json.dumps(ev) + "\n")
    _write_trace(str(traces / "torch_profiler" / "trial_1" / "1.1.pt.trace.json"), _SYNTHETIC)
    assert main(["experiment", "profile", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "torch.profiler device-time categories (us):" in out
    assert f"  {'flash_bwd_dkv':<24} {8 * 235.5:>12.1f}" in out
    assert main(["experiment", "profile", str(tmp_path), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)["torch_profiler"]
    assert summary["collective_us"] == 600.0 and len(summary["top_ops"]) == 10
    other = tmp_path / "elsewhere"
    _write_trace(str(other / "2.2.pt.trace.json"), _SYNTHETIC[:1])
    assert main(["experiment", "profile", str(tmp_path), "--json", "--trace-dir",
                 str(other)]) == 0
    summary = json.loads(capsys.readouterr().out)["torch_profiler"]
    assert summary["category_totals"] == {"flash_fwd": 8 * 129.0}
