#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (determined_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--phases kernel,serve,parity,train,train_parity]

Phases, in order; any failure raises and the script exits non-zero:

1. device (always): require CUDA; print the card's name and power limit.
2. kernel: build every hand-written kernel from csrc/ with nvcc (one process
   per source, in parallel), print each one's ptxas registers, spills and
   wgmma warnings, and hold each against its plain PyTorch version on the
   card: flash_fwd (bf16: the launch's own tile and both the 64- and
   128-row tiles) and flash_bwd (dq, dk/dv) at the training and serving
   shapes and the ragged, GQA, head-dim-64, long-walk and f32 corners,
   fused_adamw on flagship leaves and ragged tails.  Fails if ptxas spilled
   or serialised the wgmmas (C75xx) of a flash_bwd_dq_wgmma instance.  Each
   kernel is timed at its main-path shape (the bf16 forward at each tile)
   beside its plain version, its bound (with the share of it reached and
   the achieved TFLOP/s) and a library yardstick
   (``scaled_dot_product_attention`` and its backward,
   ``torch.optim.AdamW(fused=True)``), which the port never calls.
3. serve: the flagship LM (examples/transformer_lm/const.yaml: d2048, L8,
   H16, V32768, bf16 compute, f32 params; random weights from --seed) behind
   a ServeWorker on localhost; greedy POST /v1/generate requests, four of
   them sharing a 512-token prefix.  The launch counters are set to 0 just
   before the requests and read just after.
4. parity: serving-path logits (prefill and three decode steps) against the
   full TransformerLM forward, in bf16 and in an f32 copy of the model.
5. train: the bench.py workload (the flagship at seq 1024, global batch 8,
   bf16, flash attention, fused cross-entropy, fused AdamW with a bf16 first
   moment) through init -> Trainer(LMTrial).fit for 25 steps with a
   validation pass; step time, tokens/s and MFU, the losses, the launch
   counts (set to 0 just before fit, read just after) and a profile of
   three more steps.
6. train_parity: a 2-layer f32 LM trains 3 steps on the card through the
   kernels and on the CPU through the plain versions, from the same weights
   and batches; losses, weight updates and moments are compared.

Prints, before the last line, the kernels line (JSON) and the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.
Imports nothing of JAX or determined_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

CSRC = "determined_tpu_torch/csrc/"
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "fused_adamw.cu")
# kernels whose ptxas report must show no spill and no C75xx warning (every
# instance), by source
PTXAS_CLEAN = {"flash_bwd.cu": ("flash_bwd_dq_wgmma", 2)}  # D = 64, 128
# kernels line: name -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (CSRC + "flash_fwd.cu", "determined_tpu/ops/flash_attention.py:150"),
    "flash_bwd_dq": (CSRC + "flash_bwd.cu", "determined_tpu/ops/flash_attention.py:288"),
    "flash_bwd_dkv": (CSRC + "flash_bwd.cu", "determined_tpu/ops/flash_attention.py:304"),
    "fused_adamw": (CSRC + "fused_adamw.cu", "determined_tpu/ops/fused_adamw.py:125"),
}

# attention cases: the training and serving shapes, then the ragged, GQA and
# f32 corners, and the edges of the bf16 kernels' TMA pipelines: a ragged
# last tile (TMA's zero fill and clipped store), GQA at head dim 64 (the 3-D
# kv tensor map), and a long causal walk (the ring wraps many times).
# name, b, h, hkv, s, d, dtype name, causal
ATTN_CASES_SPEC = [
    ("training", 8, 16, 16, 1024, 128, "bfloat16", True),
    ("serving", 1, 16, 16, 1024, 128, "bfloat16", True),
    ("gqa", 2, 16, 4, 512, 128, "bfloat16", True),
    ("f32_hd64_ragged", 1, 4, 4, 200, 64, "float32", True),
    ("f32_hd128_full_gqa", 2, 8, 2, 77, 128, "float32", False),
    ("bf16_hd64_ragged_full", 1, 4, 4, 130, 64, "bfloat16", False),
    ("bf16_ragged1000", 1, 8, 8, 1000, 128, "bfloat16", True),
    ("bf16_gqa_hd64", 2, 8, 2, 640, 64, "bfloat16", True),
    ("bf16_long4096", 1, 8, 8, 4096, 128, "bfloat16", True),
]

# kernel vs plain version, per dtype.  bf16: both cast p to bf16 before P.V,
# but the kernel's online softmax rounds p against a running max where the
# plain version uses the row max, so outputs differ by a few bf16 ulps
# (2^-8 relative); lse sums f32 values in another order.  f32: the
# tolerance the JAX package holds its own flash kernel to (tests/test_ops.py).
KERNEL_TOL = {
    "bfloat16": dict(out=dict(atol=1e-2, rtol=1e-2), lse=dict(atol=1e-3, rtol=1e-3)),
    "float32": dict(out=dict(atol=2e-5, rtol=2e-5), lse=dict(atol=2e-5, rtol=2e-5)),
}
# backward kernels vs the plain backward; atol is relative to the largest
# |gradient| of the case.  bf16: ds and p are rounded to bf16 before their
# products on both sides, but from f32 values that differ in the last bits
# (another summation order), so a few of them round the other way, and the
# outputs are bf16 (2^-8 relative).  f32: summation order only, over up to
# Sk terms.
BWD_TOL = {
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float32": dict(rtol=2e-4, atol=2e-5),
}

# fused AdamW leaves: two flagship SwiGLU leaves, the embedding, and tails
# that are no multiple of the block
ADAMW_CASES_SPEC = [
    ((2048, 8192), "bfloat16"),
    ((2048, 8192), "float32"),
    ((32768, 2048), "bfloat16"),
    ((77, 33), "float32"),
    ((2048,), "float32"),
]
ADAMW_TIMED = ((2048, 8192), "bfloat16")
# the kernel's operations per element: 2 multiplies for g and its square,
# 2 + 3 for m and v, 2 divides for the bias corrections, a square root, an
# add, a divide, a multiply-add for the decay and a multiply-subtract for p
ADAMW_FLOPS_PER_ELEMENT = 17
# f32: the JAX package's bound for its fused sweep against optax
# (tests/test_ops.py); both sides round the same IEEE operations in the same
# order.  bf16 (the stored first moment): one bf16 ulp, where an f32 value a
# last bit apart rounds the other way.
ADAMW_TOL = {
    "float32": dict(rtol=2e-6, atol=2e-7),
    "bfloat16": dict(rtol=2 ** -7, atol=1e-6),
}

# serving-path logits vs the full forward.  bf16 keeps 8 mantissa bits and
# the two paths round at different places (the prompt padded to 1024 vs its
# own length, the chunked decode keeps p in f32 where the forward casts it),
# through 8 layers; logits here have std ~1.  f32: reassociation only.
PARITY_TOL = {"bfloat16": dict(atol=1e-1, rtol=5e-2), "float32": dict(atol=2e-3, rtol=1e-3)}

# phase 5: the bench.py workload (bench.py's hparams at one chip)
TRAIN_HPARAMS = dict(
    lr=3e-4, global_batch_size=8, seq_len=1024, vocab_size=32768, d_model=2048,
    n_layers=8, n_heads=16, dataset_size=64, bf16=True, attention="flash",
    warmup_steps=10, fused_ce="auto", fused_adamw="auto", adam_mu_bf16=True,
)
TRAIN_STEPS = 25
TRAIN_REPORT = 5

# phase 6: a 2-layer f32 LM, card against CPU
TRAIN_PARITY_HPARAMS = dict(
    lr=1e-3, global_batch_size=4, seq_len=256, vocab_size=1024, d_model=256,
    n_layers=2, n_heads=4, dataset_size=16, bf16=False, attention="flash",
    warmup_steps=1, fused_ce=True, fused_adamw=True, adam_mu_bf16=False,
)
TRAIN_PARITY_STEPS = 3
# f32 on both sides, sums taken in other orders (cuBLAS and the kernels vs
# the CPU): the losses agree to f32 reassociation through 2 layers.  Adam
# divides each moment by its root, so a gradient element near zero whose
# sign differs in the last bits moves its weight the other way; the updates
# and moments are therefore held in relative norm over each tensor.
TRAIN_PARITY_TOL = dict(
    loss=dict(rtol=1e-5, atol=1e-5), update_rel=1e-2, moment_rel=1e-3,
)

N_REQUESTS = 12
N_SHARED = 4
SHARED_PREFIX = 512

PHASES = ("kernel", "serve", "parity", "train", "train_parity")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_us(fn, reps: int = 20, trials: int = 7) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls.  A sleep kernel queued first keeps the card busy
    while the host enqueues, so host overhead stays out of the reading."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def attention_bound_us(b, h, hkv, sq, sk, d, dtype_name, causal, *, products, q_side,
                       kv_side, rows):
    """Least time for the card: every input read once, every output written
    once (``q_side`` tensors of [b, h, sq, d], ``kv_side`` of [b, hkv, sk, d],
    ``rows`` f32 [b, h, sq] rows such as lse), against the operations that
    ``products`` matrix products over the pairs this mask keeps need.
    Returns (bound in us, "bytes" or "operations", the operations)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * d * (q_side * b * h * sq + kv_side * b * hkv * sk) + 4 * rows * b * h * sq
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 2.0 * products * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations"), flops


def timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops) -> dict:
    """A kernel's timed fields of the kernels line: times in ms, the share of
    its bound it reaches (bound / time) and its achieved TFLOP/s."""
    return dict(ms=kernel_us / 1e3, plain_ms=plain_us / 1e3, bound_ms=bound_us / 1e3,
                bound_by=bound_by, library_ms=library_us / 1e3,
                bound_share=bound_us / kernel_us, tflops=flops / kernel_us / 1e6)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def build_kernels() -> None:
    """Build every kernel source at once (one nvcc each, in parallel),
    print each one's register and spill lines, and fail if a kernel of
    PTXAS_CLEAN spilled or had its wgmmas serialised."""
    from determined_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all(list(KERNEL_SOURCES))
    log(f"kernel build: {time.monotonic() - t0:.1f} s ({', '.join(KERNEL_SOURCES)})")
    for source in KERNEL_SOURCES:
        _build.load(source)
        report = _build.ptxas_report(source) or ""
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "setmaxnreg",
                                       "wgmma", "Performance", "warning")):
                log(f"  ptxas {source}: {line.strip()}")
        if source in PTXAS_CLEAN:
            kernel, instances = PTXAS_CLEAN[source]
            seen = sum("Compiling entry" in line and kernel in line for line in report.splitlines())
            assert seen == instances, f"ptxas report of {source} shows {seen} {kernel} instances"
            faults = _build.ptxas_faults(report, kernel)
            assert not faults, f"ptxas spilled or serialised {kernel}: {faults}"


def check_flash_fwd(seed: int) -> dict:
    """flash_fwd against its plain version on every forward case (bf16: the
    launch's own tile and both tiles forced), timed at the serving shape and
    at the training shape."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    result = {}
    worst = 0.0
    for name, b, h, hkv, s, d, dname, causal in ATTN_CASES_SPEC:
        dtype = getattr(torch, dname)
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        tol = KERNEL_TOL[dname]
        # bf16: the launch's own tile (0) and both tiles forced
        for rows in fa.FWD_BLOCK_ROWS if dname == "bfloat16" else (0,):
            if rows == 0:
                out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            else:
                out, lse = fa._launch_kernel(q, k, v, causal, d ** -0.5, rows)
            torch.cuda.synchronize()
            err_out, err_lse = _max_err(out, ref_out), _max_err(lse, ref_lse)
            log(f"flash_fwd case {name}: [{b},{h}/{hkv},{s},{d}] {dname} causal={causal} "
                f"block_rows={rows or 'auto'} max_abs_err out={err_out:.3e} lse={err_lse:.3e}")
            torch.testing.assert_close(out.float(), ref_out.float(), **tol["out"],
                                       msg=lambda m, rows=rows: f"flash_fwd rows={rows}: {m}")
            torch.testing.assert_close(lse, ref_lse, **tol["lse"])
            worst = max(worst, err_out)
        if name not in ("serving", "training"):
            continue
        by_rows = {
            rows: device_time_us(lambda rows=rows: fa._launch_kernel(q, k, v, True, d ** -0.5, rows))
            for rows in fa.FWD_BLOCK_ROWS
        }
        plain_us = device_time_us(lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True))
        library_us = device_time_us(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        )
        bound_us, bound_by, flops = attention_bound_us(
            b, h, hkv, s, s, d, dname, causal, products=2, q_side=2, kv_side=2, rows=1
        )
        kernel_us = by_rows[0]
        log(f"flash_fwd at the {name} shape [{b},{h},{s},{d}] {dname} causal: "
            f"kernel_us={kernel_us:.2f} (block_rows 64: {by_rows[64]:.2f}, 128: "
            f"{by_rows[128]:.2f}) plain_us={plain_us:.2f} library_us={library_us:.2f} "
            f"bound_us={bound_us:.2f} ({bound_by}) bound_share={bound_us / kernel_us:.3f} "
            f"tflops={flops / kernel_us / 1e6:.1f}")
        times = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops)
        times.update(block64_ms=by_rows[64] / 1e3, block128_ms=by_rows[128] / 1e3)
        if name == "serving":
            result.update(times)
        else:
            result.update({f"train_shape_{k}": v for k, v in times.items()})
    result["max_abs_err"] = worst
    return result


def check_flash_bwd(seed: int) -> dict:
    """flash_bwd's dq and dk/dv kernels against the plain backward on every
    attention case, timed at the training shape beside the plain version,
    the bound and the SDPA backward."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, b, h, hkv, s, d, dname, causal in ATTN_CASES_SPEC:
        dtype = getattr(torch, dname)
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        tol = BWD_TOL[dname]
        errs = {}
        for grad, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            assert g_.shape == w_.shape and g_.dtype == w_.dtype, (grad, g_.shape, w_.shape)
            scale_ = w_.float().abs().max().item()
            errs[grad] = _max_err(g_, w_)
            torch.testing.assert_close(
                g_.float(), w_.float(), rtol=tol["rtol"], atol=tol["atol"] * scale_,
                msg=lambda m, grad=grad: f"flash_bwd {grad} case {name}: {m}",
            )
        log(f"flash_bwd case {name}: [{b},{h}/{hkv},{s},{d}] {dname} causal={causal} "
            + " ".join(f"max_abs_err {g}={e:.3e}" for g, e in errs.items()))
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
        if name != "training":
            continue
        delta = fa._delta(out, do)
        dq_us = device_time_us(lambda: fa._launch_dq(q, k, v, do, lse, delta, True, d ** -0.5))
        dkv_us = device_time_us(lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, d ** -0.5))
        plain_us = device_time_us(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True), reps=5
        )
        # library yardstick: SDPA forward + backward minus its forward
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_fwd_us = device_time_us(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        )
        sdpa_both_us = device_time_us(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), do
        ))
        library_us = sdpa_both_us - sdpa_fwd_us
        # dq reads q, do, k, v, lse, delta and writes dq; dkv writes dk, dv
        for row, kernel_us, products, q_side, kv_side in (
            ("flash_bwd_dq", dq_us, 3, 3, 2), ("flash_bwd_dkv", dkv_us, 4, 2, 4),
        ):
            bound_us, bound_by, flops = attention_bound_us(
                b, h, hkv, s, s, d, dname, causal, products=products, q_side=q_side,
                kv_side=kv_side, rows=2,
            )
            rows[row] = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops)
            log(f"{row} at the training shape [{b},{h},{s},{d}] {dname} causal: "
                f"kernel_us={kernel_us:.2f} plain_us(whole bwd)={plain_us:.2f} "
                f"library_us(SDPA bwd)={library_us:.2f} bound_us={bound_us:.2f} ({bound_by}) "
                f"bound_share={rows[row]['bound_share']:.3f} tflops={rows[row]['tflops']:.1f}")
    for row in rows:
        rows[row]["max_abs_err"] = worst[row]
    return rows


def check_fused_adamw(seed: int) -> dict:
    """fused_adamw against its plain version on flagship leaves and ragged
    tails, timed on a [2048, 8192] SwiGLU leaf with a bf16 first moment."""
    import torch

    from determined_tpu_torch.ops import fused_adamw as fw

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    # step 3 of a warmed-up run, the clip active
    scalars = torch.tensor([3e-4, 0.5, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device="cuda")
    worst = 0.0
    result = {}
    for shape, mu_name in ADAMW_CASES_SPEC:
        mu_dtype = getattr(torch, mu_name)
        p = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        m = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(mu_dtype)
        v = 0.01 * torch.rand(shape, generator=gen, device="cuda")
        want = fw._leaf_reference(p, m, v, g, scalars, **hyper)
        got = [p.clone(), m.clone(), v.clone()]
        fw.adamw_leaf_(*got[:3], g, scalars, **hyper)
        torch.cuda.synchronize()
        errs = [_max_err(a, b_) for a, b_ in zip(got, want)]
        log(f"fused_adamw case {list(shape)} mu={_dname(mu_dtype)}: max_abs_err "
            f"p={errs[0]:.3e} m={errs[1]:.3e} v={errs[2]:.3e}")
        for what, a, b_ in zip("pmv", got, want):
            tol = ADAMW_TOL[_dname(b_.dtype)]
            torch.testing.assert_close(a.float(), b_.float(), **tol,
                                       msg=lambda m_, what=what: f"fused_adamw {what}: {m_}")
        worst = max(worst, *errs)
        if (shape, mu_name) != ADAMW_TIMED:
            continue
        kernel_us = device_time_us(lambda: fw.adamw_leaf_(p, m, v, g, scalars, **hyper))
        plain_us = device_time_us(lambda: fw._leaf_reference(p, m, v, g, scalars, **hyper))
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.clone()
        lib_opt = torch.optim.AdamW([lib_p], lr=3e-4, weight_decay=0.01, fused=True)
        library_us = device_time_us(lib_opt.step)
        n = p.numel()
        nbytes = n * (3 * 4 + 2 * m.element_size() + 2 * 4) + 16  # p, v, g in; p, v out; m both
        t_bytes = nbytes / PEAK_BYTES
        t_ops = ADAMW_FLOPS_PER_ELEMENT * n / PEAK_FLOPS["float32"]
        bound_us = max(t_bytes, t_ops) * 1e6
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        result = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by,
                           ADAMW_FLOPS_PER_ELEMENT * n)
        log(f"fused_adamw on {list(shape)} mu={_dname(mu_dtype)} ({nbytes / 1e6:.1f} MB): "
            f"kernel_us={kernel_us:.2f} plain_us={plain_us:.2f} "
            f"library_us(torch AdamW fused)={library_us:.2f} bound_us={bound_us:.2f} ({bound_by}) "
            f"bound_share={result['bound_share']:.3f} tflops={result['tflops']:.3f}")
    result["max_abs_err"] = worst
    return result


def phase_kernel(seed: int) -> dict:
    """Every kernel built and held against its plain version; returns the
    measured fields of each kernel's row, keyed by kernel name."""
    build_kernels()
    rows = {"flash_fwd": check_flash_fwd(seed)}
    rows.update(check_flash_bwd(seed))
    rows["fused_adamw"] = check_fused_adamw(seed)
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve the flagship through the HTTP entry point
# ---------------------------------------------------------------------------


def flagship_config(dtype):
    from determined_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
        max_seq_len=2048, dtype=dtype,
    )


def serve_config():
    from determined_tpu_torch.serve import ServeConfig

    return ServeConfig(
        block_size=16, max_prompt_len=1024, max_new_tokens=32, max_batch=8,
        num_blocks=640, queue_depth=16,
    )


def make_prompts(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i < N_SHARED:
            n = int(rng.integers(SHARED_PREFIX + 64, 1001))
            prompts.append(prefix + rng.integers(0, vocab, size=n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=int(rng.integers(64, 1001))).tolist())
    order = rng.permutation(N_REQUESTS)
    return [prompts[i] for i in order]


def post(url: str, path: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data, headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(seed: int, model) -> dict:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.serve import DecodeKernels, ServeEngine, ServeWorker

    cfg = model.cfg
    scfg = serve_config()
    kernels = DecodeKernels(model, scfg)
    worker = ServeWorker(ServeEngine(kernels))
    url = worker.start()
    try:
        # one short request first: CUDA context, cuBLAS handles, kernel load
        status, _ = post(url, "/v1/generate", {"prompt_tokens": [1, 2, 3], "max_new_tokens": 2})
        assert status == 200
        prompts = make_prompts(seed, cfg.vocab_size)
        base = worker.engine.stats()
        tracer = get_tracer()
        tracer.reset()
        fa.reset_launches()  # counts from here on are the main path's
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futs = [
                pool.submit(post, url, "/v1/generate",
                            {"prompt_tokens": p, "max_new_tokens": scfg.max_new_tokens,
                             "temperature": 0.0})
                for p in prompts
            ]
            responses = [f.result() for f in futs]
        wall = time.monotonic() - t0
        launches = fa.launches
        stats = worker.engine.stats()
        assert post(url, "/healthz")[1]["status"] == "ok"
        assert post(url, "/stats")[1]["completed"] == stats["completed"]
    finally:
        worker.shutdown()

    for (status, body), prompt in zip(responses, prompts):
        assert status == 200, body
        toks = body["tokens"]
        assert len(toks) == scfg.max_new_tokens, body
        assert all(0 <= t < cfg.vocab_size for t in toks)
        assert body["usage"]["prompt_tokens"] == len(prompt)
    hits = stats["prefix_hits"] - base["prefix_hits"]
    cold = len(prompts) - hits
    assert hits >= 1, "no request took the warm prefix-cache path"
    assert launches == cfg.n_layers * cold, (
        f"flash_fwd launched {launches} times for {cold} cold prefills of "
        f"{cfg.n_layers} layers"
    )
    generated = sum(len(b["tokens"]) for _, b in responses)
    decode_s = [s[3] for s in tracer.spans("serve.decode")]
    prefill = tracer.spans("serve.prefill")
    cold_s = [s[3] for s in prefill if not s[4]["cached_tokens"]]
    warm_s = [s[3] for s in prefill if s[4]["cached_tokens"]]
    summary = dict(
        requests=len(prompts),
        generated_tokens=generated,
        tokens_per_s=generated / wall,
        mean_ttft_ms=statistics.mean(b["ttft_ms"] for _, b in responses),
        mean_latency_ms=statistics.mean(b["latency_ms"] for _, b in responses),
        decode_steps=len(decode_s),
        mean_decode_step_ms=1e3 * statistics.mean(decode_s),
        mean_cold_prefill_ms=1e3 * statistics.mean(cold_s),
        mean_warm_prefill_ms=1e3 * statistics.mean(warm_s),
        cold_prefills=cold,
        warm_prefills=hits,
        flash_launches=launches,
        wall_s=wall,
    )
    log("serve: " + json.dumps(summary))
    profile_decode(kernels)
    return dict(summary=summary, launches=launches, kernels=kernels, prompts=prompts)


def profile_decode(kernels, steps: int = 3) -> dict:
    """Device-busy share of full decode steps: every lane at position 1000
    (the longest chunk walk the smoke prompts reach), traced with
    torch.profiler.  Tracing adds host time, so the share is a lower bound
    of the untraced one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scfg = kernels.serve_cfg
    lanes, width = scfg.max_batch, scfg.blocks_per_seq
    tokens = np.ones(lanes, np.int64)
    positions = np.full(lanes, 1000, np.int64)
    tables = 1 + np.arange(lanes * width, dtype=np.int64).reshape(lanes, width)
    kernels.decode(tokens, positions, tables)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            kernels.decode(tokens, positions, tables)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in cuda)
    out = dict(
        traced_step_ms=wall_us / steps / 1e3,
        device_ms_per_step=device_us / steps / 1e3,
        device_busy_share=device_us / wall_us,
        device_ops_per_step=sum(e.count for e in cuda) / steps,
    )
    log("decode profile (8 lanes at position 1000): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4: serving-path logits against the full forward
# ---------------------------------------------------------------------------


def check_parity(model, kernels, prompts, dtype_name: str) -> None:
    import torch

    tol = PARITY_TOL[dtype_name]
    scfg = kernels.serve_cfg
    table = list(range(1, 1 + scfg.blocks_per_seq))
    lanes = scfg.max_batch
    for prompt in prompts:
        seq = list(prompt)
        got = kernels.prefill(seq, table)
        worst = 0.0
        for step in range(4):
            with torch.no_grad():
                ref = model(torch.tensor([seq], device="cuda"))[0, -1].cpu().numpy()
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            np.testing.assert_allclose(got, ref, **tol)
            tok = int(np.argmax(got))
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > tol["atol"] + tol["rtol"] * abs(top2[1]):
                assert tok == int(np.argmax(ref)), f"greedy token differs at step {step}"
            if step == 3:
                break
            seq.append(tok)
            tokens = np.zeros(lanes, np.int64)
            positions = np.full(lanes, -1, np.int64)
            tables = np.zeros((lanes, scfg.blocks_per_seq), np.int64)
            tokens[0], positions[0], tables[0] = tok, len(seq) - 1, table
            got = kernels.decode(tokens, positions, tables)[0]
        log(f"parity {dtype_name}: prompt of {len(prompt)} tokens, prefill + 3 decode "
            f"steps, max_abs_err={worst:.3e} (tol {tol})")


def phase_parity(model, kernels, prompts) -> None:
    import torch

    from determined_tpu_torch.models.transformer import TransformerLM
    from determined_tpu_torch.serve import DecodeKernels

    # full-f32 products on both sides: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    picks = [max(prompts, key=len), min(prompts, key=len)]
    check_parity(model, kernels, picks, "bfloat16")
    model32 = TransformerLM(flagship_config(torch.float32), generator=torch.Generator("cuda"))
    model32.load_state_dict(model.state_dict())
    kernels32 = DecodeKernels(model32, dataclasses.replace(serve_config(), num_blocks=160))
    check_parity(model32, kernels32, picks, "float32")


# ---------------------------------------------------------------------------
# phase 5: train the flagship through Trainer(LMTrial).fit
# ---------------------------------------------------------------------------


def _launch_counts() -> dict:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw

    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.launches_bwd_dq,
                flash_bwd_dkv=fa.launches_bwd_dkv, fused_adamw=fw.launches)


def _reset_launches() -> None:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw

    fa.reset_launches()
    fw.reset_launches()


def phase_train(seed: int) -> dict:
    """The bench.py workload through init -> Trainer(LMTrial).fit."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    hp = dict(TRAIN_HPARAMS)
    ctx = train.init(hparams=hp, seed=seed)
    trial = LMTrial(ctx)
    trainer = train.Trainer(trial)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # counts from here on are the training path's
    t0 = time.monotonic()
    summary = trainer.fit(
        max_length=TRAIN_STEPS, report_period=TRAIN_REPORT, validation_period=TRAIN_STEPS,
        checkpoint_policy="none",
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    reports = ctx.core.train.metrics("training")
    gbs, seq = hp["global_batch_size"], hp["seq_len"]
    assert [step for step, _ in reports] == list(range(TRAIN_REPORT, TRAIN_STEPS + 1, TRAIN_REPORT))
    # every report covers TRAIN_REPORT steps; the first holds the warm-up
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    timed = step_ms[1:]
    mean_step_ms = statistics.mean(timed)
    tokens_per_s = gbs * seq / (mean_step_ms / 1e3)
    mfu = trial.flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"]
    first_loss, last_loss = reports[0][1]["loss"], reports[-1][1]["loss"]
    val_loss = summary["validation_metrics"]["validation_loss"]
    for name, x in (("first", first_loss), ("last", last_loss), ("validation", val_loss)):
        assert np.isfinite(x), f"{name} loss is not finite: {x}"
    assert last_loss < first_loss, f"loss did not fall: {first_loss} -> {last_loss}"

    n_leaves = len(trainer._params)
    n_val = trainer.val_loader.batches_per_epoch
    layers = trial._cfg().n_layers
    want = dict(
        flash_fwd=layers * (TRAIN_STEPS + n_val),
        flash_bwd_dq=layers * TRAIN_STEPS,
        flash_bwd_dkv=layers * TRAIN_STEPS,
        fused_adamw=n_leaves * TRAIN_STEPS,
    )
    assert n_leaves == 75, n_leaves
    assert launches == want, f"launches {launches} != expected {want}"
    out = dict(
        card=card_line(),  # the metrics below hold for this card and power limit
        steps=summary["steps_completed"], wall_s=wall,
        step_ms_per_report=step_ms, mean_step_ms_last_20=mean_step_ms,
        tokens_per_s=tokens_per_s, flops_per_token=trial.flops_per_token,
        mfu_vs_989_tflops=mfu, first_report_loss=first_loss, last_report_loss=last_loss,
        validation_loss=val_loss, peak_memory_gib=peak_gib, launches=launches,
    )
    log("train: " + json.dumps(out))
    out["profile"] = profile_train(trainer)
    return out


def profile_train(trainer, steps: int = 3) -> dict:
    """Device time by kernel over ``steps`` training steps, traced with
    torch.profiler, and the device-busy share of the traced window (tracing
    adds host time, so the share is a lower bound of the untraced one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.data import to_device

    it = iter(trainer.train_loader)
    batches = [to_device(next(it), trainer.device) for _ in range(steps + 1)]
    trainer._train_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches[1:]:
            trainer._train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in cuda)
    groups: dict = {}
    for e in cuda:
        name = e.key.lower()
        if "flash_bwd_dq" in name:
            g = "flash_bwd_dq"
        elif "flash_bwd_dkv" in name:
            g = "flash_bwd_dkv"
        elif "flash_fwd" in name:
            g = "flash_fwd"
        elif "adamw" in name:
            g = "fused_adamw"
        elif any(t in name for t in ("gemm", "cutlass", "nvjet", "sm90_xmma", "cublas")):
            g = "matmul (cuBLAS)"
        elif "reduce" in name or "norm" in name:
            g = "reductions"
        else:
            g = "elementwise, copies and casts"
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]
    out = dict(
        traced_step_ms=wall_us / steps / 1e3,
        device_ms_per_step=device_us / steps / 1e3,
        device_busy_share=device_us / wall_us,
        device_ops_per_step=sum(e.count for e in cuda) / steps,
        device_ms_per_step_by_group={
            k: v / steps / 1e3 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])
        },
        top_kernels_ms_per_step=[
            [e.key[:90], e.self_device_time_total / steps / 1e3, e.count // steps] for e in top
        ],
    )
    log(f"train profile ({steps} steps): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 6: the training step on the card against the plain versions on the CPU
# ---------------------------------------------------------------------------


def phase_train_parity(seed: int) -> dict:
    """A 2-layer f32 LM trains TRAIN_PARITY_STEPS steps on the card, through
    the kernels, and on the CPU, through the plain versions, from the same
    weights and batches."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.models import LMTrial

    # full-f32 products on both sides: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainers = {}
    for dev in ("cuda", "cpu"):
        t = train.Trainer(LMTrial(train.init(hparams=TRAIN_PARITY_HPARAMS, seed=seed, device=dev)))
        t._setup()
        trainers[dev] = t
    card, host = trainers["cuda"], trainers["cpu"]
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    start = {k: v.detach().cpu().clone() for k, v in host.model.state_dict().items()}
    _reset_launches()
    losses = {"cuda": [], "cpu": []}
    its = {dev: iter(t.train_loader) for dev, t in trainers.items()}
    for _ in range(TRAIN_PARITY_STEPS):
        batches = {dev: next(it) for dev, it in its.items()}
        np.testing.assert_array_equal(batches["cuda"]["tokens"], batches["cpu"]["tokens"])
        for dev, t in trainers.items():
            t._train_step(to_device(batches[dev], t.device))
            losses[dev].append(t.state.fetch_metrics()["loss"])
            t.state.reset_metrics()
    launches = _launch_counts()
    assert all(launches[k] > 0 for k in launches), launches

    tol = TRAIN_PARITY_TOL
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **tol["loss"])

    def rel(a, b) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))

    upd_err = max(
        rel(card.model.state_dict()[k].cpu() - start[k], host.model.state_dict()[k] - start[k])
        for k in start
    )
    mu_err = max(rel(card.state.opt_state.mu[k].cpu(), host.state.opt_state.mu[k]) for k in start)
    nu_err = max(rel(card.state.opt_state.nu[k].cpu(), host.state.opt_state.nu[k]) for k in start)
    out = dict(losses_card=losses["cuda"], losses_cpu=losses["cpu"],
               max_rel_update_err=upd_err, max_rel_mu_err=mu_err, max_rel_nu_err=nu_err,
               launches=launches)
    log("train parity (card kernels vs CPU plain versions): " + json.dumps(out))
    assert upd_err <= tol["update_rel"], upd_err
    assert max(mu_err, nu_err) <= tol["moment_rel"], (mu_err, nu_err)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # a subset (e.g. --phases kernel) makes a new kernel's first call on the
    # card short; the contract's kernels line needs kernel, serve and train
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    import determined_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    kernel = {}
    if "kernel" in phases:
        kernel = phase_kernel(args.seed)
    serve = None
    if "serve" in phases or "parity" in phases:
        from determined_tpu_torch.models.transformer import TransformerLM

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        model = TransformerLM(flagship_config(torch.bfloat16), generator=gen)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"flagship LM: {n_params / 1e6:.1f}M params (f32), compute bf16")
        if "serve" in phases:
            serve = phase_serve(args.seed, model)
        if "parity" in phases:
            if serve is None:
                from determined_tpu_torch.serve import DecodeKernels

                kernels, prompts = DecodeKernels(model, serve_config()), make_prompts(
                    args.seed, model.cfg.vocab_size
                )
            else:
                kernels, prompts = serve.pop("kernels"), serve["prompts"]
            phase_parity(model, kernels, prompts)
            del kernels
        serve = serve and {k: v for k, v in serve.items() if k != "kernels"}
        del model  # free the serving models before training
        gc.collect()
        torch.cuda.empty_cache()
    trained = phase_train(args.seed) if "train" in phases else None
    if "train_parity" in phases:
        phase_train_parity(args.seed)

    if kernel and serve is not None and trained is not None:
        rows = []
        for name, (source, replaces) in KERNELS.items():
            by_phase = {"train": trained["launches"][name]}
            if name == "flash_fwd":
                by_phase["serve"] = serve["launches"]
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=trained["launches"][name], launches_by_phase=by_phase,
                **kernel[name],
            ))
        print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
