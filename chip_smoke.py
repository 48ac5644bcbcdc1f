#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (determined_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--phases kernel,serve,parity]

Phases, in order; any failure raises and the script exits non-zero:

1. device (always): require CUDA; print the card's name and power limit.
2. kernel: build every hand-written kernel from csrc/ with nvcc and hold it
   against its plain PyTorch version on the card at the shapes the serving
   path gives it; time kernel, plain version, the library yardstick
   (``scaled_dot_product_attention``, which the port never calls) and the
   bound.
3. serve: the flagship LM (examples/transformer_lm/const.yaml: d2048, L8,
   H16, V32768, bf16 compute, f32 params; random weights from --seed) behind
   a ServeWorker on localhost; greedy POST /v1/generate requests, four of
   them sharing a 512-token prefix.  The launch counters are set to 0 just
   before the requests and read just after.
4. parity: serving-path logits (prefill and three decode steps) against the
   full TransformerLM forward, in bf16 and in an f32 copy of the model.

Prints, before the last line, the kernels line (JSON) and, as the last line,
{"ok": true, "device": {...}}.  Imports nothing of JAX or determined_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
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

KERNEL_SOURCE_PATH = "determined_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "determined_tpu/ops/flash_attention.py:150"  # _flash_fwd_call

# kernel vs plain version, per dtype.  bf16: both cast p to bf16 before P.V,
# but the kernel's online softmax rounds p against a running max where the
# plain version uses the row max, so outputs differ by a few bf16 ulps
# (2^-8 relative); lse sums f32 values in another order.  f32: the
# tolerance the JAX package holds its own flash kernel to (tests/test_ops.py).
KERNEL_TOL = {
    "bfloat16": dict(out=dict(atol=1e-2, rtol=1e-2), lse=dict(atol=1e-3, rtol=1e-4)),
    "float32": dict(out=dict(atol=2e-5, rtol=2e-5), lse=dict(atol=2e-5, rtol=2e-5)),
}

# serving-path logits vs the full forward.  bf16 keeps 8 mantissa bits and
# the two paths round at different places (the prompt padded to 1024 vs its
# own length, the chunked decode keeps p in f32 where the forward casts it),
# through 8 layers; logits here have std ~1.  f32: reassociation only.
PARITY_TOL = {"bfloat16": dict(atol=1e-1, rtol=5e-2), "float32": dict(atol=2e-3, rtol=1e-3)}

N_REQUESTS = 12
N_SHARED = 4
SHARED_PREFIX = 512


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


def attention_bound_us(b, h, hkv, sq, sk, d, dtype_name, causal):
    """Least time for the card: every input read once, every output written
    once, against the operations this causal mask needs."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * d * (2 * b * h * sq + 2 * b * hkv * sk) + 4 * b * h * sq
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernel(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops import _build
    from determined_tpu_torch.ops.flash_attention import (
        KERNEL_SOURCE,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    t0 = time.monotonic()
    _build.load(KERNEL_SOURCE)
    log(f"kernel build+load: {time.monotonic() - t0:.1f} s ({KERNEL_SOURCE})")
    for line in (_build.ptxas_report(KERNEL_SOURCE) or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [
        # name, b, h, hkv, s, d, dtype, causal
        ("serving", 1, 16, 16, 1024, 128, torch.bfloat16, True),
        ("gqa", 2, 16, 4, 512, 128, torch.bfloat16, True),
        ("f32_hd64_ragged", 1, 4, 4, 200, 64, torch.float32, True),
        ("f32_hd128_full_gqa", 2, 8, 2, 77, 128, torch.float32, False),
        ("bf16_hd64_ragged_full", 1, 4, 4, 130, 64, torch.bfloat16, False),
    ]
    result = {}
    for name, b, h, hkv, s, d, dtype, causal in cases:
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        tol = KERNEL_TOL[dname]
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        log(f"kernel case {name}: [{b},{h}/{hkv},{s},{d}] {dname} causal={causal} "
            f"max_abs_err out={err_out:.3e} lse={err_lse:.3e}")
        torch.testing.assert_close(out.float(), ref_out.float(), **tol["out"])
        torch.testing.assert_close(lse, ref_lse, **tol["lse"])
        if name == "serving":
            kernel_us = device_time_us(lambda: flash_attention_fwd(q, k, v, causal=True))
            plain_us = device_time_us(lambda: flash_attention_fwd_reference(q, k, v, causal=True))
            library_us = device_time_us(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
            )
            bound_us, bound_by = attention_bound_us(b, h, hkv, s, s, d, dname, causal)
            log(f"flash_fwd at the serving shape [1,16,1024,128] bf16 causal: "
                f"kernel_us={kernel_us:.2f} plain_us={plain_us:.2f} "
                f"library_us={library_us:.2f} bound_us={bound_us:.2f} ({bound_by})")
            result = dict(
                max_abs_err=err_out, ms=kernel_us / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_us / 1e3, bound_by=bound_by, library_ms=library_us / 1e3,
            )
    return result


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # a subset (e.g. --phases kernel) makes a new kernel's first call on the
    # card short; the contract's kernels line needs kernel and serve
    parser.add_argument("--phases", default="kernel,serve,parity")
    args = parser.parse_args()
    phases = set(args.phases.split(","))

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
    model = None
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

    if kernel and serve is not None:
        row = dict(
            name="flash_fwd", route="cuda", source=KERNEL_SOURCE_PATH, replaces=REPLACES,
            launches=serve["launches"], **kernel,
        )
        print(json.dumps({"kernels": [row]}), flush=True)
    print(card, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
