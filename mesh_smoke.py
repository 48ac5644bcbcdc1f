#!/usr/bin/env python3
"""Multi-GPU check of the port's mesh path on the GPUs of one host.

    python3 mesh_smoke.py [--gpus 4] [--seed N]

The MoE LM of chip_smoke.py's phase 14 (examples/transformer_lm/moe_ep.yaml
at its full width, cut to 4 layers and a global batch of 8 sequences of
2048, MOE_CUTS) runs on one GPU in this process, then as a gang of
``--gpus`` ranks (one process a GPU, NCCL, ``DistributedContext.from_torch``
from a torchrun-style environment) on each mesh of MESHES, from the same
weights and the same global batches:

R. the reference: 5 steps on one GPU through Trainer(LMTrial).fit.
G. each mesh: 5 steps through train.init(mesh_config=...) ->
   Trainer(LMTrial).fit (FSDP2 over data x fsdp, the experts over expert,
   fused_adamw on each rank's shards): every step's loss and moe_aux_loss
   against R's within MESH_LOSS_TOL, each rank's launch counts (a layer's
   flash forward, dq and dk/dv once a step, fused_adamw once a local leaf),
   the host step and peak memory of each rank.
E. the expert-parallel MoE layer (d 256, e 8, f32, TF32 off) at data 2 x
   expert 2: each rank's output, aux and gradients against the unsharded
   layer on the same rank's tokens within E_TOL.
S. the dense LM of chip_smoke.py's phase 15 (examples/transformer_lm/
   fsdp_tp_sp.yaml at its full width: d 4096, 32 heads of 128, 8 kv heads,
   vocab 32768, seq 32768, bf16, remat; 4 layers, SEQ_CUTS and
   SEQ_MESH_CUTS) for 5 steps on one GPU, then on each mesh of SEQ_MESHES
   (tensor x seq: Megatron's tensor split, ring attention over seq, FSDP2
   over fsdp x seq): every step's loss against the one GPU's within
   MESH_LOSS_TOL, each rank's launches (flash forward twice a layer a step
   under remat, dq and dk/dv once, each times the ring's units that
   ring_block_counts gives this rank on a seq axis; fused_adamw once a
   local leaf), the host step and peak memory of each rank.
C. a tensor 2 x seq 2 checkpoint (SEQ_CKPT_CUTS: the round trip, not the
   size): 3 steps on the mesh, saved whole by the chief, restored by one
   GPU's Trainer bitwise equal to the mesh's gathered params and moments.

Each gang has a hard timeout (GANG_TIMEOUT_S); its ranks are killed on
expiry and the run fails.  Prints a JSON line a part, the card's name and
power limit, and last {"ok": true, "device": {...}}; exits non-zero on any
failure and without the GPUs.  Imports nothing of JAX or determined_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MESHES = (dict(data=2, fsdp=2), dict(data=2, expert=2), dict(fsdp=2, expert=2))
STEPS = 5
# bf16 compute over another split of the batch: each rank's matmuls have
# other shapes (other cuBLAS tilings, other roundings), so the losses agree
# to bf16 reassociation, as tests/test_torch_training.py's BF16_TOL holds
# its bf16 losses
MESH_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
# f32, TF32 off, the same tokens: the layer to f32 reassociation
E_TOL = dict(rtol=1e-5, atol=1e-5)
GANG_TIMEOUT_S = 300.0
SEQ_MESHES = (dict(tensor=2, seq=2), dict(fsdp=2, tensor=2), dict(seq=4))
# S's changes to chip_smoke's phase 15 L: (key, L's value, S's value, why)
SEQ_MESH_CUTS = [
    ("global_batch_size", 1, 2, "fsdp 2 reads one sequence a batch shard"),
]
# C's round trip at a small width: the full-width state is 19.9 GB
SEQ_CKPT_CUTS = [
    ("d_model", 4096, 256, "the round trip, not the size, is what C's checkpoint shows"),
    ("n_heads", 32, 2, "head dim 128 at width 256"),
    ("n_kv_heads", 8, 2, "one kv head a tensor rank"),
    ("n_layers", 4, 2, "two blocks"),
    ("vocab_size", 32768, 4096, "the same, in the head"),
    ("seq_len", 32768, 256, "the same, in length"),
]
SEQ_CKPT_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def _hparams() -> dict:
    from chip_smoke import _moe_hparams

    return _moe_hparams()


def _seq_hparams(cuts=()) -> dict:
    from chip_smoke import _seq_hparams as phase15_hparams

    hp = phase15_hparams()
    for key, _old, value, _why in list(SEQ_MESH_CUTS) + list(cuts):
        hp[key] = value
    return hp


def _fit(ctx, steps: int) -> dict:
    """Trainer(LMTrial(ctx)).fit for ``steps`` steps, reporting each."""
    import torch

    from chip_smoke import _launch_counts, _reset_launches
    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    trainer = train.Trainer(LMTrial(ctx))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    trainer.fit(max_length=steps, report_period=1, checkpoint_policy="none")
    torch.cuda.synchronize()
    rows = ctx.core.train.metrics("training")
    gbs = ctx.get_global_batch_size()
    return dict(
        losses=[m["loss"] for _, m in rows], aux=[m.get("moe_aux_loss") for _, m in rows],
        step_ms=[1e3 * gbs / m["samples_per_second"] for _, m in rows],
        wall_s=time.monotonic() - t0, launches=_launch_counts(),
        local_leaves=len(trainer._params), layers=trainer.model.cfg.n_layers,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        params=sum(p.numel() for p in trainer._params.values()),
    )


def _rank_gang(workdir: str, mesh: dict, seed: int) -> dict:
    """One rank of a gang: G's fit on ``mesh``, E's layer, S's fit or C's
    checkpoint."""
    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.parallel import MeshConfig

    core_ctx = core.init(checkpoint_dir=os.path.join(workdir, "ck"))
    dist = core_ctx.distributed
    try:
        if mesh.get("part") == "E":
            return _rank_layer(dist)
        if mesh.get("part") == "S":
            return _rank_seq(core_ctx, mesh["mesh"], seed)
        if mesh.get("part") == "C":
            return _rank_ckpt(core_ctx, workdir, seed)
        ctx = train.init(hparams=_hparams(), seed=seed, core_context=core_ctx,
                         mesh_config=MeshConfig(**mesh))
        out = _fit(ctx, STEPS)
        out["batch_shard"] = [ctx.mesh.coordinate(a) for a in ("data", "fsdp", "expert")]
        torch.cuda.synchronize()
        return out
    finally:
        dist.close()


def _rank_seq(core_ctx, mesh: dict, seed: int) -> dict:
    """One rank of S: the LM's fit on ``mesh``, and the ring's units for
    this rank (ring_block_counts on its seq group; 1 without one)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.ops.ring_attention import ring_block_counts
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_seq_hparams(), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(**mesh))
    out = _fit(ctx, STEPS)
    out["coords"] = {a: ctx.mesh.coordinate(a) for a in ("fsdp", "seq", "tensor")}
    units = 1
    if ctx.mesh.shape["seq"] > 1:
        q = torch.randn((1, 2, 32, 64), device=ctx.device, dtype=torch.bfloat16)
        _, counts = ring_block_counts(q, q, q, ctx.mesh.group("seq"))
        units = counts[ctx.mesh.coordinate("seq")]
        out["ring_counts"] = counts
    out["ring_units"] = units
    torch.cuda.synchronize()
    return out


def _rank_ckpt(core_ctx, workdir: str, seed: int) -> dict:
    """One rank of C: SEQ_CKPT_STEPS steps at tensor 2 x seq 2 and a
    checkpoint; the chief also saves the mesh's gathered params and
    moments for the one-GPU restore to be held against."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_seq_hparams(SEQ_CKPT_CUTS), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(tensor=2, seq=2))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=SEQ_CKPT_STEPS, report_period=1, checkpoint_policy="all",
                          validation_period=SEQ_CKPT_STEPS)
    full = trainer._full_array_state()
    if core_ctx.distributed.is_chief:
        torch.save({"params": full["params"], "mu": full["opt_state"].mu,
                    "nu": full["opt_state"].nu}, os.path.join(workdir, "mesh_state.pt"))
    return dict(storage_id=summary["latest_checkpoint"])


def _ckpt_on_one_gpu(workdir: str, sid: str, seed: int) -> dict:
    """C's restore: one GPU's Trainer resumes the mesh's checkpoint; its
    params and moments equal the mesh's gathered ones bitwise."""
    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.models import LMTrial

    want = torch.load(os.path.join(workdir, "mesh_state.pt"))
    ctx = train.init(hparams=_seq_hparams(SEQ_CKPT_CUTS), seed=seed,
                     core_context=core._dummy_init(checkpoint_dir=os.path.join(workdir, "ck")))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=SEQ_CKPT_STEPS, latest_checkpoint=sid,
                          checkpoint_policy="none")
    assert summary["steps_completed"] == SEQ_CKPT_STEPS
    for name, p in trainer._params.items():
        assert torch.equal(p.detach().cpu(), want["params"][name]), name
    for which in ("mu", "nu"):
        for name, t in getattr(trainer.state.opt_state, which).items():
            assert torch.equal(t.cpu(), want[which][name]), (which, name)
    return dict(storage_id=sid, leaves=len(trainer._params), restored="bitwise")


def _layer_inputs(seed: int):
    rng = np.random.default_rng(seed + 21)
    d, e, f = 256, 8, 1024
    x = rng.standard_normal((8, 1024, d)).astype(np.float32)
    weights = {"router": rng.standard_normal((d, e)) * d ** -0.5,
               "w_in": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_gate": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_out": rng.standard_normal((e, f, d)) * (e * f) ** -0.5}
    return (d, e, f), x, weights


def _layer_run(dims, x, weights, device, mesh=None):
    """The MoE layer's output, aux and gradients (all on the host)."""
    import torch

    from determined_tpu_torch.models.moe import MoE

    d, e, f = dims
    layer = MoE(d, e, f, dtype=torch.float32, device=device)
    layer.load_state_dict({k: torch.tensor(v, dtype=torch.float32) for k, v in weights.items()})
    if mesh is not None:
        layer.shard_experts(mesh.group("expert"), mesh.shape["expert"],
                            mesh.coordinate("expert"))
    xt = torch.tensor(x, device=device, requires_grad=True)
    y, aux = layer(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return dict(y=y.detach().cpu().numpy(), aux=float(aux.detach()),
                x=xt.grad.cpu().numpy(),
                **{n: p.grad.cpu().numpy() for n, p in layer.named_parameters()})


def _rank_layer(dist) -> dict:
    """E on one rank: the expert-parallel layer on this rank's tokens and
    the unsharded layer on the same tokens, both on this rank's GPU."""
    import torch

    from determined_tpu_torch.parallel import MeshConfig, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MeshConfig(data=2, expert=2), dist.device.type)
    dims, x, weights = _layer_inputs(int(os.environ["MESH_SMOKE_SEED"]))
    rows = np.array_split(x, 2)[mesh.coordinate("data")]
    got = _layer_run(dims, rows, weights, dist.device, mesh)
    want = _layer_run(dims, rows, weights, dist.device)
    n = dims[1] // 2
    lo = mesh.coordinate("expert") * n
    errs = {}
    for k, v in got.items():
        ref = want[k][lo:lo + n] if k in ("w_in", "w_gate", "w_out") else want[k]
        np.testing.assert_allclose(v, ref, err_msg=f"E {k}", **E_TOL)
        errs[k] = float(np.max(np.abs(np.asarray(v) - np.asarray(ref))))
    return dict(max_abs_err=errs)


def _launch_gang(n: int, workdir: str, mesh: dict, seed: int) -> list:
    """``n`` rank processes of this script with a torchrun environment;
    their results, or a failure naming the ranks (killed on timeout)."""
    from determined_tpu_torch.core import allocate_port

    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(allocate_port()), MESH_SMOKE_SEED=str(seed),
               PYTHONPATH=REPO)
    procs, logs = [], []
    for rank in range(n):
        log_f = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of", workdir, json.dumps(mesh),
             "--seed", str(seed)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=REPO,
            stdout=log_f, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + GANG_TIMEOUT_S
    hung = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                hung = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if hung or p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                log(f"--- rank {r} of {mesh}:\n{f.read()[-4000:]}")
        raise RuntimeError(f"gang {mesh} failed on ranks {bad}" + (" (timed out)" if hung else ""))
    out = []
    for rank in range(n):
        with open(os.path.join(workdir, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _seq_part(args, root: str) -> None:
    """S and C (the docstring at the top)."""
    import torch

    from chip_smoke import SEQ_CUTS
    from determined_tpu_torch import train

    for key, old, value, why in SEQ_CUTS + SEQ_MESH_CUTS:
        log(f"S cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    for key, old, value, why in SEQ_CKPT_CUTS:
        log(f"C cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    ctx = train.init(hparams=_seq_hparams(), seed=args.seed)
    ref = _fit(ctx, STEPS)
    del ctx
    torch.cuda.empty_cache()
    log("S one GPU: " + json.dumps({k: v for k, v in ref.items() if k != "aux"}))
    for i, mesh in enumerate(SEQ_MESHES):
        outs = _launch_gang(args.gpus, os.path.join(root, f"s{i}"), dict(part="S", mesh=mesh),
                            args.seed)
        chief = outs[0]
        np.testing.assert_allclose(chief["losses"], ref["losses"], err_msg=str(mesh),
                                   **MESH_LOSS_TOL)
        for rank, o in enumerate(outs):
            layers, leaves, u = o["layers"], o["local_leaves"], o["ring_units"]
            if mesh.get("seq", 1) > 1:
                assert u == 2 * mesh["seq"] + 1, (mesh, rank, o["ring_counts"])
            want = dict(flash_fwd=2 * layers * STEPS * u, flash_bwd_dq=layers * STEPS * u,
                        flash_bwd_dkv=layers * STEPS * u, fused_adamw=leaves * STEPS)
            assert o["launches"] == want, (mesh, rank, o["launches"], want)
        log("S " + json.dumps(dict(
            mesh=mesh, losses=chief["losses"], ref_losses=ref["losses"],
            max_loss_rel=max(abs(a - b) / abs(b) for a, b in zip(chief["losses"], ref["losses"])),
            step_ms=[o["step_ms"] for o in outs],
            peak_memory_gib=[o["peak_memory_gib"] for o in outs],
            ref_peak_memory_gib=ref["peak_memory_gib"],
            local_params=[o["params"] for o in outs], coords=[o["coords"] for o in outs],
            ring_counts=[o.get("ring_counts") for o in outs],
            launches=[o["launches"] for o in outs])))
    workdir = os.path.join(root, "c")
    outs = _launch_gang(args.gpus, workdir, dict(part="C"), args.seed)
    sid = outs[0]["storage_id"]
    assert all(o["storage_id"] == sid for o in outs), outs
    log("C " + json.dumps(_ckpt_on_one_gpu(workdir, sid, args.seed)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gpus", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rank-of", nargs=2, metavar=("WORKDIR", "MESH"))
    args = parser.parse_args()

    import torch

    if args.rank_of:
        workdir, mesh = args.rank_of[0], json.loads(args.rank_of[1])
        result = _rank_gang(workdir, mesh, args.seed)
        with open(os.path.join(workdir, f"out{os.environ['RANK']}.pkl"), "wb") as f:
            pickle.dump(result, f)
        return 0

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.gpus:
        print(f"mesh_smoke: needs {args.gpus} CUDA devices", file=sys.stderr)
        return 1
    import determined_tpu_torch  # noqa: F401  (fails outside a checkout)
    from chip_smoke import MOE_CUTS, card_line
    from determined_tpu_torch import train

    t_start = time.monotonic()
    card = card_line()
    log(f"card: {card} x {torch.cuda.device_count()}")
    for key, old, value, why in MOE_CUTS:
        log(f"cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    root = tempfile.mkdtemp(prefix="dtt-mesh-smoke-")
    try:
        ctx = train.init(hparams=_hparams(), seed=args.seed)
        ref = _fit(ctx, STEPS)
        del ctx
        torch.cuda.empty_cache()
        log("R: " + json.dumps(ref))
        for i, mesh in enumerate(MESHES):
            outs = _launch_gang(args.gpus, os.path.join(root, f"g{i}"), mesh, args.seed)
            chief = outs[0]
            np.testing.assert_allclose(chief["losses"], ref["losses"], err_msg=str(mesh),
                                       **MESH_LOSS_TOL)
            np.testing.assert_allclose(chief["aux"], ref["aux"], err_msg=str(mesh),
                                       **MESH_LOSS_TOL)
            for rank, o in enumerate(outs):
                layers, leaves = o["layers"], o["local_leaves"]
                want = dict(flash_fwd=layers * STEPS, flash_bwd_dq=layers * STEPS,
                            flash_bwd_dkv=layers * STEPS, fused_adamw=leaves * STEPS)
                assert o["launches"] == want, (mesh, rank, o["launches"], want)
            log("G " + json.dumps(dict(
                mesh=mesh, losses=chief["losses"], ref_losses=ref["losses"],
                max_loss_rel=max(abs(a - b) / abs(b) for a, b in
                                 zip(chief["losses"], ref["losses"])),
                step_ms=[o["step_ms"] for o in outs],
                peak_memory_gib=[o["peak_memory_gib"] for o in outs],
                local_params=[o["params"] for o in outs],
                coords=[o["batch_shard"] for o in outs], launches=chief["launches"])))
        outs = _launch_gang(args.gpus, os.path.join(root, "e"), dict(part="E"), args.seed)
        log("E " + json.dumps({f"rank{r}": o["max_abs_err"] for r, o in enumerate(outs)}))
        _seq_part(args, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"mesh_smoke: {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
