"""Rank processes for the port's multi-rank CPU tests, and their launcher.

``launch(case, world, workdir, payload)`` starts ``world`` processes of this
file, each one rank of a gloo process group that meets through a
``FileStore`` under ``workdir`` (no fixed TCP port), hands them ``payload``
(numpy arrays and plain values, pickled into ``workdir``) and returns each
rank's result.  The ranks import torch and the port, never JAX: the tests
compute their JAX references in the parent.  Every launch has a hard
timeout; on expiry every rank is killed and the launch fails, so a hung
collective fails one test.

The ranks are forked from one interpreter of this file (``_Zygote``: it
imports torch and the port once, under the launch's environment, and forks
the ``world`` ranks of each launch), so a launch starts no interpreter and
imports nothing again; a launch whose environment differs from the
interpreter's gets a new one.  Each rank sets its own ``RANK``/
``LOCAL_RANK`` and runs ``main`` in the launch's directory.

Run as a script: ``python tests/torch_rank_worker.py CASE RANK WORLD DIR``
(one rank), or ``python tests/torch_rank_worker.py --zygote`` (the forking
interpreter, one JSON request a line on standard input).
"""

from __future__ import annotations

import atexit
import json
import os
import pickle
import select
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a launch may take before its ranks are killed
RANK_TIMEOUT = 120.0


def launch(case: str, world: int, workdir: str, payload: Dict[str, Any],
           timeout: float = RANK_TIMEOUT) -> List[Any]:
    """Run ``case`` on ``world`` gloo ranks; the list of their results."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "input.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTEST_XDIST_WORKER")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    rcs, hung = _zygote(env).run(case, world, workdir, timeout)

    def tail(rank: int) -> str:
        with open(os.path.join(workdir, f"rank{rank}.log")) as f:
            return f.read()[-3000:]

    if hung:
        raise AssertionError(
            f"{case} on {world} ranks did not finish within {timeout:.0f} s; ranks killed\n"
            + "\n".join(f"--- rank {r}:\n{tail(r)}" for r in range(world))
        )
    bad = [r for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        raise AssertionError(
            f"{case}: ranks {bad} failed\n" + "\n".join(f"--- rank {r}:\n{tail(r)}" for r in bad)
        )
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


class _Zygote:
    """The forking interpreter of one environment (module docstring)."""

    def __init__(self, env: Dict[str, str]) -> None:
        self.env = env
        self._buf = b""
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zygote"], env=env, cwd=REPO,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )

    def _read(self, deadline: float) -> Optional[Dict[str, Any]]:
        """The interpreter's next reply, None at ``deadline`` (the pipe is
        read by its descriptor: a buffered reader would hide a line that
        came with the one before)."""
        fd = self.proc.stdout.fileno()
        while b"\n" not in self._buf:
            ready, _, _ = select.select([fd], [], [], max(deadline - time.monotonic(), 0.0))
            if not ready:
                return None
            chunk = os.read(fd, 65536)
            if not chunk:
                raise AssertionError("the rank interpreter exited")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return json.loads(line)

    def run(self, case: str, world: int, workdir: str, timeout: float):
        """Fork ``world`` ranks of ``case``; their exit codes by rank, and
        whether the launch outlived ``timeout`` (its ranks then killed)."""
        self.proc.stdin.write(json.dumps(dict(case=case, world=world, workdir=workdir)) + "\n")
        self.proc.stdin.flush()
        deadline = time.monotonic() + timeout
        # the first launch waits for the interpreter's imports too
        pids = self._read(time.monotonic() + max(timeout, 120.0))["pids"]
        rcs: Dict[int, int] = {}
        hung = False
        while len(rcs) < world:
            reply = self._read(deadline if not hung else time.monotonic() + 60.0)
            if reply is None:
                if hung:
                    raise AssertionError("killed ranks were not reaped")
                hung = True
                for pid in pids:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                continue
            rcs[reply["rank"]] = reply["rc"]
        return [rcs[r] for r in range(world)], hung

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


_ZYGOTE: Optional[_Zygote] = None


def _zygote(env: Dict[str, str]) -> _Zygote:
    """The forking interpreter of ``env`` (rank variables aside), started
    at its first launch and kept for the next."""
    global _ZYGOTE
    base = {k: v for k, v in env.items() if k not in ("WORLD_SIZE", "LOCAL_WORLD_SIZE")}
    if _ZYGOTE is not None and (_ZYGOTE.env != base or _ZYGOTE.proc.poll() is not None):
        _ZYGOTE.close()
        _ZYGOTE = None
    if _ZYGOTE is None:
        _ZYGOTE = _Zygote(base)
        atexit.register(_ZYGOTE.close)
    return _ZYGOTE


def _serve() -> None:
    """The forking interpreter: import what every rank imports, then for
    each request fork its ranks, name their pids, and report each one's
    exit code as it ends."""
    import traceback

    import torch  # noqa: F401
    import torch.distributed  # noqa: F401

    from determined_tpu_torch import core, models, parallel, train  # noqa: F401
    from determined_tpu_torch.core import DistributedContext  # noqa: F401

    reply = sys.stdout
    for line in sys.stdin:
        req = json.loads(line)
        world, workdir = req["world"], req["workdir"]
        pids = []
        for rank in range(world):
            pid = os.fork()
            if pid == 0:
                rc = 0
                try:
                    log = os.open(os.path.join(workdir, f"rank{rank}.log"),
                                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
                    os.dup2(log, 1)
                    os.dup2(log, 2)
                    os.close(log)
                    sys.stdin = open(os.devnull)
                    os.chdir(workdir)
                    os.environ.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                                      RANK=str(rank), LOCAL_RANK=str(rank))
                    main(req["case"], rank, world, workdir)
                except BaseException:  # noqa: BLE001 - a rank reports any failure by its code
                    traceback.print_exc()
                    rc = 1
                finally:
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(rc)
            pids.append(pid)
        reply.write(json.dumps(dict(pids=pids)) + "\n")
        reply.flush()
        left = dict(zip(pids, range(world)))
        while left:
            pid, status = os.wait()
            if pid in left:
                reply.write(json.dumps(dict(rank=left.pop(pid),
                                            rc=os.waitstatus_to_exitcode(status))) + "\n")
                reply.flush()


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _numpy(t: Any) -> Any:
    return t.detach().cpu().float().numpy() if t is not None else None


def case_moe_ep(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """The expert-parallel MoE layer on this rank's slice of the batch:
    output, aux and the gradients of x, the router and its expert slices."""
    import torch

    from determined_tpu_torch.models.moe import MoE
    from determined_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(**inp["mesh"]), "cpu")
    d_model, e, f, grp = inp["dims"]
    layer = MoE(d_model, e, f, group_size=grp, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.tensor(v) for k, v in inp["params"].items()})
    if mesh.shape["expert"] > 1:
        layer.shard_experts(mesh.group("expert"), mesh.shape["expert"],
                            mesh.coordinate("expert"))
    if inp.get("shard_batch"):
        layer.shard_tokens(mesh.group("data"), (mesh.shape["data"], mesh.coordinate("data")),
                           (1, 0))
    x = torch.tensor(inp["x"]).chunk(mesh.shape["data"])[mesh.coordinate("data")]
    x = x.clone().requires_grad_(True)
    y, aux = layer(x)
    ((y ** 2).mean() + 0.01 * aux).backward()
    out = {"data": mesh.coordinate("data"), "expert": mesh.coordinate("expert"),
           "y": _numpy(y), "aux": float(aux), "x_grad": _numpy(x.grad)}
    out.update({f"grad_{n}": _numpy(p.grad) for n, p in layer.named_parameters()})
    return out


def case_moe_layers(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """Each of ``inp["cases"]``: the MoE layer split over the case's mesh as
    ``shard_model`` splits it (experts, the tensor split, this rank's part
    of the global batch), on this rank's part of the global ``x`` (its
    batch shard's rows, its seq part of each); output, aux and the
    gradients of x and of this rank's parameters under the loss
    ``mean(y²) + 0.01 aux`` of its tokens."""
    import torch

    from determined_tpu_torch.models.moe import MoE
    from determined_tpu_torch.parallel import MeshConfig, batch_shard, make_mesh
    from determined_tpu_torch.parallel.sharding import token_group

    meshes: Dict[Any, Any] = {}
    out: Dict[str, Any] = {}
    for name, c in inp["cases"].items():
        key = tuple(sorted(c["mesh"].items()))
        if key not in meshes:
            mesh = make_mesh(MeshConfig(**c["mesh"]), "cpu")
            meshes[key] = (mesh, token_group(mesh))
        mesh, tokens = meshes[key]
        d_model, e, f, grp = c["dims"]
        layer = MoE(d_model, e, f, group_size=grp, capacity_factor=c.get("capacity", 1.25),
                    dtype=torch.float32, device="cpu")
        layer.load_state_dict({k: torch.tensor(v) for k, v in c["params"].items()})
        if mesh.shape["expert"] > 1:
            layer.shard_experts(mesh.group("expert"), mesh.shape["expert"],
                                mesh.coordinate("expert"))
        if mesh.shape["tensor"] > 1:
            layer.shard_tensor(mesh.group("tensor"), mesh.shape["tensor"],
                               mesh.coordinate("tensor"))
        b_rank, n_b = batch_shard(mesh)
        n_s, s_rank = mesh.shape["seq"], mesh.coordinate("seq")
        if n_b * n_s > 1:
            layer.shard_tokens(tokens, (n_b, b_rank), (n_s, s_rank))
        x = torch.tensor(c["x"]).chunk(n_b, 0)[b_rank].chunk(n_s, 1)[s_rank]
        x = x.clone().requires_grad_(True)
        y, aux = layer(x)
        ((y ** 2).mean() + 0.01 * aux).backward()
        res = {"coords": {a: mesh.coordinate(a) for a in ("expert", "tensor", "seq")},
               "batch_shard": (b_rank, n_b), "y": _numpy(y), "aux": float(aux),
               "x_grad": _numpy(x.grad)}
        res.update({f"grad_{n}": _numpy(p.grad) for n, p in layer.named_parameters()})
        out[name] = res
    return out


def case_moe_plan(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """The MoE LM placed by the Trainer on ``inp["mesh"]``: one step's
    gradients under ``LMTrial.loss``; the plan's clip norm of them and the
    norm of their whole tensors (``ShardPlan.full``), each leaf's whole
    tensor and the box of it this rank holds with its local shard."""
    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.parallel import MeshConfig

    core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=inp["ckpt_dir"])
    ctx = train.init(hparams=inp["hparams"], seed=0, device="cpu", core_context=core_ctx,
                     mesh_config=MeshConfig(**inp["mesh"]))
    trainer = train.Trainer(_trial_class("lm", inp.get("init_state"))(ctx))
    trainer._setup()
    plan = trainer._plan
    batch = to_device(next(iter(trainer.train_loader)), trainer.device)
    trainer.trial.loss(trainer.model, batch)[0].backward()
    local = plan.local({k: p.grad for k, p in trainer._params.items()})
    params = plan.local(dict(trainer._params))
    whole_grads = {k: plan.full(k, g) for k, g in local.items()}
    return {
        "norm": float(plan.global_norm(local)),
        "whole_norm": float(torch.sqrt(sum(g.float().square().sum()
                                           for g in whole_grads.values()))),
        "params": {k: _numpy(plan.full(k, v)) for k, v in params.items()},
        "local": {k: _numpy(v) for k, v in params.items()},
        "boxes": {k: plan.box(k) for k in params},
        "tensor_dims": dict(plan.tensor_dims), "expert_params": sorted(plan.expert_params),
    }


def _trial_class(name: str, init_state: Any):
    from determined_tpu_torch.models import LMTrial, MnistTrial

    base = {"lm": LMTrial, "mnist": MnistTrial}[name]
    if init_state is None:
        return base

    class FromState(base):
        """The trial with its weights replaced before the Trainer shards
        them (the JAX Trainer's initial params, converted)."""

        def build_model(self):
            import torch

            model = super().build_model()
            model.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()})
            return model

    return FromState


def case_train(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """``Trainer(trial).fit(**fit)`` on a mesh: the summary, the reported
    rows, and the final params gathered whole."""
    from determined_tpu_torch import core, train
    from determined_tpu_torch.parallel import MeshConfig

    from determined_tpu_torch.config import ExperimentConfig

    core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=inp["ckpt_dir"])
    exp = ExperimentConfig.parse(inp["exp_config"]) if inp.get("exp_config") else None
    ctx = train.init(hparams=inp["hparams"], seed=inp.get("seed", 0), device="cpu",
                     core_context=core_ctx, mesh_config=MeshConfig(**inp["mesh"]),
                     exp_config=exp)
    trainer = train.Trainer(_trial_class(inp["trial"], inp.get("init_state"))(ctx))
    preempt_at = inp.get("preempt_at")
    if preempt_at is not None and dist.rank == dist.size - 1:
        # the last rank alone is asked to stop before step ``preempt_at``
        from determined_tpu_torch.utils import faults

        class Stop:
            def fire(self, site, **info):
                if site == "train.step" and info["step"] == preempt_at:
                    core_ctx.preempt.simulate()

        faults.set_fault_injector(Stop())
    summary = trainer.fit(**inp["fit"])
    params = trainer._full_array_state()["params"] if trainer.mesh is not None else None
    return {
        "summary": summary,
        # each parameter's shape on this rank before FSDP (its tensor slice)
        "local_shapes": {k: tuple(v.shape) for k, v in trainer._params.items()},
        "training": ctx.core.train.metrics("training"),
        "validation": ctx.core.train.metrics("validation"),
        "params": {k: _numpy(v) for k, v in params.items()} if dist.is_chief and params else None,
        "batch_shard": (trainer.train_loader.sampler.shard_rank,
                        trainer.train_loader.sampler.num_shards),
    }


def case_train_runs(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """Each of ``inp["cases"]`` (``case_train``'s inputs) in turn in this
    process group: its reported rows and, on the chief, its final params
    gathered whole (every pipeline stage's)."""
    from determined_tpu_torch import core, train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.parallel import MeshConfig

    runs = []
    for c in inp["cases"]:
        core_ctx = core._dummy_init(distributed=dist,
                                    checkpoint_dir=os.path.join(inp["ckpt_dir"], c["name"]))
        exp = ExperimentConfig.parse(c["exp_config"]) if c.get("exp_config") else None
        ctx = train.init(hparams=c["hparams"], seed=c.get("seed", 0), device="cpu",
                         core_context=core_ctx, mesh_config=MeshConfig(**c["mesh"]),
                         exp_config=exp)
        trainer = train.Trainer(_trial_class(c["trial"], c.get("init_state"))(ctx))
        summary = trainer.fit(**c["fit"])
        params = trainer._full_array_state()["params"]
        runs.append({
            "name": c["name"], "summary": summary,
            "training": ctx.core.train.metrics("training"),
            "validation": ctx.core.train.metrics("validation"),
            "params": {k: _numpy(v) for k, v in params.items()} if dist.is_chief else None,
            "local_keys": sorted(trainer._params),
            "local_shapes": {k: tuple(v.shape) for k, v in trainer._params.items()},
            "batch_shard": (trainer.train_loader.sampler.shard_rank,
                            trainer.train_loader.sampler.num_shards),
            "units": [names for names, _ in trainer._plan.units],
            "plan": None if trainer._overlap_plan is None else dict(
                enabled=trainer._overlap_plan.enabled,
                names=list(trainer._overlap_plan.names),
                fingerprint=trainer._overlap_plan.fingerprint()),
        })
    return {"runs": runs}


class _IssuedRingBytes:
    """While open, the ring bytes of the all-gathers, reduce-scatters and
    all-reduces this rank issues (an all-reduce moves 2 (n - 1) / n of its
    buffer, the others (n - 1) / n of the whole one), by hop: ``dcn`` for a
    group that spans slices (its ranks differ in the mesh's outermost
    coordinate, ``rank // per_slice``), ``ici`` for one within a slice."""

    # name: (position and keyword of the whole buffer, of the group, the
    # share of it a rank moves over (n - 1) / n); FSDP2 calls the _single
    # forms or, in older torch, the _tensor ones
    SIGNATURES = {
        "all_reduce": ((0, "tensor"), (2, "group"), 2.0),
        "reduce_scatter_tensor": ((1, "input"), (3, "group"), 1.0),
        "reduce_scatter_single": ((1, "input"), (3, "group"), 1.0),
        "all_gather_into_tensor": ((0, "output_tensor"), (2, "group"), 1.0),
        "all_gather_single": ((0, "output_tensor"), (2, "group"), 1.0),
    }

    def __init__(self) -> None:
        self.ring_bytes = {"ici": 0.0, "dcn": 0.0}
        self.per_slice = 0  # ranks a slice (0: one slice)
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> "_IssuedRingBytes":
        import torch.distributed as tdist

        for name, (buf_at, group_at, factor) in self.SIGNATURES.items():
            fn = getattr(tdist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _buf=buf_at, _group=group_at, _f=factor, **k):
                buf = a[_buf[0]] if len(a) > _buf[0] else k.get(_buf[1])
                group = a[_group[0]] if len(a) > _group[0] else k.get(_group[1])
                ranks = (tdist.get_process_group_ranks(group) if group is not None
                         else list(range(tdist.get_world_size())))
                n = len(ranks)
                spans = self.per_slice and len({r // self.per_slice for r in ranks}) > 1
                self.ring_bytes["dcn" if spans else "ici"] += (
                    _f * (n - 1) / n * buf.numel() * buf.element_size())
                return _fn(*a, **k)

            setattr(tdist, name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as tdist

        for name, fn in self._saved.items():
            setattr(tdist, name, fn)
        self._saved.clear()


def case_sync_runs(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """``case_train_runs`` with the gradient sync in view: each run's rows
    and the chief's final params, the ``step.*`` counters the tracer saw,
    the FSDP2 unit reductions (``foreach_reduce``: one reduce-scatter a
    unit) issued a step, the plan's buckets and each unit's modules, and
    the placements of the params."""
    import torch.distributed.fsdp._fully_shard._fsdp_param_group as pg
    from torch.distributed.tensor import DTensor

    from determined_tpu_torch import core, train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.parallel import MeshConfig

    reductions = [0]
    reduce = pg.foreach_reduce

    def counted(*a, **k):
        reductions[0] += 1
        return reduce(*a, **k)

    pg.foreach_reduce = counted
    issued = _IssuedRingBytes()
    tracer = get_tracer()
    runs = []
    for c in inp["cases"]:
        tracer.reset()
        tracer.configure(enabled=True)
        tracer.start()
        core_ctx = core._dummy_init(distributed=dist,
                                    checkpoint_dir=os.path.join(inp["ckpt_dir"], c["name"]))
        exp = ExperimentConfig.parse(c["exp_config"]) if c.get("exp_config") else None
        ctx = train.init(hparams=c["hparams"], seed=c.get("seed", 0), device="cpu",
                         core_context=core_ctx, mesh_config=MeshConfig(**c["mesh"]),
                         exp_config=exp)
        trainer = train.Trainer(_trial_class(c["trial"], c.get("init_state"))(ctx))
        reductions[0] = 0
        train_step = trainer._train_step

        def issuing_step(*a, **k):
            with issued:
                return train_step(*a, **k)

        trainer._train_step = issuing_step
        issued.ring_bytes = {"ici": 0.0, "dcn": 0.0}
        slices = int(c["mesh"].get("num_slices", 1))
        issued.per_slice = dist.size // slices if slices > 1 else 0
        summary = trainer.fit(**c["fit"])
        tracer.stop()
        counters: Dict[str, float] = {}
        for e in tracer.chrome_events():
            if e.get("ph") == "C" and e["name"].startswith("step."):
                counters[e["name"]] = counters.get(e["name"], 0.0) + e["args"]["value"]
        tracer.reset()
        plan = trainer._overlap_plan
        from determined_tpu_torch.train._overlap import fsdp_units

        units = fsdp_units(plan, trainer.model) if plan is not None and plan.enabled else []
        params = trainer._full_array_state()["params"]
        runs.append({
            "name": c["name"], "summary": summary,
            "training": ctx.core.train.metrics("training"),
            "params": {k: _numpy(v) for k, v in params.items()} if dist.is_chief else None,
            "counters": counters,
            "reductions": reductions[0],
            "issued_ring_bytes": issued.ring_bytes,
            "comm_model": None if trainer._comm_model is None else dict(
                ici=trainer._comm_model.bytes_per_step,
                dcn=trainer._comm_model.dcn_bytes_per_step,
                n_buckets=trainer._comm_model.n_buckets),
            "units": units,
            "coords": {a: ctx.mesh.coordinate(a) for a in ("dcn", "data", "fsdp")},
            "batch_shard": (trainer.train_loader.sampler.shard_rank,
                            trainer.train_loader.sampler.num_shards),
            "plan": None if plan is None else dict(
                enabled=plan.enabled, buckets=plan.bucket_names(),
                fingerprint=plan.fingerprint(), synced=plan.synced_leaves,
                bytes=plan.comm.bytes_per_step, dcn_bytes=plan.comm.dcn_bytes_per_step,
                n_buckets=plan.comm.n_buckets),
            "placements": {k: (tuple(type(pl).__name__ for pl in p.placements),
                               tuple(p.device_mesh.mesh_dim_names or ()))
                           for k, p in trainer._params.items() if isinstance(p, DTensor)},
        })
    pg.foreach_reduce = reduce
    return {"runs": runs}


def case_quant_rows(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """A row-parallel quantized product (``quant_linear`` with the world as
    its group): this rank's columns of ``x`` and ``w``, its partial product
    (``<mode>_part``) and the sum over the ranks (``<mode>``)."""
    import torch
    import torch.distributed as tdist

    from determined_tpu_torch.train._quant import quant_linear

    x, w = torch.tensor(inp["x"]), torch.tensor(inp["w"])
    cols = x.shape[1] // dist.size
    lo, hi = dist.rank * cols, (dist.rank + 1) * cols
    out = {}
    with torch.no_grad():
        for mode in ("int8", "fp8"):
            part = quant_linear(x[:, lo:hi], w[:, lo:hi], torch.float32, mode,
                                tdist.group.WORLD)
            whole = part.clone()
            tdist.all_reduce(whole)
            out[mode], out[f"{mode}_part"] = whole.numpy(), part.numpy()
    return out


def case_resize(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """An elastic resize's two sides on ``inp["mesh"]``.  ``save``: train
    to ``steps[0]`` with a checkpoint there, then a fresh Trainer continues
    from it to ``steps[1]``.  ``restore``: a fresh Trainer restores that
    checkpoint (``fit`` to ``steps[0]``: no step), then another continues
    to ``steps[1]``.  Each side's params whole on the chief, the sampler's
    state, and the ``trial.resize`` spans of the restore."""
    from determined_tpu_torch import core, train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.parallel import MeshConfig

    def trainer():
        core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=inp["ckpt_dir"])
        exp = ExperimentConfig.parse(inp["exp_config"]) if inp.get("exp_config") else None
        ctx = train.init(hparams=inp["hparams"], seed=0, device="cpu", core_context=core_ctx,
                         mesh_config=MeshConfig(**inp["mesh"]), exp_config=exp)
        return train.Trainer(_trial_class("lm", inp.get("init_state"))(ctx))

    def whole(t):
        params = t._full_array_state()["params"]
        return {k: _numpy(v) for k, v in params.items()} if dist.is_chief else None

    first, last = inp["steps"]
    tracer = get_tracer()
    tracer.reset()
    tracer.configure(enabled=True)
    tracer.start()
    t = trainer()
    if inp["mode"] == "save":
        sid = t.fit(max_length=first, checkpoint_period=first, report_period=first,
                    checkpoint_policy="all")["latest_checkpoint"]
    else:
        sid = inp["sid"]
        t.fit(max_length=first, latest_checkpoint=sid, report_period=first,
              checkpoint_policy="none")
    out = {"sid": sid, "at_ckpt": whole(t), "loader": t.train_loader.state_dict(),
           "steps": t.steps_completed}
    t2 = trainer()
    t2.fit(max_length=last, latest_checkpoint=sid, report_period=last,
           checkpoint_policy="none")
    tracer.stop()
    out["resize"] = [e.get("args") or {} for e in tracer.chrome_events()
                     if e.get("name") == "trial.resize"]
    tracer.reset()
    out.update(continued=whole(t2), continued_steps=t2.steps_completed)
    return out


def case_pipe_ckpt(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """A pipeline run that checkpoints every 2 steps up to ``steps``, then
    fresh Trainers that resume its checkpoints: ``resumed`` on the same mesh
    from the one before the last, ``restored`` on the same mesh from the
    last (no steps), and each of ``inp["other"]`` meshes from the last;
    each run's gathered state and the last checkpoint's storage id."""
    from determined_tpu_torch import core, train
    from determined_tpu_torch.parallel import MeshConfig

    trial_cls = _trial_class("lm", inp.get("init_state"))
    steps = inp["steps"]

    def run(mesh: Dict[str, int], sid: Any, period: Any) -> Any:
        core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=inp["ckpt_dir"])
        ctx = train.init(hparams=inp["hparams"], seed=0, device="cpu", core_context=core_ctx,
                         mesh_config=MeshConfig(**mesh))
        trainer = train.Trainer(trial_cls(ctx))
        summary = trainer.fit(max_length=steps, latest_checkpoint=sid, checkpoint_period=period,
                              report_period=1, checkpoint_policy="none" if period is None
                              else "all")
        return summary, _gathered(trainer, dist.is_chief), core_ctx

    summary, first, core_ctx = run(inp["mesh"], None, 2)
    last = summary["latest_checkpoint"]
    before = core_ctx.checkpoint.get_checkpoint_parent(last)
    out = {"last": last, "before": before, "first": first,
           "steps": core_ctx.checkpoint.get_metadata(before)["steps_completed"]}
    out["resumed"] = run(inp["mesh"], before, None)[1]
    out["restored"] = run(inp["mesh"], last, None)[1]
    out["other"] = [run(m, last, None)[1] for m in inp["other"]]
    return out


def _gathered(trainer: Any, chief: bool) -> Any:
    """The trainer's whole array state gathered onto the chief, flat:
    ``{part/name: (dtype name, float32 numpy)}`` (None elsewhere)."""
    from determined_tpu_torch.train import serialization

    full = trainer._full_array_state()
    if not chief:
        return None
    full["rng"] = full["rng"].clone()
    out = {}
    for part, node in full.items():
        for name, t in serialization.flatten({part: node}).items():
            out[name] = (str(t.dtype).replace("torch.", ""), t.detach().cpu().float().numpy())
    return out


def case_sharded(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """A sharded checkpoint written on ``inp["mesh"]`` by ``fit(**fit)``
    (or the checkpoint ``inp["sid"]``), then restored in the same processes
    on each of ``inp["restore"]``
    (``(mesh, max_length)``: a fresh Trainer's ``fit`` from the newest
    checkpoint to ``max_length``, no new checkpoint): each run's gathered
    state, reported training rows and span names."""
    from determined_tpu_torch import core, train
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.parallel import MeshConfig

    trial_cls = _trial_class(inp["trial"], inp.get("init_state"))
    tracer = get_tracer()
    runs = []
    # with ``sid`` no checkpoint is written here: the restores take it
    sid = inp.get("sid")
    writes = [] if sid else [(inp["mesh"], inp["fit"])]
    for mesh, fit in writes + [
            (m, dict(max_length=n, latest_checkpoint=None, report_period=1,
                     checkpoint_policy="none")) for m, n in inp["restore"]]:
        tracer.reset()
        if sid is not None:
            fit["latest_checkpoint"] = sid
        core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=inp["ckpt_dir"])
        ctx = train.init(hparams=inp["hparams"], seed=inp.get("seed", 0), device="cpu",
                         core_context=core_ctx, mesh_config=MeshConfig(**mesh))
        trainer = train.Trainer(trial_cls(ctx))
        summary = trainer.fit(**fit)
        sid = sid or summary["latest_checkpoint"]
        runs.append({
            "summary": summary, "state": _gathered(trainer, dist.is_chief),
            "training": ctx.core.train.metrics("training"),
            "spans": sorted({e["name"] for e in tracer.chrome_events() if e["ph"] == "X"}),
        })
    return {"runs": runs}


def case_mesh(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's coordinate on each axis of ``make_mesh``, its batch
    shard, and an all-reduce over each axis's group."""
    import torch
    import torch.distributed as tdist

    from determined_tpu_torch.parallel import MeshConfig, batch_shard, make_mesh

    mesh = make_mesh(MeshConfig(**inp["mesh"]), "cpu")
    sums = {}
    for axis in ("data", "fsdp", "expert"):
        t = torch.tensor([float(dist.rank)])
        tdist.all_reduce(t, group=mesh.group(axis))
        sums[axis] = float(t)
    return {"coords": {a: mesh.coordinate(a) for a in mesh.shape if a != "dcn"},
            "batch_shard": batch_shard(mesh), "sums": sums, "size": mesh.size}


def case_collectives(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """The star's collectives and the process group beside it."""
    import torch
    import torch.distributed as tdist

    t = torch.tensor([dist.rank + 1.0])
    tdist.all_reduce(t)
    return {
        "rank": dist.get_rank(), "size": dist.get_size(), "chief": dist.is_chief,
        "local_chief": dist.is_local_chief, "backend": dist.backend,
        "allgather": dist.allgather(f"r{dist.rank}"),
        "gather": dist.gather(dist.rank * 10),
        "broadcast": dist.broadcast("payload" if dist.is_chief else None),
        "allgather_local": dist.allgather_local(dist.local_rank),
        "all_reduce": float(t),
        "preempt": _preempt_vote(dist),
    }


def _preempt_vote(dist: Any) -> bool:
    """The last rank alone is asked to stop: every rank must stop."""
    from determined_tpu_torch.core import PreemptContext

    ctx = PreemptContext(dist).start()
    if dist.rank == dist.size - 1:
        ctx.simulate()
    return ctx.should_preempt()


def _local_part(x: Any, mesh: Any, heads: bool) -> Any:
    """This rank's part of a global [b, h, s, ...] array: the batch over
    ``data``, the heads over ``tensor`` (when ``heads``), the sequence over
    ``seq``; a leaf that requires grad."""
    import torch

    t = torch.tensor(x)
    for axis, dim, on in (("data", 0, True), ("tensor", 1, heads), ("seq", 2, True)):
        if on:
            t = t.chunk(mesh.shape[axis], dim)[mesh.coordinate(axis)]
    return t.contiguous().requires_grad_(True)


def case_ring(dist: Any, inp: Dict[str, Any]) -> Dict[str, Any]:
    """Each of ``inp["cases"]``: ``ring_attention`` on this rank's parts of
    the global q, k, v on the case's mesh, the gradients of sum(out²), and
    with ``counts`` the ring's per-rank units; then the vocab-parallel
    cross-entropy of ``inp["ce"]`` on a tensor group against the whole one
    on the same rank."""
    from determined_tpu_torch.ops.ring_attention import ring_attention, ring_block_counts
    from determined_tpu_torch.parallel import MeshConfig, make_mesh

    meshes: Dict[Any, Any] = {}
    out: Dict[str, Any] = {}
    for name, c in inp["cases"].items():
        key = tuple(sorted(c["mesh"].items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**c["mesh"]), "cpu")
        mesh = meshes[key]
        t = mesh.shape["tensor"]
        kv_split = t > 1 and c["k"].shape[1] % t == 0
        q = _local_part(c["q"], mesh, True)
        k, v = (_local_part(c[n], mesh, kv_split) for n in ("k", "v"))
        o = ring_attention(q, k, v, mesh, causal=c["causal"], assignment=c["assignment"])
        (o ** 2).sum().backward()
        res = {"coords": {a: mesh.coordinate(a) for a in ("data", "tensor", "seq")},
               "out": _numpy(o), "dq": _numpy(q.grad), "dk": _numpy(k.grad),
               "dv": _numpy(v.grad)}
        if c.get("counts"):
            _, res["counts"] = ring_block_counts(q.detach(), k.detach(), v.detach(),
                                                 mesh.group("seq"), causal=c["causal"],
                                                 assignment=c["assignment"])
        out[name] = res
    out["ce"] = _vocab_parallel_ce(inp["ce"])
    return out


def _vocab_parallel_ce(inp: Dict[str, Any]) -> Dict[str, Any]:
    """fused_cross_entropy over this rank's vocabulary columns of a tensor
    group of 2 (its hidden gradient summed by ``copy_to``, as the LM's head
    does) and vocab_parallel_cross_entropy from its logits, each against
    the whole-vocabulary loss on the same rank: the loss, the hidden's
    gradient and this rank's columns of the kernel's gradient."""
    import torch

    from determined_tpu_torch.ops.cross_entropy import (
        fused_cross_entropy,
        naive_cross_entropy,
        vocab_parallel_cross_entropy,
    )
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.parallel.tensor_parallel import copy_to

    mesh = make_mesh(MeshConfig(data=2, tensor=2), "cpu")
    group, idx = mesh.group("tensor"), mesh.coordinate("tensor")
    hidden, kernel, tgt = (torch.tensor(inp[n]) for n in ("hidden", "kernel", "targets"))
    cols = kernel.shape[1] // 2
    lo = idx * cols
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    modes = {"chunked": dict(chunk_size=8, compute_dtype=f32),
             "tile": dict(chunk_size=0, compute_dtype=f32),
             "bf16_residual": dict(chunk_size=0, bf16_residual=True, compute_dtype=bf16),
             "logits": None}
    for mode, kw in modes.items():
        runs = []
        for sharded in (False, True):
            x = hidden.clone().requires_grad_(True)
            w = (kernel[:, lo:lo + cols] if sharded else kernel).clone().requires_grad_(True)
            xin = copy_to(x, group) if sharded else x
            if kw is None:
                loss = (vocab_parallel_cross_entropy(xin @ w, tgt, group, lo) if sharded
                        else naive_cross_entropy(xin, w, tgt))
            else:
                loss = fused_cross_entropy(xin, w, tgt, group=group if sharded else None,
                                           vocab_start=lo if sharded else 0, **kw)
            loss.backward()
            wg = w.grad if sharded else w.grad[:, lo:lo + cols]
            runs.append((float(loss), _numpy(x.grad), _numpy(wg)))
        (la, xa, wa), (lb, xb, wb) = runs
        errs[mode] = {"loss": (la, lb), "dx": float(abs(xa - xb).max()),
                      "dw": float(abs(wa - wb).max()), "dx_scale": float(abs(xa).max()),
                      "dw_scale": float(abs(wa).max())}
    return errs


CASES = {"moe_ep": case_moe_ep, "moe_layers": case_moe_layers, "moe_plan": case_moe_plan,
         "train": case_train, "sharded": case_sharded, "mesh": case_mesh,
         "collectives": case_collectives, "ring": case_ring, "train_runs": case_train_runs,
         "pipe_ckpt": case_pipe_ckpt, "sync_runs": case_sync_runs, "resize": case_resize,
         "quant_rows": case_quant_rows}


def main(case: str, rank: int, world: int, workdir: str) -> None:
    import torch

    from determined_tpu_torch.core import DistributedContext

    torch.set_num_threads(2)
    with open(os.path.join(workdir, "input.pkl"), "rb") as f:
        inp = pickle.load(f)
    dist = DistributedContext.from_torch(
        device="cpu", init_method=f"file://{os.path.join(workdir, 'store')}", timeout=90.0
    )
    try:
        result = CASES[case](dist, inp)
    finally:
        dist.close()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "--zygote":
        _serve()
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
