"""The port's overlapped gradient sync (determined_tpu_torch/train/_overlap.py,
the Trainer's plan and FSDP2 units) against the JAX package's, on the CPU.

- ``build_plan``: for the same leaves (tests/test_step_optimizations.py's
  toy tree on data 2 x fsdp 4, and the LM's leaves on data 2, fsdp 2 and
  data 2 x fsdp 2 at 1 and 4 MiB buckets) the port's buckets, their order,
  the synced leaves and each hop's bytes equal JAX's; off, one bucket.
- ``CommModel``'s ``split_hops``/``split``/``total_bytes_per_step`` equal
  JAX's on the same inputs, and ``DTPU_COMM_BW_GBPS`` parses (and refuses)
  as JAX's does.
- ``LMTrial`` on data 2 over 2 gloo ranks (tests/torch_rank_worker.py, one
  launch) with ``overlap_grad_sync`` tracks the JAX Trainer at the same
  mesh and knobs for 4 steps from the same weights and batches: losses
  within 1e-5, params within 1e-5, the Trainer's plan equal to JAX's and
  each bucket's blocks one FSDP2 unit; with the knob off it tracks the
  same JAX run (the step is the same).  Under ``aggregation_frequency`` 2
  it trains as aggregation without overlap does (tests/test_step_optimizations.py's
  agg test), and reduces each unit once an optimizer step (as many unit
  reductions as without aggregation); with ``quantized_matmul: int8`` too
  it trains finite.
- The ``step.comm`` counters reach the goodput ledger as JAX's do, under
  JAX's names; they count what FSDP2 runs (``_overlap.fsdp_comm``): the
  ring bytes of the collectives each step issues, part hidden with the
  knob on or off.
- Overlap beside the pipe axis passes the configuration check
  (tests/test_torch_pipe_axes.py trains it).
"""

import functools

import jax
import numpy as np
import pytest

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.observability import get_tracer as jax_tracer
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu.parallel.mesh import make_mesh as jax_make_mesh
from determined_tpu.parallel.sharding import param_shardings as jax_param_shardings
from determined_tpu.train import _overlap as jax_overlap
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import state_dict_from_flax
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.observability import compute_ledger
from determined_tpu_torch.train import _overlap
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

# the LM's leaves reach 64 KiB (the sync floor) and several 1 MiB buckets
HP = dict(lr=1e-3, global_batch_size=16, seq_len=32, vocab_size=256, d_model=128, n_layers=2,
          n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1)
STEPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _jax_leaves(tree, mesh):
    """(name, shape, spec) of a JAX tree's leaves under its param
    shardings, in its flatten order, with the names the port gives them."""
    shardings = jax_param_shardings({k: None for k in tree}, mesh)
    return [(k, tuple(tree[k].shape), tuple(shardings[k].spec)) for k in sorted(tree)]


def _same_plan(got, want):
    assert got.enabled == want.enabled
    assert got.buckets == want.buckets
    assert got.synced_leaves == want.synced_leaves
    assert got.hierarchical_dcn == want.hierarchical_dcn
    assert got.fingerprint() == want.fingerprint()
    assert got.comm == _overlap.CommModel(**{
        f: getattr(want.comm, f) for f in
        ("bytes_per_step", "n_buckets", "bandwidth", "bwd_frac", "dcn_bytes_per_step",
         "dcn_bandwidth")})
    specs = [None if s is None else tuple(s.spec) for s in want.sync_shardings]
    assert [None if s is None else tuple(s) for s in got.sync_specs] == specs


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_plan_of_the_toy_tree_equals_jax(enabled):
    """tests/test_step_optimizations.py::test_overlap_defaults_off_and_plan_accounting's
    tree: one big leaf a bucket, the small one riding the final reduction."""
    mesh = jax_make_mesh(JaxMeshConfig(data=2, fsdp=4))
    tree = {k: jax.ShapeDtypeStruct((256, 64), np.float32) for k in "abc"}
    tree["small"] = jax.ShapeDtypeStruct((8,), np.float32)
    kw = dict(enabled=enabled, bucket_bytes=256 * 64 * 4, min_sync_bytes=1024)
    want = jax_overlap.build_plan(tree, jax_param_shardings({k: None for k in tree}, mesh),
                                  mesh, **kw)
    got = _overlap.build_plan(_jax_leaves(tree, mesh), dict(mesh.shape), **kw)
    _same_plan(got, want)
    assert (got.synced_leaves, len(got.buckets)) == ((3, 3) if enabled else (0, 0))
    assert got.comm.n_buckets == (3 if enabled else 1)


@pytest.mark.parametrize("mesh", [dict(data=2), dict(fsdp=2), dict(data=2, fsdp=2)],
                         ids=["data2", "fsdp2", "data2-fsdp2"])
@pytest.mark.parametrize("bucket_mb", [1, 4])
def test_the_lm_plan_equals_the_jax_trainers(mesh, bucket_mb):
    """The Trainer's plan for the LM (its leaves in the JAX flatten order;
    the JAX LM's params carry no batch axis) is JAX's: the same leaves
    synced and bucketed in the same order, the same bytes.  JAX's plan is
    built over the JAX Trainer's param tree (replicated, as its Trainer
    places the LM's params on these meshes: at data 2 and 1 MiB it is the
    Trainer's own plan)."""
    from jax.sharding import NamedSharding, PartitionSpec

    _, params, _, trainer_plan, _ = jax_run((("data", 2),), tuple(ON.items()))
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh), jax.devices()[:int(np.prod(list(mesh.values())))])
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32), params)
    want = jax_overlap.build_plan(
        abstract, jax.tree.map(lambda _: NamedSharding(jmesh, PartitionSpec()), abstract),
        jmesh, enabled=True, bucket_bytes=bucket_mb << 20)
    if mesh == dict(data=2) and bucket_mb == ON["overlap_bucket_mb"]:
        assert want.buckets == trainer_plan.buckets
        assert want.comm == trainer_plan.comm
    ctx = train.init(hparams=dict(HP), seed=0, device="cpu")
    model = LMTrial(ctx).build_model()
    from determined_tpu_torch.parallel import MeshConfig

    leaves = _overlap.model_leaves(model)
    flat = jax.tree_util.tree_leaves_with_path(abstract)
    # the same leaves, in the same order, with the same byte counts
    assert len(flat) == len(leaves)
    for (path, leaf), (name, shape, _) in zip(flat, leaves):
        assert int(np.prod(leaf.shape)) == int(np.prod(shape)), (path, name)
    got = _overlap.build_plan(leaves, MeshConfig(**mesh).shape, enabled=True,
                              bucket_bytes=bucket_mb << 20)
    assert got.buckets == want.buckets
    assert got.synced_leaves == want.synced_leaves
    assert got.comm.bytes_per_step == want.comm.bytes_per_step
    assert got.comm.n_buckets == want.comm.n_buckets
    # (the port's attention leaves are 2-D where JAX's are 3-D: the same
    # leaves are synced)
    assert [s is None for s in got.sync_specs] == [s is None for s in want.sync_shardings]
    if mesh == dict(data=2) and bucket_mb == 1:
        assert len(got.buckets) >= 3  # several units to overlap


def test_comm_model_equals_jax():
    kw = dict(bytes_per_step=int(80e9), n_buckets=4, bandwidth=100e9, bwd_frac=0.5,
              dcn_bytes_per_step=int(10e9), dcn_bandwidth=10e9)
    got, want = _overlap.CommModel(**kw), jax_overlap.CommModel(**kw)
    for step in (0.0, 0.3, 1.0, 7.5):
        assert got.split_hops(step) == want.split_hops(step)
        assert got.split(step) == want.split(step)
    assert got.total_bytes_per_step == want.total_bytes_per_step
    one = dict(kw, n_buckets=1)
    assert _overlap.CommModel(**one).split_hops(1.0) == jax_overlap.CommModel(**one).split_hops(1.0)


@pytest.mark.parametrize("raw", ["ici:90,dcn:12", "42", " 7.5 ", "dcn:3", "ici:90 , dcn:12"])
def test_bandwidth_env_parses_as_jax(monkeypatch, raw):
    monkeypatch.setenv("DTPU_COMM_BW_GBPS", raw)
    assert _overlap._parse_bw_env(raw) == jax_overlap._parse_bw_env(raw)
    assert _overlap.link_bandwidths("cpu") == jax_overlap.link_bandwidths("cpu")


@pytest.mark.parametrize("raw", ["ici:bogus", "ici:90,ici:80", "wan:5", "ici:-1", "0", "x",
                                 ","])
def test_bad_bandwidth_env_raises_as_jax(monkeypatch, raw):
    with pytest.raises(ValueError) as want:
        jax_overlap._parse_bw_env(raw)
    with pytest.raises(ValueError) as got:
        _overlap._parse_bw_env(raw)
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("DTPU_COMM_BW_GBPS", raw)
    with pytest.raises(ValueError):
        _overlap.link_bandwidths("NVIDIA H100 80GB HBM3")


def test_empty_bandwidth_env_is_unset_and_the_table_is_the_cards(monkeypatch):
    monkeypatch.setenv("DTPU_COMM_BW_GBPS", "")
    for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
        ici, dcn = _overlap.link_bandwidths(kind)
        assert ici == _overlap._table_bw(kind, _overlap.ICI_BW_BY_KIND, _overlap._DEFAULT_BW)
        assert dcn == _overlap._DEFAULT_DCN_BW
    # no TPU figure in the port's tables
    assert not any(k.startswith("TPU") for k in (*_overlap.ICI_BW_BY_KIND,
                                                  *_overlap.DCN_BW_BY_KIND))


def test_overlap_beside_pipe_raises_naming_a_later_slice():
    # ported: the configuration passes, and without a process group the
    # mesh of 2 devices is refused for its size
    from determined_tpu_torch.train._trainer import check_exp_config

    cfg = ExperimentConfig.parse({"hyperparameters": dict(HP, pipe_microbatches=2),
                                  "resources": {"mesh": {"pipe": 2}},
                                  "optimizations": {"overlap_grad_sync": True}})
    check_exp_config(cfg)
    with pytest.raises(ValueError, match="needs 2 devices"):
        train.init(exp_config=cfg, device="cpu")


# ---------------------------------------------------------------------------
# through the Trainer on 2 gloo ranks against the JAX Trainer
# ---------------------------------------------------------------------------

ON = {"overlap_grad_sync": True, "overlap_bucket_mb": 1}
AGG2 = dict(ON, aggregation_frequency=2)
# name: (mesh, the port's optimizations, the JAX Trainer run it is held
# against: the same knobs, or for the knob off the run with it on, which
# computes the same step; its initial weights are every run's)
RUNS = {
    "data2": (dict(data=2), {}, ON),
    "data2-overlap": (dict(data=2), ON, ON),
}
# the port only, from the same weights: aggregation 2 with and without
# overlap (held against each other, as tests/test_step_optimizations.py
# holds JAX's), and int8 matmuls beside both knobs
PORT_ONLY = {
    "data2-agg2": (dict(data=2), {"aggregation_frequency": 2}, ON),
    "data2-overlap-agg2": (dict(data=2), AGG2, ON),
    "data2-overlap-agg2-int8": (dict(data=2), dict(AGG2, quantized_matmul="int8"), ON),
}


@functools.lru_cache(maxsize=None)
def jax_run(mesh_items, opt_items, hp_items=tuple(HP.items()), steps=STEPS):
    """The JAX Trainer's fit for ``steps`` steps at the mesh and knobs:
    each step's rows, the initial and final params, its plan and the
    ``step.comm`` counters its tracer saw (summed by name)."""
    from flax.core import meta as flax_meta

    mesh, opt = dict(mesh_items), dict(opt_items)
    n = int(np.prod(list(mesh.values())))
    ctx = jax_train.init(hparams=dict(hp_items), mesh_config=JaxMeshConfig(**mesh),
                         core_context=jax_core._dummy_init(), seed=0,
                         exp_config=JaxExperimentConfig.parse({"optimizations": opt}),
                         devices=jax.devices()[:n])
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
    captured = {}
    setup = trainer._setup

    def capture_setup():
        setup()
        captured["init"] = jax.device_get(flax_meta.unbox(trainer.state.params))

    trainer._setup = capture_setup
    rows = []
    report = ctx.core.train.report_training_metrics
    ctx.core.train.report_training_metrics = lambda s, m: (rows.append(dict(m)), report(s, m))
    tracer = jax_tracer()
    tracer.reset()
    tracer.configure(enabled=True)
    tracer.start()
    try:
        with tracer.span("trial.run", cat="trial", trial="jax"):
            trainer.fit(steps, report_period=1, checkpoint_policy="none")
    finally:
        tracer.stop()
    counters = {}
    for e in tracer.chrome_events():
        if e.get("ph") == "C" and e["name"].startswith("step.comm"):
            counters[e["name"]] = counters.get(e["name"], 0.0) + e["args"]["value"]
    tracer.reset()
    tracer.configure(enabled=False)  # as a fresh process has it
    return (rows, captured["init"], jax.device_get(flax_meta.unbox(trainer.state.params)),
            trainer._overlap_plan, counters)


def run_cases(tmp_path, runs, world, hp=HP):
    """Each run through the port's Trainer on ``world`` gloo ranks in one
    launch (``case_sync_runs``), from the JAX Trainer's initial weights."""
    cases = []
    for name, (mesh, opt, jax_opt) in runs.items():
        _, init, _, _, _ = jax_run(tuple(mesh.items()), tuple(jax_opt.items()))
        cases.append(dict(name=name, trial="lm", hparams=dict(hp), mesh=mesh, seed=0,
                          init_state=state_dict_from_flax(init),
                          exp_config={"optimizations": opt},
                          fit=dict(max_length=STEPS, report_period=1,
                                   checkpoint_policy="none")))
    outs = launch("sync_runs", world, str(tmp_path / "runs"),
                  dict(cases=cases, ckpt_dir=str(tmp_path / "ck")), timeout=240.0)
    return {r["name"]: dict(r, every_rank=[o["runs"][i] for o in outs])
            for i, r in enumerate(outs[0]["runs"])}


def check_tracks_jax(out, mesh, opt, jax_opt):
    """A port run's losses and final params against the JAX Trainer's run
    at the same mesh with ``jax_opt``, within 1e-5, and the same bytes in
    the plan and the ledger's counters; with the same knobs, its plan's
    buckets and fingerprint equal to JAX's."""
    rows, _, final, plan, counters = jax_run(tuple(mesh.items()), tuple(jax_opt.items()))
    got = out["training"]
    assert [s for s, _ in got] == list(range(1, STEPS + 1))
    for (step, g), w in zip(got, rows):
        for k in ("loss", "lr"):
            np.testing.assert_allclose(g[k], float(w[k]), err_msg=f"step {step} {k}", **TOL)
    want = state_dict_from_flax(final)
    assert set(out["params"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(out["params"][k], w, err_msg=k, **TOL)
    if opt == jax_opt:
        assert out["plan"]["buckets"] == [[_overlap.leaf_order(list(want))[i] for i in b]
                                          for b in plan.buckets]
        assert out["plan"]["fingerprint"] == plan.fingerprint()
    assert out["plan"]["bytes"] == plan.comm.bytes_per_step
    assert out["plan"]["dcn_bytes"] == plan.comm.dcn_bytes_per_step
    # the counters reach the ledger under JAX's names, counting what FSDP2
    # issues: the comm model's bytes a hop are the ring bytes of the
    # all-gathers, reduce-scatters and all-reduces of every step, bar the
    # norm's scalars (at most 1 KiB a step)
    assert {k for k in out["counters"] if k.startswith("step.comm")} <= set(counters)
    model = out["comm_model"]
    assert out["counters"]["step.comm.bytes"] == (model["ici"] + model["dcn"]) * STEPS
    for hop in ("ici", "dcn"):
        assert out["counters"].get(f"step.comm.{hop}.bytes", 0.0) == model[hop] * STEPS
        issued = out["issued_ring_bytes"][hop] / STEPS
        assert model[hop] <= issued <= model[hop] + 1024, (hop, model, issued)
    return plan


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("overlap"), {**RUNS, **PORT_ONLY}, 2)


@pytest.mark.parametrize("name", list(RUNS))
def test_lm_on_data2_tracks_the_jax_trainer(runs, name):
    mesh, opt, jax_opt = RUNS[name]
    plan = check_tracks_jax(runs[name], mesh, opt, jax_opt)
    assert plan.enabled and len(plan.buckets) >= 3
    assert runs[name]["plan"]["enabled"] == bool(opt.get("overlap_grad_sync"))


def test_each_bucket_is_one_fsdp2_unit(runs):
    """With the knob on, FSDP2 reduces once a step for each bucket's unit
    (the blocks it reaches), once for each other block and once for the
    root; off, once a block and the root."""
    n_blocks = HP["n_layers"]
    off, on = runs["data2"], runs["data2-overlap"]
    units = on["units"]
    assert units and sorted(b for u in units for b in u) == [f"blocks.{i}"
                                                             for i in range(n_blocks)]
    # each unit is the first bucket's reach: the last block first
    assert units[0][0] == f"blocks.{n_blocks - 1}"
    assert off["units"] == []
    assert off["reductions"] == STEPS * (n_blocks + 1)
    assert on["reductions"] == STEPS * (len(units) + 1)
    for r in on["every_rank"]:
        assert r["reductions"] == on["reductions"] and r["units"] == units


def test_aggregation_syncs_once_an_optimizer_step(runs):
    """agg 2 with overlap: the microbatches before the last issue no
    reduction, so a step reduces each unit once, as without aggregation,
    and it trains as agg 2 without overlap (losses and params within
    1e-5)."""
    over, base = runs["data2-overlap-agg2"], runs["data2-agg2"]
    assert over["reductions"] == runs["data2-overlap"]["reductions"]
    assert base["reductions"] == runs["data2"]["reductions"]
    np.testing.assert_allclose([m["loss"] for _, m in over["training"]],
                               [m["loss"] for _, m in base["training"]], **TOL)
    for k, v in base["params"].items():
        np.testing.assert_allclose(over["params"][k], v, err_msg=k, **TOL)
    assert runs["data2-overlap-agg2-int8"]["reductions"] == runs["data2-overlap"]["reductions"]


def test_int8_matmuls_compose_with_overlap_and_aggregation(runs):
    out = runs["data2-overlap-agg2-int8"]
    assert out["plan"]["enabled"] and len(out["plan"]["buckets"]) >= 3
    losses = [m["loss"] for _, m in out["training"]]
    assert len(losses) == STEPS and all(np.isfinite(losses))


def test_comm_counters_reach_the_goodput_ledger_as_jaxs(runs):
    """The counters fold into the ledger's step.comm row as JAX's; one hop
    on a single slice.  They count FSDP2's units, which reduce-scatter as
    the backward goes with the knob on or off: part is hidden either way
    (JAX's Trainer, which all-reduces once at the end with the knob off,
    exposes it all)."""
    for name in ("data2", "data2-overlap"):
        out = runs[name]
        assert out["comm_model"]["n_buckets"] == len(out["units"] or range(HP["n_layers"])) + 1
        c = out["counters"]
        assert c["step.comm.bytes"] == c["step.comm.ici.bytes"] > 0
        assert "step.comm.dcn.bytes" not in c
        ev = [{"ph": "X", "name": "trial.run", "cat": "trial", "ts": 0, "dur": 1e7,
               "pid": 1, "tid": 1, "args": {"trial": "t"}}]
        ev += [{"ph": "C", "name": k, "ts": 10, "pid": 1, "tid": 1, "args": {"value": v}}
               for k, v in c.items() if k.startswith("step.comm")]
        comm = compute_ledger(ev)["trials"]["t"]["step.comm"]
        assert comm["bytes"] == int(c["step.comm.bytes"])
        assert comm["exposed_s"] > 0.0 and comm["hidden_s"] > 0.0
