"""The port's pipeline schedules (determined_tpu_torch/parallel/pipeline.py)
against the JAX package's, on the CPU.

- The tick model: for gpipe, 1f1b and interleaved over P in {1, 2, 4}, M in
  1..8 and V in {1, 2, 3}, ``PipelineSchedule`` equals JAX's, its error
  texts included, and the port's tick tables run each rank's units in
  ``total_ticks`` ticks, at most one a tick.
- The executor on a ``VirtualPipe`` against JAX ``pipeline_apply`` on a
  pipe 4 x data 2 mesh, four transformer blocks of width 64 as stages
  (interleaved: pipe 2 x V 2), each schedule at M in {2, 4, 8}, with an
  aux output: outputs and aux within 1e-5, and the gradients of sum(out *
  ct) + 0.3 aux with respect to every block and the input within 1e-5 of
  each one's largest magnitude.
- 1f1b holds at most P stage inputs for the backward; gpipe all M.
- The refusals: a batch that M does not divide raises JAX's text; pipe x
  seq x expert with MoE and pipe x tensor raise naming a later slice.
- The Trainer on a virtual pipe of 2 reports ``step.bubble.exposed_us``
  equal to ``BubbleModel.split`` times the steps, and the schedule's
  gauges.
- Through the Trainer on 2 gloo ranks (tests/torch_rank_worker.py): 1f1b
  at pipe 2, interleaved at pipe 2 x V 2 and gradient aggregation 2 at
  pipe 2 against the JAX Trainer at the same mesh for 8 steps with the
  clip engaged: losses within 1e-5 (f32), the updated params within the
  training parity tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_PARITY_TOL
from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.config.experiment import InvalidExperimentConfig as JaxInvalid
from determined_tpu.models.transformer import Block as JaxBlock
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.models.transformer import TransformerConfig as JaxConfig
from determined_tpu.parallel import pipeline as jax_pipeline
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu.parallel.mesh import make_mesh as jax_make_mesh
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.config.experiment import InvalidExperimentConfig
from determined_tpu_torch.convert import state_dict_from_flax, state_dict_from_split
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.transformer import Block, TransformerConfig
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.parallel import MeshConfig
from determined_tpu_torch.parallel.pipeline import (
    BubbleModel,
    PipelineSchedule,
    VirtualPipe,
    _path_has_expert_leaf,
    pipeline_apply,
    stack_chunk_params,
    stack_stage_params,
    tick_table,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

# ---------------------------------------------------------------------------
# the tick model
# ---------------------------------------------------------------------------


def _facts(make):
    """The schedule's tick model, or its error's type and text."""
    try:
        s = make()
    except (InvalidExperimentConfig, JaxInvalid) as e:
        return ("error", str(e))
    return (s.total_ticks, s.work_ticks, s.bubble_ticks, s.bubble_fraction,
            s.live_activation_microbatches, s.fingerprint())


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("v", [1, 2, 3])
def test_tick_model_matches_jax(name, p, v):
    for m in range(1, 9):
        kw = dict(name=name, n_stages=p, num_microbatches=m, virtual_stages=v)
        got = _facts(lambda: PipelineSchedule(**kw))
        want = _facts(lambda: jax_pipeline.PipelineSchedule(**kw))
        assert got == want, kw
        if got[0] == "error":
            continue
        sched = PipelineSchedule(**kw)
        bm, jbm = BubbleModel(sched), jax_pipeline.BubbleModel(jax_pipeline.PipelineSchedule(**kw))
        assert bm.split(1.7) == jbm.split(1.7) and bm.MODEL == jbm.MODEL
        if p == 1:
            continue
        # 1f1b's combined grid is its whole tick model; the others' forward
        # drain is, and their backward is its reverse
        table = tick_table(sched, train=name == "1f1b")
        assert len(table) == sched.total_ticks, kw
        for rank in range(p):
            units = [row[rank] for row in table if row[rank] is not None]
            assert len(units) == sched.work_ticks, (kw, rank)
        full = tick_table(sched, train=True)
        for rank in range(p):
            done = {u for row in full for u in [row[rank]] if u is not None}
            assert len(done) == 2 * m * v, (kw, rank)


def test_stacking_and_expert_paths_match_jax():
    """``stack_stage_params``/``stack_chunk_params`` over flat dicts give
    JAX's leading-P and [P, V] layouts, and expert leaves are named alike."""
    rng = np.random.default_rng(7)
    chunks = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
               "b": rng.standard_normal(2).astype(np.float32)} for _ in range(6)]
    port = [{k: torch.tensor(v) for k, v in c.items()} for c in chunks]
    for got, want in ((stack_stage_params(port), jax_pipeline.stack_stage_params(chunks)),
                      (stack_chunk_params(port, 3), jax_pipeline.stack_chunk_params(chunks, 3))):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(InvalidExperimentConfig, match="do not divide over 4 stages"):
        stack_chunk_params(port, 4)
    tree = {"blocks": {"layer_0": {"moe": {"w_in": 0, "router": 0}, "mlp": {"w_in": 0}}}}
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
        dotted = ".".join(str(p.key) for p in path)
        assert _path_has_expert_leaf(dotted) == jax_pipeline._path_has_expert_leaf(path), dotted


# ---------------------------------------------------------------------------
# the executor against JAX pipeline_apply
# ---------------------------------------------------------------------------

D, SEQ, BATCH, CHUNKS = 64, 8, 8, 4
AUX_W = 0.3


def _jax_block():
    cfg = JaxConfig(vocab_size=64, d_model=D, n_layers=CHUNKS, n_heads=4, max_seq_len=SEQ,
                    dtype=jnp.float32, attention_impl="reference", partition_params=False)
    return JaxBlock(cfg)


@functools.lru_cache(maxsize=None)
def _block_weights():
    from flax.core import meta as flax_meta

    block = _jax_block()
    x = jnp.zeros((BATCH, SEQ, D), jnp.float32)
    params = [jax.device_get(flax_meta.unbox(block.init(jax.random.key(i), x)))
              for i in range(CHUNKS)]
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((BATCH, SEQ, D)).astype(np.float32)
    ct = rng.standard_normal((BATCH, SEQ, D)).astype(np.float32)
    return params, xs, ct


def _jax_run(schedule, v, m):
    """JAX pipeline_apply's out, aux and the gradients of sum(out * ct) +
    AUX_W * aux w.r.t. each chunk's params and x."""
    params, xs, ct = _block_weights()
    block = _jax_block()
    n = CHUNKS // v
    mesh = jax_make_mesh(JaxMeshConfig(pipe=n, data=8 // n), jax.devices()[:8])
    stacked = (jax_pipeline.stack_chunk_params(params, n) if v > 1
               else jax_pipeline.stack_stage_params(params))

    def stage_fn(p, h):
        y, _ = block.apply({"params": p["params"]}, h)
        return y, jnp.mean(y ** 2)

    def f(p, x):
        return jax_pipeline.pipeline_apply(stage_fn, p, x, mesh, m, with_aux=True,
                                           schedule=schedule, virtual_stages=v)

    def loss(p, x):
        out, aux = f(p, x)
        return jnp.sum(out * ct) + AUX_W * aux

    with mesh:
        out, aux = jax.jit(f)(stacked, jnp.asarray(xs))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(xs))
    gp = jax.device_get(gp)
    grads = []
    for c in range(CHUNKS):
        pos = (c % n, c // n) if v > 1 else (c,)
        grads.append(jax.tree.map(lambda a: np.asarray(a[pos]), gp))
    return np.asarray(out), float(aux), grads, np.asarray(gx)


def _port_blocks():
    params, _, _ = _block_weights()
    cfg = TransformerConfig(vocab_size=64, d_model=D, n_layers=CHUNKS, n_heads=4,
                            max_seq_len=SEQ, dtype=torch.float32, attention_impl="reference")
    blocks = []
    for p in params:
        state = state_dict_from_flax({"embed": {"embedding": np.zeros((64, D))},
                                      "ln_f": {"scale": np.ones(D)},
                                      "lm_head": {"kernel": np.zeros((D, 64))},
                                      "block_0": p["params"]})
        blk = Block(cfg, torch.device("cpu"))
        blk.load_state_dict({k[len("blocks.0."):]: torch.tensor(v) for k, v in state.items()
                             if k.startswith("blocks.0.")})
        blocks.append(blk)
    return blocks


def _stage_fn(blk, h):
    y, _ = blk(h)
    return y, (y ** 2).mean()


def _port_run(schedule, v, m, stats=None):
    _, xs, ct = _block_weights()
    blocks = _port_blocks()
    n = CHUNKS // v
    pipe = VirtualPipe(n)
    x = torch.tensor(xs)
    with torch.no_grad():
        out, aux = pipeline_apply(_stage_fn, blocks, x, pipe, m, with_aux=True,
                                  schedule=schedule, virtual_stages=v)
    x = x.clone().requires_grad_(True)
    cts = torch.tensor(ct).reshape(m, BATCH // m, SEQ, D)
    loss, aux2 = pipeline_apply(_stage_fn, blocks, x, pipe, m, with_aux=True,
                                schedule=schedule, virtual_stages=v,
                                loss_fn=lambda y, k: (y * cts[k]).sum(), aux_weight=AUX_W,
                                stats=stats)
    # the training grid sums the units' aux in its own order
    np.testing.assert_allclose(float(aux2), float(aux), rtol=1e-6)
    grads = [{k: p.grad.numpy() for k, p in b.named_parameters()} for b in blocks]
    return out.numpy(), float(aux), float(loss) + AUX_W * float(aux), grads, x.grad.numpy()


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1), ("interleaved", 2)])
def test_executor_on_a_virtual_pipe_matches_jax_pipeline_apply(schedule, v, m):
    want_out, want_aux, want_grads, want_gx = _jax_run(schedule, v, m)
    out, aux, loss, grads, gx = _port_run(schedule, v, m)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, want_out, **tol)
    np.testing.assert_allclose(aux, want_aux, **tol)
    np.testing.assert_allclose(loss, float((want_out * _block_weights()[2]).sum())
                               + AUX_W * want_aux, rtol=1e-5)
    # gradients: 1e-5 of each one's largest magnitude (f32 sums of 4096
    # products in another order)
    np.testing.assert_allclose(gx, want_gx, rtol=1e-5, atol=1e-5 * np.abs(want_gx).max())
    for c in range(CHUNKS):
        state = state_dict_from_flax({"embed": {"embedding": np.zeros((64, D))},
                                      "ln_f": {"scale": np.ones(D)},
                                      "lm_head": {"kernel": np.zeros((D, 64))},
                                      "block_0": want_grads[c]["params"]})
        for k, g in grads[c].items():
            want = state[f"blocks.0.{k}"]
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"chunk {c} {k}")


@pytest.mark.parametrize("m", [2, 4, 8])
def test_1f1b_holds_at_most_p_stage_inputs_and_gpipe_all_m(m):
    # (JAX test_pipeline_schedules.py:213 reads the same from the HLO)
    live = {}
    for schedule in ("gpipe", "1f1b"):
        stats = {}
        _port_run(schedule, 1, m, stats)
        live[schedule] = stats["live"]
        want = jax_pipeline.PipelineSchedule(schedule, CHUNKS, m).live_activation_microbatches
        if schedule == "1f1b":
            assert max(stats["live"]) <= want <= CHUNKS
    # rank p holds P - p in flight under 1f1b, every microbatch under gpipe
    assert live["1f1b"] == [min(CHUNKS - p, m) for p in range(CHUNKS)]
    assert live["gpipe"] == [m] * CHUNKS


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_a_batch_the_microbatches_do_not_divide_raises_the_jax_text(devices8):
    mesh = jax_make_mesh(JaxMeshConfig(pipe=4, data=2), devices8)
    stacked = jax_pipeline.stack_stage_params(
        [{"w": jnp.ones((8, 8))} for _ in range(4)])
    with pytest.raises(JaxInvalid) as want:
        jax_pipeline.pipeline_apply(lambda p, h: h @ p["w"], stacked, jnp.ones((6, 8)), mesh, 4)
    with pytest.raises(InvalidExperimentConfig) as got:
        pipeline_apply(lambda w, h: h @ w, [torch.ones(8, 8)] * 4, torch.ones(6, 8),
                       VirtualPipe(4), 4)
    assert str(got.value) == str(want.value)
    # the preflight of an experiment: JAX's texts
    raw = {"resources": {"mesh": {"pipe": 4, "data": 2}},
           "optimizations": {"pipeline_schedule": "interleaved", "virtual_stages": 2},
           "hyperparameters": {"n_layers": 6, "global_batch_size": 16, "pipe_microbatches": 3}}
    from determined_tpu.config.experiment import preflight_experiment_config

    want_problems = preflight_experiment_config(JaxExperimentConfig.parse(raw))
    with pytest.raises(InvalidExperimentConfig) as exc:
        train.init(exp_config=ExperimentConfig.parse(raw), device="cpu")
    assert str(exc.value) == "; ".join(want_problems)


@pytest.mark.parametrize("axes,moe", [(dict(pipe=2, seq=2, expert=2), True),
                                      (dict(pipe=2, tensor=2), False)],
                         ids=["pipe-seq-expert", "pipe-tensor"])
def test_pipe_compositions_of_later_slices_raise(axes, moe):
    hp = dict(n_layers=4, moe_experts=4 if moe else 0)
    with pytest.raises(NotImplementedError, match="later slice"):
        train.init(hparams=hp, device="cpu", mesh_config=MeshConfig(**axes))
    cfg = ExperimentConfig.parse({"hyperparameters": hp, "resources": {"mesh": dict(axes)}})
    with pytest.raises(NotImplementedError, match="later slice"):
        train.init(exp_config=cfg, device="cpu")


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

TINY = dict(lr=1e-3, global_batch_size=8, seq_len=16, vocab_size=64, d_model=32, n_layers=4,
            n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1,
            pipe_microbatches=4)


def test_bubble_counter_is_the_bubble_model_times_the_steps():
    from determined_tpu_torch.observability import compute_ledger

    tracer = get_tracer()
    tracer.reset()
    tracer.configure(enabled=True)
    tracer.start()
    try:
        ctx = train.init(hparams=dict(TINY, pipeline_schedule="1f1b"), device="cpu",
                         virtual_pipe=2)
        trainer = train.Trainer(LMTrial(ctx))
        with tracer.span("trial.run", cat="trial", trial="p"):
            trainer.fit(max_length=4, report_period=2, checkpoint_policy="none")
    finally:
        tracer.stop()
    events = tracer.chrome_events()
    tracer.reset()
    model = trainer._bubble_model
    assert model == BubbleModel(PipelineSchedule("1f1b", 2, 4))
    assert model.fraction == pytest.approx(1 / 5)  # (P-1)/(M+P-1)
    counters = [e["args"]["value"] for e in events
                if e.get("ph") == "C" and e["name"] == "step.bubble.exposed_us"]
    rows = ctx.core.train.metrics("training")
    assert [s for s, _ in rows] == [2, 4] and len(counters) == 2
    gbs = TINY["global_batch_size"]
    for value, (_, m) in zip(counters, rows):
        # a segment's hot time is its steps x gbs / samples_per_second
        mean_step = 2 * gbs / m["samples_per_second"] / 2
        np.testing.assert_allclose(value, model.split(mean_step)[0] * 1e6 * 2, rtol=1e-9)
    gauges = {e["name"]: e["args"]["value"] for e in events if e.get("ph") == "C"
              and e.get("cat") == "gauge" and e["name"].startswith("step.bubble.")}
    assert gauges == {"step.bubble.fraction": pytest.approx(0.2),
                      "step.bubble.ticks_total": 10.0, "step.bubble.ticks_idle": 2.0}
    bubble = compute_ledger(events)["trials"]["p"]["step.bubble"]
    assert bubble["fraction_modeled"] == pytest.approx(0.2)
    assert bubble["ticks_total"] == 10 and bubble["ticks_idle"] == 2
    assert bubble["exposed_s"] == pytest.approx(sum(counters) / 1e6, abs=1e-6)


# ---------------------------------------------------------------------------
# through the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

HP = dict(lr=1e-3, global_batch_size=16, seq_len=16, vocab_size=128, d_model=32, n_layers=4,
          n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1,
          fused_adamw=True, grad_clip=0.05, pipe_microbatches=4)
STEPS = 8
# name: (mesh, hparams over HP, optimizations)
RUNS = {
    "1f1b": (dict(pipe=2), dict(pipeline_schedule="1f1b"), {}),
    "interleaved": (dict(pipe=2), dict(pipeline_schedule="interleaved", virtual_stages=2), {}),
    "agg2": (dict(pipe=2), {}, {"aggregation_frequency": 2}),
}


@functools.lru_cache(maxsize=None)
def jax_pipe_run(mesh_items, hp_items, opt_items, steps=STEPS):
    """The JAX Trainer's fit at ``mesh`` for ``steps`` steps: each step's
    reported metrics and its initial and final params (the split layout,
    unboxed)."""
    from flax.core import meta as flax_meta

    mesh, hp, opt = dict(mesh_items), dict(hp_items), dict(opt_items)
    exp = JaxExperimentConfig.parse({"optimizations": opt}) if opt else None
    n = int(np.prod(list(mesh.values())))
    ctx = jax_train.init(hparams=hp, mesh_config=JaxMeshConfig(**mesh),
                         core_context=jax_core._dummy_init(), seed=0, exp_config=exp,
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
    trainer.fit(steps, report_period=1, checkpoint_policy="none")
    return rows, captured["init"], jax.device_get(flax_meta.unbox(trainer.state.params))


def _init_state(init, mesh, hp):
    return state_dict_from_split(init, mesh.get("pipe", 1), int(hp.get("virtual_stages", 1)))


def clip_engages(hp, init_state):
    """Whether the first step's global gradient norm (one device, the same
    weights and batch) is far above the clip."""
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.ops.fused_adamw import global_norm

    ctx = train.init(hparams={k: v for k, v in hp.items()
                              if k not in ("pipeline_schedule", "virtual_stages")},
                     seed=0, device="cpu")
    trial = LMTrial(ctx)
    model = trial.build_model()
    model.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()})
    batch = to_device(next(iter(trial.build_training_data_loader())), ctx.device)
    trial.loss(model, batch)[0].backward()
    norm = float(global_norm({k: p.grad for k, p in model.named_parameters()}))
    return norm > 10 * hp["grad_clip"]


def run_on_ranks(tmp_path, names, runs, world):
    """Each named run through the Trainer, in turn, on ``world`` gloo ranks;
    the chief's results by name."""
    cases = []
    for name in names:
        mesh, hp, opt = runs[name]
        hp = dict(HP, **hp)
        _, init, _ = jax_pipe_run(tuple(mesh.items()), tuple(hp.items()), tuple(opt.items()))
        cases.append(dict(name=name, trial="lm", hparams=hp, mesh=mesh, seed=0,
                          init_state=_init_state(init, mesh, hp),
                          exp_config={"optimizations": opt} if opt else None,
                          fit=dict(max_length=STEPS, report_period=1,
                                   checkpoint_policy="none")))
    outs = launch("train_runs", world, str(tmp_path / "runs"),
                  dict(cases=cases, ckpt_dir=str(tmp_path / "ck")), timeout=240.0)
    return {r["name"]: dict(r, local_keys=[o["runs"][i]["local_keys"] for o in outs])
            for i, r in enumerate(outs[0]["runs"])}


def check_against_jax(out, mesh, hp, opt):
    """A run's reported rows and final params against the JAX Trainer's."""
    hp = dict(HP, **hp)
    want, init, final = jax_pipe_run(tuple(mesh.items()), tuple(hp.items()), tuple(opt.items()))
    assert clip_engages(hp, _init_state(init, mesh, hp))
    got = out["training"]
    assert [s for s, _ in got] == list(range(1, STEPS + 1))
    for (step, g), w in zip(got, want):
        for k in ("loss", "lr") + (("moe_aux_loss",) if "moe_aux_loss" in w else ()):
            np.testing.assert_allclose(g[k], float(w[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {k}")
        np.testing.assert_allclose(g["perplexity"], float(w["perplexity"]), rtol=2e-2)
    v = int(hp.get("virtual_stages", 1))
    p = mesh.get("pipe", 1)
    start, end = state_dict_from_split(init, p, v), state_dict_from_split(final, p, v)
    for k, ref in end.items():
        upd_ref, upd = ref - start[k], out["params"][k] - start[k]
        rel = float(np.linalg.norm(upd - upd_ref) / max(np.linalg.norm(upd_ref), 1e-30))
        assert rel <= TRAIN_PARITY_TOL["update_rel"], (k, rel)


@pytest.fixture(scope="module")
def schedule_runs(tmp_path_factory):
    return run_on_ranks(tmp_path_factory.mktemp("sched"), list(RUNS), RUNS, 2)


@pytest.mark.parametrize("name", list(RUNS))
def test_schedules_through_the_trainer_track_the_jax_trainer(schedule_runs, name):
    mesh, hp, opt = RUNS[name]
    check_against_jax(schedule_runs[name], mesh, hp, opt)
