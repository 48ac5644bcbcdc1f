"""Fault-tolerant training in the port (determined_tpu_torch), on the CPU,
by the names of ``tests/test_async_checkpoint.py`` and
``tests/test_fault_tolerance.py``: asynchronous checkpoints, preemption,
crash and restart, corrupt checkpoints falling back along their lineage,
the restart budget, and the failure taxonomy and backoff units (held
against the JAX package's).

A resumed run is held to the uninterrupted one with ``torch.equal``:
params, both Adam moments, the step counters and the loader position.
The model is the flagship's ``LMTrial`` at 2 layers, d_model 64, seq 32.
"""

import os
import threading

import pytest
import torch

from determined_tpu.utils import errors as jax_errors
from determined_tpu_torch import core, train
from determined_tpu_torch.config import ExperimentConfig, InvalidExperimentConfig, Length
from determined_tpu_torch.exec.run_trial import TrialSupervisor
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.train import serialization
from determined_tpu_torch.train._restart import RestartPolicy, run_with_restarts
from determined_tpu_torch.utils import faults
from determined_tpu_torch.utils.errors import (
    CheckpointCorruptError,
    FailureKind,
    FatalTrialError,
    InvalidConfigError,
    PeerLostError,
    PreemptedError,
    RestartBudgetExhaustedError,
    TransientError,
    classify_failure,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.faults import FaultInjector as JaxFaultInjector

pytestmark = pytest.mark.faults

HP = dict(lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=256, d_model=64, n_layers=2,
          n_heads=2, dataset_size=16, attention="flash", fused_ce=True, fused_adamw=True,
          warmup_steps=2, bf16=False)

SYNC_CKPT = ExperimentConfig.parse({"optimizations": {"async_checkpointing": False}})


class SimulatedCrash(TransientError):
    """A worker crash mid-step: TRANSIENT, so the supervisor restarts."""


class Injector:
    """The port's fault-injection hook: ``on(step, action)`` runs an action
    when ``train.step`` fires for that step; every fire is counted."""

    def __init__(self):
        self.rules = []
        self.counts = {}

    def fire(self, site, **info):
        self.counts[site] = self.counts.get(site, 0) + 1
        for rule in self.rules:
            site_glob, when, action, left = rule
            if left[0] and site == site_glob and when(info):
                left[0] -= 1
                action(info)

    def on(self, site, when, action, times=1):
        self.rules.append((site, when, action, [times]))

    def kill_at_step(self, step, times=1):
        def crash(info):
            raise SimulatedCrash(f"injected crash at step {step}")

        self.on("train.step", lambda i: i.get("step") == step, crash, times)

    def __enter__(self):
        faults.set_fault_injector(self)
        return self

    def __exit__(self, *exc):
        faults.set_fault_injector(None)


def make_factory(base_dir, exp_config=None, trainers=None):
    """Trainer factory over ONE checkpoint directory, as the supervisor
    uses it: every attempt gets a fresh Trainer against the same storage."""

    def factory():
        ctx = train.init(
            hparams=dict(HP), exp_config=exp_config, seed=7, device="cpu",
            core_context=core._dummy_init(checkpoint_dir=str(base_dir / "ckpts")),
        )
        t = train.Trainer(LMTrial(ctx))
        if trainers is not None:
            trainers.append(t)
        return t

    return factory


def fast_policy(max_restarts=2):
    return RestartPolicy(max_restarts=max_restarts, backoff_base=0.0, jitter=0.0)


def assert_same_state(got, want):
    """Params, moments, step counters and loader position: bitwise."""
    gp, wp = dict(got.model.named_parameters()), dict(want.model.named_parameters())
    assert gp.keys() == wp.keys()
    for k in wp:
        assert torch.equal(gp[k], wp[k]), k
        assert torch.equal(got.state.opt_state.mu[k], want.state.opt_state.mu[k]), k
        assert torch.equal(got.state.opt_state.nu[k], want.state.opt_state.nu[k]), k
    assert torch.equal(got.state.opt_state.count, want.state.opt_state.count)
    assert torch.equal(got.state.step, want.state.step)
    assert got.train_loader.state_dict() == want.train_loader.state_dict()
    assert torch.equal(got.state.rng.get_state(), want.state.rng.get_state())


# ---------------------------------------------------------------------------
# asynchronous checkpoints (tests/test_async_checkpoint.py)
# ---------------------------------------------------------------------------


def test_steps_advance_while_save_in_flight(tmp_path, monkeypatch):
    """The writer of the step-2 checkpoint waits for a later step's report:
    if saves blocked the loop, the event could never fire first."""
    trainer = make_factory(tmp_path)()
    later_step_reported = threading.Event()
    writer_saw_event = []
    real_save = serialization.save_arrays

    def gated_save(path, tree):
        writer_saw_event.append(later_step_reported.wait(timeout=60))
        real_save(path, tree)

    monkeypatch.setattr("determined_tpu_torch.train._trainer.serialization.save_arrays",
                        gated_save)
    orig_report = trainer.core.train.report_training_metrics

    def report(step, metrics):
        if step >= 4:
            later_step_reported.set()
        return orig_report(step, metrics)

    trainer.core.train.report_training_metrics = report
    result = trainer.fit(Length.batches(6), checkpoint_period=Length.batches(2),
                         report_period=Length.batches(1), checkpoint_policy="none")
    assert result["steps_completed"] == 6
    assert writer_saw_event and all(writer_saw_event)


def test_async_resume_parity(tmp_path):
    """Resume from an async-written checkpoint ends bitwise equal to the
    uninterrupted run."""
    full = make_factory(tmp_path / "full")()
    full.fit(Length.batches(6), report_period=Length.batches(1), checkpoint_policy="none")
    factory = make_factory(tmp_path / "ab")
    result_a = factory().fit(Length.batches(4), checkpoint_period=Length.batches(2),
                             report_period=Length.batches(1), checkpoint_policy="none")
    sid = result_a["latest_checkpoint"]
    assert sid is not None
    resumed = factory()
    result_b = resumed.fit(Length.batches(6), report_period=Length.batches(1),
                           checkpoint_policy="none", latest_checkpoint=sid)
    assert result_b["steps_completed"] == 6
    assert_same_state(resumed, full)


def test_preempt_waits_for_in_flight_save(tmp_path, monkeypatch):
    """Preemption at the boundary of a just-started async save waits for it
    instead of writing a second checkpoint of the same step."""
    trainer = make_factory(tmp_path)()
    save_calls = []
    real_save = serialization.save_arrays
    monkeypatch.setattr(
        "determined_tpu_torch.train._trainer.serialization.save_arrays",
        lambda path, tree: (save_calls.append(path), real_save(path, tree)),
    )
    trainer.core.preempt.should_preempt = lambda: trainer.steps_completed >= 2
    result = trainer.fit(Length.batches(10), checkpoint_period=Length.batches(2),
                         report_period=Length.batches(1), checkpoint_policy="none")
    assert result["stopped_early"] and result["steps_completed"] == 2
    assert len(save_calls) == 1  # the in-flight save was reused, not duplicated
    assert result["latest_checkpoint"] is not None
    result2 = make_factory(tmp_path)().fit(
        Length.batches(4), latest_checkpoint=result["latest_checkpoint"], checkpoint_policy="none"
    )
    assert result2["steps_completed"] == 4


@pytest.mark.parametrize("knob", [False, True], ids=["sync_knob", "async_default"])
def test_saves_run_on_the_thread_the_knob_names(tmp_path, monkeypatch, knob):
    """optimizations.async_checkpointing: false -> saves on the main thread;
    the default -> on the background writer."""
    exp = ExperimentConfig.parse({"optimizations": {"async_checkpointing": knob}})
    trainer = make_factory(tmp_path, exp_config=exp)()
    threads = []
    real_save = serialization.save_arrays
    monkeypatch.setattr(
        "determined_tpu_torch.train._trainer.serialization.save_arrays",
        lambda path, tree: (threads.append(threading.current_thread().name),
                            real_save(path, tree)),
    )
    trainer.fit(Length.batches(4), checkpoint_period=Length.batches(2), checkpoint_policy="none")
    want = "dtt-ckpt-writer" if knob else "MainThread"
    assert threads and all(t == want for t in threads)


def test_async_write_failure_surfaces_at_drain(tmp_path, monkeypatch):
    trainer = make_factory(tmp_path)()

    def boom(path, tree):
        raise OSError("disk full")

    monkeypatch.setattr("determined_tpu_torch.train._trainer.serialization.save_arrays", boom)
    with pytest.raises(RuntimeError, match="async checkpoint") as ei:
        trainer.fit(Length.batches(4), checkpoint_period=Length.batches(2),
                    checkpoint_policy="none")
    assert isinstance(ei.value.__cause__, OSError)


def test_async_written_checkpoint_corruption_falls_back(tmp_path):
    trainer = make_factory(tmp_path)()
    result = trainer.fit(Length.batches(8), checkpoint_period=Length.batches(4),
                         report_period=Length.batches(4), checkpoint_policy="none")
    sid_b = result["latest_checkpoint"]
    store = str(tmp_path / "ckpts")
    ckpt = core._dummy_init(checkpoint_dir=store).checkpoint
    sid_a = ckpt.get_checkpoint_parent(sid_b)
    assert ckpt.get_metadata(sid_a)["steps_completed"] == 4
    _corrupt_largest_file(store, sid_b, JaxFaultInjector.truncate_file)
    t2 = make_factory(tmp_path)()
    t2._setup()
    t2._restore_checkpoint(sid_b)
    assert t2.steps_completed == 4 and t2.latest_checkpoint == sid_a


# ---------------------------------------------------------------------------
# crash, preemption, corruption, budget (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------


def test_crash_mid_step_resumes_to_same_final_step_count(tmp_path):
    ref = make_factory(tmp_path / "ref", SYNC_CKPT)()
    ref_summary = ref.fit(Length.batches(12), checkpoint_period=Length.batches(4),
                          report_period=Length.batches(4))
    assert ref_summary["steps_completed"] == 12
    trainers = []
    supervisor = TrialSupervisor(make_factory(tmp_path / "sup", SYNC_CKPT, trainers),
                                 policy=fast_policy(), sleep=lambda s: None)
    with Injector() as inj:
        inj.kill_at_step(6)
        summary = supervisor.run(Length.batches(12), checkpoint_period=Length.batches(4),
                                 report_period=Length.batches(4))
    assert summary["steps_completed"] == ref_summary["steps_completed"] == 12
    assert summary["restarts"] == 1
    # attempt 1 fired steps 0..6 (7; the 7th raised); attempt 2 resumed from
    # the step-4 checkpoint and fired 4..11 (8); from scratch would be 19
    assert inj.counts["train.step"] == 15
    assert_same_state(trainers[-1], ref)


def test_crash_with_async_save_in_flight_resumes_from_finalized_only(tmp_path):
    """An async save that never reached its drain-point finalize has no
    manifest and is not the resume point; the last finalized save is."""
    trainers, resume_points = [], []
    factory = make_factory(tmp_path, trainers=trainers)

    def attempt(latest):
        resume_points.append(latest)
        return factory().fit(Length.batches(8), checkpoint_period=Length.batches(2),
                             report_period=Length.batches(8), checkpoint_policy="none",
                             latest_checkpoint=latest)

    with Injector() as inj:
        inj.kill_at_step(5)
        summary = run_with_restarts(attempt, policy=fast_policy(),
                                    get_latest_checkpoint=lambda: trainers[-1].latest_checkpoint,
                                    sleep=lambda s: None)
    assert summary["steps_completed"] == 8 and summary["restarts"] == 1
    sid = resume_points[1]
    assert sid is not None and sid == trainers[0].latest_checkpoint
    ckpt = core._dummy_init(checkpoint_dir=str(tmp_path / "ckpts")).checkpoint
    assert ckpt.get_metadata(sid)["steps_completed"] == 2


def test_preempt_checkpoints_exits_and_relaunch_resumes(tmp_path):
    trainers = []
    factory = make_factory(tmp_path, SYNC_CKPT, trainers=trainers)
    supervisor = TrialSupervisor(factory, policy=fast_policy(), sleep=lambda s: None)
    with Injector() as inj:
        inj.on("train.step", lambda i: i.get("step") == 5,
               lambda i: trainers[-1].core.preempt.simulate())
        summary = supervisor.run(Length.batches(12), checkpoint_period=Length.batches(4),
                                 report_period=Length.batches(4))
    assert summary["stopped_early"] and summary["restarts"] == 0
    assert summary["steps_completed"] == 8  # the next boundary after step 5
    sid = summary["latest_checkpoint"]
    assert sid is not None
    relaunch = TrialSupervisor(factory, policy=fast_policy(), sleep=lambda s: None)
    summary2 = relaunch.run(Length.batches(12), checkpoint_period=Length.batches(4),
                            report_period=Length.batches(4), latest_checkpoint=sid)
    assert summary2["steps_completed"] == 12 and summary2["restarts"] == 0
    ref = make_factory(tmp_path / "ref", SYNC_CKPT)()
    ref.fit(Length.batches(12), checkpoint_period=Length.batches(4),
            report_period=Length.batches(4))
    assert_same_state(trainers[-1], ref)


def _corrupt_largest_file(store_dir, sid, how):
    root = os.path.join(store_dir, sid)
    candidates = [
        (os.path.getsize(os.path.join(d, f)), os.path.join(d, f))
        for d, _, files in os.walk(root) for f in files if f != "manifest.json"
    ]
    size, victim = max(candidates)
    assert size > 0
    how(victim)
    return victim


def _two_checkpoints(tmp_path):
    factory = make_factory(tmp_path, SYNC_CKPT)
    s1 = factory().fit(Length.batches(8), checkpoint_period=Length.batches(4),
                       report_period=Length.batches(4), checkpoint_policy="none")
    return factory, s1["latest_checkpoint"], str(tmp_path / "ckpts")


def test_truncated_checkpoint_falls_back_to_previous_good(tmp_path):
    factory, sid_b, store = _two_checkpoints(tmp_path)
    ckpt = core._dummy_init(checkpoint_dir=store).checkpoint
    sid_a = ckpt.get_checkpoint_parent(sid_b)
    assert sid_a is not None and sid_a != sid_b
    assert ckpt.get_metadata(sid_a)["steps_completed"] == 4
    _corrupt_largest_file(store, sid_b, JaxFaultInjector.truncate_file)
    t2 = factory()
    t2._setup()
    t2._restore_checkpoint(sid_b)
    assert t2.steps_completed == 4 and t2.latest_checkpoint == sid_a
    s3 = factory().fit(Length.batches(12), latest_checkpoint=sid_b,
                       report_period=Length.batches(12), checkpoint_policy="none")
    assert s3["steps_completed"] == 12


def test_checkpoint_killed_before_manifest_never_poisons_resume(tmp_path):
    factory, sid_b, store = _two_checkpoints(tmp_path)
    os.remove(os.path.join(store, sid_b, "manifest.json"))  # "killed mid-finalize"
    t2 = factory()
    t2._setup()
    t2._restore_checkpoint(sid_b)
    assert t2.steps_completed == 4  # fell back to the parent


def test_no_usable_checkpoint_in_lineage_is_fatal(tmp_path):
    factory = make_factory(tmp_path, SYNC_CKPT)
    s1 = factory().fit(Length.batches(4), checkpoint_period=Length.batches(4),
                       report_period=Length.batches(4), checkpoint_policy="none")
    sid = s1["latest_checkpoint"]
    _corrupt_largest_file(str(tmp_path / "ckpts"), sid, JaxFaultInjector.bit_flip)
    t2 = factory()
    t2._setup()
    with pytest.raises(CheckpointCorruptError):
        t2._restore_checkpoint(sid)  # no parent: the trial's first checkpoint
    assert classify_failure(CheckpointCorruptError("x")) == FailureKind.FATAL


def test_restart_budget_exhausted_goes_fatal(tmp_path):
    supervisor = TrialSupervisor(make_factory(tmp_path, SYNC_CKPT),
                                 policy=fast_policy(max_restarts=2), sleep=lambda s: None)
    with Injector() as inj:
        inj.on("train.step", lambda i: i.get("step", -1) >= 2,
               lambda i: (_ for _ in ()).throw(SimulatedCrash("persistent")), times=10 ** 6)
        with pytest.raises(RestartBudgetExhaustedError) as ei:
            supervisor.run(Length.batches(8), checkpoint_period=Length.batches(4),
                           report_period=Length.batches(4))
    assert supervisor.restarts == 2
    assert classify_failure(ei.value) == FailureKind.FATAL
    assert isinstance(ei.value, FatalTrialError)


def test_transient_storage_put_failure_is_survived(tmp_path):
    """A flaky store fails one upload; the attempt dies, the supervisor
    restarts, and the trial still completes."""
    supervisor = TrialSupervisor(make_factory(tmp_path, SYNC_CKPT), policy=fast_policy(),
                                 sleep=lambda s: None)

    def fail(info):
        raise OSError("injected storage put failure")

    with Injector() as inj:
        inj.on("storage.upload", lambda i: True, fail)
        summary = supervisor.run(Length.batches(8), checkpoint_period=Length.batches(4),
                                 report_period=Length.batches(4), checkpoint_policy="none")
    assert summary["steps_completed"] == 8 and summary["restarts"] == 1


# ---------------------------------------------------------------------------
# units: the taxonomy and the restart policy, against the JAX package
# ---------------------------------------------------------------------------

_CASES = [
    ("PreemptedError", "preempted"), ("TransientError", "transient"),
    ("PeerLostError", "transient"), ("ConnectionError", "transient"),
    ("OSError", "transient"), ("RuntimeError", "transient"),
    ("InvalidConfigError", "fatal"), ("TypeError", "fatal"), ("ImportError", "fatal"),
    ("CheckpointCorruptError", "fatal"), ("RestartBudgetExhaustedError", "fatal"),
    ("InvalidExperimentConfig", "fatal"), ("NotImplementedError", "fatal"),
]


@pytest.mark.parametrize("name,kind", _CASES, ids=[c[0] for c in _CASES])
def test_classify_failure_taxonomy(name, kind):
    port_classes = dict(PreemptedError=PreemptedError, TransientError=TransientError,
                        PeerLostError=PeerLostError, InvalidConfigError=InvalidConfigError,
                        CheckpointCorruptError=CheckpointCorruptError,
                        RestartBudgetExhaustedError=RestartBudgetExhaustedError,
                        InvalidExperimentConfig=InvalidExperimentConfig)
    from determined_tpu.config import InvalidExperimentConfig as JaxInvalid

    jax_classes = {k: getattr(jax_errors, k, None) for k in port_classes}
    jax_classes["InvalidExperimentConfig"] = JaxInvalid
    builtin = getattr(__builtins__, name, None) if not isinstance(__builtins__, dict) \
        else __builtins__.get(name)
    port_exc = (port_classes.get(name) or builtin)("x")
    jax_exc = (jax_classes.get(name) or builtin)("x")
    assert classify_failure(port_exc).value == kind
    assert jax_errors.classify_failure(jax_exc).value == kind


def test_restart_policy_backoff_and_config():
    from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
    from determined_tpu.train._restart import RestartPolicy as JaxRestartPolicy

    p = RestartPolicy(max_restarts=3, backoff_base=1.0, backoff_cap=5.0, jitter=0.0)
    assert [p.delay(n) for n in range(4)] == [1.0, 2.0, 4.0, 5.0]  # capped
    jittered = RestartPolicy(backoff_base=1.0, backoff_cap=64.0, jitter=0.25)
    for n in range(5):
        assert 0.75 * 2 ** n <= jittered.delay(n) <= 1.25 * 2 ** n
    raw = {"max_restarts": 7, "fault_tolerance": {
        "restart_backoff_base": 0.5, "restart_backoff_cap": 10.0, "restart_backoff_jitter": 0.0}}
    got = RestartPolicy.from_exp_config(ExperimentConfig.parse(raw))
    want = JaxRestartPolicy.from_exp_config(JaxExperimentConfig.parse(raw))
    assert dataclasses_fields(got) == dataclasses_fields(want)
    assert got.delay(0) == 0.5


def dataclasses_fields(obj):
    import dataclasses

    return dataclasses.asdict(obj)


def test_run_with_restarts_fatal_raises_immediately():
    attempts = []

    def attempt(latest):
        attempts.append(latest)
        raise TypeError("deterministic user bug")

    with pytest.raises(TypeError):
        run_with_restarts(attempt, policy=fast_policy(5), sleep=lambda s: None)
    assert len(attempts) == 1


def test_run_with_restarts_preempted_returns_clean():
    def attempt(latest):
        raise PreemptedError("maintenance event")

    summary = run_with_restarts(attempt, policy=fast_policy(), sleep=lambda s: None)
    assert summary["stopped_early"] and summary.get("preempted")
    assert summary["restarts"] == 0


def test_run_with_restarts_backoff_sleeps_between_attempts():
    slept, calls = [], []

    def attempt(latest):
        calls.append(latest)
        if len(calls) < 3:
            raise SimulatedCrash("flaky")
        return {"steps_completed": 1}

    policy = RestartPolicy(max_restarts=5, backoff_base=1.0, backoff_cap=8.0, jitter=0.0)
    summary = run_with_restarts(attempt, policy=policy, sleep=slept.append,
                                initial_checkpoint="ck0")
    assert summary["restarts"] == 2
    assert slept == [1.0, 2.0]
    assert calls == ["ck0", "ck0", "ck0"]
