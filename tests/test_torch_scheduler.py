"""The port's concurrent trial scheduler (determined_tpu_torch/experiment/
scheduler.py) and the local experiment's concurrent runner against the JAX
package's.

- ``SlotPool``: the same acquire/release scripts give the same blocks,
  offsets and refusals in both packages (gang allocation, alignment, LIFO
  reuse, the guards, an unaligned pool).
- ``TrialScheduler`` with each package's real ASHA searcher and the same
  synthetic trial bodies (tests/test_scheduler.py's invariants): no device
  serves two live trials, ASHA stops free blocks that backfill, a trial
  error drains the running trials and surfaces, a gang that can never fit
  is refused, and a preemption drain hands back the drained trials.
- ``LocalExperiment`` on four CPU slots (MNIST, a grid of 4 and an ASHA
  cut): four trials run at once; the trial set is the serial run's and the
  JAX concurrent run's; every trial that ran as many steps as in the
  serial run has its metrics bitwise; checkpoints are namespaced per trial
  and a concurrent trial's params equal the serial trial's bitwise.
"""

import threading
import time

import jax
import numpy as np
import pytest

from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import LocalExperiment as JaxLocalExperiment
from determined_tpu.experiment import SlotPool as JaxSlotPool
from determined_tpu.experiment import TrialScheduler as JaxTrialScheduler
from determined_tpu.models.mnist import MnistTrial as JaxMnistTrial
from determined_tpu.searcher import Searcher as JaxSearcher
from determined_tpu.searcher import method_from_config as jax_method_from_config
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.experiment import LocalExperiment, SlotPool, TrialScheduler
from determined_tpu_torch.models import MnistTrial
from determined_tpu_torch.searcher import Searcher, method_from_config
from tests import torch_threads  # noqa: F401  (one intra-op thread)

IMPLS = {
    "jax": (JaxSlotPool, JaxTrialScheduler, JaxExperimentConfig, JaxSearcher,
            jax_method_from_config),
    "port": (SlotPool, TrialScheduler, ExperimentConfig, Searcher, method_from_config),
}

# scripts of (op, rid, slots) over a pool of n devices
POOL_SCRIPTS = {
    "gang_disjoint_aligned": (8, [("acquire", r, 2) for r in (1, 2, 3, 4)]
                              + [("acquire", 5, 2)]),
    "lifo_affinity": (8, [("acquire", 1, 2), ("acquire", 2, 2), ("release", 1, 0),
                          ("release", 2, 0), ("acquire", 3, 2), ("acquire", 4, 4)]),
    "guards": (4, [("acquire", 1, 0), ("acquire", 1, 5), ("acquire", 1, 4), ("acquire", 1, 2),
                   ("release", 1, 0), ("release", 1, 0)]),
    "unaligned_capacity": (6, [("acquire", 1, 4), ("acquire", 2, 4), ("acquire", 3, 2),
                               ("release", 1, 0), ("acquire", 4, 3)]),
}


def _play(pool_cls, n, script):
    pool, held, out = pool_cls(list(range(n))), {}, []
    for op, rid, slots in script:
        try:
            if op == "acquire":
                a = pool.acquire(rid, slots)
                if a is not None:
                    held[rid] = a
                out.append(None if a is None else (a.offset, tuple(a.devices)))
            else:
                pool.release(held[rid])
                out.append("released")
        except (ValueError, RuntimeError) as e:
            out.append(type(e).__name__)
    return out, pool.slots_in_use


@pytest.mark.parametrize("name", list(POOL_SCRIPTS))
def test_slot_pool_scripts_give_the_jax_blocks(name):
    n, script = POOL_SCRIPTS[name]
    port, jax_out = _play(SlotPool, n, script), _play(JaxSlotPool, n, script)
    assert port == jax_out
    if name == "gang_disjoint_aligned":
        assert port[0][-1] is None and port[1] == 8  # all-or-nothing, exhausted
    if name == "lifo_affinity":
        assert port[0][4][0] == port[0][1][0]  # the newest released block first


def _searcher(impl, max_trials=6, max_concurrent=3, max_time=8):
    _, _, cfg_cls, searcher_cls, method = IMPLS[impl]
    cfg = cfg_cls.parse({
        "hyperparameters": {"x": {"type": "double", "minval": 0, "maxval": 1}},
        "searcher": {"name": "asha", "metric": "loss", "max_trials": max_trials,
                     "max_concurrent_trials": max_concurrent, "max_time": max_time,
                     "num_rungs": 2, "divisor": 2},
    })
    return searcher_cls(method(cfg.searcher, cfg.hyperparameters), cfg.hyperparameters)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_scheduler_never_oversubscribes_and_backfills_on_asha_stop(impl):
    pool_cls, sched_cls = IMPLS[impl][:2]
    searcher = _searcher(impl)
    events, lock = [], threading.Lock()

    def run_trial(create, devices):
        rid, start, validations = create.request_id, time.monotonic(), 0
        for step in (4, 8):
            time.sleep(0.05)
            validations += 1
            # a higher request id is a worse trial: ASHA stops late arrivals
            searcher.on_validation(rid, {"loss": float(rid), "batches": step})
            if searcher.is_stopped(rid):
                break
        with lock:
            events.append((rid, tuple(devices), start, time.monotonic(), validations))
        return rid

    pool = pool_cls(list(range(8)))
    outcome = sched_cls(searcher, pool, run_trial, slots_per_trial=2, max_concurrent=3).run()
    assert not outcome.errors
    assert outcome.stats["launched"] == 6 and len(outcome.results) == 6
    assert 2 <= outcome.stats["peak_concurrency"] <= 3
    assert pool.slots_in_use == 0
    for i, (ra, da, sa, ea, _) in enumerate(events):
        for rb, db, sb, eb, _ in events[i + 1:]:
            if sa < eb and sb < ea:
                assert not set(da) & set(db), f"trials {ra} and {rb} shared devices while live"
    assert any(v < 2 for *_, v in events), "no trial was stopped early"
    assert outcome.stats["backfills"] >= 1


@pytest.mark.parametrize("impl", list(IMPLS))
def test_scheduler_trial_error_drains_and_surfaces(impl):
    pool_cls, sched_cls = IMPLS[impl][:2]
    searcher = _searcher(impl, max_trials=4, max_concurrent=2)
    started = []

    def run_trial(create, devices):
        started.append(create.request_id)
        time.sleep(0.02)
        if create.request_id == 1:
            raise RuntimeError("boom")
        searcher.on_validation(create.request_id, {"loss": 0.1, "batches": 8})
        return create.request_id

    pool = pool_cls(list(range(8)))
    outcome = sched_cls(searcher, pool, run_trial, slots_per_trial=2, max_concurrent=2).run()
    assert [rid for rid, _ in outcome.errors] == [1]
    assert pool.slots_in_use == 0
    assert len(started) <= 3  # two at first, at most one raced dispatch


@pytest.mark.parametrize("impl", list(IMPLS))
def test_scheduler_rejects_a_gang_that_never_fits(impl):
    pool_cls, sched_cls = IMPLS[impl][:2]
    with pytest.raises(ValueError):
        sched_cls(_searcher(impl), pool_cls(list(range(4))), lambda c, d: None,
                  slots_per_trial=8, max_concurrent=2)


class _Drained:
    def __init__(self, rid):
        self.request_id, self.preempted, self.checkpoint = rid, True, f"ckpt-{rid}"


@pytest.mark.parametrize("impl", list(IMPLS))
def test_scheduler_preemption_drain_hands_back_the_drained_trials(impl):
    pool_cls, sched_cls = IMPLS[impl][:2]
    searcher = _searcher(impl, max_trials=6, max_concurrent=2)
    stop = threading.Event()
    both_running = threading.Barrier(2)

    def run_trial(create, devices):
        both_running.wait(timeout=10)
        stop.set()  # the experiment drains: no new dispatch
        return _Drained(create.request_id)

    pool = pool_cls(list(range(4)))
    outcome = sched_cls(searcher, pool, run_trial, slots_per_trial=2, max_concurrent=2,
                        stop_event=stop, drain_timeout=10.0).run()
    assert not outcome.errors and outcome.results == {}
    assert sorted(outcome.preempted) == [1, 2]
    assert outcome.stats["launched"] == 2 and outcome.stats["abandoned"] == []
    assert pool.slots_in_use == 0


def _mnist_raw(search):
    searcher = {"metric": "validation_loss", "max_length": {"batches": 8},
                "max_concurrent_trials": 4}
    if search == "grid":
        hp = {"lr": {"type": "categorical", "vals": [0.2, 0.05, 0.1, 0.01]}}
        searcher["name"] = "grid"
    else:
        hp = {"lr": {"type": "log", "base": 10, "minval": -3, "maxval": -1}}
        searcher.update(name="asha", max_trials=4, num_rungs=2, divisor=2, max_time=8,
                        time_metric="batches")
        del searcher["max_length"]
    return {
        "name": f"four-slots-{search}",
        "hyperparameters": dict(hp, hidden=16, global_batch_size=32, dataset_size=64),
        "searcher": searcher,
        "min_validation_period": {"batches": 4},
        "checkpoint_policy": "best",
    }


@pytest.mark.parametrize("search", ["grid", "asha"])
def test_a_search_on_four_cpu_slots_runs_four_trials_at_once(tmp_path, search):
    with torch_threads.default_threads():
        _four_trials_at_once(tmp_path, search)


def _four_trials_at_once(tmp_path, search):
    """The serial search runs its trials in this thread, the packed one in
    the scheduler's threads: both at torch's default threads, so their
    metrics and params compare bitwise (tests/torch_threads.py)."""
    raw = _mnist_raw(search)
    serial = LocalExperiment(ExperimentConfig.parse(raw), MnistTrial,
                             checkpoint_dir=str(tmp_path / "s"), device="cpu")
    serial.run()
    packed = LocalExperiment(ExperimentConfig.parse(raw), MnistTrial,
                             checkpoint_dir=str(tmp_path / "p"), devices=["cpu"] * 4)
    packed.run()
    assert serial.scheduler_stats is None  # one slot: the serial path
    stats = packed.scheduler_stats
    assert stats["pool_capacity"] == 4 and stats["max_concurrent"] == 4
    assert stats["peak_concurrency"] == 4
    trials = {rid: r.hparams for rid, r in serial.results.items()}
    assert {rid: r.hparams for rid, r in packed.results.items()} == trials
    same = [rid for rid in trials
            if serial.results[rid].steps_completed == packed.results[rid].steps_completed]
    assert same
    for rid in same:
        assert packed.results[rid].metrics == serial.results[rid].metrics, rid

    # the JAX runner on four devices runs the same trial set
    # (no JAX checkpoints: two orbax saves at once race on their tmp
    # directory, a fault of the reference recorded in ROADMAP Queue 3)
    jax_exp = JaxLocalExperiment(JaxExperimentConfig.parse(dict(raw, checkpoint_policy="none")),
                                 JaxMnistTrial,
                                 checkpoint_dir=str(tmp_path / "j"), devices=jax.devices()[:4])
    jax_exp.run()
    assert jax_exp.scheduler_stats["peak_concurrency"] == 4
    assert {rid: r.hparams for rid, r in jax_exp.results.items()} == trials

    # checkpoints namespaced per trial; a concurrent trial's params are the
    # serial one's
    for rid, result in packed.results.items():
        assert (tmp_path / "p" / f"trial_{rid}" / result.checkpoint).is_dir()
    rid = same[0]
    _, t_serial = train.load_trial_from_checkpoint(
        str(tmp_path / "s" / f"trial_{rid}" / serial.results[rid].checkpoint), device="cpu")
    _, t_packed = train.load_trial_from_checkpoint(
        str(tmp_path / "p" / f"trial_{rid}" / packed.results[rid].checkpoint), device="cpu")
    packed_params = dict(t_packed.model.named_parameters())
    for k, p in t_serial.model.named_parameters():
        np.testing.assert_array_equal(packed_params[k].detach().numpy(), p.detach().numpy(), k)
