"""The driver side of the port's cluster path (experiment/cluster.py
``ClusterExperiment``, experiment/registry.py, ``LocalExperiment``'s
registry promotion) against the JAX package's, on the CPU.

Each of ``tests/test_cluster_experiment.py``'s nine fake-master scenarios
runs twice, with the JAX driver and with the port's, each against a fresh
``FakeMaster`` (imported from that file): an ASHA search that completes,
a trial that errors, a gang torn down and rescheduled, the driver detached
by a preemption and resumed, the driver killed at a journal event and
resumed, PBT clones submitted with their parent's checkpoint, the
``single_slice`` preflight, and the watchers riding out a master outage
shorter and longer than the grace period.  The two runs give equal trial
sets (request id -> hparams), stops, summaries and journal records.  The
fake's trials advance in lockstep (one trial at a time, by request id, a
turn ending when the driver has polled that trial after its progress), so
ASHA's rung decisions, which depend on the order validations arrive, are
the same on both sides, and the journals are kept uncompacted (where a
compaction lands depends on thread timing); where a scenario is timed by
the clock (the preemption, the outages) the comparison is of what the
clock cannot move.

Registry: ``promote_search_winner``'s payloads (test_registry.py's
promotion) at a recording master, equal for both packages, and a
``LocalExperiment`` with ``registry.auto_promote`` and no master completes
with ``registry_error`` in its summary.
"""

import json
import os
import re
import threading
import time

import pytest

from determined_tpu.api import session as jax_session_mod
from determined_tpu.config.experiment import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import ClusterExperiment as JaxClusterExperiment
from determined_tpu.experiment import registry as jax_registry
from determined_tpu.experiment.journal import journal_path as jax_journal_path
from determined_tpu.experiment.journal import read_journal as jax_read_journal
from determined_tpu_torch.api import session as port_session_mod
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.config.experiment import InvalidExperimentConfig
from determined_tpu_torch.experiment import ClusterExperiment, LocalExperiment, journal_path
from determined_tpu_torch.experiment import read_journal, registry
from determined_tpu_torch.models import MnistTrial
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_cluster_experiment import FakeMaster, _loss_plan
from tests.torch_cluster_master import RecordingMaster

SIDES = {
    "jax": dict(cluster=JaxClusterExperiment, config=JaxExperimentConfig,
                read=jax_read_journal, path=jax_journal_path, session=jax_session_mod),
    "port": dict(cluster=ClusterExperiment, config=ExperimentConfig,
                 read=read_journal, path=journal_path, session=port_session_mod),
}
ENTRY = "determined_tpu.models.mnist:MnistTrial"
# the journal compacts every 64 appends (at a snapshot); where its count
# lands depends on how the watcher threads' own records (trial_running,
# trial_result) interleave, so the compared journals are kept whole
WHOLE_JOURNAL = {"journal_compact_interval": 0}
ASHA = {
    "name": "cluster-asha", "entrypoint": ENTRY,
    "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
    "searcher": {"name": "asha", "metric": "validation_loss", "smaller_is_better": True,
                 "max_trials": 4, "max_concurrent_trials": 4, "max_time": 8,
                 "time_metric": "batches", "num_rungs": 2, "divisor": 2},
    "resources": {"slots_per_trial": 2},
    "fault_tolerance": WHOLE_JOURNAL,
}
RANDOM = {
    "name": "cluster-crash", "entrypoint": ENTRY,
    "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
    "searcher": {"name": "random", "metric": "validation_loss", "max_trials": 3,
                 "max_concurrent_trials": 1, "max_time": 4},
    "resources": {"slots_per_trial": 1},
}
PBT = {
    "name": "cluster-pbt", "entrypoint": ENTRY,
    "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
    "searcher": {"name": "pbt", "metric": "validation_loss", "population_size": 3,
                 "num_generations": 2, "truncate_fraction": 0.34, "max_time": 4,
                 "time_metric": "batches"},
    "resources": {"slots_per_trial": 1},
    "fault_tolerance": WHOLE_JOURNAL,
}
OUTAGE = {
    "name": "cluster-outage", "entrypoint": ENTRY,
    "hyperparameters": {"lr": {"type": "log", "minval": -4, "maxval": -1}},
    "searcher": {"name": "random", "metric": "validation_loss", "max_trials": 2,
                 "max_concurrent_trials": 2, "max_time": 8, "time_metric": "batches"},
    "resources": {"slots_per_trial": 1},
    "fault_tolerance": {"master_unreachable_grace_s": 0.5},
}
_TERMINAL = ("COMPLETED", "STOPPED", "ERROR")


class LockstepFake(FakeMaster):
    """FakeMaster whose trials take turns: the trial with the turn makes
    one step of progress at its poll, and hands the turn on (by request
    id, among the live trials) at its next poll, when the driver has
    processed that step.  No trial moves while the number of trials is not
    a multiple of ``expect`` (a generation's creates are all in).
    ``error_rid`` errors once its plan is spent (test_cluster_experiment's
    killer thread, on a turn)."""

    def __init__(self, *, expect, error_rid=None, restart_rid=None, **kw):
        self.expect, self.error_rid, self.restart_rid = expect, error_rid, restart_rid
        self.turn, self.moved = None, False
        super().__init__(**kw)

    def _live(self):
        return sorted(t.request_id for t in self.trials.values() if t.state not in _TERMINAL)

    def _pass_turn(self):
        live = self._live()
        later = [r for r in live if r > self.turn]
        self.turn = (later or live or [None])[0]
        self.moved = False

    def customize(self, trial):
        if trial.request_id == self.error_rid:
            trial.plan = trial.plan[:1]
        if trial.request_id == self.restart_rid:
            trial.restart_at_poll = 4
        step = trial.advance

        def advance():
            if len(self.trials) % self.expect:
                return
            if self.turn is None or self.turn not in self._live():
                self.turn = self._live()[0]
            if trial.request_id != self.turn:
                return
            if self.moved:
                self._pass_turn()
                return
            if trial.request_id == self.error_rid and not trial.plan and trial.revealed:
                trial.state, trial.restarts = "ERROR", 2
            else:
                step()
            self.moved = True
            if trial.state in _TERMINAL:
                self._pass_turn()

        trial.advance = advance


def _normal(side, exp, fake, tmp_path, summary):
    """What the comparison holds: the trial set, stops, summary and the
    journal's records (searcher snapshots counted, not compared: their
    state JSON names each package's classes)."""
    rid_of = {tid: t.request_id for tid, t in fake.trials.items()}
    replay = SIDES[side]["read"](SIDES[side]["path"](str(tmp_path / side / "driver")))

    def by_rid(text):
        # the fake names a checkpoint by master trial id, which the order
        # of the concurrent submits decides: name it by request id
        return re.sub(r"ckpt-(\d+)-(\d+)",
                      lambda m: f"ckpt-r{rid_of[int(m.group(1))]}-{m.group(2)}", text)

    records = []
    for r in replay.records:
        t = r.get("type")
        if t in ("searcher_snapshot", "experiment_started", "cluster_attached"):
            continue
        rec = {k: v for k, v in r.items() if k not in ("ts", "seq", "master_trial_id")}
        records.append(tuple(sorted((k, by_rid(repr(v))) for k, v in rec.items())))
    keep = ("status", "trials", "best_trial", "best_hparams", "best_metrics", "total_steps",
            "master_experiment_id", "resumable")
    return dict(
        trials=sorted((t.request_id, t.hparams) for t in fake.trials.values()),
        states=sorted((t.request_id, t.state) for t in fake.trials.values()),
        stops=sorted(rid_of[tid] for tid in fake.stops),
        creates=sorted((c["request_id"], c.get("source_checkpoint") is not None)
                       for c in fake.create_calls),
        summary=summary and {k: summary.get(k) for k in keep},
        journal=sorted(records),
        journal_status=replay.status,
        results=sorted((rid, r.stopped_early, r.steps_completed)
                       for rid, r in exp.results.items()),
    )


def _driver(side, raw, url, tmp_path, **kw):
    s = SIDES[side]
    return s["cluster"](s["config"].parse(raw), master_url=url,
                        checkpoint_dir=str(tmp_path / side / "driver"), poll_interval=0.01, **kw)


# ---- the nine scenarios, each run with one package's driver -----------------


def sc_asha_completes(side, tmp_path, monkeypatch):
    fake = LockstepFake(expect=4, trial_plan=_loss_plan)
    try:
        exp = _driver(side, ASHA, fake.url, tmp_path)
        summary = exp.run()
        assert summary["status"] == "completed" and fake.stops and fake.searcher_shutdown
        return _normal(side, exp, fake, tmp_path, summary)
    finally:
        fake.close()


def sc_trial_error(side, tmp_path, monkeypatch):
    fake = LockstepFake(expect=4, error_rid=1, trial_plan=_loss_plan)
    try:
        exp = _driver(side, ASHA, fake.url, tmp_path)
        summary = exp.run()
        assert summary["status"] == "completed" and exp.results[1].stopped_early
        return _normal(side, exp, fake, tmp_path, summary)
    finally:
        fake.close()


def sc_gang_teardown(side, tmp_path, monkeypatch):
    fake = LockstepFake(expect=4, restart_rid=1, trial_plan=_loss_plan)
    try:
        exp = _driver(side, ASHA, fake.url, tmp_path)
        summary = exp.run()
        tracer = (__import__("determined_tpu.observability", fromlist=["get_tracer"])
                  if side == "jax" else
                  __import__("determined_tpu_torch.observability", fromlist=["get_tracer"]))
        events = tracer.get_tracer().chrome_events()
        out = _normal(side, exp, fake, tmp_path, summary)
        out["teardowns"] = sorted(e["args"]["trial"] for e in events
                                  if e.get("name") == "gang.teardown")
        out["dispatches"] = len([e for e in events if e.get("name") == "gang.dispatch"])
        return out
    finally:
        fake.close()


def sc_preempt_resume(side, tmp_path, monkeypatch):
    class Gated(FakeMaster):
        def customize(self, trial):
            trial.plan = trial.plan[:1]
            trial.gated = True

    fake = Gated(trial_plan=_loss_plan)
    try:
        exp = _driver(side, ASHA, fake.url, tmp_path)
        timer = threading.Timer(0.5, exp.request_preemption)
        timer.start()
        first = exp.run()
        timer.cancel()
        assert first["status"] == "preempted" and first["in_flight"]
        with fake.lock:
            for t in fake.trials.values():
                t.gated = False
        exp2 = _driver(side, ASHA, fake.url, tmp_path)
        summary = exp2.resume()
        out = _normal(side, exp2, fake, tmp_path, summary)
        # the clock decides how far each trial got before the detach
        out.pop("journal")
        out["first"] = {k: first[k] for k in ("status", "resumable", "master_experiment_id")}
        out["n_created_calls"] = len(fake.trials)
        return out
    finally:
        fake.close()


def sc_driver_crash_resume(side, tmp_path, monkeypatch):
    from tests.faults import FaultInjector, SimulatedCrash

    fake = FakeMaster(trial_plan=_loss_plan)
    try:
        inj = FaultInjector()
        inj.kill_driver_at_journal_event("trial_validated", occurrence=2)
        if side == "port":
            # the injector patches the JAX journal's append; the port's
            # journal is its own copy, patched the same way here
            from determined_tpu_torch.experiment import journal as port_journal

            crash = {"n": 0}
            orig = port_journal.ExperimentJournal.append

            def append(self, rec_type, **fields):
                if rec_type == "trial_validated":
                    crash["n"] += 1
                    if crash["n"] == 2:
                        raise SimulatedCrash("driver killed at trial_validated #2")
                return orig(self, rec_type, **fields)

            monkeypatch.setattr(port_journal.ExperimentJournal, "append", append)
            with pytest.raises(SimulatedCrash):
                _driver(side, RANDOM, fake.url, tmp_path).run()
            monkeypatch.setattr(port_journal.ExperimentJournal, "append", orig)
        else:
            with inj.installed():
                with pytest.raises(SimulatedCrash):
                    _driver(side, RANDOM, fake.url, tmp_path).run()
        exp2 = _driver(side, RANDOM, fake.url, tmp_path)
        summary = exp2.resume()
        assert len(fake.trials) == 3
        return _normal(side, exp2, fake, tmp_path, summary)
    finally:
        fake.close()


def sc_pbt_clones(side, tmp_path, monkeypatch):
    fake = LockstepFake(expect=3, trial_plan=_loss_plan)
    try:
        exp = _driver(side, PBT, fake.url, tmp_path)
        summary = exp.run()
        out = _normal(side, exp, fake, tmp_path, summary)
        lineage = exp.searcher.method.lineage
        rid_of = {tid: t.request_id for tid, t in fake.trials.items()}
        out["clone_sources"] = sorted(
            (c["request_id"], lineage[c["request_id"]],
             rid_of[int(c["source_checkpoint"].split("-")[1])])
            for c in fake.create_calls if "source_checkpoint" in c)
        return out
    finally:
        fake.close()


def sc_single_slice_preflight(side, tmp_path, monkeypatch):
    raw = {"name": "ss", "entrypoint": ENTRY, "hyperparameters": {"lr": 0.1},
           "searcher": {"name": "single", "metric": "m", "max_length": {"batches": 2}},
           "resources": {"slots_per_trial": 4, "single_slice": True}}
    fake = FakeMaster(trial_plan=_loss_plan, agents=[
        {"id": "a0", "pool": "default", "slots": 2, "used_slots": 0},
        {"id": "a1", "pool": "default", "slots": 2, "used_slots": 0}])
    try:
        with pytest.raises(Exception) as info:
            _driver(side, raw, fake.url, tmp_path).run()
        return dict(error=type(info.value).__name__, message=str(info.value),
                    submitted=fake.exp_config is not None, trials=len(fake.trials))
    finally:
        fake.close()


def sc_outage_ridden_out(side, tmp_path, monkeypatch):
    monkeypatch.setattr(SIDES[side]["session"].Session, "RETRIES", 1)
    fake = FakeMaster(trial_plan=_loss_plan)
    outage = threading.Timer(0.3, fake.stop_serving)
    recovery = threading.Timer(1.8, fake.resume_serving)
    try:
        exp = _driver(side, ASHA, fake.url, tmp_path)
        outage.start()
        recovery.start()
        summary = exp.run()
    finally:
        outage.cancel()
        recovery.cancel()
        time.sleep(0)
        fake.close()
    assert all(r.metrics for r in exp.results.values())
    return dict(status=summary["status"], trials=summary["trials"],
                lost=sorted(rid for rid, r in exp.results.items() if not r.metrics),
                hparams=sorted((t.request_id, t.hparams) for t in fake.trials.values()))


def sc_grace_exhausted(side, tmp_path, monkeypatch):
    monkeypatch.setattr(SIDES[side]["session"].Session, "RETRIES", 1)
    fake = FakeMaster(trial_plan=_loss_plan)
    fake.customize = lambda t: setattr(t, "gated", True)
    killer = threading.Timer(0.3, fake.stop_serving)
    try:
        exp = _driver(side, OUTAGE, fake.url, tmp_path)
        killer.start()
        summary = exp.run()
    finally:
        killer.cancel()
        fake.close()
    return dict(status=summary["status"], trials=summary["trials"],
                stopped_early=sorted((rid, r.stopped_early) for rid, r in exp.results.items()),
                hparams=sorted((t.request_id, t.hparams) for t in fake.trials.values()))


SCENARIOS = [sc_asha_completes, sc_trial_error, sc_gang_teardown, sc_preempt_resume,
             sc_driver_crash_resume, sc_pbt_clones, sc_single_slice_preflight,
             sc_outage_ridden_out, sc_grace_exhausted]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_cluster_driver_matches_the_jax_driver(scenario, tmp_path, monkeypatch):
    got = {side: scenario(side, tmp_path, monkeypatch) for side in ("jax", "port")}
    if "message" in got["port"]:
        # the same refusal, raised as each package's InvalidExperimentConfig
        assert got["port"].pop("error") == got["jax"].pop("error") == "InvalidExperimentConfig"
    assert got["port"] == got["jax"]


def test_lockstep_asha_is_repeatable_and_spares_the_best_trial(tmp_path, monkeypatch):
    """The lockstep fake makes a run's decisions a function of the search
    alone: two runs of the port's driver stop the same trials at the same
    steps, and the best one (loss == lr: the smallest lr) reaches the top
    rung."""
    runs = [sc_asha_completes("port", tmp_path / str(i), monkeypatch) for i in range(2)]
    assert runs[0] == runs[1]
    out = runs[0]
    assert out["stops"] and out["summary"]["status"] == "completed"
    best = min(out["trials"], key=lambda t: t[1]["lr"])[0]
    assert out["summary"]["best_trial"] == best
    assert dict((rid, steps) for rid, _early, steps in out["results"])[best] == 8, out


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _promote(mod, session_mod, url):
    session = session_mod.Session(url, token="tok")
    return mod.promote_search_winner(
        session, model="lm", labels=["prod"], checkpoint_uuid="uuid-1",
        storage_path="/ck/trial_2/uuid-1", source_trial_id=2, source_experiment_id=7,
        metrics={"validation_loss": 0.25, "batches": 12})


def test_promote_search_winner_posts_the_jax_payloads():
    fakes = {"jax": RecordingMaster(), "port": RecordingMaster()}
    try:
        got = {"jax": _promote(jax_registry, jax_session_mod, fakes["jax"].url),
               "port": _promote(registry, port_session_mod, fakes["port"].url)}
        calls = {k: [(r["method"], r["path"], r["body"]) for r in f.calls()]
                 for k, f in fakes.items()}
        again = _promote(registry, port_session_mod, fakes["port"].url)  # the model exists
    finally:
        for f in fakes.values():
            f.close()
    assert got["port"] == got["jax"] == {"model": "lm", "version": 1,
                                         "checkpoint_uuid": "uuid-1", "target": "lm@v1"}
    assert calls["port"] == calls["jax"]
    assert calls["port"][-1] == ("POST", "/api/v1/models/lm/versions", {
        "checkpoint_uuid": "uuid-1", "storage_path": "/ck/trial_2/uuid-1",
        "source_trial_id": 2, "source_experiment_id": 7,
        "metrics": {"validation_loss": 0.25, "batches": 12}, "labels": ["prod"]})
    assert again["version"] == 2
    assert registry.parse_model_ref("lm@v3") == jax_registry.parse_model_ref("lm@v3") == ("lm", 3)
    assert registry.format_model_ref("lm", 3) == "lm@v3"


def test_local_experiment_promotes_through_a_master(tmp_path):
    fake = RecordingMaster()
    try:
        cfg = ExperimentConfig.parse({
            "hyperparameters": dict(lr=1e-3, hidden=16, global_batch_size=16, dataset_size=64),
            "searcher": {"name": "single", "metric": "validation_loss",
                         "max_length": {"batches": 4}},
            "min_validation_period": {"batches": 2},
            "registry": {"model": "mnist", "auto_promote": True, "labels": ["a"]},
        })
        exp = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path), device="cpu",
                              session=port_session_mod.Session(fake.url, token="tok"))
        summary = exp.run()
    finally:
        fake.close()
    assert summary["status"] == "completed" and "registry_error" not in summary
    assert summary["registry"]["target"] == "mnist@v1"
    sid = summary["registry"]["checkpoint_uuid"]
    assert os.path.isdir(tmp_path / "trial_1" / sid)
    body = fake.models["mnist"][0]
    assert body["storage_path"] == str(tmp_path / "trial_1" / sid)
    assert body["source_trial_id"] == 1 and body["labels"] == ["a"]
    replay = read_journal(journal_path(str(tmp_path)))
    assert [r for r in replay.records if r["type"] == "model_registered"]


def test_local_experiment_without_a_master_reports_registry_error(tmp_path, monkeypatch):
    monkeypatch.delenv("DTPU_MASTER", raising=False)
    cfg = ExperimentConfig.parse({
        "hyperparameters": dict(lr=1e-3, hidden=16, global_batch_size=16, dataset_size=64),
        "searcher": {"name": "single", "metric": "validation_loss",
                     "max_length": {"batches": 4}},
        "registry": {"model": "mnist", "auto_promote": True},
    })
    summary = LocalExperiment(cfg, MnistTrial, checkpoint_dir=str(tmp_path),
                              device="cpu").run()
    assert summary["status"] == "completed"
    assert "no master configured" in summary["registry_error"]


def test_invalid_experiment_config_is_the_ports_own():
    assert InvalidExperimentConfig.__module__ == "determined_tpu_torch.config.experiment"


# ---------------------------------------------------------------------------
# the CLI's cluster verbs
# ---------------------------------------------------------------------------


def test_cli_runs_detaches_and_resumes_a_cluster_search(tmp_path, monkeypatch, capsys):
    """``experiment run --cluster`` drives the search through the master at
    ``-m``; a SIGTERM detaches it (exit 75, the master keeps its trials);
    ``experiment status`` names the master; ``experiment resume`` of the
    directory re-attaches and finishes without creating a trial twice."""
    import signal

    import yaml

    from determined_tpu_torch.cli.main import main as cli

    class Gated(FakeMaster):
        def customize(self, trial):
            trial.plan = trial.plan[:1]
            trial.gated = True

    monkeypatch.setenv("DTPU_TOKEN", "t")  # ensure_session: no login, no token cache
    config = tmp_path / "asha.yaml"
    config.write_text(yaml.safe_dump(ASHA))
    driver = str(tmp_path / "driver")
    fake = Gated(trial_plan=_loss_plan)
    done = threading.Event()

    def sigterm_once_trials_run():
        # the driver installs its handlers before it submits a trial
        while not done.is_set():
            with fake.lock:
                running = [t for t in fake.trials.values() if t.revealed]
            if running:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    try:
        killer = threading.Thread(target=sigterm_once_trials_run, daemon=True)
        killer.start()
        try:
            code = cli(["-m", fake.url, "experiment", "run", str(config), "--cluster",
                        "--checkpoint-dir", driver])
        finally:
            done.set()
            killer.join(5)
        assert code == 75
        assert cli(["experiment", "status", driver]) == 0
        assert f"experiment 1 at {fake.url}" in capsys.readouterr().out
        with fake.lock:
            for t in fake.trials.values():
                t.gated = False
        assert cli(["experiment", "resume", driver]) == 0  # the journal names the master
        out = capsys.readouterr().out
        summary = json.loads(out[out.index("{"):])
    finally:
        fake.close()
    assert summary["status"] == "completed" and summary["trials"] == 4
    assert summary["master_url"] == fake.url and len(fake.trials) == 4
    assert fake.searcher_shutdown
