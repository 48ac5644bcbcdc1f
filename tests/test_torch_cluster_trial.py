"""The trial side of the port's cluster path (core.init under the master,
core/_metrics.py, _train.py, _preempt.py, _checkpoint.py, _heartbeat.py,
exec/run_trial.py) against the JAX package's, on the CPU, both talking to
a recording stand-in for the native master (tests/torch_cluster_master.py):

- in process: ``core.init(info=...)`` builds the cluster context on each
  side, and ``Trainer(MnistTrial)`` trains from the same weights (the flax
  initialisation carried to the port through ``convert``) and batches.
  Both post the same metric rows (group, step, keys; losses within
  ``test_torch_training.F32_TOL``, accuracies within 1e-6) to
  ``/api/v1/trials/metrics``, the same progress, and the same checkpoint
  records by step to ``/api/v1/checkpoints``.  A preemption signalled by
  the master at the same step makes both stop at the same step, save
  there and acknowledge it;
- as a subprocess: each package's ``run_trial`` (``python -m
  determined_tpu[_torch].exec.run_trial``, the JAX one on JAX's CPU, the
  port's with ``DTPU_TORCH_DEVICE=cpu``) makes the same request sequence:
  method, path, metric group and step, checkpoint steps and its exit code.
  Values are not compared there (each side draws its own initial weights:
  a known difference).  A job on an external resource manager
  (``DTPU_SHIP_LOGS``) ships its own output and exit as the JAX one does,
  and a task there (``DTPU_TASK_TYPE``) runs only the port's counterpart
  of its module;
- the heartbeat's failure streak and ``master_unreachable`` latch as the
  JAX reporter's, the log shipper's batches to ``/api/v1/logs``, and
  ``DistributedContext.from_rendezvous`` over gloo in two processes (and
  its refusal of a node of several slots).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.core._cluster_info import ClusterInfo as JaxClusterInfo
from determined_tpu.core._heartbeat import HeartbeatReporter as JaxHeartbeat
from determined_tpu.models.mnist import MnistTrial as JaxMnistTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu.utils import faults as jax_faults
from determined_tpu_torch import core, train
from determined_tpu_torch.convert import mnist_state_dict_from_flax
from determined_tpu_torch.core import ClusterInfo, HeartbeatReporter, LogShipper
from determined_tpu_torch.models import MnistTrial
from determined_tpu_torch.train import Callback
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_training import F32_TOL
from tests.torch_cluster_master import RecordingMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = dict(lr=1e-3, hidden=32, global_batch_size=16, dataset_size=128)
STEPS, PERIOD = 8, 4
# host-clock keys: every run's own
TIMING = ("samples_per_second",)


def _info(cls, url, store):
    return cls(master_url=url, trial_id=5, experiment_id=2, allocation_id="alloc-5",
               session_token="tok", trial_seed=0,
               exp_config={"checkpoint_storage": {"type": "shared_fs", "host_path": store}})


def _init_params():
    ctx = jax_train.init(hparams=HP, mesh_config=MeshConfig(data=1),
                         core_context=jax_core._dummy_init(), seed=0,
                         devices=jax.devices()[:1])
    trainer = jax_train.Trainer(JaxMnistTrial(ctx))
    trainer._setup()
    return jax.device_get(trainer.state.params)


class _Hook:
    """Signals preemption at the master before ``step`` runs, then waits
    until the trial's watcher has the signal."""

    def __init__(self, fake, step, watcher):
        self.fake, self.step, self.watcher = fake, step, watcher

    def fire(self, site, **info):
        if site == "train.step" and info.get("step") == self.step:
            self.fake.preempt()
            deadline = time.monotonic() + 30
            while not self.watcher().preempted:
                assert time.monotonic() < deadline
                time.sleep(0.01)


def _jax_run(fake, store, preempt_at):
    ctx = jax_core.init(info=_info(JaxClusterInfo, fake.url, store), metrics_path=None)
    try:
        tctx = jax_train.init(hparams=HP, mesh_config=MeshConfig(data=1), core_context=ctx,
                              seed=0, devices=jax.devices()[:1])
        if preempt_at is not None:
            jax_faults.set_fault_injector(_Hook(fake, preempt_at, lambda: ctx.preempt._watcher))
        try:
            return jax_train.Trainer(JaxMnistTrial(tctx)).fit(
                STEPS, validation_period=PERIOD, checkpoint_period=PERIOD, report_period=2)
        finally:
            jax_faults.set_fault_injector(None)
    finally:
        ctx.close()


def _port_run(fake, store, preempt_at, weights):
    ctx = core.init(info=_info(ClusterInfo, fake.url, store), device="cpu")
    try:
        tctx = train.init(hparams=HP, core_context=ctx, seed=0, device="cpu")

        class FromFlax(MnistTrial):
            def build_callbacks(self):
                class Load(Callback):
                    def on_training_start(self, trainer):
                        trainer.model.load_state_dict(
                            {k: torch.tensor(v) for k, v in weights.items()}, strict=True)

                return {"load": Load()}

        if preempt_at is not None:
            faults.set_fault_injector(_Hook(fake, preempt_at, lambda: ctx.preempt._watcher))
        try:
            return train.Trainer(FromFlax(tctx)).fit(
                STEPS, validation_period=PERIOD, checkpoint_period=PERIOD, report_period=2)
        finally:
            faults.set_fault_injector(None)
    finally:
        ctx.close()


def _by_path(fake, path):
    return [r for r in fake.calls() if r["path"] == path]


@pytest.mark.parametrize("preempt_at", [None, 2], ids=["full", "preempted"])
def test_cluster_context_reports_as_the_jax_one(preempt_at, tmp_path):
    weights = mnist_state_dict_from_flax(_init_params())
    fakes = {"jax": RecordingMaster(), "port": RecordingMaster()}
    try:
        jax_summary = _jax_run(fakes["jax"], str(tmp_path / "jax"), preempt_at)
        port_summary = _port_run(fakes["port"], str(tmp_path / "port"), preempt_at, weights)
    finally:
        for f in fakes.values():
            f.close()
    stop = STEPS if preempt_at is None else 4  # the first boundary after the signal
    assert port_summary["steps_completed"] == jax_summary["steps_completed"] == stop
    assert port_summary["stopped_early"] == jax_summary["stopped_early"] == (stop < STEPS)

    rows = {k: f.metric_rows() for k, f in fakes.items()}
    assert [(r["group"], r["steps_completed"], sorted(r["metrics"])) for r in rows["port"]] == \
        [(r["group"], r["steps_completed"], sorted(r["metrics"])) for r in rows["jax"]]
    assert {r["group"] for r in rows["port"]} == {"training", "validation"}
    for got, want in zip(rows["port"], rows["jax"]):
        assert (got["trial_id"], got["trial_run_id"]) == (want["trial_id"], want["trial_run_id"])
        for k, v in want["metrics"].items():
            if k in TIMING:
                continue
            tol = dict(atol=1e-6) if "accuracy" in k else F32_TOL["loss"]
            np.testing.assert_allclose(got["metrics"][k], v, **tol, err_msg=k)

    ckpts = {k: [r["body"] for r in _by_path(f, "/api/v1/checkpoints")]
             for k, f in fakes.items()}
    assert [c["metadata"]["steps_completed"] for c in ckpts["port"]] == \
        [c["metadata"]["steps_completed"] for c in ckpts["jax"]]
    assert [c["trial_id"] for c in ckpts["port"]] == [5] * len(ckpts["jax"])
    for c in ckpts["port"]:
        assert os.path.isfile(tmp_path / "port" / c["uuid"] / "manifest.json")
    progress = {k: [r["body"]["progress"] for r in f.calls()
                    if r["path"] == "/api/v1/trials/5/progress"] for k, f in fakes.items()}
    assert progress["port"] == pytest.approx(progress["jax"])
    acks = {k: len(_by_path(f, "/api/v1/allocations/alloc-5/signals/ack_preemption"))
            for k, f in fakes.items()}
    assert acks["port"] == acks["jax"] == (0 if preempt_at is None else 1)


# ---------------------------------------------------------------------------
# run_trial as the agent runs it
# ---------------------------------------------------------------------------


def _trial_env(url, store, package):
    exp = {
        "name": "run-trial", "searcher": {"name": "single", "metric": "validation_loss",
                                          "max_length": {"batches": STEPS}},
        "min_validation_period": {"batches": PERIOD},
        "min_checkpoint_period": {"batches": PERIOD},
        "checkpoint_storage": {"type": "shared_fs", "host_path": store},
        "environment": {"env": {"JAX_PLATFORMS": "cpu"} if package == "jax"
                        else {"DTPU_TORCH_DEVICE": "cpu"}},
    }
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DTPU_") and k not in ("PYTHONPATH",)}
    env.update(
        PYTHONPATH=REPO, DTPU_MASTER_URL=url, DTPU_TRIAL_ID="5", DTPU_EXPERIMENT_ID="2",
        DTPU_ALLOCATION_ID="alloc-5", DTPU_SESSION_TOKEN="tok", DTPU_HPARAMS=json.dumps(HP),
        DTPU_EXP_CONFIG=json.dumps(exp), DTPU_TRIAL_SEED="3", DTPU_TRIAL_RUN_ID="0",
        DTPU_NUM_SLOTS="1", DTPU_AGENT_ID="agent-0", DTPU_SELF_REPORT_EXIT="1",
        DTPU_RENDEZVOUS=json.dumps({"coordinator": "127.0.0.1:1", "num_nodes": 1,
                                    "node_rank": 0}),
    )
    return env


def _sequence(fake):
    """(method, path, group, step) of every request, metric batches opened
    row by row; checkpoint records by their step.  The metrics shipper
    posts from its own thread, so the sequence is kept per route (the order
    within each), with the exit report last."""
    out = []
    for r in fake.calls():
        if r["path"] == "/api/v1/trials/metrics":
            out += [("POST", r["path"], m["group"], m["steps_completed"])
                    for m in r["body"]["metrics"]]
        elif r["path"] == "/api/v1/checkpoints":
            out.append(("POST", r["path"], None, r["body"]["metadata"]["steps_completed"]))
        elif r["path"].endswith("/exit"):
            out.append((r["method"], r["path"], None, r["body"]["exit_code"]))
        else:
            out.append((r["method"], r["path"], None, None))
    return sorted(out[:-1], key=lambda c: c[1]) + out[-1:]


def test_run_trial_makes_the_jax_request_sequence(tmp_path):
    runs = {}
    for package, entry in (("jax", "determined_tpu.models.mnist:MnistTrial"),
                           ("port", "determined_tpu_torch.models.mnist:MnistTrial")):
        fake = RecordingMaster()
        try:
            mod = "determined_tpu" if package == "jax" else "determined_tpu_torch"
            proc = subprocess.run(
                [sys.executable, "-m", f"{mod}.exec.run_trial", entry],
                env=_trial_env(fake.url, str(tmp_path / package), package), cwd=tmp_path,
                capture_output=True, text=True, timeout=300)
            runs[package] = (proc.returncode, _sequence(fake), proc.stderr[-3000:])
        finally:
            fake.close()
    (jax_code, jax_seq, jax_err), (code, seq, err) = runs["jax"], runs["port"]
    assert jax_code == 0, jax_err
    assert code == 0, err
    assert seq == jax_seq
    groups = {(p, g) for _m, p, g, _s in seq}
    assert ("/api/v1/trials/metrics", "validation") in groups
    assert seq[-1] == ("POST", "/api/v1/trials/5/exit", None, 0)
    assert [s for _m, p, _g, s in seq if p == "/api/v1/checkpoints"] == [PERIOD, STEPS]
    assert "device: cpu (DTPU_TORCH_DEVICE=cpu)" in err


def test_run_trial_raises_without_a_gpu_or_the_device_variable(tmp_path):
    fake = RecordingMaster()
    try:
        env = _trial_env(fake.url, str(tmp_path), "port")
        env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, on any host
        exp = json.loads(env["DTPU_EXP_CONFIG"])
        exp["environment"] = {}
        env["DTPU_EXP_CONFIG"] = json.dumps(exp)
        proc = subprocess.run(
            [sys.executable, "-m", "determined_tpu_torch.exec.run_trial",
             "determined_tpu_torch.models.mnist:MnistTrial"],
            env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    finally:
        fake.close()
    assert proc.returncode == 1
    assert "runs on a CUDA device and none is available" in proc.stderr
    assert not fake.metric_rows()
    assert fake.calls()[-1]["body"]["exit_code"] == 1


@pytest.mark.parametrize("knob", [{"strict": True}, {"thread_sentinel": True},
                                  {"collective_sentinel": True}, {"retrace_sentinel": True}])
def test_run_trial_lint_knobs_raise_naming_the_later_slice(tmp_path, knob):
    env = _trial_env("http://127.0.0.1:1", str(tmp_path), "port")
    exp = json.loads(env["DTPU_EXP_CONFIG"])
    exp["lint"] = knob
    env["DTPU_EXP_CONFIG"] = json.dumps(exp)
    env.pop("DTPU_SELF_REPORT_EXIT")
    proc = subprocess.run(
        [sys.executable, "-m", "determined_tpu_torch.exec.run_trial",
         "determined_tpu_torch.models.mnist:MnistTrial"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "NotImplementedError" in proc.stderr and "later slice" in proc.stderr


def _external_env(**extra):
    """The variables the master sets for a job on an external resource
    manager (no agent: the process ships its own logs and exit)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DTPU_") and k not in ("PYTHONPATH",)}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def test_run_trial_ships_its_own_logs_and_exit_as_the_jax_one(tmp_path):
    runs = {}
    for package in ("jax", "port"):
        fake = RecordingMaster()
        try:
            mod = "determined_tpu" if package == "jax" else "determined_tpu_torch"
            env = _external_env(
                DTPU_MASTER_URL=fake.url, DTPU_TRIAL_ID="5", DTPU_ALLOCATION_ID="alloc-5",
                DTPU_SESSION_TOKEN="tok", DTPU_AGENT_ID="kubernetes:pool",
                DTPU_SHIP_LOGS="1", DTPU_SELF_REPORT_EXIT="1")
            # no trial argument: the usage line, exit 2
            proc = subprocess.run([sys.executable, "-m", f"{mod}.exec.run_trial"], env=env,
                                  cwd=tmp_path, capture_output=True, text=True, timeout=120)
            calls = [(r["method"], r["path"], r["body"]) for r in fake.calls()]
        finally:
            fake.close()
        runs[package] = (proc.returncode, proc.stdout, calls)
    for package, (code, stdout, calls) in runs.items():
        assert code == 2, (package, calls)
        assert stdout == ""  # fd 1 goes to the master, not the pipe
        logs = [b for _m, p, b in calls if p == "/api/v1/logs"]
        assert [b["batch_seq"] for b in logs] == list(range(len(logs)))
        assert {(b["agent"], b["trial_id"], b["allocation_id"]) for b in logs} == {
            ("kubernetes:pool", 5, "alloc-5")}
        lines = [ln.replace("determined_tpu_torch.", "determined_tpu.")
                 for b in logs for ln in b["lines"]]
        assert lines == ["usage: python -m determined_tpu.exec.run_trial "
                         "pkg.module:TrialClass"], (package, lines)
        assert calls[-1] == ("POST", "/api/v1/trials/5/exit",
                             {"exit_code": 2, "allocation_id": "alloc-5"})
    assert [(m, p) for m, p, _b in runs["port"][2]] == [(m, p) for m, p, _b in runs["jax"][2]]


@pytest.mark.parametrize("named, code", [
    ("determined_tpu.exec.gc_checkpoints", 0),    # the port's counterpart runs
    ("determined_tpu_torch.exec.gc_checkpoints", 0),
    ("determined_tpu.exec.serve_replica", 1),     # the port's replica runs; no storage: 1
    ("determined_tpu.exec.shell", 2),             # the port lacks it: refused
    ("determined_tpu.exec.run_trial", 2),         # not a task: refused
    ("json.tool", 2),                             # outside the port: refused
])
def test_run_trial_dispatches_a_task_to_the_ports_module_only(tmp_path, named, code):
    store = tmp_path / "store"
    (store / "ck-1").mkdir(parents=True)
    (store / "ck-1" / "state.pt").write_bytes(b"x")
    spec = {"storage": {"type": "shared_fs", "host_path": str(store)}, "uuids": ["ck-1"]}
    env = _external_env(DTPU_TASK_TYPE="gc", DTPU_TASK_MODULE=named,
                        DTPU_GC_SPEC=json.dumps(spec))
    proc = subprocess.run([sys.executable, "-m", "determined_tpu_torch.exec.run_trial"],
                          env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stderr
    if code == 0:
        assert not (store / "ck-1").exists()
        assert "gc: deleted checkpoint ck-1" in proc.stderr
    elif code == 1:
        assert (store / "ck-1").exists()
        assert "serve replica: storage path '' is not a directory" in proc.stderr
    else:
        assert (store / "ck-1").exists()
        assert f"task module {named!r} has no counterpart in determined_tpu_torch" in proc.stderr


# ---------------------------------------------------------------------------
# heartbeat, log shipper
# ---------------------------------------------------------------------------


class _Flaky:
    """A session whose POSTs fail while ``down`` is set."""

    def __init__(self):
        self.down, self.posts = False, []

    def post(self, path, **kw):
        self.posts.append(path)
        if self.down:
            raise ConnectionError("master down")


def test_heartbeat_latches_and_clears_as_the_jax_reporter():
    flaky = {"jax": _Flaky(), "port": _Flaky()}
    hb = {"jax": JaxHeartbeat(flaky["jax"], 5, failure_threshold=3),
          "port": HeartbeatReporter(flaky["port"], 5, failure_threshold=3)}
    trace = {k: [] for k in hb}
    for down in (False, True, True, True, True, False, True):
        for k, h in hb.items():
            flaky[k].down = down
            ok = h._beat()
            trace[k].append((ok, h.failure_streak, h.master_unreachable))
    assert trace["port"] == trace["jax"]
    assert trace["port"][3] == (False, 3, True) and trace["port"][5] == (True, 0, False)
    assert flaky["port"].posts == ["/api/v1/trials/5/heartbeat"] * 7
    assert hb["port"].beats == 2


def test_heartbeat_beats_every_interval(monkeypatch):
    monkeypatch.setattr(HeartbeatReporter, "INTERVAL", 0.05)
    flaky = _Flaky()
    hb = HeartbeatReporter(flaky, 9).start()
    try:
        deadline = time.monotonic() + 10
        while hb.beats < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        hb.close()
    assert set(flaky.posts) == {"/api/v1/trials/9/heartbeat"}


def test_log_shipper_ships_stdout_lines_to_the_masters_log_route(capsys):
    fake = RecordingMaster()
    try:
        from determined_tpu_torch.api import Session

        shipper = LogShipper(Session(fake.url, token="tok"), "task-1").start()
        print("first line")
        print("second", "line")
        shipper.close()
        calls = [r for r in fake.calls() if r["path"] == "/api/v1/logs"]
    finally:
        fake.close()
    lines = [ln for r in calls for ln in r["body"]["lines"]]
    assert {r["body"]["task_id"] for r in calls} == {"task-1"}
    assert lines == ["[stdout] first line", "[stdout] second line"]
    assert "first line" in capsys.readouterr().out  # still teed to the stream


# ---------------------------------------------------------------------------
# the master's rendezvous
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent(
    """
    import json, os, sys
    import torch, torch.distributed as tdist
    from determined_tpu_torch.core import DistributedContext

    ctx = DistributedContext.from_rendezvous(device="cpu")
    t = torch.tensor([float(ctx.rank + 1)])
    tdist.all_reduce(t)
    print(json.dumps(dict(rank=ctx.rank, size=ctx.size, backend=ctx.backend,
                          star=ctx.allgather(ctx.rank), chief=ctx.broadcast("c%d" % ctx.rank),
                          sum=t.item())))
    ctx.close()
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_from_rendezvous_joins_the_masters_gang_over_gloo():
    coord, chief = _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("DTPU_")}
        env.update(PYTHONPATH=REPO, DTPU_NUM_SLOTS="1", DTPU_CHIEF_ADDR="127.0.0.1",
                   DTPU_CHIEF_PORT=str(chief),
                   DTPU_RENDEZVOUS=json.dumps({"coordinator": f"127.0.0.1:{coord}",
                                               "num_nodes": 2, "node_rank": rank}))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rank, o in enumerate(outs):
        assert o == dict(rank=rank, size=2, backend="gloo", star=[0, 1], chief="c0", sum=3.0)


def test_from_rendezvous_of_one_node_is_a_single_rank_and_refuses_several_slots(monkeypatch):
    monkeypatch.setenv("DTPU_RENDEZVOUS", json.dumps(
        {"coordinator": "127.0.0.1:1", "num_nodes": 1, "node_rank": 0}))
    monkeypatch.setenv("DTPU_NUM_SLOTS", "1")
    ctx = core.DistributedContext.from_rendezvous(device="cpu")
    assert (ctx.rank, ctx.size, ctx.backend) == (0, 1, None)
    # several slots run as local ranks (tests/test_torch_local_ranks.py):
    # outside run_trial's local rank processes, a node of two slots refuses
    monkeypatch.setenv("DTPU_NUM_SLOTS", "2")
    monkeypatch.delenv("DTPU_LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="one local rank process a slot"):
        core.DistributedContext.from_rendezvous(device="cpu")
