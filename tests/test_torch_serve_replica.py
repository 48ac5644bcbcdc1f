"""Serving replicas of the port (``serve/replica.py``, ``ServeWorker``'s
registration, ``exec/serve_replica.py``, the launcher's mapping) against
the JAX package's, on the CPU, each talking to its own recording stand-in
for the native master (tests/torch_cluster_master.py):

- ``ReplicaRegistration``: both packages make the same requests (method,
  path, body) to register, heartbeat their stats and deregister; after a
  master restart both re-register; both ride out a killed master (the
  port's session raises the built-in ``ConnectionError``, which the
  heartbeat catches: the thread lives); both back off a shedding master by
  the same delays under a seeded ``random`` and recover; both deliver a
  rolling deploy's drain once;
- ``ServeWorker``: its registration carries the registry version and the
  task id, its heartbeats the engine's stats, and the master's drain
  reaches it, as JAX's worker over the same weights;
- ``exec/serve_replica`` as the agent runs it, on a tiny checkpoint of the
  port with ``DTPU_TORCH_DEVICE=cpu`` in the task config's ``env``: it
  reports ready, registers with its task id, serves the tokens of an
  in-process engine over the same checkpoint, prints its launch counts,
  and drains on SIGTERM or the master's word (exit 75, deregistered).  A
  missing storage directory and a bad serve config exit as the JAX module
  does (1 and 2, the same stderr line); without the device variable on
  this GPU-less host it exits 1 naming the device and serves nothing.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import meta as flax_meta

from determined_tpu import serve as jax_serve
from determined_tpu.api.session import Session as JaxSession
from determined_tpu.models import transformer as jax_tf
from determined_tpu.serve.replica import ReplicaRegistration as JaxRegistration
from determined_tpu_torch import core, serve, train
from determined_tpu_torch.api.session import Session
from determined_tpu_torch.convert import load_flax_params
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from determined_tpu_torch.serve import ReplicaRegistration
from determined_tpu_torch.serve import replica as port_replica
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_cluster_master import RecordingMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (JaxSession, JaxRegistration), "port": (Session, ReplicaRegistration)}
REG_KW = dict(url="http://127.0.0.1:9/replica", model="lm@v2", checkpoint="/ck/2",
              model_name="lm", model_version=2, task_id="task-7")
WAIT_S = 30.0


def _until(what, fn, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not fn():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _requests(fake):
    return [(r["method"], r["path"], r["body"]) for r in fake.calls()]


@pytest.fixture
def fakes():
    made = {"jax": RecordingMaster(), "port": RecordingMaster()}
    yield made
    for fake in made.values():
        fake.close()


# ---------------------------------------------------------------------------
# ReplicaRegistration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deregister", [True, False], ids=["deregister", "keep"])
def test_registration_heartbeats_and_close_as_the_jax_replica(fakes, deregister):
    seen = {}
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        fake, beats = fakes[pkg], iter(range(1000))
        reg = reg_cls(session_cls(fake.url, token="tok"), heartbeat_interval_s=0.02,
                      stats_fn=lambda: {"beat": next(beats), "queue_depth": 0}, **REG_KW)
        reg.start()
        _until("three heartbeats", lambda: len(fake.heartbeats()) >= 3)
        rid = reg.replica_id
        reg.close(deregister=deregister)
        assert reg.replica_id is None and reg._thread is None
        seen[pkg] = (rid, _requests(fake),
                     [(r["path"], r["body"]) for r in fake.heartbeats()[:3]])
    assert seen["port"] == seen["jax"]
    rid, calls, beats = seen["port"]
    assert rid == "replica-1"
    assert calls[0] == ("POST", "/api/v1/serving/replicas", {
        "url": REG_KW["url"], "model": "lm@v2", "checkpoint": "/ck/2", "model_name": "lm",
        "model_version": 2, "task_id": "task-7"})
    assert calls[1:] == ([("DELETE", "/api/v1/serving/replicas/replica-1", None)]
                         if deregister else [])
    assert beats == [("/api/v1/serving/replicas/replica-1/heartbeat",
                      {"stats": {"beat": i, "queue_depth": 0}}) for i in range(3)]


def test_registration_without_a_registry_version_posts_url_model_checkpoint(fakes):
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        reg_cls(session_cls(fakes[pkg].url), url="http://h:1", model="LMTrial").register()
    assert _requests(fakes["port"]) == _requests(fakes["jax"]) == [
        ("POST", "/api/v1/serving/replicas",
         {"url": "http://h:1", "model": "LMTrial", "checkpoint": ""})]


def test_replica_rides_out_a_killed_master_and_reregisters_after_restart(fakes, caplog):
    """The master dies (connection refused) and comes back with no
    replicas: the heartbeat thread lives through the outage, its next beat
    is answered 404, and it registers again under a new id."""
    caplog.set_level("WARNING", logger="determined_tpu_torch.serve.replica")
    seen = {}
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        fake = fakes[pkg]
        reg = reg_cls(session_cls(fake.url, token="tok"), heartbeat_interval_s=0.02, **REG_KW)
        reg.start()
        _until("a heartbeat", lambda: len(fake.heartbeats()) >= 1)
        fake.kill()
        time.sleep(0.3)  # ~15 beats refused
        assert reg._thread.is_alive(), f"{pkg}: the heartbeat died with the master"
        assert reg.replica_id == "replica-1"
        fake.restart()
        _until("re-registration", lambda: reg.replica_id == "replica-2")
        _until("a beat of the new id",
               lambda: any(r["path"].endswith("replica-2/heartbeat") for r in fake.heartbeats()))
        reg.close()
        seen[pkg] = _requests(fake)
    assert seen["port"] == seen["jax"]
    assert [(m, p) for m, p, _ in seen["port"]] == [
        ("POST", "/api/v1/serving/replicas"), ("POST", "/api/v1/serving/replicas"),
        ("DELETE", "/api/v1/serving/replicas/replica-2")]
    # the port's heartbeat caught its session's ConnectionError as an outage
    assert any("master unreachable" in r.getMessage() for r in caplog.records
               if r.name == "determined_tpu_torch.serve.replica")


def test_close_while_the_master_is_down_keeps_the_thread_from_raising(fakes):
    """Deregistration against a dead master is a warning, not an error:
    the port catches its session's ConnectionError as JAX catches requests'."""
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        fake = fakes[pkg]
        session = session_cls(fake.url, token="tok")
        session.RETRIES, session.BACKOFF = 2, 0.01
        reg = reg_cls(session, heartbeat_interval_s=0.02, **REG_KW).start()
        fake.kill()
        reg.close()  # raises nothing
        assert reg.replica_id is None


@pytest.mark.parametrize("throttled, retry_after", [
    (1, None), (2, None), (3, None), (6, None), (12, None), (3, "7"), (3, "0"),
    (2, "Wed, 21 Oct 2026 07:28:00 GMT"),
])
def test_throttle_delay_equals_the_jax_replicas_under_a_seeded_random(throttled, retry_after):
    delays = {}
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        reg = reg_cls(session_cls("http://127.0.0.1:9"), heartbeat_interval_s=2.0, **REG_KW)
        reg.throttled = throttled
        random.seed(1234)
        delays[pkg] = reg._throttle_delay(retry_after)
    assert delays["port"] == delays["jax"]
    assert delays["port"] <= port_replica.MAX_THROTTLE_S
    if retry_after in ("7", "0"):
        assert delays["port"] == float(retry_after)


def test_shedding_master_stretches_heartbeats_and_they_recover(fakes):
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        fake = fakes[pkg]
        fake.throttle = "0.02"
        reg = reg_cls(session_cls(fake.url, token="tok"), heartbeat_interval_s=0.02, **REG_KW)
        reg.start()
        _until(f"{pkg}: three shed beats", lambda: reg.throttled >= 3)
        fake.throttle = None
        _until(f"{pkg}: the streak cleared", lambda: reg.throttled == 0)
        assert reg._thread.is_alive()
        reg.close()


def test_rolling_deploy_drain_is_delivered_once(fakes):
    deploy = {"model": "lm", "version": 3, "target": "lm@v3", "checkpoint_uuid": "u3",
              "storage_path": "/ck/3"}
    seen = {}
    for pkg, (session_cls, reg_cls) in PACKAGES.items():
        fake, drains = fakes[pkg], []
        reg = reg_cls(session_cls(fake.url, token="tok"), heartbeat_interval_s=0.02,
                      on_drain=drains.append, **REG_KW)
        reg.start()
        fake.drain["replica-1"] = deploy
        _until("the drain", reg.drain_requested.is_set)
        n = len(fake.heartbeats())
        _until("three more drain answers", lambda: len(fake.heartbeats()) >= n + 3)
        reg.close()
        seen[pkg] = (drains, reg.drain_info)
    assert seen["port"] == seen["jax"] == ([deploy], deploy)


# ---------------------------------------------------------------------------
# ServeWorker
# ---------------------------------------------------------------------------

SERVE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_prompt_len=16,
                max_new_tokens=8, queue_depth=4, heartbeat_interval_s=0.05)
MODEL_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)


def _engines():
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, attention_impl="reference", **MODEL_KW)
    variables = flax_meta.unbox(
        jax_tf.TransformerLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    model = TransformerLM(TransformerConfig(dtype=torch.float32, **MODEL_KW), device="cpu")
    load_flax_params(model, variables)
    return {
        "jax": (jax_serve, JaxSession, jax_serve.ServeEngine(jax_serve.DecodeKernels(
            jcfg, variables, jax_serve.ServeConfig(**SERVE_KW)))),
        "port": (serve, Session, serve.ServeEngine(serve.DecodeKernels(
            model, serve.ServeConfig(**SERVE_KW), device="cpu"))),
    }


def test_serve_worker_registers_its_registry_version_and_takes_the_masters_drain(fakes):
    seen = {}
    deploy = {"target": "lm@v3", "version": 3}
    for pkg, (ns, session_cls, engine) in _engines().items():
        fake = fakes[pkg]
        worker = ns.ServeWorker(engine, port=0, session=session_cls(fake.url, token="tok"),
                                model="lm@v2", checkpoint="/ck/2", model_name="lm",
                                model_version=2, task_id="task-4")
        url = worker.start()
        try:
            _until("a heartbeat with stats",
                   lambda: any((r["body"] or {}).get("stats") for r in fake.heartbeats()))
            assert worker.stats()["replica_id"] == "replica-1"
            assert not worker.master_drain_requested()
            fake.drain["replica-1"] = deploy
            _until("the master's drain", worker.master_drain_requested)
            stats = fake.heartbeats()[0]["body"]["stats"]
            worker.request_drain()
            assert worker.wait_drained(timeout=30)
        finally:
            worker.shutdown()
        assert worker.replica is None
        calls = _requests(fake)
        assert calls[0][2]["url"] == url
        seen[pkg] = ([(m, p, {k: v for k, v in (b or {}).items() if k != "url"})
                      for m, p, b in calls], worker.master_drain_info, sorted(stats))
    assert seen["port"] == seen["jax"]
    calls, info, stat_keys = seen["port"]
    assert calls == [
        ("POST", "/api/v1/serving/replicas", {"model": "lm@v2", "checkpoint": "/ck/2",
                                             "model_name": "lm", "model_version": 2,
                                             "task_id": "task-4"}),
        ("DELETE", "/api/v1/serving/replicas/replica-1", {})]
    assert info == deploy
    assert {"queue_depth", "queue_capacity", "kv_utilization", "failed", "draining"} <= set(
        stat_keys)


def test_serve_worker_without_a_session_registers_nothing():
    engine = _engines()["port"][2]
    worker = serve.ServeWorker(engine, port=0)
    worker.start()
    try:
        assert worker.replica is None and "replica_id" not in worker.stats()
    finally:
        worker.shutdown()


# ---------------------------------------------------------------------------
# exec/serve_replica, as the agent runs it
# ---------------------------------------------------------------------------

HP = dict(lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=128, d_model=32, n_layers=2,
          n_heads=4, n_kv_heads=2, dataset_size=16, attention="reference", fused_ce=False,
          fused_adamw=True, warmup_steps=1, bf16=False)
REPLICA_SERVE = dict(block_size=4, num_blocks=48, max_batch=2, max_prompt_len=16,
                     max_new_tokens=6, heartbeat_interval_s=0.1)
PROMPTS = [[3, 14, 15, 9, 2, 6], list(range(20, 33)), [7]]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    ctx = train.init(hparams=dict(HP), seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(root / "ckpts")))
    summary = train.Trainer(LMTrial(ctx)).fit(max_length=2, checkpoint_policy="best")
    return str(root / "ckpts" / summary["latest_checkpoint"])


def _expected_tokens(path):
    eng = serve.ServeEngine.from_checkpoint(path, serve.ServeConfig(**REPLICA_SERVE),
                                            device="cpu")
    reqs = [eng.submit(p, max_new_tokens=REPLICA_SERVE["max_new_tokens"]) for p in PROMPTS]
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step_once()
    return [list(r.output) for r in reqs]


def _replica_env(fake, config, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DTPU_TORCH_DEVICE")}
    env.update(PYTHONPATH=REPO, DTPU_MASTER_URL=fake.url, DTPU_TASK_ID="task-9",
               DTPU_SESSION_TOKEN="tok", DTPU_TASK_PORT="0",
               DTPU_TASK_CONFIG=json.dumps(config), JAX_PLATFORMS="cpu", **extra)
    return env


def _spawn(module, env, cwd):
    return subprocess.Popen([sys.executable, "-u", "-m", module], env=env, cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class _Lines:
    """The replica's output, read on a thread, for the test to wait on."""

    def __init__(self, proc):
        self.lines = []
        self._t = threading.Thread(target=self._read, args=(proc,), daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def find(self, prefix, timeout=120.0):
        _until(f"a line {prefix!r}:\n" + "\n".join(self.lines),
               lambda: any(ln.startswith(prefix) for ln in self.lines), timeout)
        return [ln for ln in self.lines if ln.startswith(prefix)][-1]

    def join(self):
        self._t.join(30)


def _generate(url, prompt):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST", headers={"Content-Type": "application/json"},
        data=json.dumps({"prompt_tokens": prompt,
                         "max_new_tokens": REPLICA_SERVE["max_new_tokens"]}).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["tokens"]


@pytest.mark.parametrize("drain_by", ["sigterm", "master"])
def test_serve_replica_serves_the_checkpoints_tokens_and_drains_to_75(
        checkpoint, tmp_path, drain_by):
    fake = RecordingMaster()
    config = {"model": "lm", "version": 2, "checkpoint_uuid": "u2", "storage_path": checkpoint,
              "fleet_slot": 0, "serve": REPLICA_SERVE, "env": {"DTPU_TORCH_DEVICE": "cpu"}}
    proc = _spawn("determined_tpu_torch.exec.serve_replica", _replica_env(fake, config),
                  tmp_path)
    out = _Lines(proc)
    try:
        url = out.find("serving on ").split("serving on ", 1)[1]
        assert any("device: cpu (DTPU_TORCH_DEVICE=cpu)" in ln for ln in out.lines), out.lines
        got = [_generate(url, p) for p in PROMPTS]
        assert got == _expected_tokens(checkpoint)
        _until("the replica's counts", lambda: any(
            ln.startswith("serve stats: ") and json.loads(ln[13:])["completed"] == len(PROMPTS)
            for ln in out.lines))
        if drain_by == "sigterm":
            proc.send_signal(signal.SIGTERM)
        else:
            fake.drain["replica-1"] = {"target": "lm@v3"}
        assert proc.wait(timeout=60) == 75, "\n".join(out.lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.join()
        fake.close()
    calls = _requests(fake)
    assert calls[0] == ("POST", "/api/v1/serving/replicas", {
        "url": url, "model": "lm@v2", "checkpoint": checkpoint, "model_name": "lm",
        "model_version": 2, "task_id": "task-9"})
    assert ("POST", "/api/v1/tasks/task-9/ready", {}) in calls
    assert calls[-1] == ("DELETE", "/api/v1/serving/replicas/replica-1", None)
    if drain_by == "master":
        assert "deploy drain requested by master (target lm@v3)" in out.lines
    assert out.lines[-1] == "drained (clean); exiting"
    launches = json.loads(out.find("kernel launches: ").split(": ", 1)[1])
    # the CPU runs the plain versions: no kernel launches, in any count
    assert launches["flash_fwd"] == launches["flash_bwd_dq"] == launches["fused_adamw"] == 0
    assert json.loads(out.find("serve stats: ").split(": ", 1)[1])["completed"] == len(PROMPTS)


@pytest.mark.parametrize("case, code", [
    ("missing_storage", 1), ("empty_storage", 1), ("unknown_serve_key", 2),
    ("bad_serve_value", 2),
])
def test_serve_replica_fails_fast_as_the_jax_module(tmp_path, case, code):
    config = {"model": "lm", "version": 1, "storage_path": str(tmp_path)}
    if case == "missing_storage":
        config["storage_path"] = str(tmp_path / "gone")
    elif case == "empty_storage":
        config["storage_path"] = ""
    elif case == "unknown_serve_key":
        config["serve"] = {"bogus": 1}
    else:
        config["serve"] = {"block_size": 0}
    ran = {}
    for pkg, module in (("jax", "determined_tpu.exec.serve_replica"),
                        ("port", "determined_tpu_torch.exec.serve_replica")):
        fake = RecordingMaster()
        try:
            proc = subprocess.run([sys.executable, "-m", module],
                                  env=_replica_env(fake, config), cwd=tmp_path,
                                  capture_output=True, text=True, timeout=120)
        finally:
            fake.close()
        ran[pkg] = (proc.returncode, proc.stdout, proc.stderr.strip().splitlines()[-1:],
                    _requests(fake))
    assert ran["port"] == ran["jax"]
    assert ran["port"][0] == code and ran["port"][3] == []


def test_serve_replica_without_a_gpu_or_the_device_variable_serves_nothing(checkpoint, tmp_path):
    fake = RecordingMaster()
    config = {"model": "lm", "version": 1, "storage_path": checkpoint}
    try:
        proc = subprocess.run([sys.executable, "-m", "determined_tpu_torch.exec.serve_replica"],
                              env=_replica_env(fake, config), cwd=tmp_path,
                              capture_output=True, text=True, timeout=120)
    finally:
        fake.close()
    assert proc.returncode == 1
    assert "CUDA" in proc.stderr and "DTPU_TORCH_DEVICE" in proc.stderr
    assert "serving on" not in proc.stdout
    assert _requests(fake) == []
