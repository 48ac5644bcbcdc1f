"""The serving fleet through the real native master, on the CPU: the port's
counterpart of ``tests/test_registry.py``'s search → promote → serve →
roll and ``tests/test_serving.py``'s supervisor tests.

``dtpu-master`` and one ``dtpu-agent`` (built from ``native/`` into
``native/build``, which the JAX suite's ``scripts/devcluster.py`` shares;
``devcluster.build_binaries`` takes a file lock, so parallel test workers
build once) run with the agent's ``--python`` on the port's launcher.  Two
tiny checkpoints of the port are registered as ``lm`` v1 and v2 through
the port's CLI, and ``fleet set lm@1 --target 1 --env
DTPU_TORCH_DEVICE=cpu`` has the master's supervisor launch a replica: the
agent runs the port's ``exec/serve_replica``, which registers.  Greedy
tokens through the master's ``/v1/generate`` router equal an in-process
engine's over v1; ``model deploy lm@2`` drains the replica (it logs the
master's drain and its clean exit; the slot counts no failure, so it
exited 75 or 0), the supervisor relaunches it on v2, the deploy completes,
and the router then serves v2's tokens.  A SIGKILL of the relaunched
replica's process counts as a slot failure (exit 137); the master reaps the
silent replica at its heartbeat TTL and the supervisor launches another on
v2, which serves v2's tokens.
"""

import os
import signal
import time

import pytest

from determined_tpu_torch import core, devcluster, serve, train
from determined_tpu_torch.cli.main import main as cli
from determined_tpu_torch.client import Determined
from determined_tpu_torch.models import LMTrial
from tests import torch_threads  # noqa: F401  (one intra-op thread)

HP = dict(lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=128, d_model=32, n_layers=2,
          n_heads=4, n_kv_heads=2, dataset_size=16, attention="reference", fused_ce=False,
          warmup_steps=1, bf16=False)
PROMPTS = [[3, 14, 15, 9, 2, 6], list(range(20, 33)), [7]]
NEW_TOKENS = 6
#: the flow's own limit, the native build excluded (it runs in the fixture)
FLOW_TIMEOUT_S = 120.0
MASTER_ARGS = ("--serve-replica-timeout-sec", "5", "--fleet-backoff-initial-ms", "200",
               "--deploy-step-timeout-sec", "60")


@pytest.fixture(scope="module")
def binaries():
    devcluster.build_binaries()
    return devcluster.build_dir()


def _checkpoint(root, seed):
    ctx = train.init(hparams=dict(HP), seed=seed, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(root)))
    summary = train.Trainer(LMTrial(ctx)).fit(max_length=2, checkpoint_policy="best")
    return str(root / summary["latest_checkpoint"]), summary["latest_checkpoint"]


def _tokens(path):
    eng = serve.ServeEngine.from_checkpoint(path, serve.ServeConfig(), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step_once()
    return [list(r.output) for r in reqs]


def _wait(what, fn, deadline, poll=0.1):
    while True:
        got = fn()
        if got:
            return got
        assert time.monotonic() < deadline, f"{what}: not within the flow's {FLOW_TIMEOUT_S} s"
        time.sleep(poll)


def _task_lines(session, task_id):
    return [r["line"] if isinstance(r, dict) else str(r)
            for r in session.get(f"/api/v1/tasks/{task_id}/logs").json()]


def test_fleet_serves_v1_rolls_to_v2_through_the_native_master(binaries, tmp_path, monkeypatch):
    (v1, u1), (v2, u2) = _checkpoint(tmp_path / "v1", 0), _checkpoint(tmp_path / "v2", 1)
    want = {1: _tokens(v1), 2: _tokens(v2)}
    assert want[1] != want[2]
    cluster = devcluster.LocalCluster(str(tmp_path / "state"), str(tmp_path / "ckpts"),
                                      agents=1, slots=1, where=binaries,
                                      master_args=MASTER_ARGS)
    cluster.start()
    try:
        deadline = time.monotonic() + FLOW_TIMEOUT_S
        session = cluster.session()
        monkeypatch.setenv("DTPU_TOKEN", session.token)
        d = Determined(cluster.url, session=session)
        for uuid, path in ((u1, v1), (u2, v2)):
            assert cli(["-m", cluster.url, "model", "register", "lm", uuid,
                        "--storage-path", path]) == 0
        assert cli(["-m", cluster.url, "fleet", "set", "lm@1", "--target", "1",
                    "--env", "DTPU_TORCH_DEVICE=cpu"]) == 0

        first = _wait("the v1 replica", lambda: [r for r in d.get_serving()
                                                 if r.get("model_version") == 1], deadline)
        task1 = d.get_serving_fleet()["slots"][0]["task_id"]
        assert [r["tokens"] for r in (d.generate(p, max_new_tokens=NEW_TOKENS)
                                      for p in PROMPTS)] == want[1]

        assert cli(["-m", cluster.url, "model", "deploy", "lm@2", "--timeout", "90"]) == 0
        second = _wait("the v2 replica", lambda: [r for r in d.get_serving()
                                                  if r.get("model_version") == 2], deadline)
        assert second[0]["id"] != first[0]["id"]
        assert [r["tokens"] for r in (d.generate(p, max_new_tokens=NEW_TOKENS)
                                      for p in PROMPTS)] == want[2]
        slot = d.get_serving_fleet()["slots"][0]
        assert slot["launches"] == 2 and slot["failures"] == 0, slot
        assert slot["task_id"] != task1 and slot["launch_version"] == 2, slot
        lines = _task_lines(session, task1)
        assert any("device: cpu (DTPU_TORCH_DEVICE=cpu)" in ln for ln in lines), lines
        assert "deploy drain requested by master (target lm@v2)" in lines, lines
        assert lines[-1] == "drained (clean); exiting", lines
        assert d.get_task(task1)["state"] == "TERMINATED"

        # a replica killed outright is reaped at its heartbeat TTL and
        # relaunched after the supervisor's backoff, on the fleet's version
        task2 = slot["task_id"]
        os.kill(cluster.task_pid(task2), signal.SIGKILL)
        third = _wait("the relaunched replica", lambda: [
            r for r in d.get_serving() if r["id"] not in (first[0]["id"], second[0]["id"])],
            deadline)
        assert third[0]["model_version"] == 2
        assert [r["tokens"] for r in (d.generate(p, max_new_tokens=NEW_TOKENS)
                                      for p in PROMPTS)] == want[2]
        slot = d.get_serving_fleet()["slots"][0]
        assert slot["launches"] == 3 and slot["failures"] == 1, slot
        assert slot["last_error"] == f"task {task2} exited 137", slot
    finally:
        cluster.stop()
