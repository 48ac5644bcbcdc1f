"""The port's ``serve``, ``model``, ``fleet`` and ``master`` verbs
(``determined_tpu_torch/cli/main.py``) against the JAX CLI's, on the CPU:
each CLI talks to its own recording stand-in for the native master
(tests/torch_cluster_master.py, the same registry in both), and each verb
exits with the same code, prints the same lines and makes the same requests
(method, path, query, body).  ``serve`` runs as a subprocess of each
package, on a checkpoint its own Trainer wrote (the port's on the CPU
through ``DTPU_TORCH_DEVICE=cpu``): both resolve ``--model lm@1`` through
the master, print the same lines, register the same version, serve, and
drain on SIGTERM to exit 75, deregistered.  Its refusals (a path together
with ``--model``, ``--model`` without a master, nothing to serve, a version
that does not resolve or whose storage is not a directory, a bad cache
size) exit 2 with the JAX CLI's message.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import pytest

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu_torch import core, train
from determined_tpu_torch.models import LMTrial
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_cluster_master import RecordingMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {pkg: importlib.import_module(f"{name}.cli.main").main
        for pkg, name in (("jax", "determined_tpu"), ("port", "determined_tpu_torch"))}


def _seed(fake, store):
    fake.models["lm"] = [
        dict(model="lm", version=1, checkpoint_uuid="u1", storage_path=f"{store}/u1",
             source_trial_id=4, source_experiment_id=1),
        dict(model="lm", version=2, checkpoint_uuid="u2", storage_path=f"{store}/u2",
             metrics={"validation_loss": 1.5}),
        dict(model="lm", version=3, checkpoint_uuid="u3", storage_path=f"{store}/gone"),
    ]
    fake.models["empty"] = []
    os.makedirs(os.path.join(store, "u1", "state"), exist_ok=True)
    with open(os.path.join(store, "u1", "state", "params.pt"), "wb") as f:
        f.write(b"\x01" * 32)


def _run(pkg, argv, fake, capsys, with_master=True):
    """One verb of one CLI in process: its exit code, stdout, the last line
    of its stderr and the requests it made."""
    code = CLIS[pkg]((["-m", fake.url] if with_master else []) + argv)
    out, err = capsys.readouterr()
    return code, out, err.strip().splitlines()[-1:], [
        (r["method"], r["path"], r["query"], r["body"]) for r in fake.calls()]


# argv templates: {tmp} is each package's own scratch directory
VERBS = {
    "model_create": ["model", "create", "new", "--description", "a model"],
    "model_create_taken": ["model", "create", "lm"],
    "model_list": ["model", "list"],
    "model_show": ["model", "show", "lm"],
    "model_show_json": ["model", "show", "lm", "--json"],
    "model_show_missing": ["model", "show", "nope"],
    "model_register": ["model", "register", "lm", "u7", "--storage-path", "/s/u7",
                       "--trial-id", "4", "--experiment-id", "1", "--metric", "loss=0.5",
                       "--metric", "tag=x", "--label", "best", "--version", "7"],
    "model_register_new_model": ["model", "register", "fresh", "u8"],
    "model_register_taken": ["model", "register", "lm", "u2", "--version", "2"],
    "model_promote": ["model", "promote", "lm", "4"],
    "model_pull": ["model", "pull", "lm@1", "--output", "{tmp}/pulled"],
    "model_pull_exists": ["model", "pull", "lm@v1", "--output", "{tmp}"],
    "model_deploy_no_wait": ["model", "deploy", "lm@2", "--no-wait"],
    "model_deploy_wait": ["model", "deploy", "lm@2", "--timeout", "30"],
    "model_deploy_canary": ["model", "deploy", "lm@1", "--canary", "0.5", "--bake-seconds",
                            "5", "--canary-min-requests", "2", "--rollback-on-regression"],
    "model_deploy_missing": ["model", "deploy", "lm@9", "--no-wait"],
    "model_register_version": ["model", "register-version", "lm", "u9"],
    "fleet_set": ["fleet", "set", "lm@1", "--target", "2", "--env",
                  "DTPU_TORCH_DEVICE=cpu", "--env", "X=1", "--slots", "1", "--pool", "gpus"],
    "fleet_set_latest": ["fleet", "set", "lm", "--target", "1"],
    "fleet_status_unset": ["fleet", "status"],
    "master_info": ["master", "info"],
    "serve_path_and_model": ["serve", "{tmp}", "--model", "lm@1"],
    "serve_nothing": ["serve"],
    "serve_unresolved": ["serve", "--model", "nope@1"],
    "serve_no_storage": ["serve", "--model", "lm@3"],
    "serve_bad_cache": ["serve", "{tmp}", "--num-blocks", "1"],
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_verb_prints_and_requests_as_the_jax_cli(verb, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DTPU_TOKEN", "tok")
    monkeypatch.delenv("DTPU_MASTER", raising=False)
    seen = {}
    for pkg in CLIS:
        fake, tmp = RecordingMaster(), tmp_path / pkg
        tmp.mkdir()
        try:
            _seed(fake, str(tmp_path / "store"))
            argv = [a.replace("{tmp}", str(tmp)) for a in VERBS[verb]]
            code, out, err, calls = _run(pkg, argv, fake, capsys)
        finally:
            fake.close()
        seen[pkg] = json.loads(json.dumps((code, out, err, calls)).replace(str(tmp), "{tmp}"))
    assert seen["port"] == seen["jax"]
    if verb.startswith("serve"):
        assert seen["port"][0] == 2
    if verb == "model_pull":
        assert os.listdir(tmp_path / "port" / "pulled" / "state") == ["params.pt"]


@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
def test_fleet_status_after_set_as_the_jax_cli(json_out, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("DTPU_TOKEN", "tok")
    seen = {}
    for pkg in CLIS:
        fake = RecordingMaster()
        try:
            _seed(fake, str(tmp_path / "store"))
            assert CLIS[pkg](["-m", fake.url, "fleet", "set", "lm@2", "--target", "2"]) == 0
            fake.fleet["slots"][1].update(last_error="task task-2 exited 1", failures=1)
            capsys.readouterr()
            seen[pkg] = _run(pkg, ["fleet", "status"] + (["--json"] if json_out else []),
                             fake, capsys)
        finally:
            fake.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 0


def test_serve_with_model_needs_a_master(monkeypatch, capsys):
    monkeypatch.delenv("DTPU_MASTER", raising=False)
    fake = RecordingMaster()
    try:
        seen = {pkg: _run(pkg, ["serve", "--model", "lm@1"], fake, capsys, with_master=False)
                for pkg in CLIS}
    finally:
        fake.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 2 and "resolves through the master" in seen["port"][2][0]


# ---------------------------------------------------------------------------
# serve, as a process of each package
# ---------------------------------------------------------------------------

HP = dict(lr=1e-2, global_batch_size=4, seq_len=32, vocab_size=128, d_model=32, n_layers=2,
          n_heads=4, n_kv_heads=2, dataset_size=16, attention="reference", warmup_steps=1,
          bf16=False)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli-serve")
    jctx = jax_train.init(hparams=dict(HP), mesh_config=MeshConfig(data=1),
                          core_context=jax_core._dummy_init(checkpoint_dir=str(root / "jax")),
                          seed=0, devices=jax.devices()[:1])
    jsum = jax_train.Trainer(JaxLMTrial(jctx)).fit(max_length=2, checkpoint_policy="best")
    ctx = train.init(hparams=dict(HP, fused_ce=False), seed=0, device="cpu",
                     core_context=core._dummy_init(checkpoint_dir=str(root / "port")))
    psum = train.Trainer(LMTrial(ctx)).fit(max_length=2, checkpoint_policy="best")
    return {"jax": str(root / "jax" / jsum["latest_checkpoint"]),
            "port": str(root / "port" / psum["latest_checkpoint"])}


def _serve_once(pkg, path, tmp_path):
    fake = RecordingMaster()
    fake.models["lm"] = [dict(model="lm", version=1, checkpoint_uuid="u1", storage_path=path)]
    # one JAX CPU device, as a replica process has (the suite's
    # conftest forces eight for the in-process mesh tests)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DTPU_MASTER", "DTPU_TORCH_DEVICE", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, DTPU_TOKEN="tok", JAX_PLATFORMS="cpu")
    if pkg == "port":
        env["DTPU_TORCH_DEVICE"] = "cpu"
    module = {"jax": "determined_tpu.cli", "port": "determined_tpu_torch.cli"}[pkg]
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", module, "-m", fake.url, "serve", "--model", "lm@1",
         "--num-blocks", "32", "--max-prompt-len", "16", "--max-new-tokens", "4"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(ln.rstrip("\n") for ln in proc.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 240
        while not any(ln.startswith("serving on ") for ln in lines):
            assert proc.poll() is None and time.monotonic() < deadline, lines
            time.sleep(0.05)
        url = [ln for ln in lines if ln.startswith("serving on ")][0].split()[-1]
        req = urllib.request.Request(
            url + "/v1/generate", method="POST",
            data=json.dumps({"prompt_tokens": [3, 1, 4], "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            tokens = json.loads(resp.read())["tokens"]
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)
        fake.close()
    calls = [(r["method"], r["path"], r["body"]) for r in fake.calls()]
    text = "\n".join(lines).replace(path, "<checkpoint>").replace(url, "<url>")
    calls = json.loads(json.dumps(calls).replace(path, "<checkpoint>").replace(url, "<url>"))
    return code, text.splitlines(), calls, len(tokens)


def test_serve_resolves_registers_serves_and_drains_as_the_jax_cli(checkpoints, tmp_path):
    seen = {pkg: _serve_once(pkg, checkpoints[pkg], tmp_path) for pkg in CLIS}
    assert seen["port"] == seen["jax"]
    code, lines, calls, n_tokens = seen["port"]
    assert code == 75 and n_tokens == 4
    assert lines == [
        "resolved lm@1 -> lm@v1 (<checkpoint>)", "loading checkpoint <checkpoint> ...",
        "serving on <url>", "drain requested: rejecting new requests, finishing in-flight",
        "drained (clean); exiting"]
    assert calls == [
        ["GET", "/api/v1/models/lm/versions/1", None],
        ["POST", "/api/v1/serving/replicas", {"url": "<url>", "model": "lm@v1",
                                              "checkpoint": "<checkpoint>",
                                              "model_name": "lm", "model_version": 1}],
        ["DELETE", "/api/v1/serving/replicas/replica-1", None]]
