"""The port's SDK client (``determined_tpu_torch/client.py``) against the JAX
package's ``client.py``, on the CPU: each ``Determined`` talks to its own
recording stand-in for the native master (tests/torch_cluster_master.py),
and every call makes the same requests (method, path, query, body) and
returns the same answer.  Covered: the model registry (create, get, list,
register a version, resolve ``name@version``), the serving fleet (rolling
and canary deploys, the fleet spec, the replica table, generation through
the master's router, a 503 from it), experiments, trials and checkpoints
(``Checkpoint.download`` through the port's storage), tasks, tokens,
workspaces, templates, events, agents, pools, users and the module-level
``login``/``get_*`` functions.  ``open_shell_ws`` raises on the port,
naming the later slice.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from determined_tpu import client as jax_client
from determined_tpu.api.session import APIError as JaxAPIError
from determined_tpu.api.session import Session as JaxSession
from determined_tpu_torch import client
from determined_tpu_torch.api.session import APIError, NotFoundError, Session
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_cluster_master import RecordingMaster

CLIENTS = {"jax": (jax_client, JaxSession), "port": (client, Session)}


def _plain(value):
    """A call's answer, comparable across packages."""
    if hasattr(value, "to_dict"):
        return {"type": type(value).__name__, **value.to_dict()}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


def _seed(fake, store):
    fake.events[:] = [{"seq": 3, "type": "a"}, {"seq": 5, "type": "b"}]
    fake.models["lm"] = [
        dict(model="lm", version=1, checkpoint_uuid="u1", storage_path=f"{store}/u1"),
        dict(model="lm", version=2, checkpoint_uuid="u2", storage_path=f"{store}/u2",
             source_trial_id=4, metrics={"validation_loss": 1.5}),
    ]
    fake.canned.update({
        ("GET", "/api/v1/experiments"): [{"id": 1, "state": "COMPLETED"}],
        ("GET", "/api/v1/experiments/1"): {
            "id": 1, "state": "COMPLETED", "trials": [{"id": 4}],
            "config": {"checkpoint_storage": {"type": "shared_fs", "host_path": store},
                       "searcher": {"metric": "validation_loss"}}},
        ("GET", "/api/v1/trials/4"): {"id": 4, "state": "COMPLETED", "experiment_id": 1},
        ("GET", "/api/v1/trials/4/metrics"): [
            {"group": "validation", "metrics": {"validation_loss": 2.0}},
            {"group": "validation", "metrics": {"validation_loss": 1.5}}],
        ("GET", "/api/v1/trials/4/logs"): ["line 1", "line 2"],
        ("GET", "/api/v1/checkpoints"): [
            {"uuid": "u1", "trial_id": 4, "metadata": {"steps_completed": 8}},
            {"uuid": "u0", "trial_id": 4, "state": "DELETED", "metadata": {}},
            {"uuid": "u2", "trial_id": 4, "metadata": {"steps_completed": 4}}],
        ("GET", "/api/v1/checkpoints/u1"): {"uuid": "u1", "trial_id": 4,
                                            "metadata": {"steps_completed": 8}},
        ("GET", "/api/v1/tasks/task-1"): {"id": "task-1", "state": "TERMINATED",
                                          "ready": True},
        ("GET", "/api/v1/tasks"): [{"id": "task-1"}],
        ("GET", "/api/v1/tasks/task-1/logs"): [{"line": "hello"}],
        ("GET", "/api/v1/templates/t"): {"config": {"resources": {"slots": 1}}},
        ("GET", "/api/v1/templates"): [{"name": "t"}],
        ("GET", "/api/v1/agents"): [{"id": "agent-0", "slots": 1}],
        ("GET", "/api/v1/resource-pools"): [{"name": "default"}],
        ("GET", "/api/v1/tokens"): [{"id": "tok-1"}],
        ("GET", "/api/v1/workspaces"): [{"name": "w"}],
        ("GET", "/api/v1/auth/whoami"): {"username": "determined", "admin": True},
    })


class _Replica:
    """A serving replica stand-in: /v1/generate answers a fixed function of
    the prompt."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                out = json.dumps({"tokens": [t + 1 for t in body["prompt_tokens"]],
                                  "echo": body}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


SCENARIOS = {
    "create_model": lambda d: d.create_model("new", description="a model"),
    "get_model": lambda d: d.get_model("lm"),
    "get_models": lambda d: d.get_models(),
    "register_version": lambda d: d.get_model("lm").register_version("u3", {"note": 1}),
    "get_versions": lambda d: d.get_model("lm").get_versions(),
    "resolve_latest": lambda d: d.resolve_model_version("lm@latest"),
    "resolve_v1": lambda d: d.resolve_model_version("lm@v1"),
    "resolve_bare": lambda d: d.resolve_model_version("lm"),
    "deploy": lambda d: d.deploy_model("lm@2"),
    "deploy_canary": lambda d: d.deploy_model(
        "lm@1", canary_fraction=0.5, bake_seconds=5, min_requests=3,
        rollback_on_regression=True),
    "deploy_then_status": lambda d: (d.deploy_model("lm@latest"), d.get_serving_deploy()),
    "set_fleet": lambda d: d.set_serving_fleet(
        "lm@1", 2, pool="gpus", config={"env": {"DTPU_TORCH_DEVICE": "cpu"}}),
    "set_then_get_fleet": lambda d: (d.set_serving_fleet("lm@2", 1), d.get_serving_fleet()),
    "master_info": lambda d: d.master_info(),
    "whoami": lambda d: d.whoami(),
    "create_user": lambda d: d.create_user("alice", "pw", role="viewer"),
    "list_experiments": lambda d: d.list_experiments(workspace="w", owner="me"),
    "get_experiment": lambda d: d.get_experiment(1),
    "experiment_trials_and_best": lambda d: (
        d.get_experiment(1).get_trials(), d.get_experiment(1).best_trial()),
    "experiment_signals": lambda d: (d.get_experiment(1).pause(), d.get_experiment(1).kill()),
    "get_trial_metrics_logs": lambda d: (
        list(d.get_trial(4).iter_metrics(group="validation")),
        d.get_trial(4).summary_metric("validation_loss"), list(d.get_trial(4).logs())),
    "trial_checkpoints": lambda d: d.get_trial(4).list_checkpoints(),
    "list_checkpoints": lambda d: d.list_checkpoints(),
    "tasks": lambda d: (
        d.run_command(["echo", "hi"], slots=1, env={"A": "1"}, work_dir="/w",
                      resource_pool="p"),
        d.start_tensorboard([1]), d.start_notebook("/w", "p"), d.start_shell(),
        d.get_task("task-1"), d.list_tasks(), d.task_logs("task-1"),
        d.wait_task_done("task-1", timeout=5), d.wait_task_ready("task-1", timeout=5),
        d.kill_task("task-1")),
    "tokens": lambda d: (d.create_token("ci", ttl_days=3, username="bob"), d.list_tokens(),
                         d.revoke_token("tok-1")),
    "workspaces": lambda d: (
        d.create_workspace("w 1"), d.list_workspaces(), d.archive_workspace("w 1"),
        d.archive_workspace("w 1", archived=False),
        d.assign_workspace_role("w 1", "bob", "viewer"), d.delete_workspace("w 1")),
    "templates": lambda d: (d.set_template("t", {"a": 1}), d.get_template("t"),
                            d.list_templates(), d.delete_template("t")),
    "events": lambda d: (list(d.events(since=1, types=["b"])), d.get_events(since=2)),
    "cluster": lambda d: (d.list_agents(), d.list_resource_pools()),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_client_call_makes_the_jax_clients_requests(scenario, tmp_path):
    seen = {}
    for pkg, (mod, session_cls) in CLIENTS.items():
        fake = RecordingMaster()
        try:
            _seed(fake, str(tmp_path / "store"))
            d = mod.Determined(fake.url, session=session_cls(fake.url, token="tok"))
            answer = SCENARIOS[scenario](d)
            answer = ([_plain(a) for a in answer] if isinstance(answer, tuple)
                      else _plain(answer))
            seen[pkg] = (answer, [(r["method"], r["path"], r["query"], r["body"])
                                  for r in fake.calls()])
        finally:
            fake.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1], "no request made"


def test_generate_goes_through_the_masters_router_as_the_jax_client():
    seen = {}
    for pkg, (mod, session_cls) in CLIENTS.items():
        fake, replica = RecordingMaster(), _Replica()
        try:
            d = mod.Determined(fake.url, session=session_cls(fake.url, token="tok"))
            errors = {"jax": JaxAPIError, "port": APIError}
            with pytest.raises(errors[pkg]) as refused:
                d.generate([1, 2])  # no replica registered: 503
            fake.replicas["replica-1"] = dict(url=replica.url, inflight=0)
            out = d.generate([5, 6, 7], max_new_tokens=4, session_key="s1")
            plain = d.generate([9])
            table = [{k: v for k, v in r.items() if k != "url"} for r in d.get_serving()]
            seen[pkg] = (refused.value.status, out, plain, table,
                         [(r["method"], r["path"], r["body"]) for r in fake.calls()])
        finally:
            fake.close()
            replica.close()
    assert seen["port"] == seen["jax"]
    status, out, plain, table, _ = seen["port"]
    assert status == 503
    assert out == {"tokens": [6, 7, 8], "echo": {"prompt_tokens": [5, 6, 7],
                                                 "max_new_tokens": 4, "session": "s1"}}
    assert plain["echo"] == {"prompt_tokens": [9]}
    assert [r["id"] for r in table] == ["replica-1"]


def test_get_serving_fleet_before_a_spec_is_not_found():
    fake = RecordingMaster()
    try:
        d = client.Determined(fake.url, session=Session(fake.url, token="tok"))
        with pytest.raises(NotFoundError):
            d.get_serving_fleet()
        with pytest.raises(NotFoundError):
            d.get_serving_deploy()
    finally:
        fake.close()


def test_checkpoint_download_copies_through_the_ports_storage(tmp_path):
    store = tmp_path / "store"
    (store / "u1" / "state").mkdir(parents=True)
    (store / "u1" / "state" / "params.pt").write_bytes(b"\x00" * 64)
    (store / "u1" / "metadata.json").write_text("{}")
    got = {}
    for pkg, (mod, session_cls) in CLIENTS.items():
        fake = RecordingMaster()
        try:
            _seed(fake, str(store))
            d = mod.Determined(fake.url, session=session_cls(fake.url, token="tok"))
            target = str(tmp_path / pkg)
            assert d.get_checkpoint("u1").download(target) == target
            got[pkg] = (sorted(os.path.relpath(os.path.join(r, f), target)
                               for r, _, fs in os.walk(target) for f in fs),
                        [(r["method"], r["path"]) for r in fake.calls()])
        finally:
            fake.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["metadata.json", os.path.join("state", "params.pt")]


def test_create_experiment_ships_the_context_as_the_jax_client(tmp_path):
    ctx = tmp_path / "ctx"
    (ctx / "pkg").mkdir(parents=True)
    (ctx / "model_def.py").write_text("X = 1\n")
    (ctx / "pkg" / "m.py").write_text("Y = 2\n")
    (ctx / ".detignore").write_text("*.log\n")
    (ctx / "run.log").write_text("skip me")
    config = {"name": "e", "entrypoint": "model_def:Trial",
              "hyperparameters": {"lr": 0.1, "global_batch_size": 8},
              "searcher": {"name": "single", "metric": "loss", "max_length": {"batches": 4}}}
    seen = {}
    for pkg, (mod, session_cls) in CLIENTS.items():
        fake = RecordingMaster()
        try:
            fake.canned[("POST", "/api/v1/experiments")] = {"id": 1, "state": "ACTIVE"}
            d = mod.Determined(fake.url, session=session_cls(fake.url, token="tok"))
            exp = d.create_experiment(config, context_dir=str(ctx))
            seen[pkg] = (exp.id, [(r["method"], r["path"], r["body"]) for r in fake.calls()])
        finally:
            fake.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1][0][2]["context"]  # the tarball rode the request


def test_module_level_login_and_getters_as_the_jax_client(tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_AUTH_PATH", str(tmp_path / "auth.json"))
    monkeypatch.delenv("DTPU_TOKEN", raising=False)
    monkeypatch.delenv("DTPU_SESSION_TOKEN", raising=False)
    seen = {}
    for pkg, (mod, _session_cls) in CLIENTS.items():
        fake = RecordingMaster()
        try:
            _seed(fake, str(tmp_path / "store"))
            monkeypatch.setattr(mod, "_default_client", None)
            d = mod.login(fake.url, user="alice", password="pw")
            assert d.session.token == "recorded-token"
            answers = [_plain(mod.get_experiment(1)), _plain(mod.get_trial(4)),
                       _plain(mod.get_checkpoint("u1")), _plain(mod.get_model("lm"))]
            seen[pkg] = (answers, [(r["method"], r["path"], r["body"]) for r in fake.calls()])
        finally:
            fake.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1][0] == ("POST", "/api/v1/auth/login",
                                  {"username": "alice", "password": "pw"})


def test_open_shell_ws_raises_naming_the_later_slice():
    d = client.Determined("http://127.0.0.1:9", session=Session("http://127.0.0.1:9"))
    with pytest.raises(NotImplementedError, match="later slice"):
        d.open_shell_ws("task-1")
