"""The port's master client (determined_tpu_torch/api, exec/_tls.py), its
cluster facts (core/_cluster_info.py) and the agent's launcher
(exec/launcher.py), against the JAX package's on the CPU:

- JAX's ``requests`` session and the port's ``urllib`` one, each against
  the same scripted local HTTP server, make the same number of attempts
  with the same sleeps (the jitter drawn from one seeded generator on each
  side) and end in the same outcome: the same status, or the same kind of
  exception (``APIError``, ``NotFoundError``, a connection failure, a read
  timeout), for 429 with and without ``Retry-After``, 503, 5xx on GET and
  POST (with and without the POST's opt-in), a read timeout, a refused
  connection and the explicit opt-out;
- ``ClusterInfo`` reads the same fields from the same ``DTPU_*``
  environment as the JAX class and round-trips through ``to_env``;
- the launcher maps the agent's ``-m determined_tpu.exec.<name>`` to the
  port's module and refuses a module the port lacks.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests

from determined_tpu.api import session as jax_session
from determined_tpu.core._cluster_info import ClusterInfo as JaxClusterInfo
from determined_tpu_torch.api import session as port_session
from determined_tpu_torch.api.authentication import TokenStore
from determined_tpu_torch.core import ClusterInfo
from determined_tpu_torch.exec import launcher
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ScriptedServer:
    """Answers the n-th request with the n-th scripted (status, headers,
    delay) and 200 {} after the script; records every request."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = []
        self.auth = []
        self.lock = threading.Lock()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                with srv.lock:
                    srv.requests.append((self.command, self.path, body))
                    srv.auth.append(self.headers.get("Authorization"))
                    status, headers, delay = (srv.script.pop(0) if srv.script
                                              else (200, {}, 0.0))
                if delay:
                    time.sleep(delay)
                out = json.dumps({"status": status}).encode()
                try:
                    self.send_response(status)
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                except OSError:
                    pass  # the client gave up (read timeout)

            do_GET = do_POST = do_PUT = do_DELETE = _answer

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _outcome(exc):
    """What a call ended in, named alike for both packages."""
    if exc is None:
        return "ok"
    if isinstance(exc, (jax_session.NotFoundError, port_session.NotFoundError)):
        return f"NotFoundError {exc.status}"
    if isinstance(exc, (jax_session.APIError, port_session.APIError)):
        return f"APIError {exc.status}"
    if isinstance(exc, (requests.Timeout, TimeoutError)):
        return "read timeout"
    if isinstance(exc, (requests.ConnectionError, ConnectionError)):
        return "connection"
    return type(exc).__name__


def _run(module, monkeypatch, script, method, kw, url=None):
    """One call through ``module``'s Session against a fresh scripted
    server: (outcome, attempts as (method, path), sleeps)."""
    sleeps = []
    monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=sleeps.append))
    monkeypatch.setattr(module, "random", types.SimpleNamespace(uniform=random.Random(7).uniform))
    srv = ScriptedServer(script)
    try:
        s = module.Session(url or srv.url, token="tok")
        exc = None
        try:
            resp = s.request(method, "/api/v1/thing", json={"a": 1}, **kw)
            assert resp.status_code == 200 and resp.json() == {"status": 200}
        except Exception as e:  # noqa: BLE001 - compared below
            exc = e
        return _outcome(exc), [(m, p) for m, p, _ in srv.requests], sleeps
    finally:
        srv.close()


RA = {"Retry-After": "0.25"}
CASES = {
    # name: (script, method, kwargs, the expected outcome and attempts)
    "429_retry_after_post": ([(429, RA, 0), (429, RA, 0)], "POST", {}, ("ok", 3)),
    "429_without_retry_after": ([(429, {}, 0)] * 2, "GET", {}, ("ok", 3)),
    "429_exhausted": ([(429, RA, 0)] * 6, "POST", {}, ("APIError 429", 5)),
    "429_opt_out": ([(429, RA, 0)], "GET", {"retry": False}, ("APIError 429", 1)),
    "503_retry_after_get": ([(503, RA, 0), (503, RA, 0)], "GET", {}, ("ok", 3)),
    "500_get": ([(500, {}, 0)] * 5, "GET", {}, ("APIError 500", 5)),
    "502_get_recovers": ([(502, {}, 0)] * 2, "GET", {}, ("ok", 3)),
    "500_post": ([(500, {}, 0)], "POST", {}, ("APIError 500", 1)),
    "500_post_opt_in": ([(500, {}, 0)] * 2, "POST", {"retry": True}, ("ok", 3)),
    "500_get_opt_out": ([(500, {}, 0)], "GET", {"retry": False}, ("APIError 500", 1)),
    "read_timeout_get": ([(200, {}, 0.6)] * 2, "GET", {"timeout": 0.2}, ("ok", 3)),
    "read_timeout_post": ([(200, {}, 0.6)], "POST", {"timeout": 0.2}, ("read timeout", 1)),
    "404": ([(404, {}, 0)], "GET", {}, ("NotFoundError 404", 1)),
    "400_post": ([(400, {}, 0)], "POST", {"retry": True}, ("APIError 400", 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_retries_as_the_jax_session(case, monkeypatch):
    script, method, kw, (outcome, attempts) = CASES[case]
    jax_run = _run(jax_session, monkeypatch, script, method, kw)
    port_run = _run(port_session, monkeypatch, script, method, kw)
    assert port_run == jax_run
    assert port_run[0] == outcome and len(port_run[1]) == attempts, port_run
    # a sleep between attempts, none after the last
    assert len(port_run[2]) == attempts - 1, port_run


def test_session_connection_refused_as_the_jax_session(monkeypatch):
    """A master that is down: GET retries five times, POST once, and both
    end in a connection failure after the same backoff."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    url = f"http://127.0.0.1:{sock.getsockname()[1]}"
    sock.close()  # nothing listens there now
    for method, attempts in (("GET", 5), ("POST", 1)):
        got = [_run(m, monkeypatch, [], method, {}, url=url) for m in (jax_session, port_session)]
        assert got[0] == got[1]
        assert got[1][0] == "connection" and len(got[1][2]) == attempts - 1


def test_session_sends_the_token_the_query_and_the_body():
    srv = ScriptedServer([])
    try:
        s = port_session.Session(srv.url, token="tok")
        resp = s.get("/api/v1/x", params={"offset": 3, "group": "validation"})
        assert resp.status_code == 200 and json.loads(resp.text) == {"status": 200}
        s.post("/api/v1/y", json={"k": [1, 2]})
        (m1, p1, b1), (m2, p2, b2) = srv.requests
        assert (m1, p1, b1) == ("GET", "/api/v1/x?offset=3&group=validation", b"")
        assert (m2, p2, json.loads(b2)) == ("POST", "/api/v1/y", {"k": [1, 2]})
        assert srv.auth == ["Bearer tok", "Bearer tok"]
    finally:
        srv.close()


def test_login_and_token_store(tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_AUTH_PATH", str(tmp_path / "auth.json"))
    srv = ScriptedServer([])
    try:
        store = TokenStore()
        store.set(srv.url + "/", "alice", "t1")
        assert store.get(srv.url) == {"username": "alice", "token": "t1"}
        assert oct(os.stat(store.path).st_mode & 0o777) == "0o600"
        store.clear(srv.url)
        assert store.get(srv.url) is None
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# ClusterInfo
# ---------------------------------------------------------------------------

ENV = {
    "DTPU_MASTER_URL": "http://127.0.0.1:8080", "DTPU_CLUSTER_ID": "c1",
    "DTPU_AGENT_ID": "agent-0", "DTPU_TASK_ID": "", "DTPU_ALLOCATION_ID": "alloc-3",
    "DTPU_SESSION_TOKEN": "tok", "DTPU_TRIAL_ID": "7", "DTPU_EXPERIMENT_ID": "2",
    "DTPU_TRIAL_RUN_ID": "1", "DTPU_HPARAMS": json.dumps({"lr": 0.1, "hidden": 32}),
    "DTPU_LATEST_CHECKPOINT": "uuid-9", "DTPU_TRIAL_SEED": "8", "DTPU_NUM_SLOTS": "1",
    "DTPU_SLOT_IDS": "[0]",
    "DTPU_RENDEZVOUS": json.dumps({"coordinator": "10.0.0.1:29500", "num_nodes": 2,
                                   "node_rank": 1}),
    "DTPU_EXP_CONFIG": json.dumps({"name": "x", "checkpoint_storage": {"type": "shared_fs",
                                                                      "host_path": "/ck"}}),
}


def test_cluster_info_reads_the_jax_fields_and_round_trips(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DTPU_"):
            monkeypatch.delenv(k)
    assert ClusterInfo.from_env() is None and JaxClusterInfo.from_env() is None
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    port, jax = ClusterInfo.from_env(), JaxClusterInfo.from_env()
    assert vars(port) == vars(jax)
    assert port.trial_id == 7 and port.rendezvous["node_rank"] == 1
    assert port.to_env() == jax.to_env()
    for k in list(os.environ):
        if k.startswith("DTPU_"):
            monkeypatch.delenv(k)
    for k, v in port.to_env().items():
        monkeypatch.setenv(k, v)
    assert vars(ClusterInfo.from_env()) == vars(port)


# ---------------------------------------------------------------------------
# the agent's launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module, mapped", [
    ("determined_tpu.exec.run_trial", "determined_tpu_torch.exec.run_trial"),
    ("determined_tpu.exec.gc_checkpoints", "determined_tpu_torch.exec.gc_checkpoints"),
    ("determined_tpu_torch.exec.run_trial", "determined_tpu_torch.exec.run_trial"),
    # the module the master's fleet supervisor launches for every replica
    ("determined_tpu.exec.serve_replica", "determined_tpu_torch.exec.serve_replica"),
])
def test_launcher_maps_the_agents_module_to_the_ports(module, mapped):
    exe, argv = launcher.command(["-m", module, "pkg.mod:Trial"])
    assert exe == sys.executable
    assert argv == [sys.executable, "-m", mapped, "pkg.mod:Trial"]


@pytest.mark.parametrize("argv", [
    ["-m", "determined_tpu.exec.shell"],
    ["-m", "determined_tpu.exec.tensorboard"],
    ["-m", "some.other.module"],
    ["determined_tpu/exec/run_trial.py"],
    ["-m", "determined_tpu.exec.notebook"],
    ["-m", "determined_tpu.exec.command"],
])
def test_launcher_refuses_what_the_port_lacks(argv):
    with pytest.raises(launcher.LauncherError):
        launcher.command(argv)


def test_launcher_execs_the_ports_module_and_exits_2_for_others(tmp_path):
    """As the agent runs it (an executable with the agent's argv, from any
    directory): the port's run_trial answers, and an unported module exits
    2 with its name, running nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    path = os.path.join(REPO, "determined_tpu_torch", "exec", "launcher.py")
    assert os.access(path, os.X_OK)
    ran = subprocess.run([path, "-m", "determined_tpu.exec.run_trial"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert ran.returncode == 2
    assert "python -m determined_tpu_torch.exec.run_trial" in ran.stdout
    refused = subprocess.run([path, "-m", "determined_tpu.exec.notebook"], cwd=tmp_path,
                             env=env, capture_output=True, text=True, timeout=60)
    assert refused.returncode == 2
    assert "determined_tpu.exec.notebook" in refused.stderr


@pytest.mark.parametrize("module, code, says", [
    # the port's replica runs: a task config with no storage fails fast
    ("determined_tpu.exec.serve_replica", 1,
     "serve replica: storage path '' is not a directory"),
    ("determined_tpu.exec.tensorboard", 2, "'determined_tpu.exec.tensorboard' has no counterpart"),
    ("determined_tpu.exec.notebook", 2, "'determined_tpu.exec.notebook' has no counterpart"),
    ("determined_tpu.exec.shell", 2, "'determined_tpu.exec.shell' has no counterpart"),
    ("determined_tpu.exec.command", 2, "'determined_tpu.exec.command' has no counterpart"),
])
def test_launcher_runs_the_ports_serve_replica_and_refuses_the_task_containers(
        tmp_path, module, code, says):
    """The master starts each task by module name (``serve_replica`` for
    the fleet, ``master.cpp:1610``): the port's replica answers, and the
    four task containers the port lacks exit 2 naming themselves."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "DTPU_TASK_CONFIG")}
    path = os.path.join(REPO, "determined_tpu_torch", "exec", "launcher.py")
    ran = subprocess.run([path, "-m", module], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert ran.returncode == code, ran.stderr
    assert says in ran.stderr
