"""A recording stand-in for the native master (``native/master``): the
routes a trial process, a driver, a serving replica and the SDK call,
answered as the master answers them, every request recorded.  The
preemption long-poll holds until ``preempt()`` (or its timeout), as the
master's does.

The serving routes (``native/master/master.cpp`` ``/api/v1/serving*``,
``/v1/generate``): registration answers 201 with an id; a heartbeat 200,
404 for an id it does not know, 429 with ``Retry-After`` while
``throttle`` is set, and ``{"drain": true, "deploy": {...}}`` for an id in
``drain``; a ``failed`` stat reaps the replica.  ``PUT /serving/fleet``,
``POST /serving/deploy`` and their GETs answer the master's JSON; a deploy
reads back ``completed`` at its first GET.  ``/v1/generate`` proxies to the
registered replica with the fewest requests in flight (503 with
``Retry-After`` when none is registered).  ``canned`` answers any other
route a test names.  ``kill()`` closes the listener
(connection refused, as from a dead master); ``restart()`` rebinds the same
port with the replica table empty, as a restarted master forgets its
replicas.  Imports no JAX."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class RecordingMaster:
    def __init__(self):
        self.requests = []          # dicts: method, path, query, body
        self.lock = threading.Lock()
        self._preempt = threading.Event()
        self._closing = threading.Event()
        self.models = {}            # name -> [version json]
        self.replicas = {}          # id -> registration body
        self.registrations = 0
        self.drain = {}             # replica id -> deploy payload its heartbeat gets
        self.throttle = None        # a Retry-After value: heartbeats answer 429
        self.fleet = None
        self.deploy = None
        self.canned = {}            # (method, path) -> the JSON answered there
        self.events = []            # the event feed: GET /api/v1/events?since=N
        self.port = 0
        self._serve()

    def _serve(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200, headers=()):
                out = json.dumps(obj).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    for k, v in headers:
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                except OSError:
                    pass

            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                parsed = urlparse(self.path)
                rec = dict(method=self.command, path=parsed.path,
                           query={k: v[0] for k, v in parse_qs(parsed.query).items()},
                           body=json.loads(raw) if raw else None, t=time.monotonic())
                with fake.lock:
                    fake.requests.append(rec)
                return self._json(*fake.route(rec))

            do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _answer

        self.server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.server.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True, name="recording-master").start()

    def route(self, rec):
        path, method = rec["path"], rec["method"]
        if (method, path) in self.canned:
            return self.canned[(method, path)], 200
        if path == "/api/v1/auth/login":
            return {"token": "recorded-token"}, 200
        if path == "/api/v1/master":
            return {"version": "0.1.0", "cluster_name": "dtpu", "agents": 0}, 200
        if path.endswith("/signals/preemption"):
            hold = float(rec["query"].get("timeout_seconds", 60))
            deadline = time.monotonic() + hold
            while not (self._preempt.is_set() or self._closing.is_set()):
                if time.monotonic() >= deadline:
                    break
                self._preempt.wait(0.05)
            return {"preempt": self._preempt.is_set()}, 200
        if path.endswith("/searcher_metric_best"):
            return {"best": None}, 200
        if path.startswith("/api/v1/models"):
            return self._models(method, path, rec["body"] or {})
        if path.startswith("/api/v1/serving"):
            return self._serving(method, path, rec["body"] or {})
        if path == "/v1/generate":
            return self._generate(rec["body"] or {})
        if path == "/api/v1/events":
            since = int(rec["query"].get("since", 0))
            return [e for e in self.events if e["seq"] > since], 200
        return {}, 200

    # -- model registry --------------------------------------------------------

    def _models(self, method, path, body):
        parts = path.split("/")[4:]  # after /api/v1/models
        with self.lock:
            if method == "POST" and not parts:
                if body["name"] in self.models:
                    return {"error": "model exists"}, 409
                self.models[body["name"]] = []
                return {"name": body["name"], "labels": body.get("labels", []),
                        "description": body.get("description", ""),
                        "metadata": body.get("metadata", {}), "versions": []}, 200
            if method == "GET" and not parts:
                return [{"name": n, "versions": list(v)} for n, v in self.models.items()], 200
            name = parts[0]
            if name not in self.models:
                return {"error": "no such model"}, 404
            versions = self.models[name]
            if method == "POST" and parts[1:] == ["versions"]:
                number = int(body.get("version") or len(versions) + 1)
                if any(v["version"] == number for v in versions):
                    return {"error": f"version {number} exists"}, 409
                ver = dict(body, model=name, version=number)
                ver.setdefault("storage_path", f"/recorded/{body.get('checkpoint_uuid')}")
                versions.append(ver)
                return ver, 200
            if method == "POST" and parts[1:] == ["promote"]:
                ver = dict(checkpoint_uuid=f"trial-{body['trial_id']}-latest", model=name,
                           version=len(versions) + 1, source_trial_id=body["trial_id"])
                versions.append(ver)
                return ver, 200
            if method == "GET" and len(parts) == 1:
                return {"name": name, "versions": list(versions)}, 200
            if method == "GET" and parts[1:] == ["versions"]:
                return list(versions), 200
            if method == "GET" and len(parts) == 3:
                if not versions:
                    return {"error": "no such version"}, 404
                want = (max(v["version"] for v in versions) if parts[2] == "latest"
                        else int(parts[2]))
                for v in versions:
                    if v["version"] == want:
                        return dict(v, model=name), 200
                return {"error": "no such version"}, 404
        return {"error": "no route"}, 404

    # -- serving ---------------------------------------------------------------

    def _serving(self, method, path, body):
        parts = path.split("/")[4:]  # after /api/v1/serving
        with self.lock:
            if parts == ["replicas"] and method == "POST":
                self.registrations += 1
                rid = f"replica-{self.registrations}"
                self.replicas[rid] = dict(body, inflight=0)
                return {"id": rid, "heartbeat_ttl_ms": 15000}, 201
            if len(parts) >= 2 and parts[0] == "replicas":
                rid = parts[1]
                if rid not in self.replicas:
                    return {"error": "no such replica"}, 404
                if method == "DELETE":
                    del self.replicas[rid]
                    return {}, 200
                if self.throttle is not None:
                    return {"error": "shedding"}, 429, [("Retry-After", str(self.throttle))]
                stats = body.get("stats")
                if stats is not None:
                    self.replicas[rid]["stats"] = stats
                    if stats.get("failed"):
                        del self.replicas[rid]
                        return {"reaped": True}, 200
                dep = self.drain.get(rid)
                return ({"drain": True, "deploy": dep} if dep is not None else {}), 200
            if not parts and method == "GET":
                return [dict(id=rid, url=r["url"], model=r.get("model", ""),
                             checkpoint=r.get("checkpoint", ""), stats=r.get("stats"),
                             **({"model_name": r["model_name"],
                                 "model_version": r["model_version"]}
                                if r.get("model_name") else {}))
                        for rid, r in self.replicas.items()], 200
            if parts == ["fleet"]:
                if method == "PUT":
                    version = self._version_of(body["model"], body.get("version"))
                    if version is None:
                        return {"error": "no such version"}, 404
                    self.fleet = dict(
                        model=body["model"], version=version, target=int(body["target"]),
                        owner="determined", pool=body.get("pool", ""),
                        config=body.get("config") or {},
                        status="reconciling", detail=f"0/{body['target']} replicas live",
                        slots=[dict(index=i, replica_id="", task_id=f"task-{i + 1}",
                                    launch_version=version, failures=0, launches=1,
                                    last_error="", gave_up=False)
                               for i in range(int(body["target"]))])
                    return self.fleet, 200
                if self.fleet is None:
                    return {"error": "no fleet spec has been set"}, 404
                return self.fleet, 200
            if parts == ["deploy"]:
                if method == "POST":
                    version = self._version_of(body["model"], body.get("version"))
                    if version is None:
                        return {"error": "no such version"}, 404
                    target = f"{body['model']}@v{version}"
                    pending = [rid for rid, r in self.replicas.items()
                               if (r.get("model_name"), r.get("model_version"))
                               != (body["model"], version)]
                    self.deploy = dict(id=1, model=body["model"], version=version,
                                       target=target, pending=pending, draining="",
                                       rolled=[], status="rolling", phase="", detail="")
                    if body.get("canary_fraction"):
                        self.deploy["phase"] = "canary"
                        self.deploy["canary"] = dict(
                            fraction=body["canary_fraction"],
                            count=max(1, round(body["canary_fraction"] * len(pending))),
                            verdict="")
                    return dict(self.deploy), 202
                if self.deploy is None:
                    return {"error": "no deploy has been started"}, 404
                self.deploy.update(status="completed", phase="", pending=[],
                                   rolled=self.deploy["pending"] or self.deploy["rolled"])
                if "canary" in self.deploy:
                    self.deploy["canary"]["verdict"] = "pass"
                return dict(self.deploy), 200
        return {"error": "no route"}, 404

    def _version_of(self, name, version):
        versions = self.models.get(name)
        if not versions:
            return None
        if version in (None, "latest"):
            return max(v["version"] for v in versions)
        return int(version) if any(v["version"] == int(version) for v in versions) else None

    def _generate(self, body):
        with self.lock:
            live = sorted(self.replicas.items(), key=lambda kv: kv[1]["inflight"])
        for rid, rep in live:
            rep["inflight"] += 1
            try:
                req = urllib.request.Request(
                    rep["url"] + "/v1/generate", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return json.loads(resp.read()), resp.status, [("X-DTPU-Replica", rid)]
            except urllib.error.HTTPError as e:
                if e.code not in (429, 503):
                    return json.loads(e.read() or b"{}"), e.code, [("X-DTPU-Replica", rid)]
            except OSError:
                pass  # unreachable: fail over to the next replica
            finally:
                rep["inflight"] -= 1
        return {"error": "no serving replicas available"}, 503, [("Retry-After", "1")]

    # -- control ---------------------------------------------------------------

    def preempt(self):
        self._preempt.set()

    def calls(self, *, skip=("/heartbeat", "/signals/preemption")):
        """The recorded requests, without the timing-driven ones."""
        with self.lock:
            return [r for r in self.requests if not r["path"].endswith(skip)]

    def heartbeats(self):
        """The recorded heartbeats, in order."""
        with self.lock:
            return [r for r in self.requests if r["path"].endswith("/heartbeat")]

    def metric_rows(self):
        """Every metrics row the trial shipped, in order."""
        return [row for r in self.calls() if r["path"] == "/api/v1/trials/metrics"
                for row in r["body"]["metrics"]]

    def kill(self):
        """Close the listener: the next request is refused."""
        self.server.shutdown()
        self.server.server_close()

    def restart(self):
        """Rebind the same port with the replica table empty."""
        with self.lock:
            self.replicas.clear()
        self._serve()

    def close(self):
        self._closing.set()
        try:
            self.kill()
        except OSError:
            pass
