"""A recording stand-in for the native master (``native/master``): the
routes a trial process and a driver call, answered as the master answers
them, every request recorded.  The preemption long-poll holds until
``preempt()`` (or its timeout), as the master's does.  Imports no JAX."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class RecordingMaster:
    def __init__(self):
        self.requests = []          # dicts: method, path, query, body
        self.lock = threading.Lock()
        self._preempt = threading.Event()
        self._closing = threading.Event()
        self.models = {}            # name -> [version json]
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                out = json.dumps(obj).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
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

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True,
                         name="recording-master").start()

    def route(self, rec):
        path, method = rec["path"], rec["method"]
        if path == "/api/v1/auth/login":
            return {"token": "recorded-token"}, 200
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
        return {}, 200

    def _models(self, method, path, body):
        parts = path.split("/")[4:]  # after /api/v1/models
        with self.lock:
            if method == "POST" and not parts:
                if body["name"] in self.models:
                    return {"error": "exists"}, 409
                self.models[body["name"]] = []
                return {"name": body["name"], "labels": body.get("labels", [])}, 200
            name = parts[0]
            if name not in self.models:
                return {"error": "no such model"}, 404
            if method == "POST" and parts[1:] == ["versions"]:
                ver = dict(body, model=name, version=len(self.models[name]) + 1)
                self.models[name].append(ver)
                return ver, 200
            if method == "GET" and len(parts) == 1:
                return {"name": name, "versions": self.models[name]}, 200
            if method == "GET" and len(parts) == 3:
                return self.models[name][int(parts[2]) - 1], 200
        return {"error": "no route"}, 404

    def preempt(self):
        self._preempt.set()

    def calls(self, *, skip=("/heartbeat", "/signals/preemption")):
        """The recorded requests, without the timing-driven ones."""
        with self.lock:
            return [r for r in self.requests if not r["path"].endswith(skip)]

    def metric_rows(self):
        """Every metrics row the trial shipped, in order."""
        return [row for r in self.calls() if r["path"] == "/api/v1/trials/metrics"
                for row in r["body"]["metrics"]]

    def close(self):
        self._closing.set()
        self.server.shutdown()
        self.server.server_close()
