"""The replica's HTTP surface: /v1/generate, /healthz, /stats.

A port of ``determined_tpu/serve/http.py``.

A thin stdlib ``ThreadingHTTPServer`` — each request thread parks on its
``GenRequest.done`` event while the engine thread does the work, so the
server needs no async machinery and the engine stays the only place model
code runs.  Backpressure surfaces as status codes, never as buffering:
429 when the admission queue is full, 503 once draining starts, 413 for
requests the replica could never fit.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from determined_tpu_torch.serve.engine import _EngineBase
from determined_tpu_torch.serve.scheduler import AdmissionRejected
from determined_tpu_torch.utils import faults

logger = logging.getLogger("determined_tpu_torch.serve.http")

#: generous ceiling on how long one response may take end to end; a
#: request admitted but stuck longer than this answers 504
REQUEST_TIMEOUT_S = 600.0


class ServeHTTPServer:
    """Bind the engine to an HTTP port.  ``start()`` returns the bound
    port (pass port 0 to let the OS choose — tests and multi-replica
    hosts)."""

    def __init__(self, engine: _EngineBase, host: str = "127.0.0.1", port: int = 0) -> None:
        self.engine = engine
        self.host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.draining = False  # plain flag: flipped once by the drain path

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        engine = self.engine
        server = self

        class Handler(BaseHTTPRequestHandler):
            # stdlib default logs every request to stderr; route to logging
            def log_message(self, fmt: str, *args: Any) -> None:  # noqa: N802
                logger.debug("%s " + fmt, self.client_address[0], *args)

            def _reply(self, status: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except BrokenPipeError:  # client gave up; nothing to do
                    pass

            def do_GET(self) -> None:  # noqa: N802
                if self.path == "/healthz":
                    if not engine.healthy:
                        self._reply(500, {"status": "failed",
                                          "error": engine.failed})
                    elif server.draining:
                        self._reply(503, {"status": "draining"})
                    else:
                        self._reply(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._reply(200, engine.stats())
                else:
                    self._reply(404, {"error": f"no such path: {self.path}"})

            def do_POST(self) -> None:  # noqa: N802
                if self.path != "/v1/generate":
                    self._reply(404, {"error": f"no such path: {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._reply(400, {"error": "bad json"})
                    return
                try:
                    status, payload = server.handle_generate(body)
                except Exception as e:  # noqa: BLE001 - a failed handler must still answer
                    logger.exception("/v1/generate handler failed")
                    status = 500
                    payload = {"error": f"handler failed: {e}"}
                    # handler-level 5xx the engine's own error path never
                    # saw: count it so heartbeat stats stay truthful
                    engine.note_http_response(status)
                self._reply(status, payload)

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="dtpu-serve-http",
            daemon=True,
        )
        self._thread.start()
        return self.port

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start_drain(self) -> None:
        """Flip /healthz to draining and reject new generations; in-flight
        handler threads keep their connections until their requests
        finish."""
        self.draining = True

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- request handling (runs on handler threads) --------------------------

    def handle_generate(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        if self.draining:
            return 503, {"error": "draining"}
        # chaos hook: an installed injector raising here surfaces as a
        # counted 500
        faults.fire("serve.generate")
        prompt = body.get("prompt_tokens")
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            return 400, {"error": "prompt_tokens must be a list of ints"}
        try:
            # type coercion INSIDE the guard: a malformed field is a 400,
            # never an unanswered connection from a crashed handler
            max_new = body.get("max_new_tokens")
            seed = body.get("seed")
            stop = body.get("stop_token")
            req = self.engine.submit(
                prompt,
                max_new_tokens=None if max_new is None else int(max_new),
                temperature=float(body.get("temperature", 0.0)),
                seed=None if seed is None else int(seed),
                stop_token=None if stop is None else int(stop),
            )
        except AdmissionRejected as e:
            return e.status, {"error": e.reason}
        except (TypeError, ValueError) as e:
            return 400, {"error": f"bad request field: {e}"}
        if not req.done.wait(REQUEST_TIMEOUT_S):
            self.engine.note_http_response(504)
            return 504, {"error": "generation timed out", "request_id": req.id}
        if req.error:
            # already counted by the engine's _finish_error; http_5xx only
            # tracks failures the engine did NOT see
            return 500, {"error": req.error, "request_id": req.id}
        return 200, {
            "request_id": req.id,
            "tokens": req.output,
            "usage": {
                "prompt_tokens": len(req.prompt),
                "completion_tokens": len(req.output),
            },
            "ttft_ms": round((req.ttft_s or 0.0) * 1e3, 2),
            "latency_ms": round((req.latency_s or 0.0) * 1e3, 2),
        }
