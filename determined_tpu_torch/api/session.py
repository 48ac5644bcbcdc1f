"""HTTP session to the master: ``determined_tpu/api/session.py`` on the
standard library.

The JAX package's session is built on ``requests``; this one is built on
``urllib.request`` with an ``ssl`` context from the master's CA bundle
(``cert_path``, else ``DTPU_MASTER_CERT``), so the port needs no package
beyond the standard library to talk to the master.  The retry contract is
the JAX session's, case for case: idempotent methods (or a call that opts
in with ``retry=True``) retry connection failures, read timeouts and 5xx
with jittered exponential backoff; 429 retries for every method on its own
counter unless the call opts out with ``retry=False``; 429 and 503 honour
the server's ``Retry-After``.  A connection failure that outlasts the
retries is raised as the built-in ``ConnectionError``, a read timeout as
``TimeoutError`` (where the JAX session raises ``requests.ConnectionError``
and ``requests.Timeout``).  ``get``/``post``/... return a ``Response`` with
the ``status_code``, ``json()``, ``text`` and ``headers`` callers read.
"""

from __future__ import annotations

import http.client
import json as json_mod
import logging
import os
import random
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from determined_tpu_torch.utils import faults

logger = logging.getLogger("determined_tpu_torch.api")

# Methods safe to send twice when the first attempt's fate is unknown.
# POST is excluded by default — a duplicated POST can double-create — and
# must opt in per call site (``retry=True``) when the endpoint is known
# idempotent (e.g. checkpoint reports keyed by uuid).
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})

#: what a transport failure is raised as (callers riding out an outage
#: catch these beside ``APIError``)
TRANSPORT_ERRORS = (ConnectionError, TimeoutError)


class APIError(Exception):
    def __init__(
        self, status: int, message: str, retry_after: Optional[str] = None
    ) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        #: the server's Retry-After header (seconds form), when one came
        #: back on a 429/503
        self.retry_after = retry_after


class NotFoundError(APIError):
    pass


class Response:
    """One answer of the master: status, headers and the whole body."""

    def __init__(self, status_code: int, headers: Any, content: bytes) -> None:
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json_mod.loads(self.content or b"null")


def _transport_error(e: BaseException) -> BaseException:
    """A urllib/http.client failure as the port's transport error: a
    timeout as ``TimeoutError``, anything else as ``ConnectionError``."""
    if isinstance(e, TimeoutError):
        return e
    reason = getattr(e, "reason", None)
    if isinstance(reason, TimeoutError):
        return TimeoutError(str(reason))
    if isinstance(e, ConnectionError):
        return e
    err = ConnectionError(str(reason if reason is not None else e) or type(e).__name__)
    err.__cause__ = e
    return err


class Session:
    RETRIES = 5
    BACKOFF = 0.5

    def __init__(
        self,
        master_url: str,
        token: Optional[str] = None,
        cert_path: Optional[str] = None,
        timeout: float = 30.0,
    ) -> None:
        self.master_url = master_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        # master cert bundle for https:// masters: explicit arg wins, then
        # the env the agent injects into trials
        if cert_path is None:
            cert_path = os.environ.get("DTPU_MASTER_CERT") or None
        self._ssl: Optional[ssl.SSLContext] = (
            ssl.create_default_context(cafile=cert_path) if cert_path else None
        )

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _backoff_delay(self, attempt: int, retry_after: Optional[str] = None) -> float:
        """Exponential backoff with +/-50% jitter so a gang of trial
        processes retrying the same master outage doesn't stampede in
        lockstep; an explicit ``Retry-After`` (seconds form) wins."""
        if retry_after:
            try:
                return max(float(retry_after), 0.0)
            except ValueError:
                pass  # HTTP-date form: fall through to backoff
        return self.BACKOFF * (2**attempt) * random.uniform(0.5, 1.5)

    def _send(self, method: str, url: str, body: Optional[bytes], timeout: float) -> Response:
        req = urllib.request.Request(url, data=body, headers=self._headers(), method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout, context=self._ssl) as resp:
                return Response(resp.status, resp.headers, resp.read())
        except urllib.error.HTTPError as e:
            # an answer, not a transport failure: the status decides below
            with e:
                return Response(e.code, e.headers, e.read())

    def request(
        self,
        method: str,
        path: str,
        json: Optional[Any] = None,
        params: Optional[Dict[str, Any]] = None,
        stream: bool = False,
        timeout: Optional[float] = None,
        retry: Optional[bool] = None,
    ) -> Response:
        """One master request with bounded retries.

        Only idempotent methods retry by default; ``retry`` overrides in
        either direction (a POST to an idempotent endpoint may opt in, a
        GET that must not repeat may opt out).  429 responses are retried
        for every method — rate-limited requests were not executed — and
        429/503 honor the server's ``Retry-After``.  ``stream`` is taken
        for the JAX session's signature; the body is always read whole.
        """
        del stream
        url = self.master_url + (path if path.startswith("/") else "/" + path)
        if params:
            url += "?" + urllib.parse.urlencode(params)
        body = json_mod.dumps(json).encode() if json is not None else None
        retryable = retry if retry is not None else method.upper() in IDEMPOTENT_METHODS
        attempts = self.RETRIES if retryable else 1
        last: Optional[BaseException] = None
        attempt = 0
        rate_limited = 0  # 429s retry for every method, on their own counter
        while attempt < attempts:
            try:
                # inside the try so an injected ConnectionError exercises
                # the same retry machinery the real fault would
                faults.fire("api.request", method=method, path=path, attempt=attempt)
                resp = self._send(method.upper(), url, body, timeout or self.timeout)
            except (OSError, http.client.HTTPException) as e:
                if not isinstance(e, (ConnectionError, TimeoutError, urllib.error.URLError,
                                      http.client.HTTPException)):
                    raise
                # a read timeout rides the same path: the classic symptom of
                # a master dying mid-response, and for idempotent/opted-in
                # requests a retry is what the restarted master expects
                last = _transport_error(e)
                attempt += 1
                if attempt < attempts:
                    time.sleep(self._backoff_delay(attempt - 1))
                continue
            if resp.status_code == 404:
                raise NotFoundError(404, resp.text)
            if resp.status_code == 429:
                # not executed server-side: safe to retry any method —
                # unless the caller explicitly opted out of all retries
                last = APIError(429, resp.text, resp.headers.get("Retry-After"))
                if retry is False:
                    raise last
                rate_limited += 1
                if rate_limited >= self.RETRIES:
                    raise last
                time.sleep(
                    self._backoff_delay(rate_limited - 1, resp.headers.get("Retry-After"))
                )
                continue
            if resp.status_code >= 500:
                last = APIError(resp.status_code, resp.text)
                attempt += 1
                if attempt < attempts:
                    retry_after = (
                        resp.headers.get("Retry-After")
                        if resp.status_code == 503
                        else None
                    )
                    time.sleep(self._backoff_delay(attempt - 1, retry_after))
                continue
            if resp.status_code >= 400:
                raise APIError(resp.status_code, resp.text)
            return resp
        raise last if last is not None else APIError(0, "request failed")

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Response:
        return self.request("POST", path, **kw)

    def patch(self, path: str, **kw) -> Response:
        return self.request("PATCH", path, **kw)

    def put(self, path: str, **kw) -> Response:
        return self.request("PUT", path, **kw)

    def delete(self, path: str, **kw) -> Response:
        return self.request("DELETE", path, **kw)


def login(master_url: str, username: str = "determined", password: str = "") -> Session:
    """Authenticate and return a token-carrying Session.  Login is safe to
    repeat (each attempt just mints a token), so the POST opts into
    retries — masters are commonly still coming up when clients connect."""
    s = Session(master_url)
    resp = s.post(
        "/api/v1/auth/login",
        json={"username": username, "password": password},
        retry=True,
    )
    token = resp.json().get("token")
    return Session(master_url, token=token)
