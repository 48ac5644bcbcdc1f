"""Token store + session bootstrap for the CLI: a copy of
``determined_tpu/api/authentication.py``.

Reference: ``harness/determined/common/api/authentication.py`` — the ``det``
CLI keeps a per-master token cache under ``~/.determined/auth.json`` and
auto-logs-in as the default ``determined`` user (blank password) when no
credentials are supplied.  Same contract here: resolution order is

1. ``DTPU_TOKEN`` env (explicit override),
2. ``DTPU_SESSION_TOKEN`` env (on-cluster: injected by the master into the
   task environment),
3. cached token for this master url (``~/.dtpu/auth.json``, override path
   via ``DTPU_AUTH_PATH``), validated against the master,
4. fresh login with the given (or default) username/password, cached.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from determined_tpu_torch.api.session import APIError, Session

DEFAULT_USER = "determined"


def _auth_path() -> str:
    return os.environ.get(
        "DTPU_AUTH_PATH", os.path.join(os.path.expanduser("~"), ".dtpu", "auth.json")
    )


class TokenStore:
    """Per-master-url token cache on disk."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or _auth_path()

    def _load(self) -> Dict[str, Dict[str, str]]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, master_url: str) -> Optional[Dict[str, str]]:
        return self._load().get(master_url.rstrip("/"))

    def set(self, master_url: str, username: str, token: str) -> None:
        data = self._load()
        data[master_url.rstrip("/")] = {"username": username, "token": token}
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
        os.chmod(tmp, 0o600)
        os.replace(tmp, self.path)

    def clear(self, master_url: str) -> None:
        data = self._load()
        if data.pop(master_url.rstrip("/"), None) is not None:
            with open(self.path, "w") as f:
                json.dump(data, f, indent=2)


def login(
    master_url: str,
    username: str = DEFAULT_USER,
    password: str = "",
    store: Optional[TokenStore] = None,
) -> Session:
    """Authenticate, cache the token, and return a token-carrying Session."""
    anon = Session(master_url)
    resp = anon.post(
        "/api/v1/auth/login", json={"username": username, "password": password}
    )
    token = resp.json()["token"]
    (store or TokenStore()).set(master_url, username, token)
    return Session(master_url, token=token)


def _token_valid(master_url: str, token: str) -> bool:
    try:
        Session(master_url, token=token).get("/api/v1/users")
        return True
    except APIError:
        return False


def ensure_session(
    master_url: str,
    username: Optional[str] = None,
    password: Optional[str] = None,
) -> Session:
    """Return an authenticated Session using the resolution order above.

    A ``username`` without a ``password`` still prefers that user's cached
    token (so ``dtpu -u alice ...`` works after ``dtpu login -u alice``);
    an explicit password always re-authenticates.
    """
    env_token = os.environ.get("DTPU_TOKEN") or os.environ.get("DTPU_SESSION_TOKEN")
    if env_token:
        return Session(master_url, token=env_token)
    store = TokenStore()
    if password is None:
        cached = store.get(master_url)
        if (
            cached
            and (username is None or cached.get("username") == username)
            and _token_valid(master_url, cached["token"])
        ):
            return Session(master_url, token=cached["token"])
    return login(master_url, username or DEFAULT_USER, password or "", store)
