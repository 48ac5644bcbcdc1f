"""TLS context for the exec modules' urllib calls to an https master: a
copy of ``determined_tpu/exec/_tls.py``.

The agent injects ``DTPU_MASTER_CERT`` (the CA bundle its own --master-cert
names) into every trial/task process; code that talks to the master
through raw urllib verifies against it — the Session transport already
does (api/session.py).
"""

from __future__ import annotations

import os
import ssl
import urllib.request
from typing import Optional


def master_ssl_context() -> Optional[ssl.SSLContext]:
    ca = os.environ.get("DTPU_MASTER_CERT")
    if not ca:
        return None
    return ssl.create_default_context(cafile=ca)


def urlopen(req, timeout: float = 30.0):
    """urllib.request.urlopen that trusts DTPU_MASTER_CERT for https."""
    return urllib.request.urlopen(req, timeout=timeout, context=master_ssl_context())
