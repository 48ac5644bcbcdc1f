"""Client-side helpers shared with the master protocol: the experiment
context tarball (``determined_tpu/common``; its websocket client, ``ws.py``,
is a later slice)."""

from determined_tpu_torch.common.context import (
    ContextTooLargeError,
    build_context,
    extract_context,
    read_detignore,
)

__all__ = [
    "build_context",
    "extract_context",
    "read_detignore",
    "ContextTooLargeError",
]
