"""Checkpoint storage of the port: the shared_fs and directory backends
(``determined_tpu/storage`` without its cloud backends)."""

from determined_tpu_torch.storage.base import (  # noqa: F401
    StorageManager,
    file_md5,
    from_string,
    md5_files,
    list_directory,
)
from determined_tpu_torch.storage.shared_fs import (  # noqa: F401
    DirectoryStorageManager,
    SharedFSStorageManager,
)
