"""The port's client of the master: ``Session`` (``urllib`` with the JAX
session's retry contract) and the CLI's token store
(``determined_tpu/api``)."""

from determined_tpu_torch.api.session import (  # noqa: F401
    TRANSPORT_ERRORS,
    APIError,
    NotFoundError,
    Session,
    login,
)
