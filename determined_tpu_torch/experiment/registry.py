"""Driver-side model-registry client: promotion + ``name@version`` refs (a
copy of ``determined_tpu/experiment/registry.py``).

The registry itself lives in the C++ master (``/api/v1/models``; WAL-
journaled, so it survives a master SIGKILL like every other control-plane
mutation — ``docs/registry.md``).  This module is the thin driver-side
layer the experiment drivers share:

- :func:`parse_model_ref` / :func:`format_model_ref` — the ``name@vN`` /
  ``name@latest`` reference grammar;
- :func:`ensure_model` / :func:`register_version` — create-if-missing +
  version registration with full lineage (checkpoint uuid AND storage
  path, source trial/experiment, metrics snapshot, labels).  Registration
  is idempotent master-side: re-posting a version that already exists
  with the same checkpoint is a 200 no-op, so a driver retry after a lost
  response never mints a duplicate;
- :func:`resolve_version` — what ``--model name@latest`` loads from;
- :func:`promote_search_winner` — the ``on_search_complete`` body both
  ``LocalExperiment`` and ``ClusterExperiment`` delegate to when the
  config carries ``registry: {model, auto_promote: true}``.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple, Union

from determined_tpu_torch.api.session import APIError, NotFoundError, Session

logger = logging.getLogger("determined_tpu_torch.experiment.registry")

#: version part of a ref: "latest", "3", or "v3"
_VERSION_RE = re.compile(r"^(?:latest|v?(\d+))$")


def parse_model_ref(ref: str) -> Tuple[str, Union[int, str]]:
    """``"name@v3"``/``"name@3"`` -> ``("name", 3)``; ``"name@latest"``
    and bare ``"name"`` -> ``("name", "latest")``."""
    if not isinstance(ref, str) or not ref:
        raise ValueError(f"model ref must be a non-empty string, got {ref!r}")
    name, sep, version = ref.partition("@")
    if not name:
        raise ValueError(f"model ref {ref!r} has an empty model name")
    if not sep or version == "latest":
        return name, "latest"
    m = _VERSION_RE.match(version)
    if m is None or m.group(1) is None:
        raise ValueError(
            f"model ref {ref!r}: version must be 'latest', 'N', or 'vN'"
        )
    return name, int(m.group(1))


def format_model_ref(name: str, version: int) -> str:
    """The canonical ``name@vN`` label replicas report and deploys target."""
    return f"{name}@v{int(version)}"


def ensure_model(
    session: Session, name: str, *, labels: Optional[List[str]] = None
) -> Dict[str, Any]:
    """Create the model if it does not exist; either way return its json.
    A 409 from the create is the already-exists race, not an error."""
    try:
        return session.post(
            "/api/v1/models", json={"name": name, "labels": list(labels or [])}
        ).json()
    except APIError as e:
        if e.status != 409:
            raise
    return session.get(f"/api/v1/models/{name}").json()


def register_version(
    session: Session,
    name: str,
    *,
    checkpoint_uuid: str,
    storage_path: Optional[str] = None,
    source_trial_id: Optional[int] = None,
    source_experiment_id: Optional[int] = None,
    metrics: Optional[Dict[str, Any]] = None,
    labels: Optional[List[str]] = None,
    version: Optional[int] = None,
) -> Dict[str, Any]:
    """Register ``checkpoint_uuid`` as the next version of ``name``
    (creating the model when needed) and return the version json.  The
    master fills lineage it can derive itself (cluster checkpoints it
    already tracks); a driver-local checkpoint must carry its own
    ``storage_path``.  Pass ``version`` to pin an explicit number — the
    master 409s when it is taken by a different checkpoint."""
    ensure_model(session, name, labels=labels)
    body: Dict[str, Any] = {"checkpoint_uuid": checkpoint_uuid}
    if storage_path:
        body["storage_path"] = storage_path
    if source_trial_id is not None:
        body["source_trial_id"] = int(source_trial_id)
    if source_experiment_id is not None:
        body["source_experiment_id"] = int(source_experiment_id)
    if metrics:
        body["metrics"] = dict(metrics)
    if labels:
        body["labels"] = list(labels)
    if version is not None:
        body["version"] = int(version)
    return session.post(f"/api/v1/models/{name}/versions", json=body).json()


def resolve_version(session: Session, ref: str) -> Dict[str, Any]:
    """Resolve a ``name[@version]`` ref to its version json ({model,
    version, checkpoint_uuid, storage_path, ...})."""
    name, version = parse_model_ref(ref)
    try:
        return session.get(f"/api/v1/models/{name}/versions/{version}").json()
    except NotFoundError as e:
        raise NotFoundError(
            e.status, f"model ref {ref!r} did not resolve: {e.message}"
        ) from e


def registry_session(
    session: Optional[Session] = None, master_url: Optional[str] = None
) -> Optional[Session]:
    """The session promotion should use: an explicit one, else a login to
    ``master_url`` or ``$DTPU_MASTER``.  None when no master is configured
    (a masterless LocalExperiment skips promotion with a warning)."""
    if session is not None:
        return session
    url = master_url or os.environ.get("DTPU_MASTER")
    if not url:
        return None
    from determined_tpu_torch.api.session import login

    return login(url)


def promote_search_winner(
    session: Session,
    *,
    model: str,
    labels: Optional[List[str]],
    checkpoint_uuid: str,
    storage_path: Optional[str],
    source_trial_id: Optional[int],
    source_experiment_id: Optional[int] = None,
    metrics: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Register the search winner's checkpoint as ``model``'s next version
    and return {model, version, checkpoint_uuid, target}."""
    ver = register_version(
        session,
        model,
        checkpoint_uuid=checkpoint_uuid,
        storage_path=storage_path,
        source_trial_id=source_trial_id,
        source_experiment_id=source_experiment_id,
        metrics=metrics,
        labels=labels,
    )
    out = {
        "model": model,
        "version": int(ver["version"]),
        "checkpoint_uuid": ver.get("checkpoint_uuid", checkpoint_uuid),
        "target": format_model_ref(model, int(ver["version"])),
    }
    logger.info(
        "registry: promoted checkpoint %s to %s",
        out["checkpoint_uuid"], out["target"],
    )
    return out
