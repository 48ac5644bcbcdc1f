"""Python SDK: ORM-ish client objects over the master REST API (the port's
``determined_tpu/client.py``, on its standard-library session).

Reference: ``harness/determined/experimental/client.py:107-623`` —
``Determined`` entry object with ``create_experiment`` / ``get_experiment``
/ ``get_trial`` / checkpoint + model registry objects, the serving fleet
(rolling deploys, the supervised fleet, the master's ``/v1/generate``
router), and module-level convenience functions bound to a default client.
The CLI's master verbs are built on this SDK, so every one is scriptable.
Transport failures surface as the built-in ``ConnectionError`` and
``TimeoutError`` (``api.TRANSPORT_ERRORS``).

Usage::

    from determined_tpu_torch import client
    d = client.Determined("http://master:8080")
    d.set_serving_fleet("lm@1", 2)
    d.generate([1, 2, 3], max_new_tokens=8)["tokens"]
"""

from __future__ import annotations

import base64
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Union

from determined_tpu_torch.api.authentication import ensure_session, login as _auth_login
from determined_tpu_torch.api.session import Session

TERMINAL_STATES = ("COMPLETED", "CANCELED", "ERROR")


class _Resource:
    """Base for API-backed objects: a Session + a raw dict snapshot."""

    def __init__(self, session: Session, data: Dict[str, Any]) -> None:
        self._session = session
        self._data = dict(data)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)


class Experiment(_Resource):
    @property
    def id(self) -> int:
        return int(self._data["id"])

    @property
    def state(self) -> str:
        return self._data["state"]

    @property
    def progress(self) -> float:
        return float(self._data.get("progress", 0.0))

    @property
    def config(self) -> Dict[str, Any]:
        return self._data.get("config") or {}

    def reload(self) -> "Experiment":
        self._data = self._session.get(f"/api/v1/experiments/{self.id}").json()
        return self

    def _signal(self, verb: str) -> "Experiment":
        self._session.post(f"/api/v1/experiments/{self.id}/{verb}")
        return self.reload()

    def pause(self) -> "Experiment":
        return self._signal("pause")

    def activate(self) -> "Experiment":
        return self._signal("activate")

    def cancel(self) -> "Experiment":
        return self._signal("cancel")

    def kill(self) -> "Experiment":
        return self._signal("kill")

    def fork(self, config_overrides: Optional[Dict[str, Any]] = None) -> "Experiment":
        """New experiment from this one's config (+ overrides); inherits the
        context directory, starts from scratch."""
        resp = self._session.post(
            f"/api/v1/experiments/{self.id}/fork",
            json={"config": config_overrides or {}},
        )
        return Experiment(self._session, resp.json()).reload()

    def continue_(self, config_overrides: Optional[Dict[str, Any]] = None) -> "Experiment":
        """Fork whose trials resume from this experiment's newest
        checkpoint (reference handleContinueExperiment)."""
        resp = self._session.post(
            f"/api/v1/experiments/{self.id}/continue",
            json={"config": config_overrides or {}},
        )
        return Experiment(self._session, resp.json()).reload()

    def delete(self) -> None:
        """Delete this terminal experiment: records removed, checkpoints
        and profiler traces GC'd from storage (reference: det experiment
        delete)."""
        self._session.delete(f"/api/v1/experiments/{self.id}")

    def wait(self, timeout: Optional[float] = None, interval: float = 1.0) -> str:
        """Poll until the experiment reaches a terminal state; returns it."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            self.reload()
            if self.state in TERMINAL_STATES:
                return self.state
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"experiment {self.id} still {self.state} after {timeout}s"
                )
            time.sleep(interval)

    def get_trials(self) -> List["Trial"]:
        self.reload()
        return [
            Trial(self._session, t if isinstance(t, dict) else {"id": t})
            for t in self._data.get("trials", [])
        ]

    def best_trial(
        self, metric: Optional[str] = None, smaller_is_better: Optional[bool] = None
    ) -> Optional["Trial"]:
        """Trial with the best reported searcher metric (reference:
        client.py Experiment top_checkpoint / ordering semantics)."""
        scfg = (self.config.get("searcher") or {})
        metric = metric or scfg.get("metric", "loss")
        if smaller_is_better is None:
            smaller_is_better = bool(scfg.get("smaller_is_better", True))
        best, best_val = None, None
        for t in self.get_trials():
            val = t.reload().summary_metric(metric)
            if val is None:
                continue
            if (
                best_val is None
                or (smaller_is_better and val < best_val)
                or (not smaller_is_better and val > best_val)
            ):
                best, best_val = t, val
        return best


class Trial(_Resource):
    @property
    def id(self) -> int:
        return int(self._data["id"])

    @property
    def state(self) -> str:
        return self._data.get("state", "")

    def reload(self) -> "Trial":
        self._data = self._session.get(f"/api/v1/trials/{self.id}").json()
        return self

    def iter_metrics(self, group: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        """Yield reported metric records, oldest first (reference:
        client.py Trial.iter_metrics / stream_trials_metrics)."""
        params = {"group": group} if group else None
        rows = self._session.get(
            f"/api/v1/trials/{self.id}/metrics", params=params
        ).json()
        yield from rows

    def summary_metric(self, name: str, group: str = "validation") -> Optional[float]:
        """Latest reported value of one validation metric."""
        last = None
        for row in self.iter_metrics(group=group):
            metrics = row.get("metrics", row)
            if name in metrics:
                last = metrics[name]
        return None if last is None else float(last)

    def logs(
        self, follow: bool = False, timeout: Optional[float] = None
    ) -> Iterator[str]:
        """Yield log lines; ``follow=True`` streams until the trial leaves
        PENDING/RUNNING (or ``timeout`` seconds elapse, if given)."""
        offset = 0
        deadline = None if timeout is None else time.time() + timeout
        while True:
            lines = self._session.get(
                f"/api/v1/trials/{self.id}/logs", params={"offset": offset}
            ).json()
            yield from lines
            offset += len(lines)
            if not follow:
                return
            self.reload()
            if self.state not in ("PENDING", "RUNNING"):
                return
            if deadline is not None and time.time() > deadline:
                return
            time.sleep(0.5)

    def list_checkpoints(self) -> List["Checkpoint"]:
        # the master's listing iterates a uuid-keyed map (arbitrary order)
        # and keeps gc'd records as state=DELETED tombstones: drop those
        # and sort by steps_completed so [-1] is the newest checkpoint,
        # which gc retention (save_trial_latest) guarantees is on disk
        cps = self._session.get("/api/v1/checkpoints").json()
        mine = [
            c
            for c in cps
            if c.get("trial_id") == self.id and c.get("state") != "DELETED"
        ]
        mine.sort(
            key=lambda c: (
                (c.get("metadata") or {}).get("steps_completed") or 0,
                c.get("uuid") or "",
            )
        )
        return [Checkpoint(self._session, c) for c in mine]


class Checkpoint(_Resource):
    @property
    def uuid(self) -> str:
        return self._data["uuid"]

    @property
    def trial_id(self) -> Optional[int]:
        tid = self._data.get("trial_id")
        return None if tid is None else int(tid)

    @property
    def metadata(self) -> Dict[str, Any]:
        return self._data.get("metadata") or {}

    def reload(self) -> "Checkpoint":
        self._data = self._session.get(f"/api/v1/checkpoints/{self.uuid}").json()
        return self

    def delete(self) -> None:
        self._session.delete(f"/api/v1/checkpoints/{self.uuid}")

    def download(self, target_dir: Optional[str] = None) -> str:
        """Fetch the checkpoint's files locally via the owning experiment's
        storage config; returns the local directory (reference:
        ``Checkpoint.download``).  Pair with
        ``train.load_trial_from_checkpoint`` to rebuild the model."""
        if self.trial_id is None:
            raise ValueError("checkpoint has no trial; cannot resolve storage")
        trial = self._session.get(f"/api/v1/trials/{self.trial_id}").json()
        exp = self._session.get(
            f"/api/v1/experiments/{trial['experiment_id']}"
        ).json()
        storage_raw = (exp.get("config") or {}).get("checkpoint_storage")
        if not storage_raw:
            raise ValueError("experiment config has no checkpoint_storage")
        import tempfile

        from determined_tpu_torch.config.experiment import CheckpointStorageConfig
        from determined_tpu_torch.storage import from_string

        storage = from_string(CheckpointStorageConfig.parse(dict(storage_raw)).to_url())

        target = target_dir or tempfile.mkdtemp(prefix=f"dtpu-ckpt-{self.uuid}-")
        storage.download(self.uuid, target)
        return target


class ModelVersion(_Resource):
    @property
    def version(self) -> int:
        return int(self._data["version"])

    @property
    def checkpoint_uuid(self) -> str:
        return self._data.get("checkpoint_uuid", "")

    @property
    def storage_path(self) -> str:
        return self._data.get("storage_path", "")


class Model(_Resource):
    @property
    def name(self) -> str:
        return self._data["name"]

    def reload(self) -> "Model":
        self._data = self._session.get(f"/api/v1/models/{self.name}").json()
        return self

    def register_version(
        self, checkpoint_uuid: str, metadata: Optional[Dict[str, Any]] = None
    ) -> ModelVersion:
        resp = self._session.post(
            f"/api/v1/models/{self.name}/versions",
            json={"checkpoint_uuid": checkpoint_uuid, "metadata": metadata or {}},
        )
        return ModelVersion(self._session, resp.json())

    def get_versions(self) -> List[ModelVersion]:
        rows = self._session.get(f"/api/v1/models/{self.name}/versions").json()
        return [ModelVersion(self._session, r) for r in rows]


class Determined:
    """SDK entry point (reference: ``determined.experimental.Determined``)."""

    def __init__(
        self,
        master: Optional[str] = None,
        user: Optional[str] = None,
        password: Optional[str] = None,
        session: Optional[Session] = None,
    ) -> None:
        self.master = (
            master or os.environ.get("DTPU_MASTER") or "http://127.0.0.1:8080"
        )
        self._session = session or ensure_session(self.master, user, password)

    @property
    def session(self) -> Session:
        return self._session

    # -- experiments --
    def create_experiment(
        self,
        config: Union[str, Dict[str, Any]],
        context_dir: Optional[str] = None,
        context_bytes: Optional[bytes] = None,
        template: Optional[str] = None,
    ) -> Experiment:
        """Submit an experiment; ``config`` is a yaml path or a dict.
        ``context_dir`` is packed (honoring .detignore) and shipped;
        pass ``context_bytes`` instead if you already packed it.
        ``template`` names a master-stored config template the config is
        merged over (config wins; reference templates/)."""
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        from determined_tpu_torch.config.experiment import ExperimentConfig

        if template is None:
            ExperimentConfig.parse(dict(config))  # client-side validation
        body: Dict[str, Any] = {"config": config}
        if template is not None:
            body["template"] = template
        if context_bytes is None and context_dir:
            from determined_tpu_torch.common import build_context

            context_bytes = build_context(context_dir)
        if context_bytes is not None:
            body["context"] = base64.b64encode(context_bytes).decode()
        resp = self._session.post("/api/v1/experiments", json=body)
        return Experiment(self._session, resp.json())

    def get_experiment(self, experiment_id: int) -> Experiment:
        return Experiment(
            self._session,
            self._session.get(f"/api/v1/experiments/{experiment_id}").json(),
        )

    def list_experiments(
        self,
        workspace: Optional[str] = None,
        project: Optional[str] = None,
        owner: Optional[str] = None,
    ) -> List[Experiment]:
        params = {
            k: v
            for k, v in {
                "workspace": workspace, "project": project, "owner": owner
            }.items()
            if v is not None
        }
        rows = self._session.get("/api/v1/experiments", params=params or None).json()
        return [Experiment(self._session, r) for r in rows]

    def list_workspaces(self) -> List[Dict[str, Any]]:
        """Workspace/project tree with experiment counts."""
        return self._session.get("/api/v1/workspaces").json()

    # -- trials / checkpoints --
    def get_trial(self, trial_id: int) -> Trial:
        return Trial(
            self._session, self._session.get(f"/api/v1/trials/{trial_id}").json()
        )

    def get_checkpoint(self, uuid: str) -> Checkpoint:
        return Checkpoint(
            self._session, self._session.get(f"/api/v1/checkpoints/{uuid}").json()
        )

    def list_checkpoints(self) -> List[Checkpoint]:
        rows = self._session.get("/api/v1/checkpoints").json()
        return [Checkpoint(self._session, r) for r in rows]

    # -- model registry --
    def create_model(
        self, name: str, description: str = "", metadata: Optional[Dict] = None
    ) -> Model:
        resp = self._session.post(
            "/api/v1/models",
            json={"name": name, "description": description, "metadata": metadata or {}},
        )
        return Model(self._session, resp.json())

    def get_model(self, name: str) -> Model:
        return Model(self._session, self._session.get(f"/api/v1/models/{name}").json())

    def get_models(self) -> List[Model]:
        rows = self._session.get("/api/v1/models").json()
        return [Model(self._session, r) for r in rows]

    def resolve_model_version(self, ref: str) -> ModelVersion:
        """Resolve ``name[@version|@latest]`` to its registered version
        (checkpoint uuid + storage path + lineage)."""
        from determined_tpu_torch.experiment.registry import resolve_version

        return ModelVersion(self._session, resolve_version(self._session, ref))

    def deploy_model(
        self,
        ref: str,
        *,
        canary_fraction: Optional[float] = None,
        rollback_on_regression: bool = False,
        bake_seconds: Optional[float] = None,
        min_requests: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Start a rolling deployment of a registry version onto the
        serving fleet; returns the deploy state (poll
        ``get_serving_deploy`` until ``status != "rolling"``).

        With ``canary_fraction`` the master rolls only that cohort first,
        bakes it for ``bake_seconds`` comparing error rate and latency
        against the pre-roll baseline, and either finishes the roll or
        holds (``rollback_on_regression=True`` rolls the cohort back to
        the prior version instead of holding)."""
        from determined_tpu_torch.experiment.registry import parse_model_ref

        name, version = parse_model_ref(ref)
        body: Dict[str, Any] = {"model": name, "version": version}
        if canary_fraction is not None:
            body["canary_fraction"] = float(canary_fraction)
            if bake_seconds is not None:
                body["bake_seconds"] = float(bake_seconds)
            if min_requests is not None:
                body["min_requests"] = int(min_requests)
            if rollback_on_regression:
                body["rollback_on_regression"] = True
        return self._session.post("/api/v1/serving/deploy", json=body).json()

    def get_serving_deploy(self) -> Dict[str, Any]:
        return self._session.get("/api/v1/serving/deploy").json()

    def set_serving_fleet(
        self,
        ref: str,
        target: int,
        *,
        pool: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Declare the serving-fleet spec: ``target`` replicas of registry
        version ``ref`` (``name@version``).  The master's supervisor
        launches replicas as agent tasks and relaunches any that die
        (capped backoff; crash loops mark the fleet degraded).  ``config``
        merges into each replica's task config (``resources.slots``,
        ``serve`` overrides, ``env``)."""
        from determined_tpu_torch.experiment.registry import parse_model_ref

        name, version = parse_model_ref(ref)
        body: Dict[str, Any] = {
            "model": name,
            "version": version,
            "target": int(target),
        }
        if pool:
            body["pool"] = pool
        if config:
            body["config"] = config
        return self._session.put("/api/v1/serving/fleet", json=body).json()

    def get_serving_fleet(self) -> Dict[str, Any]:
        """The supervised fleet's spec + per-slot status (404 when no
        fleet spec has been declared)."""
        return self._session.get("/api/v1/serving/fleet").json()

    def get_serving(self) -> List[Dict[str, Any]]:
        """The live serving-replica routing table."""
        return self._session.get("/api/v1/serving").json()

    def generate(
        self,
        prompt_tokens: List[int],
        *,
        max_new_tokens: Optional[int] = None,
        session_key: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Generate through the master's router (``POST /v1/generate``):
        the master picks the least-loaded replica with consistent-hash
        affinity on ``session_key`` (or the prompt prefix), so repeated
        calls with the same key land on the replica holding the prefix
        cache.  Raises on 503 (no live replica / fleet saturated) like
        every other binding — callers retry with backoff."""
        body: Dict[str, Any] = {"prompt_tokens": list(prompt_tokens)}
        if max_new_tokens is not None:
            body["max_new_tokens"] = int(max_new_tokens)
        if session_key is not None:
            body["session"] = session_key
        return self._session.post("/v1/generate", json=body).json()

    # -- generic tasks (NTSC: tensorboard viewer behind the proxy) --
    def start_tensorboard(
        self, experiment_ids: Optional[List[int]] = None
    ) -> Dict[str, Any]:
        """Launch a tensorboard/metrics-viewer task; returns task info with
        ``proxy_url`` (reference: ``det tensorboard start``)."""
        resp = self._session.post(
            "/api/v1/tasks",
            json={
                "type": "tensorboard",
                "config": {"experiment_ids": experiment_ids or []},
            },
        )
        return resp.json()

    def start_notebook(
        self, work_dir: Optional[str] = None, resource_pool: Optional[str] = None
    ) -> Dict[str, Any]:
        """Launch a Jupyter notebook task behind the proxy (reference:
        ``det notebook start``)."""
        body: Dict[str, Any] = {
            "type": "notebook", "config": {"work_dir": work_dir or ""},
        }
        if resource_pool:
            body["resource_pool"] = resource_pool
        resp = self._session.post("/api/v1/tasks", json=body)
        return resp.json()

    def run_command(
        self,
        entrypoint: Any,
        *,
        resource_pool: Optional[str] = None,
        slots: int = 0,
        env: Optional[Dict[str, str]] = None,
        work_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Run an arbitrary command as a scheduler-placed task (reference:
        ``det cmd run``, ``master/internal/command/command.go``).
        ``entrypoint`` is an argv list or a shell string."""
        config: Dict[str, Any] = {"entrypoint": entrypoint}
        if env:
            config["env"] = dict(env)
        if work_dir:
            config["work_dir"] = work_dir
        if slots:
            config["resources"] = {"slots": int(slots)}
        body: Dict[str, Any] = {"type": "command", "config": config}
        if resource_pool:
            body["resource_pool"] = resource_pool
        return self._session.post("/api/v1/tasks", json=body).json()

    def task_logs(self, task_id: str) -> List[Dict[str, Any]]:
        return self._session.get(f"/api/v1/tasks/{task_id}/logs").json()

    def wait_task_done(self, task_id: str, timeout: float = 120.0) -> Dict[str, Any]:
        """Wait until the task reaches TERMINATED (commands run to
        completion; viewers terminate on kill/idle)."""
        deadline = time.time() + timeout
        while True:
            info = self.get_task(task_id)
            if info.get("state") == "TERMINATED":
                return info
            if time.time() > deadline:
                raise TimeoutError(f"task {task_id} still running after {timeout}s")
            time.sleep(0.5)

    def start_shell(self, shell: Optional[str] = None) -> Dict[str, Any]:
        """Launch a shell task (PTY behind a websocket through the proxy;
        reference: ``det shell start`` + sshd tunnel)."""
        resp = self._session.post(
            "/api/v1/tasks",
            json={"type": "shell", "config": {"shell": shell or "/bin/sh"}},
        )
        return resp.json()

    def open_shell_ws(self, task_id: str):
        """Open the shell task's websocket through the master proxy.  The
        websocket client (``determined_tpu/common/ws.py``) and the shell
        task are a later slice of the port: this raises."""
        raise NotImplementedError(
            f"open_shell_ws({task_id!r}): the websocket client and the shell task "
            "(common/ws.py, exec/shell.py) come with a later slice of determined_tpu_torch"
        )

    def get_task(self, task_id: str) -> Dict[str, Any]:
        return self._session.get(f"/api/v1/tasks/{task_id}").json()

    def list_tasks(self) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/tasks").json()

    def kill_task(self, task_id: str) -> None:
        self._session.delete(f"/api/v1/tasks/{task_id}")

    def wait_task_ready(self, task_id: str, timeout: float = 60.0) -> Dict[str, Any]:
        deadline = time.time() + timeout
        while True:
            info = self.get_task(task_id)
            if info.get("ready"):
                return info
            if info.get("state") == "TERMINATED":
                raise RuntimeError(f"task {task_id} terminated before ready")
            if time.time() > deadline:
                raise TimeoutError(f"task {task_id} not ready after {timeout}s")
            time.sleep(0.5)

    # -- named access tokens (reference internal/token/) --
    def create_token(
        self, name: str, ttl_days: int = 30, username: Optional[str] = None
    ) -> Dict[str, Any]:
        """Create a named access token.  The returned dict's ``token`` is
        the only time the secret is shown; list/revoke use ``id``."""
        body: Dict[str, Any] = {"name": name, "ttl_days": ttl_days}
        if username:
            body["username"] = username
        return self._session.post("/api/v1/tokens", json=body).json()

    def list_tokens(self) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/tokens").json()

    def revoke_token(self, token_id: str) -> None:
        self._session.delete(f"/api/v1/tokens/{token_id}")

    # -- workspaces (reference api_project.go + rbac/) --
    def create_workspace(self, name: str) -> Dict[str, Any]:
        return self._session.post("/api/v1/workspaces", json={"name": name}).json()

    def list_workspaces(self) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/workspaces").json()

    def archive_workspace(self, name: str, archived: bool = True) -> None:
        from urllib.parse import quote

        verb = "archive" if archived else "unarchive"
        self._session.post(f"/api/v1/workspaces/{quote(name, safe='')}/{verb}")

    def delete_workspace(self, name: str) -> None:
        from urllib.parse import quote

        self._session.delete(f"/api/v1/workspaces/{quote(name, safe='')}")

    def assign_workspace_role(self, name: str, username: str, role: str) -> None:
        """Bind ``username`` to ``role`` (viewer/user/admin; "none" removes)
        in workspace ``name``; a workspace with any binding is restricted
        to bound users + its owner + cluster admins."""
        from urllib.parse import quote

        self._session.put(
            f"/api/v1/workspaces/{quote(name, safe='')}/roles",
            json={"username": username, "role": role},
        )

    # -- streaming events (reference common/streams/_client.py) --
    def events(
        self,
        since: int = 0,
        follow: bool = False,
        types: Optional[List[str]] = None,
        poll_timeout: float = 30.0,
    ):
        """Iterate the master's seq-ordered event feed.

        The reference streams entity deltas over a websocket
        (``harness/determined/common/streams/_client.py``); here the
        journal doubles as the feed and a long-poll carries it.  Yields
        event dicts (each has ``seq`` + ``type``); with ``follow=True``
        blocks for new events until the caller breaks, otherwise returns
        once the backlog is drained.
        """
        while True:
            params = {"since": str(since)}
            if follow:
                params["timeout_seconds"] = str(int(poll_timeout))
            batch = self._session.get("/api/v1/events", params=params).json()
            for ev in batch:
                since = max(since, int(ev.get("seq", since)))
                if types and ev.get("type") not in types:
                    continue
                yield ev
            if not batch and not follow:
                return

    # -- config templates --
    def set_template(self, name: str, config: Dict[str, Any]) -> None:
        self._session.put(f"/api/v1/templates/{name}", json={"config": config})

    def get_template(self, name: str) -> Dict[str, Any]:
        return self._session.get(f"/api/v1/templates/{name}").json()["config"]

    def list_templates(self) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/templates").json()

    def delete_template(self, name: str) -> None:
        self._session.delete(f"/api/v1/templates/{name}")

    # -- streaming updates --
    def stream_events(
        self, since: int = 0, poll_timeout: int = 30
    ) -> Iterator[Dict[str, Any]]:
        """Follow the master's seq-ordered event feed (reference:
        streams client over internal/stream/ websocket deltas; here a
        long-polled journal tail).  Yields events forever; track
        ``event["seq"]`` to resume."""
        while True:
            rows = self._session.get(
                "/api/v1/events",
                params={"since": since, "timeout_seconds": poll_timeout},
                timeout=poll_timeout + 15,
            ).json()
            for ev in rows:
                since = max(since, int(ev.get("seq", 0)))
                yield ev

    def get_events(self, since: int = 0) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/events", params={"since": since}).json()

    # -- cluster --
    def list_agents(self) -> List[Dict[str, Any]]:
        return self._session.get("/api/v1/agents").json()

    def list_resource_pools(self) -> List[Dict[str, Any]]:
        """Declared pools (agent/kubernetes/slurm backends, ``rm.hpp``)
        plus implicit agent pools with slot totals (reference
        ``GetResourcePools``)."""
        return self._session.get("/api/v1/resource-pools").json()

    def master_info(self) -> Dict[str, Any]:
        return self._session.get("/api/v1/master").json()

    def whoami(self) -> Dict[str, Any]:
        return self._session.get("/api/v1/auth/whoami").json()

    def create_user(
        self,
        username: str,
        password: str = "",
        admin: bool = False,
        role: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Create a user; ``role`` is admin/user/viewer (RBAC-lite)."""
        body: Dict[str, Any] = {"username": username, "password": password, "admin": admin}
        if role is not None:
            body["role"] = role
        return self._session.post("/api/v1/users", json=body).json()


# -- module-level convenience (reference: client.py module functions bound to
#    a lazily-created default Determined) --

_default_client: Optional[Determined] = None


def login(
    master: Optional[str] = None,
    user: Optional[str] = None,
    password: Optional[str] = None,
) -> Determined:
    """Authenticate (caching the token) and set the default client."""
    global _default_client
    master = master or os.environ.get("DTPU_MASTER") or "http://127.0.0.1:8080"
    if user is not None:
        session = _auth_login(master, user, password or "")
        _default_client = Determined(master, session=session)
    else:
        _default_client = Determined(master)
    return _default_client


def _require_client() -> Determined:
    global _default_client
    if _default_client is None:
        _default_client = Determined()
    return _default_client


def create_experiment(
    config: Union[str, Dict[str, Any]], context_dir: Optional[str] = None
) -> Experiment:
    return _require_client().create_experiment(config, context_dir)


def get_experiment(experiment_id: int) -> Experiment:
    return _require_client().get_experiment(experiment_id)


def get_trial(trial_id: int) -> Trial:
    return _require_client().get_trial(trial_id)


def get_checkpoint(uuid: str) -> Checkpoint:
    return _require_client().get_checkpoint(uuid)


def get_model(name: str) -> Model:
    return _require_client().get_model(name)
