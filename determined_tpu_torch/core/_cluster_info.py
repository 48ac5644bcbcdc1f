"""ClusterInfo: facts the launch layer passes into the training process (a
copy of ``determined_tpu/core/_cluster_info.py``).

Reference: ``harness/determined/_info.py`` (ClusterInfo via DET_* env
vars + rendezvous info file).  Here everything rides DTPU_* env vars,
written by the agent/launch layer before exec'ing the training script.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class ClusterInfo:
    def __init__(
        self,
        master_url: Optional[str] = None,
        cluster_id: str = "",
        agent_id: str = "",
        task_id: str = "",
        allocation_id: str = "",
        session_token: str = "",
        trial_id: Optional[int] = None,
        experiment_id: Optional[int] = None,
        trial_run_id: int = 0,
        hparams: Optional[Dict[str, Any]] = None,
        latest_checkpoint: Optional[str] = None,
        trial_seed: int = 0,
        num_slots: int = 1,
        slot_ids: Optional[list] = None,
        rendezvous: Optional[Dict[str, Any]] = None,
        exp_config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.master_url = master_url
        self.cluster_id = cluster_id
        self.agent_id = agent_id
        self.task_id = task_id
        self.allocation_id = allocation_id
        self.session_token = session_token
        self.trial_id = trial_id
        self.experiment_id = experiment_id
        self.trial_run_id = trial_run_id
        self.hparams = hparams or {}
        self.latest_checkpoint = latest_checkpoint
        self.trial_seed = trial_seed
        self.num_slots = num_slots
        self.slot_ids = slot_ids or []
        self.rendezvous = rendezvous or {}
        self.exp_config = exp_config or {}

    @classmethod
    def from_env(cls) -> Optional["ClusterInfo"]:
        """None when not running under the platform (off-cluster)."""
        if "DTPU_MASTER_URL" not in os.environ and "DTPU_TRIAL_ID" not in os.environ:
            return None

        def j(name: str) -> Optional[Dict[str, Any]]:
            raw = os.environ.get(name)
            return json.loads(raw) if raw else None

        return cls(
            master_url=os.environ.get("DTPU_MASTER_URL"),
            cluster_id=os.environ.get("DTPU_CLUSTER_ID", ""),
            agent_id=os.environ.get("DTPU_AGENT_ID", ""),
            task_id=os.environ.get("DTPU_TASK_ID", ""),
            allocation_id=os.environ.get("DTPU_ALLOCATION_ID", ""),
            session_token=os.environ.get("DTPU_SESSION_TOKEN", ""),
            trial_id=int(os.environ["DTPU_TRIAL_ID"]) if "DTPU_TRIAL_ID" in os.environ else None,
            experiment_id=(
                int(os.environ["DTPU_EXPERIMENT_ID"])
                if "DTPU_EXPERIMENT_ID" in os.environ
                else None
            ),
            trial_run_id=int(os.environ.get("DTPU_TRIAL_RUN_ID", "0")),
            hparams=j("DTPU_HPARAMS"),
            latest_checkpoint=os.environ.get("DTPU_LATEST_CHECKPOINT") or None,
            trial_seed=int(os.environ.get("DTPU_TRIAL_SEED", "0")),
            num_slots=int(os.environ.get("DTPU_NUM_SLOTS", "1")),
            slot_ids=json.loads(os.environ.get("DTPU_SLOT_IDS", "[]")),
            rendezvous=j("DTPU_RENDEZVOUS"),
            exp_config=j("DTPU_EXP_CONFIG"),
        )

    def to_env(self) -> Dict[str, str]:
        """Inverse of from_env, used by the launch layer."""
        env: Dict[str, str] = {}
        if self.master_url:
            env["DTPU_MASTER_URL"] = self.master_url
        for k, v in [
            ("DTPU_CLUSTER_ID", self.cluster_id),
            ("DTPU_AGENT_ID", self.agent_id),
            ("DTPU_TASK_ID", self.task_id),
            ("DTPU_ALLOCATION_ID", self.allocation_id),
            ("DTPU_SESSION_TOKEN", self.session_token),
        ]:
            if v:
                env[k] = v
        if self.trial_id is not None:
            env["DTPU_TRIAL_ID"] = str(self.trial_id)
        if self.experiment_id is not None:
            env["DTPU_EXPERIMENT_ID"] = str(self.experiment_id)
        env["DTPU_TRIAL_RUN_ID"] = str(self.trial_run_id)
        if self.hparams:
            env["DTPU_HPARAMS"] = json.dumps(self.hparams)
        if self.latest_checkpoint:
            env["DTPU_LATEST_CHECKPOINT"] = self.latest_checkpoint
        env["DTPU_TRIAL_SEED"] = str(self.trial_seed)
        env["DTPU_NUM_SLOTS"] = str(self.num_slots)
        if self.slot_ids:
            env["DTPU_SLOT_IDS"] = json.dumps(self.slot_ids)
        if self.rendezvous:
            env["DTPU_RENDEZVOUS"] = json.dumps(self.rendezvous)
        if self.exp_config:
            env["DTPU_EXP_CONFIG"] = json.dumps(self.exp_config)
        return env


_info_cache: Optional[ClusterInfo] = None
_info_loaded = False


def get_cluster_info() -> Optional[ClusterInfo]:
    global _info_cache, _info_loaded
    if not _info_loaded:
        _info_cache = ClusterInfo.from_env()
        _info_loaded = True
    return _info_cache


def _reset_cluster_info_cache() -> None:
    global _info_cache, _info_loaded
    _info_cache = None
    _info_loaded = False
