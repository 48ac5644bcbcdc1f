"""Replica registration: make a serving worker discoverable via the master
(``determined_tpu/serve/replica.py`` for the port).

A replica POSTs itself to ``/api/v1/serving/replicas`` with the URL it
listens on, heartbeats on an interval, and the master prunes any replica
whose heartbeat goes stale (crash, partition, SIGKILL), so ``GET
/api/v1/serving`` is always the live routing table.  A heartbeat answered
404 means the master forgot us (restart, prune race): the thread
re-registers with the same payload rather than dying.

The heartbeat response is also the master's only channel TO the worker:
during a rolling deploy (``POST /api/v1/serving/deploy``) the master
answers the draining replica's heartbeat with ``{"drain": true, "deploy":
{...target...}}`` — the worker then runs its normal drain (503-new,
finish in-flight, deregister, exit 75) and whatever supervises it
relaunches it on the target version.

The port's session raises the built-in ``ConnectionError`` and
``TimeoutError`` for a master it cannot reach (``api.TRANSPORT_ERRORS``),
where the JAX session raises ``requests``' classes: those are what the
heartbeat rides out here.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Any, Callable, Dict, Optional

from determined_tpu_torch.api.session import (
    TRANSPORT_ERRORS,
    APIError,
    NotFoundError,
    Session,
)

logger = logging.getLogger("determined_tpu_torch.serve.replica")

#: ceiling on the heartbeat's 429 backoff — stay a couple of TTL windows
#: under the master's reap horizon while still easing off a shedding master
MAX_THROTTLE_S = 30.0


class ReplicaRegistration:
    """Owns the replica's master-side lifecycle + the heartbeat thread."""

    def __init__(
        self,
        session: Session,
        *,
        url: str,
        model: str = "",
        checkpoint: str = "",
        model_name: str = "",
        model_version: int = 0,
        task_id: str = "",
        heartbeat_interval_s: float = 2.0,
        stats_fn: Optional[Any] = None,
        on_drain: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self._session = session
        self._payload: Dict[str, Any] = {
            "url": url,
            "model": model,
            "checkpoint": checkpoint,
        }
        if model_name:
            # registry-launched (--model name@version): the resolved
            # version rides registration so the listing shows it
            self._payload["model_name"] = model_name
            self._payload["model_version"] = int(model_version)
        if task_id:
            # supervisor-launched: lets the master's fleet supervisor bind
            # this replica back to the slot whose task is running it
            self._payload["task_id"] = task_id
        self._interval = heartbeat_interval_s
        #: called once (from the heartbeat thread) when the master's
        #: heartbeat response asks this replica to drain (rolling deploy)
        self._on_drain = on_drain
        self.drain_requested = threading.Event()
        self.drain_info: Dict[str, Any] = {}
        #: zero-arg callable whose dict rides each heartbeat, surfacing
        #: queue depth / kv utilization in the master's replica listing
        self._stats_fn = stats_fn
        self._lock = threading.Lock()  # guards replica_id + throttled
        self.replica_id: Optional[str] = None
        #: consecutive 429s from the master's admission control; each one
        #: stretches the next heartbeat exponentially (jittered, capped)
        #: instead of hammering a shedding master on the fixed cadence
        self.throttled = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _throttle_delay(self, retry_after: Optional[str] = None) -> float:
        """Next heartbeat delay after ``self.throttled`` consecutive 429s:
        the master's ``Retry-After`` (seconds form) when given, else
        capped exponential backoff off the base interval with +/-50%
        jitter so a throttled fleet doesn't re-stampede in lockstep."""
        if retry_after:
            try:
                return max(float(retry_after), 0.0)
            except ValueError:
                pass  # HTTP-date form: fall through to computed backoff
        with self._lock:
            throttled = self.throttled
        return min(
            MAX_THROTTLE_S,
            self._interval * (2 ** max(throttled, 1)) * random.uniform(0.5, 1.5),
        )

    # -- registration --------------------------------------------------------

    def register(self) -> str:
        resp = self._session.post(
            "/api/v1/serving/replicas", json=dict(self._payload), retry=True
        )
        rid = resp.json()["id"]
        with self._lock:
            self.replica_id = rid
        logger.info("registered serving replica %s (%s)", rid, self._payload["url"])
        return rid

    def start(self) -> "ReplicaRegistration":
        """Register and keep the registration alive in the background."""
        self.register()
        self._thread = threading.Thread(
            target=self._run, name="dtpu-serve-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    # -- heartbeat loop ------------------------------------------------------

    def _run(self) -> None:
        delay = self._interval
        while not self._stop.wait(delay):
            delay = self._interval  # 429 handling below stretches this
            with self._lock:
                rid = self.replica_id
            if rid is None:
                continue
            body: Dict[str, Any] = {}
            if self._stats_fn is not None:
                try:
                    body["stats"] = self._stats_fn()
                except Exception:  # noqa: BLE001 - stats must not kill liveness
                    logger.exception("stats collection failed; heartbeat without")
            try:
                resp = self._session.post(
                    f"/api/v1/serving/replicas/{rid}/heartbeat",
                    json=body,
                    retry=False,
                )
                with self._lock:
                    self.throttled = 0
                self._handle_heartbeat_response(resp)
            except NotFoundError:
                # master forgot us (restart or prune race): re-register.
                # The catch is deliberately broad — register() uses a
                # retrying POST whose terminal failure is a ConnectionError
                # (master still down), and an exception escaping THIS
                # except-block would kill the heartbeat thread for good;
                # the worker must keep serving and keep retrying instead.
                logger.warning("replica %s unknown to master; re-registering", rid)
                try:
                    self.register()
                    with self._lock:
                        self.throttled = 0
                except APIError as e:
                    if e.status == 429:
                        # admission control sheds re-registrations too:
                        # ease off instead of re-stampeding every interval
                        with self._lock:
                            self.throttled += 1
                        delay = self._throttle_delay(e.retry_after)
                        logger.warning(
                            "re-registration of replica %s shed (429); "
                            "retrying in %.1fs", rid, delay,
                        )
                    else:
                        logger.warning(
                            "re-registration of replica %s failed (HTTP %d); "
                            "will retry on the next heartbeat", rid, e.status,
                        )
                except TRANSPORT_ERRORS:
                    # routine during a master restart window: warn without a
                    # traceback (this repeats every interval until it lands)
                    logger.warning(
                        "re-registration of replica %s failed (master still "
                        "unreachable?); will retry on the next heartbeat", rid,
                    )
                except Exception:  # noqa: BLE001 - survive, but keep the trace
                    logger.exception(
                        "re-registration of replica %s failed; will retry", rid
                    )
            except TRANSPORT_ERRORS:
                # master down/restarting: a serving replica keeps serving
                # through a control-plane outage and re-registers when the
                # master's heartbeat 404 says it forgot us
                logger.warning(
                    "master unreachable; heartbeat for replica %s will retry", rid
                )
            except APIError as e:
                if e.status == 429:
                    # the master's admission control is shedding load: back
                    # off — the TTL is sized in intervals, so the capped
                    # delay keeps us alive while easing pressure
                    with self._lock:
                        self.throttled += 1
                    delay = self._throttle_delay(e.retry_after)
                    logger.warning(
                        "heartbeat for replica %s shed (429); next in %.1fs",
                        rid, delay,
                    )
                else:
                    # transient master trouble: keep beating, the master-side
                    # TTL is several intervals wide
                    logger.warning("heartbeat failed for replica %s", rid)
            except Exception:  # noqa: BLE001 - the heartbeat must survive
                logger.exception("heartbeat error for replica %s", rid)

    def _handle_heartbeat_response(self, resp: Any) -> None:
        """The master's answer may carry a rolling-deploy drain request."""
        try:
            data = resp.json()
        except ValueError:
            return
        if not isinstance(data, dict) or not data.get("drain"):
            return
        if not self.drain_requested.is_set():
            # published BEFORE drain_requested.set(), and every reader
            # gates on that Event (release/acquire ordering)
            self.drain_info = dict(data.get("deploy") or {})
            self.drain_requested.set()
            logger.info(
                "master requested drain (rolling deploy -> %s)",
                self.drain_info.get("target") or "?",
            )
            if self._on_drain is not None:
                try:
                    self._on_drain(self.drain_info)
                except Exception:  # noqa: BLE001 - must not kill the heartbeat
                    logger.exception("on_drain callback failed")

    # -- shutdown ------------------------------------------------------------

    def close(self, deregister: bool = True) -> None:
        """Stop heartbeating; optionally remove the master-side record so
        a drained replica disappears immediately instead of at TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 2 * self._interval))
            self._thread = None
        with self._lock:
            rid, self.replica_id = self.replica_id, None
        if deregister and rid is not None:
            try:
                self._session.delete(f"/api/v1/serving/replicas/{rid}")
            except (APIError, *TRANSPORT_ERRORS):
                logger.warning("deregistration of %s failed (master will prune)", rid)
