"""Experiment journal: write-ahead log for crash-recoverable searches.

A copy of ``determined_tpu/experiment/journal.py``: an append-only, fsynced
JSONL file at ``checkpoint_dir/experiment.journal`` that records

- ``experiment_started``   name, raw config, trial entrypoint, seed
- ``cluster_attached``     master url + experiment id (cluster-driven
                           searches, a later slice of the port)
- ``searcher_snapshot``    full ``Searcher.state_json`` (method + ctx
                           request-id counter/rng + trial records)
- ``trial_created``        rid, hparams, source_trial_id
- ``trial_running``        rid, device ids
- ``trial_validated``      rid, steps, metrics
- ``trial_checkpoint``     rid, latest FINALIZED checkpoint uuid
- ``trial_cloned``         rid, source rid, materialized uuid, inherited steps
- ``trial_result``         rid, the completed TrialResult payload
- ``trial_exited`` / ``trial_exited_early``   searcher lifecycle events
- ``model_registered``     registry promotion (name, version, uuid)
- ``experiment_preempted`` / ``experiment_completed``   terminal status

Consistency model: ``JournaledSearcher`` appends each searcher event AND a
fresh snapshot inside the searcher lock, so the only record a crash can
orphan is the very last line.  ``read_journal`` tolerates a truncated tail
and returns the orphaned events so a resume can redeliver them.

Compaction: every ``compact_interval`` appends (at a snapshot record) the
journal atomically rewrites itself (temp file + fsync + ``os.replace``) down
to one snapshot plus the per-trial summaries; an ``on_compact`` hook runs
after the journal lock is released (the experiment applies checkpoint
retention there).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.searcher import Create, Searcher
from determined_tpu_torch.utils import faults

logger = logging.getLogger("determined_tpu_torch.experiment.journal")

JOURNAL_FILENAME = "experiment.journal"
JOURNAL_VERSION = 1

# searcher lifecycle events that a resume may need to redeliver when the
# crash orphaned them (event appended, follow-up snapshot never landed)
_SEARCHER_EVENTS = ("trial_validated", "trial_exited", "trial_exited_early")


class ExperimentJournalError(RuntimeError):
    """Missing/unusable journal where one is required (e.g. resume)."""


def _json_default(obj: Any) -> Any:
    # numpy scalars ride along in validation metric dicts
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            return fn()
    return str(obj)


def journal_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, JOURNAL_FILENAME)


class ExperimentJournal:
    """Append-only experiment WAL with atomic compaction.

    Thread-safe: trial threads journal validations/checkpoints while the
    dispatcher journals lifecycle events.  Every append is flushed AND
    fsynced before returning — a record the caller saw land survives a
    SIGKILL of the driver.
    """

    def __init__(
        self,
        path: str,
        *,
        compact_interval: int = 64,
        on_compact: Optional[Callable[[], None]] = None,
    ) -> None:
        self.path = path
        self.compact_interval = max(int(compact_interval), 0)  # 0 = never
        self._on_compact = on_compact
        self._lock = threading.Lock()
        self._fh: Optional[Any] = None
        self._owner_fd: Optional[int] = None
        self._seq = 0
        self._since_compact = 0
        # rolling memory of what compaction must preserve
        self._started: Optional[Dict[str, Any]] = None
        self._cluster: Optional[Dict[str, Any]] = None
        self._snapshot: Optional[Dict[str, Any]] = None
        self._created: Dict[int, Dict[str, Any]] = {}
        self._checkpoints: Dict[int, Dict[str, Any]] = {}
        self._clones: Dict[int, Dict[str, Any]] = {}
        self._results: Dict[int, Dict[str, Any]] = {}
        # (model name, version) -> registration record; registry-promoted
        # checkpoints stay pinned across compaction and resume
        self._registered: Dict[Any, Dict[str, Any]] = {}
        self._status: Optional[Dict[str, Any]] = None

    # -- lifecycle ---------------------------------------------------------

    def open(self, *, fresh: bool) -> "ExperimentJournal":
        """Open for appending.  ``fresh=True`` truncates any prior journal
        (a NEW run owns the directory); ``fresh=False`` replays an existing
        file into memory so compaction keeps resumed history, and REPAIRS
        it — a crash mid-write leaves a partial trailing line, and
        appending after it would merge two records into one unparseable
        line mid-file, poisoning every later read."""
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._acquire_owner_lock()
        # repair + replay I/O runs OUTSIDE the journal lock: a long journal
        # is megabytes of read/rewrite/fsync, and holding _lock across it
        # would stall any early appender for the whole repair.  Exclusion
        # is already total here — the flock above bars other processes, and
        # no thread of THIS process can append before open() returns.
        records: List[Dict[str, Any]] = []
        if not fresh and os.path.exists(self.path):
            records = _read_records(self.path)
            tmp = self.path + ".repair"
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in records:
                    f.write(json.dumps(rec, default=_json_default) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        with self._lock:
            for rec in records:
                self._absorb(rec)
            self._fh = open(self.path, "w" if fresh else "a", encoding="utf-8")
            return self

    def _acquire_owner_lock(self) -> None:
        """One live driver per journal: a second driver (an operator
        resuming a directory whose run is still alive) must fail loudly,
        not interleave seq numbers and double-dispatch trials.

        ``flock`` on a persistent fd, not a pid file: the kernel releases
        the lock the instant the owner dies (including SIGKILL), so there
        is no staleness heuristic and no unlink/recreate TOCTOU window
        between two racing resumers.  The lock file itself is never
        unlinked — unlinking would let a third process lock a fresh inode
        while a second still holds the old one.  The pid inside is
        diagnostic only (for the refusal message)."""
        import fcntl

        lock_path = self.path + ".lock"
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                owner = os.read(fd, 64).decode(errors="replace").strip() or "unknown"
            finally:
                os.close(fd)
            raise ExperimentJournalError(
                f"experiment journal {self.path} is owned by live driver "
                f"pid {owner}; refusing to double-drive the search"
            ) from None
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._owner_fd = fd

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._owner_fd is not None:
                os.close(self._owner_fd)  # releases the flock
                self._owner_fd = None

    # -- append path -------------------------------------------------------

    def append(self, rec_type: str, **fields: Any) -> Dict[str, Any]:
        compacted = False
        with self._lock:
            if self._fh is None:
                raise ExperimentJournalError("journal is not open")
            self._seq += 1
            rec = {"v": JOURNAL_VERSION, "seq": self._seq, "ts": time.time(),
                   "type": rec_type}
            rec.update(fields)
            # driver-kill fault site: chaos tests crash the experiment
            # driver here, BEFORE the record lands — simulating a crash at
            # the worst moment (the event happened, the WAL never saw it)
            faults.fire("experiment.journal.append", type=rec_type, seq=self._seq)
            io_t0 = time.monotonic()
            self._fh.write(json.dumps(rec, default=_json_default) + "\n")
            self._fh.flush()
            # The fsync IS the append: a record the caller saw land must
            # survive SIGKILL (WAL contract), and appenders must serialize
            # behind the same durability point or seq order and file order
            # could diverge.  Bounded (one record) + traced (journal.append).
            # dtpu: lint-ok[blocking-under-lock]
            os.fsync(self._fh.fileno())
            # append+fsync latency: trial threads block here inside their
            # searcher events, so a slow disk shows up in the goodput
            # ledger as journal time, not mystery "other"
            get_tracer().record_span(
                "journal.append", "journal", io_t0, time.monotonic(), {"type": rec_type}
            )
            self._absorb(rec)
            self._since_compact += 1
            # compact ONLY on snapshot appends: every searcher event is
            # immediately followed by its snapshot (same searcher-locked
            # region), so at a snapshot append no event is orphaned — a
            # compaction at any other record type could drop an event
            # whose follow-up snapshot hasn't landed, silently undoing a
            # searcher decision if the driver then crashed
            if (
                self.compact_interval
                and self._since_compact >= self.compact_interval
                and rec_type == "searcher_snapshot"
            ):
                # Compaction must swap the file while NO append is
                # mid-write — the lock is the atomicity, not an accident;
                # it runs once per compact_interval appends and the heavy
                # follow-up work (GC) already happens outside on_compact.
                # dtpu: lint-ok[blocking-under-lock]
                self._compact_locked()
                compacted = True
        if compacted and self._on_compact is not None:
            # outside the journal lock: the hook may take the searcher lock
            # (GC reads trial metrics) and trial threads take searcher ->
            # journal; invoking under the journal lock would be an ABBA
            try:
                self._on_compact()
            except Exception:  # noqa: BLE001 - GC must not kill the search
                logger.exception("journal on_compact hook failed")
        return rec

    def _absorb(self, rec: Dict[str, Any]) -> None:
        t = rec.get("type")
        self._seq = max(self._seq, int(rec.get("seq", 0)))
        if t == "experiment_started":
            self._started = rec
        elif t == "cluster_attached":
            self._cluster = rec
        elif t == "searcher_snapshot":
            self._snapshot = rec
        elif t == "trial_created":
            self._created[int(rec["rid"])] = rec
        elif t == "trial_checkpoint":
            self._checkpoints[int(rec["rid"])] = rec
        elif t == "trial_cloned":
            self._clones[int(rec["rid"])] = rec
        elif t == "trial_result":
            self._results[int(rec["rid"])] = rec
        elif t == "model_registered":
            self._registered[(rec.get("name"), rec.get("version"))] = rec
        elif t in ("experiment_preempted", "experiment_completed"):
            self._status = rec

    def _compact_locked(self) -> None:
        """Atomically rewrite the journal as one snapshot + summaries."""
        records: List[Dict[str, Any]] = []
        if self._started is not None:
            records.append(self._started)
        if self._cluster is not None:
            records.append(self._cluster)
        if self._snapshot is not None:
            records.append(self._snapshot)
        records.extend(self._created[r] for r in sorted(self._created))
        records.extend(self._clones[r] for r in sorted(self._clones))
        records.extend(self._checkpoints[r] for r in sorted(self._checkpoints))
        records.extend(self._results[r] for r in sorted(self._results))
        records.extend(
            self._registered[k] for k in sorted(self._registered, key=str)
        )
        if self._status is not None:
            records.append(self._status)
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, default=_json_default) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        # fsync the directory so the rename itself is durable
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        self._fh = open(self.path, "a", encoding="utf-8")
        self._since_compact = 0
        logger.info("journal compacted to %d records", len(records))


# -- replay ------------------------------------------------------------------


def _read_records(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # a crash mid-write leaves at most one partial LAST line;
                # a bad line followed by good ones is real corruption
                logger.warning(
                    "journal %s: discarding unparseable line %d", path, i + 1
                )
                break
            records.append(rec)
    return records


@dataclasses.dataclass
class JournalReplay:
    """What a journal says happened, digested for resume/status."""

    records: List[Dict[str, Any]]
    started: Optional[Dict[str, Any]]          # experiment_started payload
    searcher_state: Optional[Dict[str, Any]]   # latest snapshot's state
    tail_events: List[Dict[str, Any]]          # searcher events after it
    created: Dict[int, Dict[str, Any]]         # rid -> hparams
    checkpoints: Dict[int, str]                # rid -> latest ckpt uuid
    clones: Dict[int, Dict[str, Any]]          # rid -> {source, uuid, steps}
    results: Dict[int, Dict[str, Any]]         # rid -> TrialResult payload
    status: str                                # running|preempted|completed
    # registry promotions ({name, version, uuid}): resume keeps these
    # checkpoints pinned against the retention pass
    registered_models: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    # cluster-driven searches (experiment/cluster.py): which master owns
    # trial execution, so a resumed driver re-attaches to the same
    # experiment instead of starting a new one
    cluster: Optional[Dict[str, Any]] = None

    @property
    def in_flight(self) -> List[int]:
        """Trials created but never completed — work a resume re-queues."""
        return sorted(r for r in self.created if r not in self.results)


def read_journal(path: str) -> JournalReplay:
    if not os.path.exists(path):
        raise ExperimentJournalError(
            f"no experiment journal at {path}: nothing to resume "
            "(was the experiment started with fault_tolerance.journal off?)"
        )
    records = _read_records(path)
    if not records:
        raise ExperimentJournalError(f"experiment journal at {path} is empty")
    started: Optional[Dict[str, Any]] = None
    cluster: Optional[Dict[str, Any]] = None
    snapshot: Optional[Dict[str, Any]] = None
    snapshot_seq = -1
    created: Dict[int, Dict[str, Any]] = {}
    checkpoints: Dict[int, str] = {}
    clones: Dict[int, Dict[str, Any]] = {}
    results: Dict[int, Dict[str, Any]] = {}
    registered: List[Dict[str, Any]] = []
    status = "running"
    for rec in records:
        t = rec.get("type")
        if t == "experiment_started":
            started = rec
        elif t == "cluster_attached":
            cluster = rec
        elif t == "searcher_snapshot":
            snapshot = rec
            snapshot_seq = int(rec.get("seq", -1))
        elif t == "trial_created":
            created[int(rec["rid"])] = rec.get("hparams") or {}
        elif t == "trial_checkpoint":
            if rec.get("uuid"):
                checkpoints[int(rec["rid"])] = rec["uuid"]
        elif t == "trial_cloned":
            clones[int(rec["rid"])] = {
                "source": rec.get("source"),
                "uuid": rec.get("uuid"),
                "steps": rec.get("steps") or 0,
            }
            if rec.get("uuid"):
                # the materialized clone is the child's first resume point
                checkpoints[int(rec["rid"])] = rec["uuid"]
        elif t == "trial_result":
            results[int(rec["rid"])] = rec.get("result") or {}
        elif t == "model_registered":
            registered.append(
                {
                    "name": rec.get("name"),
                    "version": rec.get("version"),
                    "uuid": rec.get("uuid"),
                }
            )
        elif t == "experiment_preempted":
            status = "preempted"
        elif t == "experiment_completed":
            status = "completed"
    tail = [
        rec
        for rec in records
        if rec.get("type") in _SEARCHER_EVENTS and int(rec.get("seq", 0)) > snapshot_seq
    ]
    return JournalReplay(
        records=records,
        started=started,
        searcher_state=(snapshot or {}).get("state"),
        tail_events=tail,
        created=created,
        checkpoints=checkpoints,
        clones=clones,
        results=results,
        status=status,
        cluster=cluster,
        registered_models=registered,
    )


def experiment_status(checkpoint_dir: str) -> Dict[str, Any]:
    """Digest a checkpoint_dir's journal into a status report (the data
    behind ``dtpu experiment status``)."""
    replay = read_journal(journal_path(checkpoint_dir))
    started = replay.started or {}
    trials = []
    for rid in sorted(replay.created):
        result = replay.results.get(rid)
        trials.append(
            {
                "request_id": rid,
                "state": "completed" if result is not None else "in_flight",
                "hparams": replay.created[rid],
                "cloned_from": (replay.clones.get(rid) or {}).get("source"),
                "steps_completed": (result or {}).get("steps_completed"),
                "metrics": (result or {}).get("metrics"),
                "checkpoint": (
                    (result or {}).get("checkpoint")
                    if result is not None
                    else replay.checkpoints.get(rid)
                ),
            }
        )
    return {
        "name": started.get("name"),
        "entrypoint": started.get("entrypoint"),
        "seed": started.get("seed"),
        "cluster": (
            None
            if replay.cluster is None
            else {
                "master_url": replay.cluster.get("master_url"),
                "experiment_id": replay.cluster.get("experiment_id"),
            }
        ),
        "status": replay.status,
        "resumable": replay.status != "completed",
        "checkpoint_dir": checkpoint_dir,
        "trials_created": len(replay.created),
        "trials_completed": len(replay.results),
        "trials_in_flight": len(replay.in_flight),
        "trials": trials,
    }


# -- the journaling searcher -------------------------------------------------


class JournaledSearcher(Searcher):
    """Searcher that write-ahead-logs every lifecycle event.

    Event + snapshot are appended while STILL HOLDING the searcher lock
    (reentrant), so records are strictly ordered with the state changes
    they describe: a snapshot in the journal always reflects exactly the
    events before it, and at most the final event of the file can lack its
    follow-up snapshot (crash between the two appends) — ``read_journal``
    surfaces those as ``tail_events`` for redelivery.

    With ``journal`` unset (None) this is byte-for-byte a plain Searcher.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.journal: Optional[ExperimentJournal] = None

    def _journal_event(
        self, event: Optional[str], payload: Dict[str, Any], actions: List[Any]
    ) -> None:
        if self.journal is None:
            return
        if event is not None:
            self.journal.append(event, **payload)
        for a in actions:
            if isinstance(a, Create):
                self.journal.append(
                    "trial_created",
                    rid=a.request_id,
                    hparams=a.hparams,
                    source_trial_id=a.source_trial_id,
                )
        self.journal.append("searcher_snapshot", state=json.loads(self._state_json_locked()))

    # The four lifecycle methods below append (fsync) INSIDE the searcher
    # lock on purpose — it is the journal's consistency model (class
    # docstring): event + snapshot must be strictly ordered with the state
    # change they describe, or a crash could persist a snapshot that
    # contradicts its own event stream.  The cost is one bounded, traced
    # fsync per searcher event; the lock order stays one-way
    # (searcher -> journal), which the lock-order-cycle rule verifies.

    def start(self) -> List[Any]:
        with self._lock:
            already = self._started
            actions = super().start()
            if not already:
                # fsync-under-searcher-lock is the WAL ordering contract
                # dtpu: lint-ok[blocking-under-lock]
                self._journal_event(None, {}, actions)
            return actions

    def on_validation(self, request_id: int, metrics: Dict[str, Any]) -> List[Any]:
        with self._lock:
            actions = super().on_validation(request_id, metrics)
            # fsync-under-searcher-lock is the WAL ordering contract
            # dtpu: lint-ok[blocking-under-lock]
            self._journal_event(
                "trial_validated",
                {"rid": request_id, "metrics": dict(metrics)},
                actions,
            )
            return actions

    def on_trial_exited(self, request_id: int) -> List[Any]:
        with self._lock:
            actions = super().on_trial_exited(request_id)
            # fsync-under-searcher-lock is the WAL ordering contract
            # dtpu: lint-ok[blocking-under-lock]
            self._journal_event("trial_exited", {"rid": request_id}, actions)
            return actions

    def on_trial_exited_early(self, request_id: int, reason: str) -> List[Any]:
        with self._lock:
            actions = super().on_trial_exited_early(request_id, reason)
            # fsync-under-searcher-lock is the WAL ordering contract
            # dtpu: lint-ok[blocking-under-lock]
            self._journal_event(
                "trial_exited_early", {"rid": request_id, "reason": reason}, actions
            )
            return actions
