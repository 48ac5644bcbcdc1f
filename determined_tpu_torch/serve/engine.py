"""The serving engine: prefill/decode steps and the batching loops.

Port of ``determined_tpu/serve/engine.py``.  Two engines share one
:class:`DecodeKernels`:

- :class:`ServeEngine`: iteration-level continuous batching.  Every decode
  step, finished sequences retire (blocks freed, response completed) and
  queued requests join the freed lanes immediately.
- :class:`StaticBatchEngine`: the naive baseline.  A batch is formed and
  decoded until every member finishes, and only then replaced.

Every step is shaped by :class:`ServeConfig` (lane count, prompt padding,
block-table width).  The JAX package guards its one-trace-per-step rule
with a RetraceSentinel; eager PyTorch has no trace to count here.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from determined_tpu_torch._device import DeviceLike, resolve_device
from determined_tpu_torch.models.transformer import (
    TransformerLM,
    _check_decodable,
    init_kv_cache,
    transformer_decode,
    transformer_prefill,
    transformer_prefill_suffix,
)
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.serve.config import ServeConfig
from determined_tpu_torch.serve.kv_cache import (
    BlockAllocator,
    CacheOOM,
    prefix_block_hashes,
)
from determined_tpu_torch.serve.scheduler import (
    ActiveSeq,
    AdmissionQueue,
    AdmissionRejected,
    GenRequest,
    LaneTable,
)

logger = logging.getLogger("determined_tpu_torch.serve")


def sample_token(logits: np.ndarray, temperature: float, rng: Any) -> int:
    """Sample one token from f32 logits [vocab]: greedy at temperature 0,
    softmax sampling otherwise.  Shared by the serving engines and the
    full-forward oracle in the parity tests, so 'sampling matches' reduces
    to 'logits match'."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / float(temperature)
    z -= z.max()
    p = np.exp(z)
    total = p.sum()
    if not np.isfinite(total) or total <= 0.0:
        # NaN/inf logits (a numerically degenerate model) must degrade to
        # a bad TOKEN, not a ValueError that kills the scheduler loop
        return int(np.argmax(np.nan_to_num(logits, nan=-np.inf)))
    return int(rng.choice(len(p), p=p / total))


class DecodeKernels:
    """Prefill/decode steps for one model on one device.

    ``prefill`` runs one request at a time ([1, max_prompt_len], padded);
    ``decode`` steps all ``max_batch`` lanes at once.  The model is copied to
    ``device`` (CUDA unless named) in its compute dtype once, which gives
    the same values as the JAX functions' per-use casts of the f32 params.
    Each step updates ``self.cache`` in place.
    """

    def __init__(
        self, model: TransformerLM, serve_cfg: ServeConfig, *, device: DeviceLike = None
    ) -> None:
        _check_decodable(model.cfg)
        self.device = resolve_device(device)
        self.model_cfg = model.cfg
        self.serve_cfg = serve_cfg
        self.model = copy.deepcopy(model).to(device=self.device, dtype=model.cfg.dtype)
        self.model.requires_grad_(False)
        self.cache = init_kv_cache(
            model.cfg, serve_cfg.num_blocks, serve_cfg.block_size, device=self.device
        )
        #: suffix-prefill token width: the prompt padded up to whole blocks
        self._suffix_pad = (
            serve_cfg.blocks_for(serve_cfg.max_prompt_len) * serve_cfg.block_size
        )

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- step entry points (host <-> device copies happen HERE) -------------

    @torch.no_grad()
    def prefill(self, prompt: List[int], block_table: List[int]) -> np.ndarray:
        """Run the padded prefill for one sequence, writing its K/V into
        the paged cache; returns the f32 logits at the last prompt token."""
        tokens = np.zeros((1, self.serve_cfg.max_prompt_len), np.int64)
        tokens[0, : len(prompt)] = prompt
        logits, self.cache = transformer_prefill(
            self.model,
            self._tensor(tokens),
            self._tensor(np.asarray([len(prompt)], np.int64)),
            self._tensor(np.asarray(block_table, np.int64)[None, :]),
            self.cache,
        )
        return logits[0, len(prompt) - 1].cpu().numpy()

    @torch.no_grad()
    def prefill_suffix(
        self, prompt: List[int], block_table: List[int], start: int
    ) -> np.ndarray:
        """Prefill only ``prompt[start:]`` (the un-cached suffix; ``start``
        is block-aligned and the cached prefix already sits in the mapped
        blocks).  Returns the f32 logits at the last prompt token."""
        tokens = np.zeros((1, self._suffix_pad), np.int64)
        tokens[0, : len(prompt)] = prompt
        logits, self.cache = transformer_prefill_suffix(
            self.model,
            self._tensor(tokens),
            self._tensor(np.asarray([start], np.int64)),
            self._tensor(np.asarray([len(prompt)], np.int64)),
            self._tensor(np.asarray(block_table, np.int64)[None, :]),
            self.cache,
        )
        return logits[0].cpu().numpy()

    @torch.no_grad()
    def decode(
        self, tokens: np.ndarray, positions: np.ndarray, tables: np.ndarray
    ) -> np.ndarray:
        """One decode step over every lane; returns f32 logits [B, vocab]."""
        logits, self.cache = transformer_decode(
            self.model,
            self._tensor(np.asarray(tokens, np.int64)),
            self._tensor(np.asarray(positions, np.int64)),
            self._tensor(np.asarray(tables, np.int64)),
            self.cache,
            chunk_blocks=self.serve_cfg.decode_chunk_blocks,
        )
        return logits.cpu().numpy()


class _EngineBase:
    """Admission, sampling, stats, and lifecycle shared by both engines."""

    def __init__(self, kernels: DecodeKernels, thread_name: str) -> None:
        self.kernels = kernels
        self.cfg = kernels.serve_cfg
        self.allocator = BlockAllocator(
            self.cfg.num_blocks,
            self.cfg.block_size,
            prefix_cache=self.cfg.prefix_cache,
        )
        self.queue = AdmissionQueue(self.cfg.queue_depth)
        self._tracer = get_tracer()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._finished = threading.Event()
        #: set when the loop died on an unexpected exception; /healthz
        #: reports it so a crashed engine never keeps serving 'ok'
        self.failed: Optional[str] = None
        self._thread = threading.Thread(
            target=self._run_guarded, name=thread_name, daemon=True
        )
        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._tokens_generated = 0
        #: requests that finished with an error (prefill crash, engine
        #: stop/crash, drain abandonment) — the error-rate numerator the
        #: master's canary bake compares against its pre-roll baseline
        self._errored = 0
        #: 5xx responses counted by the HTTP layer (note_http_response);
        #: catches handler-level failures the engine never sees
        self._http_5xx = 0
        self._latency_ms_total = 0.0
        self._started_at = time.monotonic()

    # -- admission (HTTP threads) -------------------------------------------

    def submit(
        self,
        prompt: List[int],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        seed: Optional[int] = None,
        stop_token: Optional[int] = None,
    ) -> GenRequest:
        """Admit one request or raise :class:`AdmissionRejected` — 413 for
        requests no drained replica could ever serve, 429 under queue
        backpressure, 503 while draining."""
        with self._tracer.span("serve.admit", cat="serve"):
            if not prompt:
                raise AdmissionRejected(400, "empty prompt")
            if len(prompt) > self.cfg.max_prompt_len:
                raise AdmissionRejected(
                    413,
                    f"prompt of {len(prompt)} tokens exceeds max_prompt_len="
                    f"{self.cfg.max_prompt_len}",
                )
            new = (
                self.cfg.max_new_tokens
                if max_new_tokens is None
                else min(int(max_new_tokens), self.cfg.max_new_tokens)
            )
            if new < 1:  # 0 is a client error, not "use the default"
                raise AdmissionRejected(400, "max_new_tokens must be >= 1")
            if self.allocator.blocks_for(len(prompt) + new) > self.allocator.capacity:
                # permanent: this request can NEVER fit this replica's cache
                raise AdmissionRejected(
                    413, "request exceeds kv cache capacity (kv_cache_oom)"
                )
            req = GenRequest(
                prompt=list(prompt),
                max_new_tokens=new,
                temperature=float(temperature),
                seed=seed,
                stop_token=stop_token,
            )
            try:
                self.queue.submit(req)
            except AdmissionRejected:
                with self._stats_lock:
                    self._rejected += 1
                raise
        with self._stats_lock:
            self._submitted += 1
        self._tracer.gauge("serve.queue_depth", float(self.queue.depth()))
        self._wake.set()
        return req

    def generate(self, prompt: List[int], timeout: float = 120.0, **kw: Any) -> GenRequest:
        """submit + wait: the in-process convenience the bench/tests use."""
        req = self.submit(prompt, **kw)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {req.id} did not finish in {timeout}s")
        return req

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "_EngineBase":
        if not self._thread.is_alive() and not self._finished.is_set():
            self._thread.start()
        return self

    @property
    def healthy(self) -> bool:
        """False once the loop died (crash or stop) — the liveness the
        HTTP layer and heartbeats must report, NOT thread aliveness alone
        (an unstarted engine in tests is fine)."""
        return self.failed is None and not (
            self._finished.is_set() and not self.queue.draining
        )

    def _run_guarded(self) -> None:
        """The thread target: one unexpected exception must not strand
        parked HTTP handlers on a silently dead loop — fail everything
        loudly and flip `failed` so /healthz stops claiming 'ok'."""
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - last line of defense
            logger.exception("serving engine loop died")
            # Safe: the engine thread is the ONLY writer (exactly once, on
            # death); HTTP threads only read the GIL-atomic reference.
            self.failed = f"{type(e).__name__}: {e}"  # dtpu: lint-ok[unlocked-shared-state]
            reason = f"engine crashed: {self.failed}"
            self._fail_outstanding(reason)
            self._abort_active(reason)
            self._finished.set()

    def _abort_active(self, reason: str) -> None:
        """Fail in-flight sequences on a crash; subclasses know where
        their live lanes are."""

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish queued + in-flight work, stop the loop.
        Returns True when everything completed inside ``timeout``."""
        self.queue.start_drain()
        self._wake.set()
        if not self._thread.is_alive():
            return True
        self._thread.join(timeout if timeout is not None else self.cfg.drain_grace_s)
        if self._thread.is_alive():
            self.stop()
            return False
        return True

    def stop(self) -> None:
        """Hard stop: abandon in-flight work, fail outstanding requests."""
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        self._fail_outstanding("engine stopped")

    def _finish_error(self, req: GenRequest, reason: str) -> None:
        """Fail one request AND count it: every error-finish goes through
        here so the `errored` stat the heartbeat ships stays truthful."""
        req.finish(error=reason)
        with self._stats_lock:
            self._errored += 1

    def note_http_response(self, status: int) -> None:
        """HTTP layer callback: count 5xx responses (handler failures the
        engine's own error path never sees)."""
        if status >= 500:
            with self._stats_lock:
                self._http_5xx += 1

    def _fail_outstanding(self, reason: str) -> None:
        while True:
            req = self.queue.get()
            if req is None:
                break
            self._finish_error(req, reason)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            counters = {
                "submitted": self._submitted,
                "completed": self._completed,
                "rejected": self._rejected,
                "tokens_generated": self._tokens_generated,
                "errored": self._errored,
                "http_5xx": self._http_5xx,
                "latency_ms_avg": round(
                    self._latency_ms_total / self._completed, 3
                )
                if self._completed
                else 0.0,
            }
        kv = self.allocator.stats()
        return {
            **counters,
            "queue_depth": self.queue.depth(),
            # static queue bound: the router's saturation signal — at
            # queue_depth >= queue_capacity the next submit would 429
            "queue_capacity": self.cfg.queue_depth,
            "draining": self.queue.draining,
            # truthy once the loop died: the heartbeat ships this and the
            # master reaps the replica immediately instead of waiting out
            # the TTL behind a 500 /healthz
            "failed": self.failed,
            "kv_cache": kv,
            # live-block fraction, shared (ref>1) blocks counted ONCE so
            # prefix sharing never inflates the router's load signal
            "kv_utilization": round(kv["used"] / max(1, kv["capacity"]), 4),
            "prefix_hits": kv["prefix_hits"],
            "prefix_tokens_saved": kv["prefix_tokens_saved"],
            "prefix_hit_rate": round(
                kv["prefix_hits"] / max(1, kv["prefix_lookups"]), 4
            ),
            "uptime_s": round(time.monotonic() - self._started_at, 3),
        }

    # -- shared engine internals --------------------------------------------

    def _padded_table(self, blocks: List[int]) -> List[int]:
        return blocks + [0] * (self.cfg.blocks_per_seq - len(blocks))

    def _start_sequence(self, req: GenRequest) -> Optional[ActiveSeq]:
        """Allocate + prefill + sample the first token.  Returns the live
        sequence, or None when the request finished at prefill (wanted a
        single token).  Raises CacheOOM without side effects.

        With the prefix cache on, admission first walks the allocator's
        hash trie for the longest run of cached full blocks (capped at
        ``len(prompt) - 1`` tokens, so the block the first decode write
        lands in is never aliased — the partial tail is copy-on-write by
        re-prefilling it into a private block), maps the shared physical
        blocks into this sequence's table with a reference each, and
        prefills only the un-cached suffix.  Afterwards every full prompt
        block is registered as cached content for future admissions.
        """
        total = self.allocator.blocks_for(len(req.prompt) + req.max_new_tokens)
        shared: List[int] = []
        cached_tokens = 0
        chain: List[Any] = []
        if self.cfg.prefix_cache:
            chain = prefix_block_hashes(
                req.prompt, self.cfg.block_size, limit_tokens=len(req.prompt) - 1
            )
            shared = self.allocator.match_prefix(chain)
            cached_tokens = len(shared) * self.cfg.block_size
        needed = total - len(shared)
        try:
            with self._tracer.span("serve.kv_alloc", cat="serve", blocks=needed):
                private = self.allocator.alloc(needed)
        except CacheOOM:
            if shared:
                self.allocator.free(shared)
            raise
        blocks = shared + private
        self._tracer.gauge("serve.kv_utilization", self.allocator.utilization())
        table = self._padded_table(blocks)
        try:
            with self._tracer.span(
                "serve.prefill", cat="serve", request=req.id,
                cached_tokens=cached_tokens,
            ):
                if cached_tokens:
                    logits = self.kernels.prefill_suffix(
                        req.prompt, table, cached_tokens
                    )
                else:
                    # nothing matched: the wide single-pass prefill beats
                    # the suffix kernel's block-sequential walk (its step
                    # loop serializes what one pass runs in parallel)
                    logits = self.kernels.prefill(req.prompt, table)
        except BaseException:
            self.allocator.free(blocks)
            raise
        if chain:
            # the suffix just materialized this prompt's remaining full
            # blocks; make them matchable (shared prefix entries are
            # already in the trie — first writer wins)
            self.allocator.register_prefix(chain, blocks[: len(chain)])
        rng = np.random.default_rng(req.seed)
        tok = sample_token(logits, req.temperature, rng)
        req.first_token_at = time.monotonic()
        req.output.append(tok)
        with self._stats_lock:
            self._tokens_generated += 1
        seq = ActiveSeq(
            request=req,
            blocks=blocks,
            block_table=table,
            pos=len(req.prompt),
            next_token=tok,
            rng=rng,
        )
        if self._sequence_finished(seq, tok):
            self._retire_seq(seq)
            return None
        return seq

    def _sequence_finished(self, seq: ActiveSeq, last_token: int) -> bool:
        req = seq.request
        return len(req.output) >= req.max_new_tokens or (
            req.stop_token is not None and last_token == req.stop_token
        )

    def _retire_seq(self, seq: ActiveSeq) -> None:
        self.allocator.free(seq.blocks)
        self._tracer.gauge("serve.kv_utilization", self.allocator.utilization())
        seq.request.finish()
        latency = seq.request.latency_s
        with self._stats_lock:
            self._completed += 1
            if latency is not None:
                self._latency_ms_total += latency * 1000.0

    def _decode_batch(self, lanes: List[Optional[ActiveSeq]]) -> np.ndarray:
        """One decode step over the full (fixed-width) lane table."""
        b = self.cfg.max_batch
        t = self.cfg.blocks_per_seq
        tokens = np.zeros(b, np.int32)
        positions = np.full(b, -1, np.int32)
        tables = np.zeros((b, t), np.int32)
        n_active = 0
        for i, seq in enumerate(lanes):
            if seq is None:
                continue
            tokens[i] = seq.next_token
            positions[i] = seq.pos
            tables[i] = seq.block_table
            n_active += 1
        with self._tracer.span("serve.decode", cat="serve", active=n_active):
            logits = self.kernels.decode(tokens, positions, tables)
        return logits

    def _advance_lane(self, seq: ActiveSeq, logits_row: np.ndarray) -> bool:
        """Sample the next token for one lane; True when the seq finished."""
        tok = sample_token(logits_row, seq.request.temperature, seq.rng)
        seq.request.output.append(tok)
        seq.pos += 1
        seq.next_token = tok
        with self._stats_lock:
            self._tokens_generated += 1
        return self._sequence_finished(seq, tok)

    def _run(self) -> None:  # pragma: no cover - subclasses implement
        raise NotImplementedError


class ServeEngine(_EngineBase):
    """Continuous batching: join between any two steps, retire instantly."""

    def __init__(self, kernels: DecodeKernels) -> None:
        super().__init__(kernels, thread_name="dtpu-serve-engine")
        self.lanes = LaneTable(self.cfg.max_batch)
        #: trial/model label surfaced in the master's replica listing
        self.model_label = type(kernels.model_cfg).__name__

    def _abort_active(self, reason: str) -> None:
        for i in self.lanes.active():
            seq = self.lanes.retire(i)
            self._finish_error(seq.request, reason)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        serve_cfg: Optional[ServeConfig] = None,
        trial_class: Optional[type] = None,
        *,
        device: DeviceLike = None,
    ) -> "ServeEngine":
        """Load a trial checkpoint's params (``train.load_trial_from_checkpoint``
        with ``parts=("params",)``: the files that hold them are checked
        against the manifest first, the optimizer's moments are neither read
        nor verified) and serve its model on ``device`` (CUDA unless named).  The trial's
        ``build_model()`` must return a module exposing ``cfg`` (a
        TransformerConfig): the LMTrial contract.  The port writes no
        pipeline-stage layout, so the JAX function's second check has
        nothing to catch here."""
        from determined_tpu_torch import train

        trial, trainer = train.load_trial_from_checkpoint(
            path, trial_class=trial_class, device=device, parts=("params",)
        )
        if getattr(trainer.model, "cfg", None) is None:
            raise ValueError(
                "checkpointed trial does not build a decoder-only transformer "
                "(model has no .cfg); only TransformerLM-style trials serve"
            )
        engine = cls(DecodeKernels(trainer.model, serve_cfg or ServeConfig(), device=device))
        engine.model_label = type(trial).__name__  # e.g. "LMTrial"
        return engine

    def _admit_one(self) -> bool:
        """Try to move one queued request into a lane.  False when nothing
        was admitted (empty queue, or the head request must wait for cache
        blocks — it is parked at the front so FIFO order holds)."""
        req = self.queue.get()
        if req is None:
            return False
        try:
            seq = self._start_sequence(req)
        except CacheOOM:
            self.queue.requeue_head(req)
            return False
        except Exception as e:  # noqa: BLE001 - a poisoned request must not kill the loop
            logger.exception("request %d failed at prefill", req.id)
            self._finish_error(req, f"prefill failed: {e}")
            return True
        if seq is not None:
            self.lanes.join(seq)
        self._tracer.gauge("serve.queue_depth", float(self.queue.depth()))
        return True

    def step_once(self) -> bool:
        """One scheduler iteration: admit whatever fits, run one decode
        step, retire what finished.  Returns True when any work happened.
        The engine thread loops this; tests drive it directly for
        deterministic join/retire assertions (no wall-clock races)."""
        worked = False
        while self.lanes.has_free_lane() and not self._stop.is_set():
            if not self._admit_one():
                break
            worked = True
        snapshot = self.lanes.snapshot()
        if any(seq is not None for seq in snapshot):
            logits = self._decode_batch(list(snapshot))
            for i, seq in enumerate(snapshot):
                if seq is not None and self._advance_lane(seq, logits[i]):
                    self.lanes.retire(i)
                    self._retire_seq(seq)
            worked = True
        return worked

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.step_once():
                continue
            # idle: no active lanes, nothing admitted
            if self.queue.draining and self.queue.empty():
                break
            self._wake.wait(timeout=0.05)
            self._wake.clear()
        if self._stop.is_set():
            for i in self.lanes.active():
                seq = self.lanes.retire(i)
                self.allocator.free(seq.blocks)
                self._finish_error(seq.request, "engine stopped")
        self._finished.set()

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["lanes"] = self.lanes.stats()
        return out


class StaticBatchEngine(_EngineBase):
    """The naive baseline: form a batch, decode it to FULL completion.

    No mid-flight joins, no early retirement — a lane whose sequence
    finished early idles (position -1) until the whole batch is done.
    The like-for-like denominator of a continuous-vs-static A/B: same
    kernels, same admission, same sampling.
    """

    def __init__(self, kernels: DecodeKernels) -> None:
        super().__init__(kernels, thread_name="dtpu-serve-static")
        self._current: List[ActiveSeq] = []  # crash-abort bookkeeping

    def _abort_active(self, reason: str) -> None:
        for seq in self._current:
            if not seq.request.done.is_set():
                self._finish_error(seq.request, reason)
        self._current = []

    def _gather_batch(self) -> List[ActiveSeq]:
        batch: List[ActiveSeq] = []
        while len(batch) < self.cfg.max_batch:
            req = self.queue.get()
            if req is None:
                break
            try:
                seq = self._start_sequence(req)
            except CacheOOM:
                self.queue.requeue_head(req)
                break
            except Exception as e:  # noqa: BLE001
                self._finish_error(req, f"prefill failed: {e}")
                continue
            if seq is not None:
                batch.append(seq)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._current = self._gather_batch()
            if not batch:
                if self.queue.draining and self.queue.empty():
                    break
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            lanes: List[Optional[ActiveSeq]] = list(batch)
            lanes += [None] * (self.cfg.max_batch - len(lanes))
            live = [seq is not None for seq in lanes]
            while any(live) and not self._stop.is_set():
                logits = self._decode_batch(
                    [seq if live[i] else None for i, seq in enumerate(lanes)]
                )
                for i, seq in enumerate(lanes):
                    if seq is None or not live[i]:
                        continue
                    if self._advance_lane(seq, logits[i]):
                        # the RESPONSE completes now, but the lane stays
                        # occupied until the whole batch drains — that gap
                        # is exactly what continuous batching removes
                        live[i] = False
                        self._retire_seq(seq)
            if self._stop.is_set():
                for i, seq in enumerate(lanes):
                    if seq is not None and live[i]:
                        self.allocator.free(seq.blocks)
                        self._finish_error(seq.request, "engine stopped")
            self._current = []
        self._finished.set()
