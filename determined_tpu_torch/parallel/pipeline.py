"""Pipeline parallelism: microbatch schedules over the ``pipe`` mesh axis.

Port of ``determined_tpu/parallel/pipeline.py``.  ``PipelineSchedule`` (the
analytic tick model, its validation and error texts) and ``BubbleModel``
(the goodput ledger's ``step.bubble`` rows) are the JAX package's.  The
executor differs in form, not in schedule: where JAX runs every stage as
one ``lax.scan`` inside ``shard_map`` and hands activations on with a
``ppermute`` rotation each tick, the port runs one process a pipe rank
(``PipeGroup``) and hands them on with ``torch.distributed`` point-to-point
operations, a tick's sends and receives in one ``batch_isend_irecv`` so
that a tick in which every rank both sends and receives cannot deadlock.
A ``VirtualPipe`` holds all ``n`` ranks in one process and a hand-off is a
move between their inboxes: the same stage code, so one card launches the
kernels that ``n`` cards would (``ops/ring_attention.py``'s ``VirtualRing``
is the same device for the ring).  Only a caller's explicit choice selects
it.

The tick tables are JAX's (``tick_table``):

- ``gpipe``: rank p applies its stage to microbatch k at tick p + k, M + P
  - 1 ticks; the backward runs the same ticks in reverse order (the scan's
  transpose), so each stage sums its gradients in decreasing microbatch
  order.
- ``1f1b``: on rank p a warm-up of P - p forwards at ticks p + k, then F
  units at p + 2k and B units at 2P - 1 - p + 2k, 2(M + P - 1) ticks, the
  gradients summed in increasing microbatch order.  JAX keeps a ring of P
  stage inputs and recomputes each forward unit inside its custom
  backward; the port keeps the autograd graphs of the microbatches in
  flight instead, at most P - p on rank p (``stats["live"]``), and runs
  each forward once.
- ``interleaved``: rank p holds chunks {v * P + p}; microbatch q * P + r
  passes chunk v * P + p at tick p + q * V * P + v * P + r, V * M + P - 1
  ticks (a partial last group leaves gaps); the backward is its reverse.

The port's executor owns the backward, as a 1F1B schedule must (its
backward units run between forward units): ``pipeline_apply`` with a
``loss_fn`` applies it to each microbatch's output on the rank holding the
last chunk and runs each B unit's ``torch.autograd.backward`` there and on
every stage, the stage parameters' gradients accumulating in ``.grad``
and the input's flowing into ``x``'s graph.  Without a ``loss_fn`` it is
the forward alone and returns the outputs, as JAX's does.  ``with_aux``:
each unit's aux is summed over the valid units only, summed over the
stages and averaged over the microbatches (JAX :582-608); its gradient is
``aux_weight`` / M a unit.  The mean over the batch and seq shards that
JAX takes of it (``pmean``) is the Trainer's mean over the ranks in the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from determined_tpu_torch.config.experiment import (
    PIPELINE_SCHEDULES as SCHEDULES,
    InvalidExperimentConfig,
)

# MoE expert-weight param names: their leading dim is the expert dim,
# shardable over the expert mesh axis
_EXPERT_PARAM_NAMES = frozenset({"w_in", "w_gate", "w_out"})

# a unit of work: ("F" or "B", microbatch, chunk)
Unit = Tuple[str, int, int]


def _path_has_expert_leaf(path: Any) -> bool:
    """Whether a parameter path (a dotted name such as
    ``blocks.3.moe.w_in``, or a sequence of keys) names a MoE expert
    weight."""
    if isinstance(path, str):
        keys: List[Any] = path.split(".")
    else:
        keys = [getattr(p, "key", getattr(p, "name", p)) for p in path]
    return any(k == "moe" for k in keys) and keys[-1] in _EXPERT_PARAM_NAMES


# ---------------------------------------------------------------------------
# Analytic tick model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Static description of one pipeline schedule: the analytic tick
    model behind both the runtime dispatch and the goodput ledger's
    bubble accounting.  Validation raises ``InvalidExperimentConfig`` so
    a bad knob fails at config/setup time, not at first step."""

    name: str = "gpipe"
    n_stages: int = 1
    num_microbatches: int = 1
    virtual_stages: int = 1

    def __post_init__(self) -> None:
        if self.name not in SCHEDULES:
            raise InvalidExperimentConfig(
                f"pipeline_schedule {self.name!r} not in {SCHEDULES}"
            )
        if self.n_stages < 1 or self.num_microbatches < 1:
            raise InvalidExperimentConfig(
                f"pipeline schedule needs n_stages >= 1 and microbatches >= 1 "
                f"(got P={self.n_stages}, M={self.num_microbatches})"
            )
        if self.virtual_stages < 1:
            raise InvalidExperimentConfig(
                f"virtual_stages must be >= 1 (got {self.virtual_stages})"
            )
        if self.name == "interleaved" and self.virtual_stages < 2:
            raise InvalidExperimentConfig(
                "pipeline_schedule: interleaved needs virtual_stages >= 2 "
                f"(got {self.virtual_stages}); with one virtual stage it IS "
                "gpipe — set pipeline_schedule: gpipe instead"
            )
        if self.name != "interleaved" and self.virtual_stages != 1:
            raise InvalidExperimentConfig(
                f"virtual_stages={self.virtual_stages} only applies to "
                f"pipeline_schedule: interleaved (got {self.name!r})"
            )

    @property
    def total_ticks(self) -> int:
        """Schedule makespan in unit ticks (one stage/chunk application —
        for 1f1b, one forward OR backward unit)."""
        p, m, v = self.n_stages, self.num_microbatches, self.virtual_stages
        if p <= 1:
            return m * v
        if self.name == "interleaved":
            # microbatch m-1 = group q, offset r; its last chunk (V*P-1)
            # runs on rank P-1 at tick q*V*P + (V-1)*P + r + (P-1)
            q, r = divmod(m - 1, p)
            return q * v * p + (v - 1) * p + r + p
        if self.name == "1f1b":
            return 2 * (m + p - 1)
        return m + p - 1  # gpipe forward drain

    @property
    def work_ticks(self) -> int:
        """Busy ticks per device (each device does every microbatch)."""
        p, m, v = self.n_stages, self.num_microbatches, self.virtual_stages
        if p <= 1:
            return self.total_ticks
        if self.name == "interleaved":
            return v * m
        if self.name == "1f1b":
            return 2 * m  # one F and one B unit per microbatch
        return m

    @property
    def bubble_ticks(self) -> int:
        return self.total_ticks - self.work_ticks

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule: (P-1)/(M+P-1) for gpipe AND
        1f1b (1f1b trades memory, not bubble), (P-1)/(V*M+P-1) for
        interleaved when P | M."""
        return self.bubble_ticks / max(self.total_ticks, 1)

    @property
    def live_activation_microbatches(self) -> int:
        """How many microbatches of stage-input activations the schedule
        keeps live for backward: the 1f1b stash is a ring of P; the AD
        schedules save one residual set per scan tick."""
        if self.n_stages <= 1:
            return 1
        if self.name == "1f1b":
            return min(self.n_stages, self.num_microbatches)
        return self.total_ticks

    def fingerprint(self) -> str:
        """Cache-key material: every field shapes the schedule (trip
        counts, param layout, the backward's order)."""
        return (
            f"pipe:{self.name}:p={self.n_stages}"
            f":m={self.num_microbatches}:v={self.virtual_stages}"
        )


@dataclasses.dataclass(frozen=True)
class BubbleModel:
    """Analytic exposed-bubble model for the ``step.bubble`` ledger rows.
    The split applies the schedule's idle fraction to the measured step
    time; it is a *model* (labeled ``pipeline-tick-v1`` in the ledger) that
    treats the whole step as pipeline ticks — embed/head/optimizer time
    outside the schedule makes it an upper bound."""

    schedule: PipelineSchedule

    MODEL = "pipeline-tick-v1"

    @property
    def fraction(self) -> float:
        return self.schedule.bubble_fraction

    def split(self, avg_step_s: float) -> Tuple[float, float]:
        """(bubble_s, busy_s) per step under the tick model."""
        step = max(avg_step_s, 0.0)
        bubble = step * self.fraction
        return bubble, step - bubble


# ---------------------------------------------------------------------------
# Tick tables
# ---------------------------------------------------------------------------


def _forward_grid(sched: PipelineSchedule) -> List[Tuple[int, int, Unit]]:
    """(tick, rank, F unit) of the schedule's forward drain: gpipe's (the
    1f1b forward is gpipe's, JAX's primal) or the interleaved one."""
    n, m, v = sched.n_stages, sched.num_microbatches, sched.virtual_stages
    out = []
    for p in range(n):
        for k in range(m):
            if sched.name == "interleaved":
                q, r = divmod(k, n)
                for vs in range(v):
                    out.append((p + q * v * n + vs * n + r, p, ("F", k, vs * n + p)))
            else:
                out.append((p + k, p, ("F", k, p)))
    return out


def tick_table(sched: PipelineSchedule, train: bool) -> List[List[Optional[Unit]]]:
    """``table[t][p]``: the unit rank ``p`` runs at tick ``t`` (None: idle).
    Without ``train`` the forward drain; with it the forward and backward
    units (1f1b's combined grid, the others' forward then its reverse)."""
    n, m = sched.n_stages, sched.num_microbatches
    cells: List[Tuple[int, int, Unit]] = []
    if train and sched.name == "1f1b":
        for p in range(n):
            for k in range(m):
                # warm-up of P - p forwards, then strict alternation
                cells.append((p + k if k < n - p else p + 2 * k, p, ("F", k, p)))
                cells.append((2 * n - 1 - p + 2 * k, p, ("B", k, p)))
    else:
        fwd = _forward_grid(sched)
        cells.extend(fwd)
        if train:
            ticks = 1 + max(t for t, _, _ in fwd)
            cells.extend((2 * ticks - 1 - t, p, ("B",) + u[1:]) for t, p, u in fwd)
    total = 1 + max(t for t, _, _ in cells)
    table: List[List[Optional[Unit]]] = [[None] * n for _ in range(total)]
    for t, p, unit in cells:
        if table[t][p] is not None:
            raise AssertionError(f"tick {t}: rank {p} holds {table[t][p]} and {unit}")
        table[t][p] = unit
    return table


# ---------------------------------------------------------------------------
# Pipes: where the stages live and how activations move
# ---------------------------------------------------------------------------


class VirtualPipe:
    """A pipe of ``n`` ranks that all live in this process: every rank's
    units run in turn each tick and a hand-off is a move between their
    inboxes.  It runs the same stage code as ``PipeGroup``, so on one card
    it launches the kernels that the pipe would launch on ``n`` cards."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a pipe needs at least one rank, got {n}")
        self.size = n

    def ranks(self) -> List[int]:
        return list(range(self.size))

    def exchange(self, sends: List[Tuple[int, Any, torch.Tensor]],
                 recvs: List[Tuple[int, Any]], inboxes: List[Dict[Any, torch.Tensor]],
                 like: torch.Tensor) -> None:
        for dst, key, t in sends:
            inboxes[dst][key] = t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t  # the units of every rank already summed into it


class PipeGroup:
    """This process's rank of a pipe group (``torch.distributed``): a
    tick's sends and receives go out as one ``batch_isend_irecv``, NCCL on
    the card and gloo on the CPU."""

    def __init__(self, group: Any, size: int, rank: int) -> None:
        import torch.distributed as tdist

        self.group, self.size, self.rank = group, size, rank
        # the global rank of each pipe rank (P2POp's peers are global)
        self.globals = tdist.get_process_group_ranks(group)

    def ranks(self) -> List[int]:
        return [self.rank]

    def exchange(self, sends: List[Tuple[int, Any, torch.Tensor]],
                 recvs: List[Tuple[int, Any]], inboxes: List[Dict[Any, torch.Tensor]],
                 like: torch.Tensor) -> None:
        from determined_tpu_torch.core._distributed import p2p_exchange

        got = p2p_exchange(
            [(self.globals[dst], t) for dst, _, t in sends],
            [(self.globals[src], torch.empty_like(like)) for src, _ in recvs],
            self.group,
        )
        inbox = inboxes[self.rank]
        for (_, key), t in zip(recvs, got):
            inbox[key] = t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as tdist

        tdist.all_reduce(t, group=self.group)
        return t

    def warm(self, like: torch.Tensor) -> None:
        """Create every neighbour pair's communicator before anything is
        timed (the first send between two ranks creates it): one round in
        which each rank sends to the next and receives from the previous,
        the circular wrap included."""
        from determined_tpu_torch.core._distributed import warm_pipe

        warm_pipe(self.group, self.globals, self.rank, like)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stages: Sequence[Any],
    x: torch.Tensor,
    pipe: Any,
    num_microbatches: int,
    with_aux: bool = False,
    schedule: str = "gpipe",
    virtual_stages: int = 1,
    *,
    loss_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    aux_weight: float = 0.0,
    on_backward: Optional[Callable[[int, bool], None]] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Any:
    """Run ``stage_fn`` across the pipe's stages.

    - ``stages``: one entry a chunk, ``stages[c]`` for chunk ``c = v * P +
      p`` (rank ``p``'s ``v``-th virtual stage; gpipe and 1f1b: ``c = p``),
      passed to ``stage_fn(stages[c], h)``; a ``PipeGroup`` rank reads only
      its own chunks (the others may be None);
    - ``x``: ``[batch, ...]``, this rank's batch slice, split into
      ``num_microbatches`` contiguous microbatches; only the rank holding
      chunk 0 reads its values, the others its shape and dtype (each
      activation and its gradient moves in that shape and dtype);
    - ``pipe``: a ``PipeGroup`` or a ``VirtualPipe``;
    - ``with_aux``: ``stage_fn`` returns ``(y, aux_scalar)``;
    - ``loss_fn(y, k)``: the scalar loss of microbatch ``k``'s output on the
      rank holding the last chunk.  With it and grad enabled the schedule
      trains (forward and backward units; ``on_backward(chunk, last)`` runs
      before each B unit, ``last`` on the chunk's last one of the run) and
      returns ``(loss, aux)``: the loss summed over the microbatches and
      aux, both on every rank of the pipe; without grad the forward alone
      returns the same.  Without ``loss_fn`` the forward alone returns the
      outputs ``[batch, ...]`` (None on a ``PipeGroup`` rank without the
      last chunk), with ``with_aux`` also aux;
    - ``stats``: filled with ``ticks`` and ``live`` (each of this process's
      ranks' most autograd graphs held at once: its stage inputs live for
      the backward).
    """
    n = pipe.size
    if n == 1 and schedule == "interleaved":
        raise InvalidExperimentConfig(
            "pipeline_schedule: interleaved needs a pipe mesh axis > 1 "
            f"(pipe has {n} rank)"
        )
    batch = x.shape[0]
    sched = PipelineSchedule(
        name=schedule, n_stages=n, num_microbatches=num_microbatches,
        virtual_stages=virtual_stages,
    )
    if batch % num_microbatches:
        raise InvalidExperimentConfig(
            f"global batch {batch} not divisible by pipe_microbatches "
            f"{num_microbatches} (pipeline_schedule {schedule!r}, "
            f"P={n}): pick a microbatch count dividing the batch"
        )
    m, chunks = num_microbatches, n * virtual_stages
    mb = batch // m
    train = loss_fn is not None and torch.is_grad_enabled()
    table = tick_table(sched, train)
    mine = pipe.ranks()
    xs = x.detach().reshape(m, mb, *x.shape[1:])
    like = xs[0]

    inboxes: List[Dict[Any, torch.Tensor]] = [{} for _ in range(n)]
    saved: List[Dict[Tuple[int, int], Any]] = [{} for _ in range(n)]
    live = [0] * n
    outs: List[Optional[torch.Tensor]] = [None] * m
    dxs: List[Optional[torch.Tensor]] = [None] * m
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss_sum, aux_sum = zero.clone(), zero.clone()
    last_b = {}  # chunk -> its last B unit's tick
    for t, row in enumerate(table):
        for p in mine:
            u = row[p]
            if u is not None and u[0] == "B":
                last_b[u[2]] = t
    aux_ct = aux_weight / m

    def forward(p: int, k: int, c: int) -> Optional[Tuple[int, Any, torch.Tensor]]:
        nonlocal loss_sum, aux_sum
        xin = xs[k] if c == 0 else inboxes[p].pop(("F", k, c))
        if train:
            xin = xin.detach().requires_grad_(c > 0 or x.requires_grad)
        with torch.set_grad_enabled(train):
            res = stage_fn(stages[c], xin)
            y, aux = res if with_aux else (res, None)
            if aux is not None:
                aux_sum = aux_sum + aux.detach().float()
            lk = None
            if c == chunks - 1:
                if loss_fn is not None:
                    lk = loss_fn(y, k)
                    loss_sum = loss_sum + lk.detach().float()
                else:
                    outs[k] = y.detach()
        if train:
            saved[p][(k, c)] = (xin, y, aux, lk)
            live[p] = max(live[p], len(saved[p]))
        if c == chunks - 1:
            return None
        if y.shape != like.shape or y.dtype != like.dtype:
            raise ValueError(f"chunk {c} gives {y.dtype}{list(y.shape)}; the pipe moves "
                             f"{like.dtype}{list(like.shape)}")
        return ((c + 1) % n, ("F", k, c + 1), y.detach())

    def backward(p: int, k: int, c: int, t: int) -> Optional[Tuple[int, Any, torch.Tensor]]:
        xin, y, aux, lk = saved[p].pop((k, c))
        if on_backward is not None:
            on_backward(c, t == last_b[c])
        tensors, grads = [], []
        if c == chunks - 1:
            tensors.append(lk)
            grads.append(torch.ones_like(lk))
        else:
            tensors.append(y)
            grads.append(inboxes[p].pop(("B", k, c)))
        if aux is not None and aux.requires_grad and aux_ct:
            tensors.append(aux)
            grads.append(torch.full_like(aux, aux_ct))
        torch.autograd.backward(tensors, grads)
        if c > 0:
            return ((c - 1) % n, ("B", k, c - 1), xin.grad)
        if x.requires_grad:
            dxs[k] = xin.grad
        return None

    for t, row in enumerate(table):
        sends: List[Tuple[int, Any, torch.Tensor]] = []
        for p in mine:
            u = row[p]
            if u is None:
                continue
            kind, k, c = u
            msg = forward(p, k, c) if kind == "F" else backward(p, k, c, t)
            if msg is not None:
                sends.append(msg)
        # what this rank's neighbours send it this tick (a real pipe:
        # both ends read the same table)
        recvs: List[Tuple[int, Any]] = []
        if not isinstance(pipe, VirtualPipe):
            me = pipe.rank
            prev, nxt = (me - 1) % n, (me + 1) % n
            u = row[prev]
            if u is not None and u[0] == "F" and u[2] < chunks - 1:
                recvs.append((prev, ("F", u[1], u[2] + 1)))
            u = row[nxt]
            if u is not None and u[0] == "B" and u[2] > 0:
                recvs.append((nxt, ("B", u[1], u[2] - 1)))
        if sends or recvs:
            pipe.exchange(sends, recvs, inboxes, like)

    if stats is not None:
        stats.update(ticks=len(table), live=[live[p] for p in mine])
    if train and x.requires_grad and 0 in mine:
        torch.autograd.backward(x, torch.cat(dxs).reshape(x.shape))
    # aux over the stages (every rank's units), averaged over microbatches
    aux = pipe.all_reduce(aux_sum) / m
    if loss_fn is not None:
        # the loss lives on the last chunk's rank: summed, every rank holds it
        return pipe.all_reduce(loss_sum), aux
    holds_last = (chunks - 1) % n in mine
    out = torch.cat(outs).reshape(batch, *outs[0].shape[1:]) if holds_last else None
    return (out, aux) if with_aux else out


def stack_stage_params(param_list: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack per-stage flat ``{name: tensor}`` dicts into the leading-``P``
    layout of the JAX package's ``pipeline_apply``."""
    return {k: torch.stack([d[k] for d in param_list]) for k in param_list[0]}


def stack_chunk_params(param_list: Sequence[Dict[str, torch.Tensor]],
                       n_stages: int) -> Dict[str, torch.Tensor]:
    """Stack V*P per-chunk flat dicts (chunk order: the order the
    microbatch traverses them) into the ``[P, V, ...]`` interleaved
    layout: ``out[p, v]`` is chunk ``v*P + p`` — rank p's v-th virtual
    stage."""
    total = len(param_list)
    if n_stages < 1 or total % n_stages:
        raise InvalidExperimentConfig(
            f"{total} pipeline chunks do not divide over {n_stages} stages"
        )
    v_stages = total // n_stages
    return {
        k: torch.stack([
            torch.stack([param_list[v * n_stages + p][k] for v in range(v_stages)])
            for p in range(n_stages)
        ])
        for k in param_list[0]
    }
