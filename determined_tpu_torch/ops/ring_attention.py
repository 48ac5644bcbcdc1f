"""Ring attention: sequence-parallel attention over the mesh ``seq`` axis.

Port of ``determined_tpu/ops/ring_attention.py``.  q, k and v are split
along the sequence over the ranks of the ``seq`` group; each rank attends
its queries to the k/v shard it holds, passes that shard to the next rank
of the ring, and after n steps has seen every shard.  Where the JAX module
computes each block with jnp einsums and an online softmax in f32, the port
computes each block with the flash kernels (``ops/flash_attention.py``:
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` on CUDA tensors, their plain
versions on CPU tensors) and merges the blocks' ``(out, lse)`` pairs in f32.
The kernels' lse is base 2, ``[b, h, 1, S]`` f32; so is every lse here.

- **Contiguous sweep** (``_ring_fwd_local``/``_ring_bwd_local`` in JAX):
  rank r holds rows ``[r·sl, (r+1)·sl)``.  Under causal masking a k/v shard
  that lies after every local query (``src > idx``) is skipped; the
  rotation still happens.  The diagonal block (``src == idx``) is a causal
  flash call, every earlier one a full one.
- **Zigzag sweep** (``_zz_fwd_local``/``_zz_bwd_local``): rank r holds the
  half-chunks (r, 2n-1-r) of the 2n in the sequence, laid out as two
  contiguous tensors.  Each step runs hi-q × lo-k (always, full),
  lo-q × lo-k (iff src ≤ idx) and hi-q × hi-k (iff src ≥ idx), causal on
  the diagonal: 2n+1 half-block computes a rank a sweep, the same on every
  rank.  Entry and exit are half-chunk exchanges (``_to_zigzag``,
  ``_from_zigzag``), so the layout outside the ring stays contiguous.
- **Merging**: ``lse = log2(2^a + 2^b)``, each ``out`` rescaled by
  ``2^(a - lse)``, in f32; the merged out is cast to the input dtype once.
- **Backward**: ``_RingAttention`` is a ``torch.autograd.Function`` whose
  backward re-runs the ring, rotating (k, v, dk, dv) together, so no
  rotated shard is stored.  Each block's ``(dq, dk, dv)`` comes from
  ``flash_attention_bwd`` given the *merged* out and lse, which makes the
  block's ``p`` and ``delta`` the global ones; dk/dv come back summed over
  the GQA group, in the kv-head shape the ring rotates, and travel in f32.
- **GQA-compact rotation**: k and v rotate with their ``h_kv`` heads; the
  kernels expand them inside the block.

Communication is ``torch.distributed.batch_isend_irecv`` on the seq group
(NCCL on the card, gloo on the CPU): every send is posted with its matching
receive in one batch, so no order of ranks can deadlock, and the k/v
rotation of a step is in flight while the step's blocks compute.

The sweeps run over a *ring*: ``_GroupRing`` (this rank of a process group)
or ``VirtualRing`` (n ranks' shards on one device, rotated as a Python
list).  Both call the same per-step block functions (``_contig_fwd_step``,
``_zz_fwd_step``, ``_contig_bwd_step``, ``_zz_bwd_step``); the virtual ring
holds the ring's kernel route on one card and is held equal to the
distributed ring by the tests.

Under the ``tensor`` axis q, k and v carry this rank's heads, k/v grouped
as q's: the model's ``Attention`` expands k/v to full heads before the ring
where the tensor size does not divide ``h_kv`` (JAX's ``ring_attention``
expands them inside the op, over global arrays).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from determined_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

# a block's (out, lse) and a rank's running merge of them
Block = Tuple[torch.Tensor, torch.Tensor]
Fields = List[List[torch.Tensor]]  # fields[f][j]: field f of the ring's j-th local rank


# ---------------------------------------------------------------------------
# rings: where the shards live and how they move
# ---------------------------------------------------------------------------


class VirtualRing:
    """A ring of ``n`` ranks whose shards all live in this process: the
    whole q, k and v are cut into ``n`` shards, every rank's blocks run in
    turn, and a rotation is a Python list rotation.  It runs the same block
    functions as the distributed ring, so on one card it launches the
    kernels the ring would launch on n cards."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.n = n

    def ranks(self) -> List[int]:
        return list(range(self.n))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[-2] % self.n:
            raise ValueError(f"sequence length {x.shape[-2]} is no multiple of the ring's {self.n}")
        return [t.contiguous() for t in x.chunk(self.n, dim=-2)]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=-2)

    def start_rotate(self, fields: Fields, tag0: int = 0) -> Fields:
        # rank j receives what rank j - 1 held
        return [f[-1:] + f[:-1] for f in fields]

    def finish(self, handle: Fields) -> Fields:
        return handle

    def exchange(self, held: List[Dict[int, torch.Tensor]], dst: Callable[[int], int],
                 src: Callable[[int], int], wanted: List[List[int]]) -> List[List[torch.Tensor]]:
        chunks = {c: t for h in held for c, t in h.items()}
        return [[chunks[c] for c in w] for w in wanted]

    def counts(self, cnt: List[int]) -> List[int]:
        return list(cnt)


class _GroupRing:
    """This rank of the ring over a process group: one local rank, its
    neighbours' global ranks, P2P through ``batch_isend_irecv``."""

    def __init__(self, group: Any) -> None:
        import torch.distributed as tdist

        self.group = group
        self.n = tdist.get_world_size(group)
        self.idx = tdist.get_rank(group)

    def _peer(self, group_rank: int) -> int:
        import torch.distributed as tdist

        return tdist.get_global_rank(self.group, group_rank % self.n)

    def ranks(self) -> List[int]:
        return [self.idx]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.contiguous()]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def _batch(self, sends, recvs):
        """Post every (peer, tensor, tag) send and receive in one batch."""
        import torch.distributed as tdist

        ops = [tdist.P2POp(tdist.isend, t, peer, self.group, tag) for peer, t, tag in sends]
        ops += [tdist.P2POp(tdist.irecv, t, peer, self.group, tag) for peer, t, tag in recvs]
        return tdist.batch_isend_irecv(ops) if ops else []

    def start_rotate(self, fields: Fields, tag0: int = 0):
        """Send each field to the next rank, receive the previous rank's;
        field ``i`` travels under tag ``tag0 + i``."""
        nxt, prv = self._peer(self.idx + 1), self._peer(self.idx - 1)
        bufs = [torch.empty_like(f[0]) for f in fields]
        reqs = self._batch([(nxt, f[0], tag0 + i) for i, f in enumerate(fields)],
                           [(prv, b, tag0 + i) for i, b in enumerate(bufs)])
        return reqs, bufs

    def finish(self, handle) -> Fields:
        reqs, bufs = handle
        for r in reqs:
            r.wait()
        return [[b] for b in bufs]

    def exchange(self, held: List[Dict[int, torch.Tensor]], dst: Callable[[int], int],
                 src: Callable[[int], int], wanted: List[List[int]]) -> List[List[torch.Tensor]]:
        """Each half-chunk ``c`` this rank holds goes to rank ``dst(c)``;
        each chunk it wants comes from rank ``src(c)``.  Sends and receives
        between two ranks are posted in chunk order on both sides, and
        tagged with the chunk, so they match under NCCL and gloo alike."""
        mine = held[0]
        sends = [(self._peer(dst(c)), t, c) for c, t in sorted(mine.items())
                 if dst(c) != self.idx]
        got: Dict[int, torch.Tensor] = {}
        recvs = []
        for c in sorted(wanted[0]):
            if src(c) == self.idx:
                got[c] = mine[c]
            else:
                got[c] = torch.empty_like(next(iter(mine.values())))
                recvs.append((self._peer(src(c)), got[c], c))
        for r in self._batch(sends, recvs):
            r.wait()
        return [[got[c] for c in wanted[0]]]

    def counts(self, cnt: List[int]) -> List[int]:
        import torch.distributed as tdist

        out: List[Any] = [None] * self.n
        tdist.all_gather_object(out, cnt[0], group=self.group)
        return out


def _as_ring(group: Any):
    return group if isinstance(group, VirtualRing) else _GroupRing(group)


# ---------------------------------------------------------------------------
# the block computes of one rank at one step
# ---------------------------------------------------------------------------


def _merge(acc: Optional[Block], blk: Block) -> Block:
    """Fold one block's ``(out, lse)`` into a running f32 merge (base 2)."""
    out, lse = blk
    if acc is None:
        return out.float(), lse
    o_a, l_a = acc
    l = torch.logaddexp2(l_a, lse)                          # [b, h, 1, s]
    w_a = torch.exp2(l_a - l).transpose(-1, -2)             # [b, h, s, 1]
    w_b = torch.exp2(lse - l).transpose(-1, -2)
    return o_a * w_a + out.float() * w_b, l


def _contig_fwd_step(q, k, v, idx: int, src: int, causal: bool, scale: float,
                     acc: Optional[Block]) -> Tuple[Optional[Block], int]:
    """Rank ``idx``'s block against the shard of rank ``src``: the merge
    and the half-block units it ran (a full shard counts 4, JAX's units)."""
    if causal and src > idx:
        return acc, 0
    blk = flash_attention_fwd(q, k, v, causal=causal and src == idx, scale=scale)
    return _merge(acc, blk), 4


def _zz_fwd_step(q: Tuple, k: Tuple, v: Tuple, idx: int, src: int, scale: float,
                 acc: List[Optional[Block]]) -> Tuple[List[Optional[Block]], int]:
    """Rank ``idx``'s zigzag blocks against the half-chunks of rank
    ``src``: ``q``, ``k``, ``v`` are (lo, hi) pairs, ``acc`` the lo and hi
    merges."""
    (q_lo, q_hi), (k_lo, k_hi), (v_lo, v_hi) = q, k, v
    st_lo, st_hi = acc
    # hi-q sees every lo-k chunk: never masked
    st_hi = _merge(st_hi, flash_attention_fwd(q_hi, k_lo, v_lo, causal=False, scale=scale))
    cnt = 1
    if src <= idx:
        st_lo = _merge(st_lo, flash_attention_fwd(q_lo, k_lo, v_lo, causal=src == idx,
                                                  scale=scale))
        cnt += 1
    if src >= idx:
        st_hi = _merge(st_hi, flash_attention_fwd(q_hi, k_hi, v_hi, causal=src == idx,
                                                  scale=scale))
        cnt += 1
    return [st_lo, st_hi], cnt


def _add(acc: Optional[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    return g.float() if acc is None else acc.add_(g.float())


def _contig_bwd_step(q, k, v, out, lse, do, idx: int, src: int, causal: bool, scale: float,
                     dq: Optional[torch.Tensor], dk: torch.Tensor, dv: torch.Tensor):
    """Rank ``idx``'s block gradients against the shard of ``src``: dq
    accumulates here, dk/dv into the buffers travelling with that shard."""
    if causal and src > idx:
        return dq
    g = flash_attention_bwd(q, k, v, out, lse, do, causal=causal and src == idx, scale=scale)
    dk.add_(g[1].float())
    dv.add_(g[2].float())
    return _add(dq, g[0])


def _zz_bwd_step(q: Tuple, k: Tuple, v: Tuple, out: Tuple, lse: Tuple, do: Tuple,
                 idx: int, src: int, scale: float, dq: List, dk: Tuple, dv: Tuple) -> List:
    """Rank ``idx``'s zigzag block gradients against the half-chunks of
    ``src`` (the forward's schedule); every argument but idx/src/scale is
    a (lo, hi) pair."""
    lo, hi = 0, 1

    def block(qh: int, kh: int, causal: bool) -> None:
        g = flash_attention_bwd(q[qh], k[kh], v[kh], out[qh], lse[qh], do[qh],
                                causal=causal, scale=scale)
        dq[qh] = _add(dq[qh], g[0])
        dk[kh].add_(g[1].float())
        dv[kh].add_(g[2].float())

    block(hi, lo, False)
    if src <= idx:
        block(lo, lo, src == idx)
    if src >= idx:
        block(hi, hi, src == idx)
    return dq


# ---------------------------------------------------------------------------
# sweeps over a ring
# ---------------------------------------------------------------------------


def _fwd_sweep(ring, qs, ks, vs, *, zigzag: bool, causal: bool, scale: float):
    """The forward sweep of every local rank: per rank, the merged (out in
    f32, lse) (pairs of halves for zigzag) and the units it ran."""
    n, idxs = ring.n, ring.ranks()
    acc: List[Any] = [[None, None] if zigzag else None for _ in idxs]
    cnt = [0] * len(idxs)
    kv: Fields = [list(ks), list(vs)]
    for step in range(n):
        handle = ring.start_rotate(_flat(kv, zigzag)) if step < n - 1 else None
        for j, idx in enumerate(idxs):
            src = (idx - step) % n
            if zigzag:
                acc[j], c = _zz_fwd_step(qs[j], kv[0][j], kv[1][j], idx, src, scale, acc[j])
            else:
                acc[j], c = _contig_fwd_step(qs[j], kv[0][j], kv[1][j], idx, src, causal,
                                             scale, acc[j])
            cnt[j] += c
        if handle is not None:
            kv = _unflat(ring.finish(handle), zigzag)
    return acc, cnt


def _bwd_sweep(ring, qs, ks, vs, outs, lses, dos, *, zigzag: bool, causal: bool,
               scale: float):
    """The backward sweep: (k, v) rotate while a step computes, then
    (dk, dv) follow them; after n rotations dk/dv are home."""
    n, idxs = ring.n, ring.ranks()
    dq: List[Any] = [[None, None] if zigzag else None for _ in idxs]
    if zigzag:
        zeros = lambda t: tuple(torch.zeros_like(h, dtype=torch.float32) for h in t)  # noqa: E731
    else:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
    kv: Fields = [list(ks), list(vs)]
    dkv: Fields = [[zeros(t) for t in ks], [zeros(t) for t in vs]]
    for step in range(n):
        handle = ring.start_rotate(_flat(kv, zigzag)) if step < n - 1 else None
        for j, idx in enumerate(idxs):
            src = (idx - step) % n
            if zigzag:
                dq[j] = _zz_bwd_step(qs[j], kv[0][j], kv[1][j], outs[j], lses[j], dos[j], idx,
                                     src, scale, dq[j], dkv[0][j], dkv[1][j])
            else:
                dq[j] = _contig_bwd_step(qs[j], kv[0][j], kv[1][j], outs[j], lses[j], dos[j],
                                         idx, src, causal, scale, dq[j], dkv[0][j], dkv[1][j])
        # tagged apart from the (k, v) batch still in flight
        dkv = _unflat(ring.finish(ring.start_rotate(_flat(dkv, zigzag), tag0=8)), zigzag)
        if handle is not None:
            kv = _unflat(ring.finish(handle), zigzag)
    return dq, dkv[0], dkv[1]


def _flat(fields: Fields, zigzag: bool) -> Fields:
    """(lo, hi) pairs as two fields each, for the rotation."""
    if not zigzag:
        return fields
    return [[p[h] for p in f] for f in fields for h in (0, 1)]


def _unflat(fields: Fields, zigzag: bool) -> Fields:
    if not zigzag:
        return fields
    return [[(a, b) for a, b in zip(fields[i], fields[i + 1])] for i in range(0, len(fields), 2)]


# ---------------------------------------------------------------------------
# zigzag layout
# ---------------------------------------------------------------------------


def _zz_owner(chunk: int, n: int) -> int:
    """Zigzag owner of half-chunk ``chunk`` (of 2n): rank r holds (r, 2n-1-r)."""
    return chunk if chunk < n else 2 * n - 1 - chunk


def _to_zigzag(ring, xs: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Contiguous shards (rank s holds chunks 2s, 2s+1) to zigzag pairs
    (rank r holds chunks r, 2n-1-r), each half a contiguous tensor."""
    n = ring.n
    hc = xs[0].shape[-2] // 2
    held = [{2 * s: x[..., :hc, :].contiguous(), 2 * s + 1: x[..., hc:, :].contiguous()}
            for s, x in zip(ring.ranks(), xs)]
    got = ring.exchange(held, lambda c: _zz_owner(c, n), lambda c: c // 2,
                        [[r, 2 * n - 1 - r] for r in ring.ranks()])
    return [(lo, hi) for lo, hi in got]


def _from_zigzag(ring, pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """The inverse exchange: zigzag pairs back to contiguous shards."""
    n = ring.n
    held = [{r: lo, 2 * n - 1 - r: hi} for r, (lo, hi) in zip(ring.ranks(), pairs)]
    got = ring.exchange(held, lambda c: c // 2, lambda c: _zz_owner(c, n),
                        [[2 * s, 2 * s + 1] for s in ring.ranks()])
    return [torch.cat([a, b], dim=-2) for a, b in got]


# ---------------------------------------------------------------------------
# the differentiable ring
# ---------------------------------------------------------------------------


def _ring_forward(ring, q, k, v, zigzag: bool, causal: bool, scale: float):
    """Forward through ``ring``: per local rank the inputs in the sweep's
    layout, the merged out (input dtype) and lse in that layout, the
    joined out, and each rank's units."""
    qs, ks, vs = (ring.split(t) for t in (q, k, v))
    if zigzag:
        qs, ks, vs = (_to_zigzag(ring, xs) for xs in (qs, ks, vs))
    acc, cnt = _fwd_sweep(ring, qs, ks, vs, zigzag=zigzag, causal=causal, scale=scale)
    if zigzag:
        outs = [tuple(a[0].to(q.dtype) for a in pair) for pair in acc]
        lses = [tuple(a[1] for a in pair) for pair in acc]
        joined = ring.join(_from_zigzag(ring, [(lo, hi) for lo, hi in outs]))
    else:
        outs = [a[0].to(q.dtype) for a in acc]
        lses = [a[1] for a in acc]
        joined = ring.join(outs)
    return (qs, ks, vs, outs, lses), joined, cnt


def _flatten_saved(parts) -> List[torch.Tensor]:
    flat = []
    for per_rank in parts:
        for item in per_rank:
            flat.extend(item if isinstance(item, tuple) else (item,))
    return flat


class _RingAttention(torch.autograd.Function):
    """The ring's forward, and a backward that runs the ring again."""

    @staticmethod
    def forward(ctx, q, k, v, ring, zigzag: bool, causal: bool, scale: float):
        saved, out, _ = _ring_forward(ring, q, k, v, zigzag, causal, scale)
        ctx.save_for_backward(*_flatten_saved(saved))
        ctx.ring, ctx.zigzag, ctx.causal, ctx.scale = ring, zigzag, causal, scale
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        ring, zigzag = ctx.ring, ctx.zigzag
        flat = list(ctx.saved_tensors)
        per = 2 if zigzag else 1
        m = len(ring.ranks())

        def take() -> List[Any]:
            items = []
            for _ in range(m):
                chunk = flat[:per]
                del flat[:per]
                items.append(tuple(chunk) if zigzag else chunk[0])
            return items

        qs, ks, vs, outs, lses = (take() for _ in range(5))
        dos = ring.split(do.to(ctx.dtypes[0]))
        if zigzag:
            dos = _to_zigzag(ring, dos)
        dq, dk, dv = _bwd_sweep(ring, qs, ks, vs, outs, lses, dos, zigzag=zigzag,
                                causal=ctx.causal, scale=ctx.scale)
        grads = []
        for g, dt in zip((dq, dk, dv), ctx.dtypes):
            if zigzag:
                g = _from_zigzag(ring, [(a.to(dt), b.to(dt)) for a, b in g])
            else:
                g = [t.to(dt) for t in g]
            grads.append(ring.join(g))
        return grads[0], grads[1], grads[2], None, None, None, None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _resolve_assignment(assignment: str, causal: bool, sl: int) -> str:
    """zigzag needs causal masking (the balance argument is causal-specific)
    and an even per-rank shard; everything else rides contiguous."""
    if assignment == "auto":
        return "zigzag" if (causal and sl % 2 == 0) else "contiguous"
    if assignment == "zigzag" and not causal:
        raise ValueError("zigzag assignment requires causal=True")
    if assignment == "zigzag" and sl % 2:
        raise ValueError(f"zigzag needs an even per-rank shard, got {sl}")
    if assignment not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring assignment {assignment!r}")
    return assignment


def _prepare(q, k, group, causal, scale, assignment):
    ring = _as_ring(group)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sl = q.shape[-2] // ring.n if isinstance(ring, VirtualRing) else q.shape[-2]
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} do not divide the {q.shape[1]} query heads")
    zigzag = _resolve_assignment(assignment, causal, sl) == "zigzag"
    return ring, scale, zigzag


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    assignment: str = "auto",
) -> torch.Tensor:
    """Ring attention over ``group``: a process group of the seq ranks,
    with q [b, h, sl, d] and k/v [b, h_kv, sl, d] this rank's contiguous
    shard (rank r holds rows ``[r·sl, (r+1)·sl)``), or a ``VirtualRing``
    with the whole sequences.  Returns out in q's layout; differentiable.
    ``assignment``: "auto" (zigzag for causal), "contiguous" or "zigzag"."""
    ring, scale, zigzag = _prepare(q, k, group, causal, scale, assignment)
    return _RingAttention.apply(q, k, v, ring, zigzag, causal, scale)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    seq_axis: str = "seq",
    assignment: str = "auto",
) -> torch.Tensor:
    """Sequence-parallel attention over the ``seq_axis`` group of ``mesh``
    (``parallel.mesh.Mesh``) on this rank's shards.  Without a mesh or
    with a seq axis of one, attention on the whole sequence, as the JAX
    function falls back: ``dot_product_attention``'s 'auto' (the flash
    kernels on CUDA, the plain version on the CPU)."""
    if mesh is None or mesh.shape.get(seq_axis, 1) <= 1:
        from determined_tpu_torch.ops.attention import dot_product_attention

        return dot_product_attention(q, k, v, causal=causal, scale=scale)
    return ring_attention_local(q, k, v, mesh.group(seq_axis), causal=causal, scale=scale,
                                assignment=assignment)


def ring_block_counts(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any,
    *,
    causal: bool = True,
    assignment: str = "auto",
) -> Tuple[torch.Tensor, List[int]]:
    """Run the forward ring over ``group`` (as ``ring_attention_local``)
    and return ``(out, per_rank_counts)``: the half-block computes each
    rank of the ring ran (a full-shard compute counts 4), the balance
    evidence of the zigzag assignment.  Each counted unit is one flash
    forward launch on the card for zigzag; a contiguous full shard is one
    launch counting 4."""
    ring, scale, zigzag = _prepare(q, k, group, causal, None, assignment)
    with torch.no_grad():
        _, out, cnt = _ring_forward(ring, q, k, v, zigzag, causal, scale)
    return out, ring.counts(cnt)
