"""The port's DistributedContext (determined_tpu_torch/core/_distributed.py)
against the JAX package's (tests/test_distributed.py's cases that do not
test the JAX side's rendezvous), and ``from_torch`` on gloo ranks.

- Thread ranks over localhost TCP, each holding a real context of the port
  and one of the JAX package, run the same collectives: the results are
  equal (exact: picklable objects).
- ``from_torch`` on 4 gloo processes (tests/torch_rank_worker.py, under a
  hard timeout of ``RANK_TIMEOUT`` seconds): rank facts from torchrun's
  environment, the star's collectives, an all-reduce of the process group
  beside it, and the preemption vote (one rank asked, every rank stops).
- ``core.init`` takes ``from_torch`` under a torchrun environment of more
  than one rank, the single-rank context otherwise.
"""

import threading
import time

import pytest

from determined_tpu.core import DistributedContext as JaxDistributedContext
from determined_tpu.core import DummyDistributedContext as JaxDummy
from determined_tpu_torch import core
from determined_tpu_torch.core import DistributedContext, DummyDistributedContext, allocate_port
from determined_tpu_torch.core._distributed import _StarClient, _StarServer
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch


def _run(cls, size, fn, local_size=None, timeout=20.0):
    """Thread ranks, each with a real ``cls`` context (the JAX package's
    ``tests/parallel_utils.Execution`` for either package)."""
    local_size = local_size or size
    n_nodes = size // local_size
    chief_port = allocate_port()
    local_ports = [allocate_port() for _ in range(n_nodes)]
    results, errors = [None] * size, [None] * size

    def worker(rank):
        cross_rank, local_rank = divmod(rank, local_size)
        ctx = None
        try:
            ctx = cls(rank=rank, size=size, local_rank=local_rank, local_size=local_size,
                      cross_rank=cross_rank, cross_size=n_nodes, chief_addr="127.0.0.1",
                      chief_port=chief_port, local_chief_port=local_ports[cross_rank],
                      timeout=timeout)
            results[rank] = fn(ctx, rank)
        except BaseException as e:  # noqa: BLE001
            errors[rank] = e
        finally:
            if ctx is not None:
                ctx.close()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    for rank, e in enumerate(errors):
        if e is not None:
            raise AssertionError(f"rank {rank} failed: {e!r}") from e
    return results


def _both(size, fn, **kw):
    got = _run(DistributedContext, size, fn, **kw)
    want = _run(JaxDistributedContext, size, fn, **kw)
    assert got == want
    return got


def test_allgather_orders_by_rank():
    for r in _both(4, lambda ctx, rank: ctx.allgather(f"r{rank}")):
        assert r == ["r0", "r1", "r2", "r3"]


def test_gather_chief_only():
    results = _both(3, lambda ctx, rank: ctx.gather(rank * 10))
    assert results[0] == [0, 10, 20]
    assert results[1] is None and results[2] is None


def test_broadcast_from_chief():
    assert _both(4, lambda ctx, rank: ctx.broadcast("payload" if ctx.is_chief else None)) == \
        ["payload"] * 4


def test_local_collectives_two_nodes():
    results = _both(4, lambda ctx, rank: ctx.allgather_local(
        ("node", ctx.cross_rank, ctx.local_rank)), local_size=2)
    assert results[0] == [("node", 0, 0), ("node", 0, 1)]
    assert results[2] == [("node", 1, 0), ("node", 1, 1)]


def test_multiple_rounds_stay_in_lockstep():
    def fn(ctx, rank):
        return [ctx.allgather(rank + i * 100) for i in range(5)]

    for r in _both(3, fn):
        assert r[0] == [0, 1, 2]
        assert r[4] == [400, 401, 402]


def test_rank_predicates_match_jax():
    def fn(ctx, rank):
        return (ctx.get_rank(), ctx.get_size(), ctx.is_chief, ctx.is_local_chief,
                ctx.cross_rank, ctx.cross_size)

    assert _both(4, fn, local_size=2)[3] == (3, 4, False, False, 1, 2)


def test_single_rank_no_sockets():
    for ctx in (DummyDistributedContext(), DistributedContext.single()):
        assert ctx.allgather("x") == JaxDummy().allgather("x") == ["x"]
        assert ctx.gather("x") == ["x"]
        assert ctx.broadcast("y") == "y"
        ctx.barrier()
        ctx.close()


def test_size_mismatch_raises():
    for cls in (DistributedContext, JaxDistributedContext):
        with pytest.raises(ValueError):
            cls(rank=0, size=4, local_size=3, cross_size=2, chief_addr="127.0.0.1",
                chief_port=1)


def test_star_timeout_message_names_missing_ranks():
    port = allocate_port()
    server = _StarServer(port, n_workers=3, host="127.0.0.1")
    try:
        client = _StarClient("127.0.0.1", port, rank=2, timeout=5.0)
        deadline = time.time() + 5
        while time.time() < deadline:
            with server._lock:
                if 2 in server._conns:
                    break
        with pytest.raises(TimeoutError) as e:
            server.wait_ready(timeout=0.3)
        assert "1/3" in str(e.value) and "[2]" in str(e.value)
        client.close()
    finally:
        server.close()


def test_from_torch_on_gloo_ranks(tmp_path):
    outs = launch("collectives", 4, str(tmp_path), {})
    for rank, out in enumerate(outs):
        assert (out["rank"], out["size"], out["chief"]) == (rank, 4, rank == 0)
        assert out["local_chief"] == (rank == 0)
        assert out["backend"] == "gloo"
        assert out["allgather"] == ["r0", "r1", "r2", "r3"]
        assert out["gather"] == ([0, 10, 20, 30] if rank == 0 else None)
        assert out["broadcast"] == "payload"
        assert out["allgather_local"] == [0, 1, 2, 3]
        assert out["all_reduce"] == 10.0
        assert out["preempt"] is True


def test_core_init_takes_from_torch_under_torchrun(monkeypatch, tmp_path):
    seen = []

    def fake(cls=None, **kw):
        seen.append(kw)
        return DummyDistributedContext()

    monkeypatch.setattr(DistributedContext, "from_torch", classmethod(
        lambda cls, **kw: fake(**kw)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    ctx = core.init(checkpoint_dir=str(tmp_path), device="cpu")
    assert seen == [{"device": "cpu"}]
    ctx.close()
    monkeypatch.setenv("WORLD_SIZE", "1")
    ctx = core.init(checkpoint_dir=str(tmp_path))
    assert isinstance(ctx.distributed, DummyDistributedContext) and len(seen) == 1
    ctx.close()
