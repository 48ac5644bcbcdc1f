"""Control-plane distributed context, and the tensor plane's process group.

A copy of ``determined_tpu/core/_distributed.py``.  Control-plane
collectives (checkpoint storage ids, the preemption vote, rendezvous of
non-tensor facts) are tiny, rare and host-side: a chief-rooted star over
TCP sockets carrying pickled objects (``_StarServer``/``_StarClient``/
``_Star``).  Where the JAX package leaves the tensor plane to XLA, the port
opens a ``torch.distributed`` process group beside the star
(``DistributedContext.from_torch`` under torchrun, ``from_rendezvous`` under
the master, in place of ``from_jax``): NCCL on CUDA, gloo on the CPU.  One
process per device, as torchrun launches them.

One DistributedContext per process.  ``rank``/``size`` are global,
``local_rank``/``local_size`` within a host, ``cross_rank``/``cross_size``
across hosts.

The pipe axis's activations move point to point (``p2p_exchange``): a
pipeline tick's sends and receives go out as one ``batch_isend_irecv`` on
the pipe group, NCCL on the card and gloo on the CPU.  ``warm_pipe`` makes
each neighbour pair's communicator before anything is timed.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.utils import faults
from determined_tpu_torch.utils.errors import PeerLostError

logger = logging.getLogger("determined_tpu_torch.core.distributed")

_LEN = struct.Struct(">Q")

# A connection that never sends its hello is half-open (SYN landed, the
# process died, or a port scanner poked us): give it this long, then drop
# it without consuming a worker slot.
HELLO_TIMEOUT = 30.0


def allocate_port(host: str = "127.0.0.1") -> int:
    """Bind-and-release to find a free TCP port (test/rendezvous helper)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, length))


class _StarServer:
    """Chief side of the star: accepts ``n_workers`` identified connections."""

    def __init__(self, port: int, n_workers: int, host: str = "0.0.0.0") -> None:
        self.n_workers = n_workers
        self._conns: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(max(n_workers, 1))
        if n_workers == 0:
            self._ready.set()
        else:
            self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
            self._accept_thread.start()

    def _accept_loop(self) -> None:
        """Accept until all workers have identified themselves.

        Each accepted connection handshakes on its OWN thread with a hello
        deadline, so one half-open connection (peer died after SYN, or a
        stray scanner) is dropped and logged instead of serially blocking
        every later worker's rendezvous.
        """
        try:
            while not self._ready.is_set():
                conn, addr = self._listener.accept()
                threading.Thread(
                    target=self._handshake, args=(conn, addr), daemon=True
                ).start()
        except OSError:
            return  # listener closed during shutdown

    def _handshake(self, conn: socket.socket, addr: Any) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(HELLO_TIMEOUT)
        try:
            hello = _recv_msg(conn)
            rank = int(hello["rank"])
        except Exception as e:  # noqa: BLE001 - drop, log, keep the slot free
            logger.warning(
                "dropping half-open/garbled connection from %s (no hello within "
                "%.0fs: %s)",
                addr,
                HELLO_TIMEOUT,
                e,
            )
            try:
                conn.close()
            except OSError:
                pass
            return
        conn.settimeout(None)  # collectives set their own deadlines
        with self._lock:
            self._conns[rank] = conn
            done = len(self._conns) >= self.n_workers
        if done:
            self._ready.set()

    def wait_ready(self, timeout: float) -> None:
        if not self._ready.wait(timeout):
            with self._lock:
                have = sorted(self._conns)
            raise TimeoutError(
                f"star rendezvous timed out: {len(have)}/{self.n_workers} workers "
                f"connected (ranks {have})"
            )

    def gather(self, own: Any, timeout: float) -> List[Any]:
        self.wait_ready(timeout)
        out: Dict[int, Any] = {0: own} if 0 not in self._conns else {}
        for rank, conn in self._conns.items():
            # hard deadline: a dead peer must surface as PeerLostError, not
            # hang the gang forever on a blocking recv
            conn.settimeout(timeout)
            try:
                out[rank] = _recv_msg(conn)
            except socket.timeout as e:
                raise PeerLostError(
                    f"gather: rank {rank} sent nothing within {timeout:.0f}s"
                ) from e
            except (ConnectionError, OSError) as e:
                raise PeerLostError(f"gather: rank {rank} connection lost: {e}") from e
        # ranks of workers + chief's own slot; caller supplies ordering map
        return [out[k] for k in sorted(out)]

    def scatter_same(self, value: Any, timeout: float) -> None:
        self.wait_ready(timeout)
        for rank, conn in self._conns.items():
            conn.settimeout(timeout)
            try:
                _send_msg(conn, value)
            except socket.timeout as e:
                raise PeerLostError(
                    f"scatter: rank {rank} not draining within {timeout:.0f}s"
                ) from e
            except (ConnectionError, OSError) as e:
                raise PeerLostError(f"scatter: rank {rank} connection lost: {e}") from e

    def close(self) -> None:
        for c in self._conns.values():
            try:
                c.close()
            except OSError:
                pass
        self._listener.close()


class _StarClient:
    """Worker side: one persistent framed-pickle connection to the chief."""

    def __init__(self, addr: str, port: int, rank: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                self._sock = socket.create_connection((addr, port), timeout=timeout)
                break
            except OSError as e:
                last_err = e
                time.sleep(0.1)
        else:
            raise ConnectionError(f"could not reach chief at {addr}:{port}: {last_err}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # create_connection left the connect timeout installed as the socket
        # timeout: every later send/recv inherits the deadline, so a dead
        # chief surfaces as PeerLostError instead of an eternal block
        _send_msg(self._sock, {"rank": rank})

    def send(self, obj: Any) -> None:
        try:
            _send_msg(self._sock, obj)
        except socket.timeout as e:
            raise PeerLostError(f"send to chief timed out: {e}") from e
        except (ConnectionError, OSError) as e:
            raise PeerLostError(f"chief connection lost during send: {e}") from e

    def recv(self) -> Any:
        try:
            return _recv_msg(self._sock)
        except socket.timeout as e:
            raise PeerLostError(f"no reply from chief within deadline: {e}") from e
        except (ConnectionError, OSError) as e:
            raise PeerLostError(f"chief connection lost during recv: {e}") from e

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _collective_timeout(timeout: float) -> float:
    """``DTPU_COLLECTIVE_TIMEOUT`` over the given collective deadline."""
    env_timeout = os.environ.get("DTPU_COLLECTIVE_TIMEOUT")
    if env_timeout:
        try:
            return float(env_timeout)
        except ValueError:
            logger.warning("ignoring malformed DTPU_COLLECTIVE_TIMEOUT=%r", env_timeout)
    return timeout


class _Star:
    """A gather/allgather/broadcast group of ``size`` ranks rooted at 0."""

    def __init__(
        self,
        group_rank: int,
        size: int,
        chief_addr: str,
        chief_port: int,
        timeout: float = 600.0,
        bind_host: str = "0.0.0.0",
        server: Optional[_StarServer] = None,
    ) -> None:
        self.group_rank = group_rank
        self.size = size
        self.timeout = timeout
        self.server: Optional[_StarServer] = None
        self.client: Optional[_StarClient] = None
        self._addr = (chief_addr, chief_port, bind_host)
        # The chief binds eagerly (workers must have something to retry
        # against); workers connect lazily on first collective so ranks
        # that never communicate need no live chief.
        if size > 1 and group_rank == 0:
            self.server = server or _StarServer(chief_port, size - 1, host=bind_host)

    def _ensure_connected(self) -> None:
        if self.size <= 1 or self.group_rank == 0 or self.client is not None:
            return
        addr, port, _ = self._addr
        self.client = _StarClient(addr, port, self.group_rank, self.timeout)

    def gather(self, obj: Any) -> Optional[List[Any]]:
        faults.fire("distributed.gather", rank=self.group_rank)
        if self.size <= 1:
            return [obj]
        self._ensure_connected()
        if self.server is not None:
            return self.server.gather(obj, self.timeout)
        assert self.client is not None
        self.client.send(obj)
        return None

    def allgather(self, obj: Any) -> List[Any]:
        faults.fire("distributed.allgather", rank=self.group_rank)
        if self.size <= 1:
            return [obj]
        self._ensure_connected()
        if self.server is not None:
            result = self.server.gather(obj, self.timeout)
            self.server.scatter_same(result, self.timeout)
            return result
        assert self.client is not None
        self.client.send(obj)
        return self.client.recv()

    def broadcast(self, obj: Any) -> Any:
        faults.fire("distributed.broadcast", rank=self.group_rank)
        if self.size <= 1:
            return obj
        self._ensure_connected()
        if self.server is not None:
            self.server.scatter_same(obj, self.timeout)
            return obj
        assert self.client is not None
        return self.client.recv()

    def barrier(self) -> None:
        self.allgather(None)

    def close(self) -> None:
        if self.server:
            self.server.close()
        if self.client:
            self.client.close()


class DistributedContext:
    """Rank bookkeeping + control-plane collectives.

    Two stars, like the reference (``_distributed.py:91-168``): a global
    star rooted at rank 0 (the chief) and a per-host star rooted at each
    host's local chief.
    """

    def __init__(
        self,
        *,
        rank: int,
        size: int,
        local_rank: Optional[int] = None,
        local_size: int = 1,
        cross_rank: Optional[int] = None,
        cross_size: Optional[int] = None,
        chief_addr: Optional[str] = None,
        chief_port: Optional[int] = None,
        local_chief_port: Optional[int] = None,
        timeout: float = 600.0,
        servers: Tuple[Optional[_StarServer], Optional[_StarServer]] = (None, None),
    ) -> None:
        if size > 1 and (chief_addr is None or chief_port is None):
            raise ValueError("multi-rank DistributedContext requires chief_addr/chief_port")
        # Infer the node topology when not given: one process per node by
        # default (local_size=1), so cross follows from rank/local_size.
        if local_rank is None:
            local_rank = rank % local_size
        if cross_size is None:
            cross_size = size // local_size
        if cross_rank is None:
            cross_rank = rank // local_size
        if local_size * cross_size != size:
            raise ValueError(
                f"local_size ({local_size}) x cross_size ({cross_size}) != size ({size})"
            )
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self._closed = False
        # the tensor plane, set by from_torch: the rank's device, the
        # process group's backend, and whether close() destroys the group
        self.device: Any = None
        self.backend: Optional[str] = None
        self._owns_process_group = False

        self._global = _Star(
            rank, size, chief_addr or "127.0.0.1", chief_port or 0, timeout, server=servers[0]
        )
        if local_size > 1:
            lport = local_chief_port if local_chief_port is not None else (chief_port or 0) + 1
            self._local = _Star(
                local_rank, local_size, "127.0.0.1", lport, timeout, bind_host="127.0.0.1",
                server=servers[1],
            )
        else:
            self._local = _Star(0, 1, "127.0.0.1", 0, timeout)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_torch(
        cls,
        *,
        device: Any = None,
        init_method: Optional[str] = None,
        timeout: float = 600.0,
    ) -> "DistributedContext":
        """Build from torchrun's environment (``RANK``, ``WORLD_SIZE``,
        ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
        ``MASTER_PORT``) and open the tensor process group beside the star:
        NCCL on CUDA, gloo only where ``device`` names the CPU.  A rank runs
        on ``cuda:LOCAL_RANK`` unless ``device`` names its ordinal (a gang
        on a block of the host's devices, ``experiment/_gang.py``: the
        rank's device is its block's, every device stays visible, and
        ``LOCAL_RANK`` is never taken as an ordinal there).  ``init_method`` overrides the TCP
        rendezvous at ``MASTER_ADDR:MASTER_PORT`` (``file://...`` for a
        ``FileStore``).

        The stars' chiefs bind free ports and publish them over the process
        group, so the star needs no port of its own (``DTPU_CHIEF_PORT``
        pins the global one where a firewall wants it).  The timeout is the
        collective I/O deadline (``DTPU_COLLECTIVE_TIMEOUT`` overrides it)
        and the process group's."""
        timeout = _collective_timeout(timeout)
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        return cls._with_process_group(
            rank=int(os.environ.get("RANK", "0")),
            size=int(os.environ.get("WORLD_SIZE", "1")),
            local_rank=int(os.environ.get("LOCAL_RANK", "0")),
            local_size=int(os.environ.get("LOCAL_WORLD_SIZE", "1")),
            addr=addr,
            init_method=init_method
            or f"tcp://{addr}:{int(os.environ.get('MASTER_PORT', '29500'))}",
            device=device,
            timeout=timeout,
        )

    @classmethod
    def from_rendezvous(
        cls, *, device: Any = None, timeout: float = 600.0
    ) -> "DistributedContext":
        """Build from the master's launch environment, as the JAX
        package's ``from_jax`` reads it after ``jax.distributed``:
        ``DTPU_RENDEZVOUS`` (``coordinator`` host:port, ``num_nodes``,
        ``node_rank``) is the torch process group's TCP rendezvous (NCCL
        on CUDA, gloo where ``device`` names the CPU), one rank a node, and
        ``DTPU_CHIEF_ADDR``/``DTPU_CHIEF_PORT`` are the star's chief (the
        master picks the port).  An allocation of one node is a single
        rank with no process group.

        A node's process drives one device here: an allocation of more
        than one slot on a node (``DTPU_NUM_SLOTS`` > 1) raises, since
        running a node's slots as local ranks is a later slice of the port.
        A host with several GPUs runs one agent a GPU, each with its own
        ``CUDA_VISIBLE_DEVICES``, which the trial inherits."""
        import json

        slots = int(os.environ.get("DTPU_NUM_SLOTS", "1") or 1)
        if slots > 1:
            raise NotImplementedError(
                f"an allocation of {slots} slots on one node needs its slots run as "
                "local ranks, which is not ported to determined_tpu_torch yet; it comes "
                "with a later slice of the port (ROADMAP.md, Queue 1): start one agent a "
                "GPU (`cluster up --gpus`) so that each node holds one slot"
            )
        info = json.loads(os.environ.get("DTPU_RENDEZVOUS") or "{}")
        size = int(info.get("num_nodes", 1))
        if size <= 1:
            return cls.single()
        host, _, port = str(info["coordinator"]).rpartition(":")
        return cls._with_process_group(
            rank=int(info["node_rank"]),
            size=size,
            local_rank=0,
            local_size=1,
            addr=os.environ.get("DTPU_CHIEF_ADDR") or host,
            init_method=f"tcp://{host}:{int(port)}",
            device=device,
            timeout=_collective_timeout(timeout),
        )

    @classmethod
    def _with_process_group(
        cls, *, rank: int, size: int, local_rank: int, local_size: int, addr: str,
        init_method: str, device: Any, timeout: float,
    ) -> "DistributedContext":
        """Open the tensor process group, then the stars beside it (the
        chiefs bind, every rank learns the ports over the group)."""
        import datetime

        import torch
        import torch.distributed as tdist

        from determined_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"no process group backend for device {dev}")
        tdist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout),
        )
        pinned = int(os.environ.get("DTPU_CHIEF_PORT", "0") or 0)
        chief = _StarServer(pinned, size - 1, host="0.0.0.0") if rank == 0 and size > 1 else None
        local = (
            _StarServer(0, local_size - 1, host="127.0.0.1")
            if local_rank == 0 and local_size > 1 else None
        )
        ports = [None] * size
        tdist.all_gather_object(
            ports, (chief.port if chief else 0, local.port if local else 0)
        )
        ctx = cls(
            rank=rank,
            size=size,
            local_rank=local_rank,
            local_size=local_size,
            cross_rank=rank // max(local_size, 1),
            cross_size=max(size // max(local_size, 1), 1),
            chief_addr=addr,
            chief_port=ports[0][0] or None,
            local_chief_port=ports[rank - local_rank][1],
            timeout=timeout,
            servers=(chief, local),
        )
        ctx.device = dev
        ctx.backend = backend
        ctx._owns_process_group = True
        return ctx

    @classmethod
    def single(cls) -> "DistributedContext":
        return cls(rank=0, size=1)

    # -- predicates --------------------------------------------------------

    def get_rank(self) -> int:
        return self.rank

    def get_size(self) -> int:
        return self.size

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    @property
    def is_local_chief(self) -> bool:
        return self.local_rank == 0

    # -- collectives -------------------------------------------------------

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Chief returns [rank0_obj, rank1_obj, ...]; workers return None."""
        return self._global.gather(obj)

    def allgather(self, obj: Any) -> List[Any]:
        return self._global.allgather(obj)

    def broadcast(self, obj: Any) -> Any:
        """Chief's ``obj`` is returned on every rank."""
        return self._global.broadcast(obj)

    def gather_local(self, obj: Any) -> Optional[List[Any]]:
        return self._local.gather(obj)

    def allgather_local(self, obj: Any) -> List[Any]:
        return self._local.allgather(obj)

    def broadcast_local(self, obj: Any = None) -> Any:
        return self._local.broadcast(obj)

    def barrier(self) -> None:
        self._global.barrier()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._global.close()
        self._local.close()
        if self._owns_process_group:
            import torch.distributed as tdist

            if tdist.is_initialized():
                tdist.destroy_process_group()

    def __enter__(self) -> "DistributedContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def p2p_exchange(sends: List[Tuple[int, Any]], recvs: List[Tuple[int, Any]],
                 group: Any) -> List[Any]:
    """Send each ``(global rank, tensor)`` of ``sends`` and fill each
    ``(global rank, buffer)`` of ``recvs`` over ``group``, all in one
    ``batch_isend_irecv`` (so that ranks that both send to and receive from
    each other in one call cannot deadlock), then wait; returns the
    buffers.  A failed operation raises: there is no fallback."""
    import torch.distributed as tdist

    ops = [tdist.P2POp(tdist.isend, t.contiguous(), peer, group) for peer, t in sends]
    ops += [tdist.P2POp(tdist.irecv, buf, peer, group) for peer, buf in recvs]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return [buf for _, buf in recvs]


def warm_pipe(group: Any, ranks: List[int], rank: int, like: Any) -> None:
    """Make the pipe group's communicators: an all-reduce over the group
    (NCCL wants the group's first operation to involve every rank), then
    one round in which pipe rank ``rank`` sends a tensor shaped ``like`` to
    the next rank and receives one from the previous, the circular wrap
    included, which creates every neighbour pair's communicator.
    ``ranks``: the group's global ranks in pipe order."""
    import torch
    import torch.distributed as tdist

    tdist.all_reduce(torch.zeros(1, device=like.device), group=group)
    n = len(ranks)
    if n > 1:
        p2p_exchange([(ranks[(rank + 1) % n], torch.zeros_like(like))],
                     [(ranks[(rank - 1) % n], torch.empty_like(like))], group)


class DummyDistributedContext(DistributedContext):
    """Single-rank context for off-cluster runs (reference ``_dummy_init``)."""

    def __init__(self) -> None:
        super().__init__(rank=0, size=1)
