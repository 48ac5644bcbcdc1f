"""A node's slots as local ranks (determined_tpu_torch/exec/run_trial.py
``run_local_ranks``, core/_distributed.py ``from_rendezvous``), on the CPU.

The JAX package drives a node's N devices from one process
(determined_tpu/exec/run_trial.py sizes its CPU backend from
``DTPU_NUM_SLOTS``); its global device order is process-major, then local.
The port runs one process a slot:

- Two nodes of two slots each (``DTPU_NUM_SLOTS=2``, ``num_nodes=2``): each
  node's process starts two local ranks; their ranks are ``node_rank x 2 +
  local_rank`` (JAX's device order), the world is 4, ``local_rank`` and
  ``cross_rank`` are the node's, and the star's chief, whose value every rank
  receives, is node 0's local rank 0.
- A local rank that fails makes its node's process exit non-zero, after
  stopping the node's other rank (which waits in the rendezvous).
- ``run_trial`` as the agent runs it, against a recording master: an LM on
  pipe 2 x data 2 launched as two nodes of two slots ships the same metric
  rows, bitwise, as the same trial launched as four one-slot nodes.
- ``cluster up``'s GPU blocks: an agent that owns N GPUs gets N ids in its
  ``CUDA_VISIBLE_DEVICES``; ``LocalCluster`` refuses blocks that do not
  match the agents' slots.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from determined_tpu_torch import devcluster
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_cluster_master import RecordingMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent(
    """
    import json, os, sys
    import torch, torch.distributed as tdist
    from determined_tpu_torch.core import DistributedContext

    if os.environ.get("PROBE_FAIL_RANK") == os.environ["DTPU_LOCAL_RANK"]:
        sys.exit(3)
    ctx = DistributedContext.from_rendezvous(device="cpu")
    t = torch.tensor([float(ctx.rank + 1)])
    tdist.all_reduce(t)
    out = dict(
        rank=ctx.rank, size=ctx.size, local_rank=ctx.local_rank, local_size=ctx.local_size,
        cross_rank=ctx.cross_rank, cross_size=ctx.cross_size, chief=ctx.is_chief,
        got=ctx.broadcast("from rank %d" % ctx.rank), star=ctx.allgather(ctx.rank),
        local_star=ctx.allgather_local(ctx.rank), sum=t.item(),
        node=json.loads(os.environ["DTPU_RENDEZVOUS"])["node_rank"])
    # a file a rank: a node's ranks share its stdout
    with open(os.path.join(os.environ["PROBE_DIR"], "rank%d.json" % ctx.rank), "w") as f:
        json.dump(out, f)
    ctx.close()
    """
)

_NODE = ("import sys; from determined_tpu_torch.exec.run_trial import run_local_ranks; "
         "sys.exit(run_local_ranks([sys.executable, '-c', sys.argv[1]], int(sys.argv[2])))")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _node_env(nodes, node_rank, slots, coord, chief, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DTPU_")}
    env.update(PYTHONPATH=REPO, DTPU_NUM_SLOTS=str(slots), DTPU_CHIEF_ADDR="127.0.0.1",
               DTPU_CHIEF_PORT=str(chief), OMP_NUM_THREADS="1",
               DTPU_RENDEZVOUS=json.dumps({"coordinator": f"127.0.0.1:{coord}",
                                           "num_nodes": nodes, "node_rank": node_rank}),
               **extra)
    return env


def test_a_nodes_slots_run_as_local_ranks_in_the_jax_device_order(tmp_path):
    coord, chief = _free_port(), _free_port()
    nodes = [subprocess.Popen([sys.executable, "-c", _NODE, _PROBE, "2"],
                              env=_node_env(2, n, 2, coord, chief, PROBE_DIR=str(tmp_path)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in range(2)]
    for p in nodes:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    outs = [json.loads(f.read_text()) for f in sorted(tmp_path.glob("rank*.json"))]
    by_rank = {o["rank"]: o for o in outs}
    assert sorted(by_rank) == [0, 1, 2, 3]
    for rank, o in by_rank.items():
        # JAX's order: node (process) major, then the node's own devices
        assert o["rank"] == o["node"] * 2 + o["local_rank"]
        assert (o["size"], o["local_size"], o["cross_size"]) == (4, 2, 2)
        assert o["cross_rank"] == o["node"]
        assert o["chief"] == (rank == 0)
        assert o["got"] == "from rank 0"  # the chief is node 0's local rank 0
        assert o["star"] == [0, 1, 2, 3]
        assert o["local_star"] == [2 * o["node"], 2 * o["node"] + 1]
        assert o["sum"] == 10.0


def test_a_local_ranks_failure_fails_the_node():
    coord, chief = _free_port(), _free_port()
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", _NODE, _PROBE, "2"],
                       env=_node_env(1, 0, 2, coord, chief, PROBE_FAIL_RANK="1",
                                     PROBE_DIR="/nonexistent"),
                       capture_output=True, text=True, timeout=120)
    # rank 1 exits 3 before the rendezvous; rank 0, waiting in it, is stopped
    assert p.returncode == 3, p.stderr
    assert "a local rank exited 3; stopping the node's others" in p.stderr
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# run_trial as the agent runs it
# ---------------------------------------------------------------------------

HP = dict(lr=1e-3, global_batch_size=8, seq_len=16, vocab_size=128, d_model=32, n_layers=2,
          n_heads=4, dataset_size=64, bf16=False, attention="reference", warmup_steps=1,
          fused_adamw=True, pipe_microbatches=2)
STEPS, PERIOD = 4, 2
TIMING = ("samples_per_second",)


def _gang(url, store, nodes, slots):
    """Run the trial as ``nodes`` node processes of ``slots`` slots each;
    their exit codes and stderr."""
    exp = {
        "name": "local-ranks", "searcher": {"name": "single", "metric": "validation_loss",
                                            "max_length": {"batches": STEPS}},
        "min_validation_period": {"batches": PERIOD},
        "checkpoint_storage": {"type": "shared_fs", "host_path": store},
        "resources": {"mesh": {"pipe": 2, "data": 2}},
        "environment": {"env": {"DTPU_TORCH_DEVICE": "cpu"}},
    }
    coord, chief = _free_port(), _free_port()
    procs = []
    for n in range(nodes):
        env = _node_env(nodes, n, slots, coord, chief)
        env.update(DTPU_MASTER_URL=url, DTPU_TRIAL_ID="5", DTPU_EXPERIMENT_ID="2",
                   DTPU_ALLOCATION_ID="alloc-5", DTPU_SESSION_TOKEN="tok",
                   DTPU_HPARAMS=json.dumps(HP), DTPU_EXP_CONFIG=json.dumps(exp),
                   DTPU_TRIAL_SEED="3", DTPU_TRIAL_RUN_ID="0", DTPU_AGENT_ID=f"agent-{n}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "determined_tpu_torch.exec.run_trial",
             "determined_tpu_torch.models.transformer:LMTrial"],
            env=env, cwd=store, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return [(p.wait(timeout=300), p.communicate()[1]) for p in procs]


def _rows(fake):
    return [(r["group"], r["steps_completed"],
             {k: v for k, v in r["metrics"].items() if k not in TIMING})
            for r in fake.metric_rows()]


def test_four_local_ranks_equal_four_one_slot_nodes_bitwise(tmp_path):
    rows = {}
    for nodes, slots in ((2, 2), (4, 1)):
        fake = RecordingMaster()
        store = tmp_path / f"n{nodes}"
        store.mkdir()
        try:
            for code, err in _gang(fake.url, str(store), nodes, slots):
                assert code == 0, err[-3000:]
            rows[nodes] = _rows(fake)
        finally:
            fake.close()
        if slots > 1:
            # every local rank joined the gang (a node's stderr carries both
            # of its ranks' lines, rank-prefixed)
            assert "[rank=3]" in err and "[rank=2]" in err
    train = [s for g, s, _ in rows[2] if g == "training"]
    assert train == list(range(1, STEPS + 1))
    assert [s for g, s, _ in rows[2] if g == "validation"] == [PERIOD, STEPS]
    assert rows[2] == rows[4]


@pytest.mark.parametrize("agents,per,want", [
    (4, 1, ["0", "1", "2", "3"]), (1, 4, ["0,1,2,3"]), (2, 2, ["0,1", "2,3"]),
])
def test_gpu_blocks_give_each_agent_its_gpus(agents, per, want):
    assert devcluster.gpu_blocks(4, agents, per) == want
    cluster = devcluster.LocalCluster("/nonexistent/s", "/nonexistent/c", agents=agents,
                                      gpus=want)
    # an agent's slots are its block's GPUs
    assert cluster.gpus == want and cluster.slots == [per] * agents
    assert devcluster.LocalCluster("/nonexistent/s", "/nonexistent/c", agents=agents,
                                   slots=per).slots == [per] * agents
    with pytest.raises(ValueError, match="need"):
        devcluster.gpu_blocks(4, agents + 1, per)
    with pytest.raises(ValueError, match="slots"):
        devcluster.LocalCluster("/nonexistent/s", "/nonexistent/c", agents=agents,
                                slots=per, gpus=want)


@pytest.mark.parametrize("local,named,want", [
    ("2", None, "cuda:2"), (None, None, "cuda:0"), ("3", "cuda:1", "cuda:1"), ("1", "cpu", "cpu"),
])
def test_a_local_rank_trains_on_its_own_gpu(monkeypatch, local, named, want):
    """``task_device``: a local rank on ``cuda:DTPU_LOCAL_RANK`` of the
    node's GPUs; a process of one slot on the current device; an explicit
    ``DTPU_TORCH_DEVICE`` wins.  (No GPU here: CUDA's answers are stood in
    for.)"""
    import logging

    import torch

    from determined_tpu_torch._device import DEVICE_ENV, task_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
    for var, value in (("DTPU_LOCAL_RANK", local), (DEVICE_ENV, named)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert task_device(logging.getLogger("t")) == torch.device(want)
