"""The native control plane for the port: build ``dtpu-master`` and
``dtpu-agent`` from ``native/`` and run a master with N agents whose trials
run the port (``scripts/devcluster.py`` and the JAX CLI's ``cluster up``,
for ``determined_tpu_torch``).

The binaries are built at first use into ``native/build`` (or
``DTPU_NATIVE_BUILD_DIR``; both ignored by git): cmake where it is
installed, else one ``g++`` process a binary, both at once (the tree has no
third-party dependencies).  Every agent is started with ``--python`` set to
the port's launcher (``exec/launcher.py``), so the trial process it execs is
``determined_tpu_torch.exec.run_trial``; with ``gpus`` each agent gets its
GPUs through its own ``CUDA_VISIBLE_DEVICES``, which its trials inherit: one
GPU and one slot an agent, or an agent that owns N GPUs as N slots, whose
trial runs one local rank process a GPU (``exec/run_trial.py``).

    python -m determined_tpu_torch.cli cluster up --agents 4 --gpus
    python -m determined_tpu_torch.cli cluster up --agents 1 --gpus --slots 4
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "determined_tpu_torch", "exec", "launcher.py")


def build_dir() -> str:
    return os.environ.get("DTPU_NATIVE_BUILD_DIR", os.path.join(REPO, "native", "build"))


def binary(name: str, where: Optional[str] = None) -> str:
    return os.path.join(where or build_dir(), name)


def binaries_built(where: Optional[str] = None) -> bool:
    return all(os.path.exists(binary(n, where)) for n in ("dtpu-master", "dtpu-agent"))


def build_binaries(where: Optional[str] = None, force: bool = False) -> float:
    """Build dtpu-master and dtpu-agent into ``where`` (``build_dir()``);
    returns the seconds it took (0 when they were there, or another
    process built them while this one waited for the directory's lock)."""
    import fcntl

    where = where or build_dir()
    if binaries_built(where) and not force:
        return 0.0
    os.makedirs(where, exist_ok=True)
    # one build at a time per directory (parallel test workers share
    # native/build): a second caller waits, then finds the binaries there
    with open(os.path.join(where, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if binaries_built(where) and not force:
            return 0.0
        return _build(where)


def _build(where: str) -> float:
    t0 = time.monotonic()
    native = os.path.join(REPO, "native")
    if shutil.which("cmake"):
        steps = [[["cmake", "-S", native, "-B", where, "-DCMAKE_BUILD_TYPE=Release"]],
                 [["cmake", "--build", where, "-j", "2"]]]
    else:
        flags = ["-O2", "-std=c++17", "-pthread", "-Wall", "-Wextra",
                 "-Wno-missing-field-initializers"]
        steps = [[["g++", *flags, os.path.join(native, src), "-o", binary(name, where), "-ldl"]
                  for src, name in (("master/master.cpp", "dtpu-master"),
                                    ("agent/agent.cpp", "dtpu-agent"))]]
    for step in steps:
        # the commands of a step run at once; their warnings are shown only
        # when one fails
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for cmd in step]
        outs = [p.communicate()[0].decode(errors="replace") for p in procs]
        for cmd, p, out in zip(step, procs, outs):
            if p.returncode:
                raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out[-4000:]}")
    return time.monotonic() - t0


def gpu_blocks(n_gpus: int, agents: int, per_agent: int = 1) -> List[str]:
    """Each agent's ``CUDA_VISIBLE_DEVICES``: ``per_agent`` consecutive GPU
    ids of the host's ``n_gpus``, agent by agent."""
    if per_agent < 1 or agents * per_agent > n_gpus:
        raise ValueError(f"{agents} agent(s) of {per_agent} GPU(s) need {agents * per_agent} "
                         f"GPUs, found {n_gpus}")
    return [",".join(str(a * per_agent + i) for i in range(per_agent)) for a in range(agents)]


def _get(url: str, timeout: float = 2.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read() or b"null")


class LocalCluster:
    """A master and ``agents`` agents on this host, each agent running the
    port's trials and serving replicas through the launcher.  The cluster
    lives from ``start()`` to ``stop()``, so one cluster can carry several
    runs (a training run, then the fleet serving its checkpoints);
    ``master_args`` are extra ``dtpu-master`` flags, as
    ``scripts/devcluster.py``'s ``DevCluster(master_args=...)`` takes them.
    Each agent has ``slots`` slots (1 by default); with ``gpus``, one
    ``CUDA_VISIBLE_DEVICES`` block an agent, it has one slot a GPU of its
    block instead, and ``slots`` is not taken.
    ``stop()`` ends every process it started (SIGTERM, then SIGKILL of what
    is left, with each process group, so a trial an agent forked goes
    too).

    ``slices`` splits the agents into that many contiguous blocks, each
    agent started with ``--slice-id slice-<s>`` (``native/agent``): the
    master then stamps each gang with the slices it spans
    (``DTPU_NUM_SLICES``) and applies a trial's ``resources.elastic``
    policy to slice losses and returning capacity.  Agent ids follow the
    blocks, so a gang's node ranks are slice-major.  ``kill_agents`` takes
    agents down as a lost host goes (SIGKILL of the agent and of the
    trials it runs), and ``start_agents`` brings them back."""

    def __init__(
        self,
        state_dir: str,
        checkpoint_dir: str,
        *,
        agents: int = 1,
        slots: Optional[int] = None,
        gpus: Optional[Sequence[str]] = None,
        port: int = 0,
        scheduler: str = "priority",
        cwd: Optional[str] = None,
        where: Optional[str] = None,
        master_args: Sequence[str] = (),
        slices: int = 1,
    ) -> None:
        from determined_tpu_torch.core import allocate_port

        self.state_dir = state_dir
        self.checkpoint_dir = checkpoint_dir
        self.n_agents = agents
        self.gpus = [str(g) for g in gpus] if gpus is not None else None
        if self.gpus is not None and (slots is not None or len(self.gpus) != agents):
            raise ValueError(f"gpus gives {agents} agent(s) their slots, one GPU block an "
                             f"agent; got {self.gpus} and slots={slots}")
        #: each agent's slots
        self.slots = ([len(g.split(",")) for g in self.gpus] if self.gpus is not None
                      else [1 if slots is None else slots] * agents)
        if slices < 1 or agents % slices:
            raise ValueError(f"{agents} agents do not split into {slices} slices")
        self.slices = slices
        self.port = port or allocate_port()
        self.scheduler = scheduler
        self.log_dir = os.path.join(state_dir, "logs")
        self.cwd = cwd or REPO
        self.where = where or build_dir()
        #: extra dtpu-master flags (``--serve-replica-timeout-sec 5``, ...)
        self.master_args = list(master_args)
        self.url = f"http://127.0.0.1:{self.port}"
        self.procs: Dict[str, subprocess.Popen] = {}

    def _spawn(self, name: str, argv: List[str], env: Optional[dict] = None) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, f"{name}.log"), "ab") as sink:
            self.procs[name] = subprocess.Popen(
                argv, stdout=sink, stderr=subprocess.STDOUT, cwd=self.cwd, env=env,
                start_new_session=True,
            )

    def start(self, timeout: float = 30.0) -> "LocalCluster":
        os.makedirs(self.state_dir, exist_ok=True)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._spawn("master", [
            binary("dtpu-master", self.where), "--host", "127.0.0.1", "--port", str(self.port),
            "--state-dir", os.path.join(self.state_dir, "master"),
            "--checkpoint-dir", self.checkpoint_dir, "--scheduler", self.scheduler,
            *self.master_args,
        ])
        deadline = time.monotonic() + timeout
        while True:
            try:
                _get(self.url + "/api/v1/master")
                break
            except Exception:  # noqa: BLE001 - not up yet
                self._check_alive()
                if time.monotonic() > deadline:
                    raise RuntimeError(f"dtpu-master did not come up in {timeout:.0f} s")
                time.sleep(0.1)
        self.start_agents(range(self.n_agents), timeout=max(deadline - time.monotonic(), 1.0))
        return self

    def slice_of(self, i: int) -> int:
        """The slice agent ``i`` belongs to."""
        return i * self.slices // self.n_agents

    def start_agents(self, agents: Sequence[int], timeout: float = 30.0) -> None:
        """Start (or restart) the agents ``agents`` and wait until the
        master lists them."""
        for i in agents:
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                        if env.get("PYTHONPATH") else "")
            if self.gpus is not None:
                env["CUDA_VISIBLE_DEVICES"] = self.gpus[i]
            slice_id = ["--slice-id", f"slice-{self.slice_of(i)}"] if self.slices > 1 else []
            self._spawn(f"agent-{i}", [
                binary("dtpu-agent", self.where), "--master-host", "127.0.0.1",
                "--master-port", str(self.port), "--id", f"agent-{i}",
                "--slots", str(self.slots[i]), "--python", LAUNCHER,
                "--state-dir", os.path.join(self.state_dir, f"agent-{i}"), *slice_id,
            ], env=env)
        deadline = time.monotonic() + timeout
        session = self.session()
        want = {f"agent-{i}" for i in agents}
        while not want <= {a["id"] for a in session.get("/api/v1/agents").json()
                           if a.get("alive", True)}:
            self._check_alive()
            if time.monotonic() > deadline:
                raise RuntimeError(f"agents {sorted(want)} did not register in {timeout:.0f} s")
            time.sleep(0.1)

    def kill_agents(self, agents: Sequence[int]) -> None:
        """SIGKILL the agents ``agents`` and every trial process they run,
        as a lost host takes them: the master sees the agents stop polling."""
        for i in agents:
            self._kill_trials([i])
            p = self.procs.pop(f"agent-{i}", None)
            if p is not None and p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait()

    def _check_alive(self) -> None:
        for name, p in self.procs.items():
            if p.poll() is not None:
                raise RuntimeError(
                    f"{name} exited with {p.returncode}; see {self.log_dir}/{name}.log")

    def session(self):
        """A session logged in as the default (admin) user."""
        from determined_tpu_torch.api import login

        return login(self.url)

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs.values())

    def stop(self, grace: float = 10.0) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + grace
        for p in self.procs.values():
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self._kill_trials()
        for p in self.procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass

    def task_pid(self, task_id: str) -> Optional[int]:
        """The pid of the process an agent runs for ``task_id`` (a trial's
        allocation or a generic task such as a serving replica), from the
        agent's pidfile; None when no agent runs it."""
        for i in range(self.n_agents):
            try:
                with open(os.path.join(self.state_dir, f"agent-{i}", f"{task_id}.pid")) as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                continue
        return None

    def _kill_trials(self, agents: Optional[Sequence[int]] = None) -> None:
        """SIGKILL the process group of every trial an agent (of
        ``agents``, by default all) left running (the agent forks each into
        a group of its own and records its pid under its state
        directory)."""
        for i in range(self.n_agents) if agents is None else agents:
            state = os.path.join(self.state_dir, f"agent-{i}")
            for name in os.listdir(state) if os.path.isdir(state) else ():
                if not name.endswith(".pid"):
                    continue
                try:
                    with open(os.path.join(state, name)) as f:
                        pid = int(f.read().strip() or 0)
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"determined_tpu" not in f.read():
                            continue
                    os.killpg(pid, signal.SIGKILL)
                except (OSError, ValueError):
                    pass

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
