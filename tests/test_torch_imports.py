"""The port stands alone: no module of determined_tpu_torch, nor
chip_smoke.py, imports JAX, flax, optax, orbax, transformers, msgpack or
anything of the JAX package, nor ``yaml`` at import time (a card's machine may lack it: the port
imports it only where a file is read); and its entry points never fall back
to the CPU on their own."""

import os
import textwrap

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_fork_probe import REPO, Zygote

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "determined_tpu", "yaml",
           "transformers", "msgpack", "requests")


# Each probe runs in a child forked from one interpreter that has the
# blocker installed (and, for ``forked``, torch imported once): a fresh
# interpreter a probe without a torch import of its own each time.
@pytest.fixture(scope="module")
def forked():
    zygote = Zygote(BLOCKED, "torch")
    yield zygote
    zygote.close()


@pytest.fixture(scope="module")
def forked_bare():
    zygote = Zygote(BLOCKED, "none")
    yield zygote
    zygote.close()

_PROBE = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = {blocked!r}

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import determined_tpu_torch
    names = ["determined_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            determined_tpu_torch.__path__, "determined_tpu_torch."
        )
    ]
    for name in names:
        importlib.import_module(name)
    importlib.import_module("chip_smoke")
    leaked = sorted(
        m for m in sys.modules
        if any(m == b or m.startswith(b + ".") for b in BLOCKED)
    )
    assert not leaked, leaked
    print(len(names))
    """
).format(blocked=BLOCKED)


def test_port_and_chip_smoke_import_nothing_of_jax(forked):
    proc = forked.run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    # every module of the slices was walked, not a stub of the package
    assert int(proc.stdout.strip().splitlines()[-1]) >= 75


@pytest.mark.parametrize("module", [
    "determined_tpu_torch.observability",
    "determined_tpu_torch.observability._tracer",
    "determined_tpu_torch.observability._goodput",
    "determined_tpu_torch.core._metrics",
    "determined_tpu_torch.core._profiler",
    "determined_tpu_torch.utils.kineto",
])
def test_observability_and_profiler_modules_import_nothing_of_jax(forked_bare, module):
    """The tracer, the ledger, the metrics shipper, the profiler and the op
    table are the port's own copies: each, imported alone, pulls in
    nothing of JAX or the JAX package (nor torch.profiler: that is
    imported when a window opens)."""
    probe = textwrap.dedent(
        """
        import importlib, sys

        BLOCKED = {blocked!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        importlib.import_module({module!r})
        assert "torch.profiler" not in sys.modules
        print("ok")
        """
    ).format(blocked=BLOCKED, module=module)
    proc = forked_bare.run(probe)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "determined_tpu_torch.train._quant",
    "determined_tpu_torch.utils.compilation_cache",
    "determined_tpu_torch.inference",
    "determined_tpu_torch.models.resnet",
    "determined_tpu_torch.models.diffusion",
    "determined_tpu_torch.models._layers",
    "determined_tpu_torch.train._optim",
    "determined_tpu_torch.models.hf_gpt2",
    "determined_tpu_torch.models.hf_bert",
    "determined_tpu_torch.models._hf_common",
    "determined_tpu_torch.models._flax_msgpack",
])
def test_step_knob_and_train_to_serve_modules_import_nothing_of_jax(forked, module):
    """The quantized matmuls, the build cache, batch inference, the ResNet,
    the DDPM UNet and sampler, their layers and the SGD optimizer, and the
    GPT-2 and BERT modules with their Flax weight reader are the port's own
    copies: each, imported alone, pulls in nothing of JAX
    or the JAX package, and builds no kernel (nothing of ops/_build is
    loaded)."""
    probe = textwrap.dedent(
        """
        import importlib, sys

        BLOCKED = {blocked!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        importlib.import_module({module!r})
        assert "determined_tpu_torch.ops._build" not in sys.modules or not sys.modules[
            "determined_tpu_torch.ops._build"]._libs
        print("ok")
        """
    ).format(blocked=BLOCKED, module=module)
    proc = forked.run(probe)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "determined_tpu_torch.models.moe",
    "determined_tpu_torch.core._distributed",
    "determined_tpu_torch.parallel",
    "determined_tpu_torch.parallel.mesh",
    "determined_tpu_torch.parallel.sharding",
    "determined_tpu_torch.parallel.tensor_parallel",
    "determined_tpu_torch.parallel.pipeline",
    "determined_tpu_torch.ops.ring_attention",
    "determined_tpu_torch.train._overlap",
])
def test_moe_and_parallel_modules_import_nothing_of_jax(forked, module):
    """The MoE layer, the distributed context, the mesh and sharding rules
    and the overlapped sync's plan are the port's own copies: each, imported alone, pulls in nothing
    of JAX or the JAX package (not its ``core/_distributed.py`` or
    ``parallel/mesh.py``, which import no JAX themselves), opens no process
    group and loads no FSDP (imported where a mesh is built)."""
    probe = textwrap.dedent(
        """
        import importlib, sys

        BLOCKED = {blocked!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        importlib.import_module({module!r})
        import torch.distributed as dist
        assert not dist.is_initialized()
        assert "torch.distributed.fsdp" not in sys.modules
        print("ok")
        """
    ).format(blocked=BLOCKED, module=module)
    proc = forked.run(probe)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "determined_tpu_torch.experiment.scheduler",
    "determined_tpu_torch.experiment._gang",
    "determined_tpu_torch.exec.gang_rank",
    "determined_tpu_torch.train.serialization",
    "mesh_smoke",
])
def test_scheduler_gang_and_sharded_checkpoint_modules_import_nothing_of_jax(forked, module):
    """The concurrent trial scheduler, the gang launcher, the gang's rank
    entry point and the sharded array plane are the port's own copies (not
    the JAX package's ``experiment/scheduler.py``, which imports no JAX
    itself), and ``mesh_smoke.py`` drives them: each, imported alone, pulls
    in nothing of JAX or the JAX package, opens no process group and starts
    no rank process."""
    probe = textwrap.dedent(
        """
        import importlib, sys

        BLOCKED = {blocked!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        importlib.import_module({module!r})
        import multiprocessing
        import torch.distributed as dist
        assert not dist.is_initialized()
        assert not multiprocessing.active_children()
        print("ok")
        """
    ).format(blocked=BLOCKED, module=module)
    proc = forked.run(probe)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda(forked):
    """Without a GPU the smoke run prints no result and exits non-zero."""
    proc = forked.run(
        "import torch; torch.cuda.is_available = lambda: False; "
        "import runpy, sys; sys.argv = ['chip_smoke.py']; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_decode_kernels_without_device_raises_instead_of_running_on_cpu(monkeypatch):
    from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from determined_tpu_torch.serve import DecodeKernels, ServeConfig

    model = TransformerLM(
        TransformerConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2), device="cpu"
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeKernels(model, ServeConfig())


def test_run_local_without_a_gpu_raises_instead_of_training_on_cpu(forked, tmp_path):
    """``python -m determined_tpu_torch.cli run-local`` on a machine without
    a GPU raises before it trains or writes a checkpoint."""
    ckpt = tmp_path / "ckpts"
    argv = ["run-local", os.path.join(REPO, "examples/transformer_lm/const.yaml"),
            "determined_tpu_torch.models.transformer:LMTrial", "--checkpoint-dir", str(ckpt)]
    # the CLI reads yaml: the probe takes the import blocker off first
    proc = forked.run(
        "import sys; sys.meta_path[:] = [m for m in sys.meta_path "
        "if type(m).__name__ != '_Blocker']; "
        "import torch; torch.cuda.is_available = lambda: False; "
        "from determined_tpu_torch.cli.main import main; "
        f"sys.exit(main({argv!r}))", cwd=str(tmp_path), path=[REPO])
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not ckpt.exists()


@pytest.mark.parametrize("module, no_torch", [
    ("determined_tpu_torch.api.session", True),
    ("determined_tpu_torch.api.authentication", True),
    ("determined_tpu_torch.exec._tls", True),
    ("determined_tpu_torch.exec.launcher", True),
    ("determined_tpu_torch.exec.run_trial", True),
    ("determined_tpu_torch.core._cluster_info", True),
    ("determined_tpu_torch.core._heartbeat", True),
    ("determined_tpu_torch.core._preempt", True),
    ("determined_tpu_torch.core._train", True),
    ("determined_tpu_torch.experiment.registry", False),
    ("determined_tpu_torch.devcluster", True),
    ("determined_tpu_torch.experiment.cluster", False),
    ("determined_tpu_torch.exec.serve_replica", True),
    ("determined_tpu_torch.serve.replica", False),
    ("determined_tpu_torch.client", True),
    ("determined_tpu_torch.common.context", True),
    ("determined_tpu_torch.cli.main", True),
    # the package's names load when read: the registry client alone stays light
    ("determined_tpu_torch.experiment", True),
])
def test_cluster_modules_import_nothing_of_jax_or_requests(forked, forked_bare, module,
                                                          no_torch):
    """The cluster path's modules are the port's own copies on the standard
    library: each, imported alone, pulls in nothing of JAX, the JAX package
    or ``requests``; the session, the launcher (an exec shim the agent
    runs for every trial) and the trial process's entry import no torch
    before the experiment's environment is applied."""
    probe = textwrap.dedent(
        """
        import importlib, sys

        BLOCKED = {blocked!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        importlib.import_module({module!r})
        print("torch" in sys.modules)
        """
    ).format(blocked=BLOCKED, module=module)
    proc = (forked_bare if no_torch else forked).run(probe)
    assert proc.returncode == 0, proc.stderr
    if no_torch:
        assert proc.stdout.strip() == "False"
