"""The port's mesh and sharding rules (determined_tpu_torch/parallel)
against the JAX package's (tests/test_mesh.py's cases): ``MeshConfig``'s
resolution and its errors, the logical rules, the batch's spec, the
auto-FSDP dim choice, and on 4 gloo ranks ``make_mesh``'s coordinates
against the JAX mesh's device layout (tests/torch_rank_worker.py, each
launch under a hard timeout of ``RANK_TIMEOUT`` seconds).  Exact equality
throughout: these are integers and names."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from determined_tpu.parallel import DEFAULT_RULES as JAX_RULES
from determined_tpu.parallel import MeshConfig as JaxMeshConfig
from determined_tpu.parallel import batch_sharding as jax_batch_sharding
from determined_tpu.parallel import logical_to_mesh_spec as jax_spec
from determined_tpu.parallel import make_mesh as jax_make_mesh
from determined_tpu.train._trainer import _infer_fsdp_specs
from determined_tpu_torch.parallel import (
    DEFAULT_RULES,
    MeshAxes,
    MeshConfig,
    batch_sharding,
    fsdp_shard_dim,
    logical_to_mesh_spec,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch


def test_mesh_config_resolve():
    cfg = MeshConfig(data=-1, tensor=2).resolve(8)
    assert cfg.data == 4 and cfg.tensor == 2
    assert cfg.num_devices == 8
    assert cfg.sizes() == JaxMeshConfig(data=-1, tensor=2).resolve(8).sizes()


@pytest.mark.parametrize("kw, n", [
    (dict(data=-1, fsdp=-1), 8), (dict(data=3), 8), (dict(data=-1, fsdp=3), 8),
    (dict(data=2, num_slices=0), 2), (dict(expert=4), 2),
])
def test_mesh_config_resolve_errors_are_the_jax_errors(kw, n):
    with pytest.raises(ValueError) as got:
        MeshConfig(**kw).resolve(n)
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**kw).resolve(n)
    assert str(got.value) == str(want.value)


def test_default_rules_are_the_jax_rules():
    assert DEFAULT_RULES == JAX_RULES
    assert MeshAxes.ALL == ("dcn", "data", "fsdp", "tensor", "seq", "expert", "pipe")


def _jax_shape(cfg):
    mesh = jax_make_mesh(cfg, jax.devices()[:cfg.num_devices])
    return mesh


def test_logical_to_mesh_spec_drops_trivial_axes(devices8):
    spec = logical_to_mesh_spec(("embed", "mlp"), DEFAULT_RULES, MeshConfig(data=8))
    assert spec == (None, None)
    spec = logical_to_mesh_spec(("batch", None), DEFAULT_RULES, MeshConfig(data=8))
    assert spec == (MeshAxes.DATA, None)


def test_logical_to_mesh_spec_no_duplicate_axes(devices8):
    spec = logical_to_mesh_spec(("heads", "mlp"), DEFAULT_RULES, MeshConfig(tensor=8))
    assert spec == (MeshAxes.TENSOR, None)


@pytest.mark.parametrize("mesh", [
    dict(data=8), dict(data=2, fsdp=2, tensor=2), dict(fsdp=4, tensor=2), dict(data=2, expert=4),
    dict(data=2, fsdp=2, expert=2), dict(expert=8),
])
@pytest.mark.parametrize("logical", [
    ("batch", "length", "embed"), ("expert", "embed", "mlp"), ("expert", "mlp", "embed"),
    ("embed", "expert"), ("fsdp_shard", "mlp"), ("vocab", "embed"), ("heads", "mlp"),
    (None, "kv"), ("stage", "batch"),
])
def test_logical_specs_equal_the_jax_specs(devices8, mesh, logical):
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh), devices8)
    want = jax_spec(logical, JAX_RULES, jmesh)
    got = logical_to_mesh_spec(logical, DEFAULT_RULES, MeshConfig(**mesh))
    assert P(*got) == want


@pytest.mark.parametrize("mesh", [dict(data=8), dict(data=2, fsdp=2, expert=2),
                                  dict(fsdp=4, expert=2), dict(expert=8)])
def test_batch_goes_over_data_and_fsdp(devices8, mesh):
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh), devices8)
    got = batch_sharding(MeshConfig(**mesh))
    assert P(*got) == jax_batch_sharding(jmesh).spec
    assert "expert" not in str(got)


@pytest.mark.parametrize("n", [1, 2, 4, 3])
def test_auto_fsdp_dim_is_the_jax_trainers_choice(devices8, n):
    shapes = [(8, 2048, 8192), (2048, 512), (512, 2048), (7,), (6, 6), (), (3, 5), (16, 4, 8)]
    jmesh = jax_make_mesh(JaxMeshConfig(fsdp=n), devices8[:n]) if n in (1, 2, 4) else None
    for shape in shapes:
        got = fsdp_shard_dim(shape, n)
        if jmesh is not None:
            spec = _infer_fsdp_specs(jax.ShapeDtypeStruct(shape, np.float32), jmesh)
            want = None if spec is None else spec.index("fsdp_shard")
            assert got == want, shape
        elif got is not None:
            assert shape[got] % n == 0


@pytest.mark.parametrize("axis", ["tensor", "seq", "pipe", "dcn"])
def test_axes_of_later_slices_raise_naming_the_slice(axis):
    """Every axis is ported, beside every other: each composition passes
    the configuration check (MoE blocks on tensor and seq, pipe x seq x
    expert, and tensor and dcn beside pipe)."""
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.train._trainer import check_exp_config

    def passes(mesh):
        if "dcn" in mesh:
            mesh = dict(mesh, num_slices=mesh.pop("dcn"))
        check_exp_config(ExperimentConfig.parse({
            "hyperparameters": {"n_layers": 4, "moe_experts": 4, "moe_every": 2},
            "resources": {"mesh": mesh}}))

    others = {"data": 2, "fsdp": 2, "seq": 2, "expert": 2, "tensor": 2, "pipe": 2, "dcn": 2}
    for other, n in others.items():
        if other != axis:
            passes({axis: 2, other: n})
    passes({"data": 2, "fsdp": 2, "expert": 8, axis: 1})


@pytest.mark.parametrize("mesh", [dict(data=2, expert=2), dict(data=2, fsdp=2),
                                  dict(fsdp=2, expert=2)])
def test_ranks_sit_where_the_jax_mesh_puts_its_devices(tmp_path, devices8, mesh):
    """Rank r's coordinates are those of device r in the JAX mesh, its batch
    shard is its (data, fsdp) index, and each axis's group sums the ranks
    of its line."""
    outs = launch("mesh", 4, str(tmp_path), dict(mesh=mesh))
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh), devices8[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    names = list(jmesh.axis_names)
    for rank, out in enumerate(outs):
        pos = dict(zip(names, (int(i[0]) for i in np.nonzero(ids == devices8[rank].id))))
        assert out["coords"] == {a: pos[a] for a in out["coords"]}, rank
        c = out["coords"]
        assert out["batch_shard"] == (c["data"] * mesh.get("fsdp", 1) + c["fsdp"],
                                      mesh.get("data", 1) * mesh.get("fsdp", 1))
        for axis, total in out["sums"].items():
            line = [r for r, o in enumerate(outs)
                    if all(o["coords"][a] == c[a] for a in c if a != axis)]
            assert total == float(sum(line)), (rank, axis)
