"""The port's ring attention (``determined_tpu_torch/ops/ring_attention.py``)
against the JAX package's on the 8-device virtual mesh.

4 gloo ranks (tests/torch_rank_worker.py, one launch under its hard
timeout for every case) run ``ring_attention`` on their parts of the same
global q, k, v: the contiguous and zigzag sweeps, causal and full, GQA,
and GQA and MQA with a tensor axis (tests/test_ops.py's ring cases at
4 devices).  The assembled outputs and the gradients of sum(out²) hold the
JAX ``ring_attention`` (on the same mesh over 4 of the virtual devices) at
1e-5 in f32; ``ring_block_counts`` gives JAX's per-rank units.  The
in-process ``VirtualRing`` holds the distributed ring, and the
vocab-parallel cross-entropy on a tensor group of 2 holds the
whole-vocabulary loss, in the same launch.
"""

import jax
import numpy as np
import pytest
import torch

from determined_tpu.ops.ring_attention import _resolve_assignment as jax_resolve
from determined_tpu.ops.ring_attention import ring_attention as jax_ring
from determined_tpu.ops.ring_attention import ring_block_counts as jax_ring_block_counts
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu.parallel.mesh import make_mesh as jax_make_mesh
from determined_tpu_torch.ops.attention import dot_product_attention, reference_attention
from determined_tpu_torch.ops.ring_attention import (
    VirtualRing,
    _resolve_assignment,
    ring_attention,
    ring_attention_local,
    ring_block_counts,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_rank_worker import launch

# f32 on both sides; the port merges flash blocks in log2 space where JAX
# runs an online softmax in natural log: reassociation only
TOL = dict(rtol=1e-5, atol=1e-5)
# the virtual ring runs the same block functions on the same shards in
# the same order as the ranks; the ranks' products may use other thread
# splits (2 threads a rank), so f32 rounding is all that may differ
VIRTUAL_TOL = dict(rtol=1e-6, atol=1e-6)

# name: (mesh, b, h, h_kv, s, causal, assignment, with per-rank counts)
CASES = {
    "contiguous_causal": (dict(data=2, seq=2), 2, 4, 4, 64, True, "contiguous", False),
    "zigzag_n2": (dict(data=2, seq=2), 2, 4, 4, 64, True, "auto", False),
    "full": (dict(data=2, seq=2), 2, 4, 4, 64, False, "auto", False),
    "zigzag_n4_gqa": (dict(seq=4), 1, 8, 2, 64, True, "zigzag", True),
    "contiguous_n4_gqa": (dict(seq=4), 1, 8, 2, 64, True, "contiguous", True),
    "mqa_tensor": (dict(tensor=2, seq=2), 1, 8, 1, 64, True, "auto", False),
    "gqa_tensor": (dict(tensor=2, seq=2), 1, 8, 2, 64, True, "auto", False),
}
D = 16


def _inputs(name):
    _, b, h, hkv, s, *_ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, D), (b, hkv, s, D), (b, hkv, s, D)))


@pytest.fixture(scope="module")
def jax_refs(devices8):
    """JAX ring_attention's out and gradients of sum(out²) for each case."""
    refs = {}
    for name, (mesh, _b, _h, _hkv, _s, causal, assignment, _c) in CASES.items():
        jmesh = jax_make_mesh(JaxMeshConfig(**mesh), devices8[:4])

        def loss(q, k, v, jmesh=jmesh, causal=causal, assignment=assignment):
            out = jax_ring(q, k, v, jmesh, causal=causal, assignment=assignment)
            return (out ** 2).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2), has_aux=True))(
            *_inputs(name))
        refs[name] = dict(out=np.asarray(out), dq=np.asarray(grads[0]),
                          dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of 4 ranks for every case (and the cross-entropy's)."""
    cases = {}
    for name, (mesh, _b, _h, _hkv, _s, causal, assignment, counts) in CASES.items():
        q, k, v = _inputs(name)
        cases[name] = dict(mesh=mesh, q=q, k=k, v=v, causal=causal, assignment=assignment,
                           counts=counts)
    rng = np.random.default_rng(5)
    targets = rng.integers(0, 96, (40,))
    targets[::7] = -1  # ignored tokens
    ce = dict(hidden=rng.standard_normal((40, 16)).astype(np.float32),
              kernel=(rng.standard_normal((16, 96)) * 0.25).astype(np.float32), targets=targets)
    return launch("ring", 4, str(tmp_path_factory.mktemp("ring")), dict(cases=cases, ce=ce))


def _assemble(name, outs):
    """The global out and gradients from each rank's parts (dk/dv of kv
    heads a tensor rank held whole are its partial sums: added up)."""
    mesh, b, h, hkv, s, *_ = CASES[name]
    t, n, nd = mesh.get("tensor", 1), mesh.get("seq", 1), mesh.get("data", 1)
    kv_split = t > 1 and hkv % t == 0
    full = {"out": np.zeros((b, h, s, D), np.float32), "dq": np.zeros((b, h, s, D), np.float32),
            "dk": np.zeros((b, hkv, s, D), np.float32), "dv": np.zeros((b, hkv, s, D), np.float32)}
    for o in outs:
        r, c = o[name], o[name]["coords"]
        bs = slice(c["data"] * b // nd, (c["data"] + 1) * b // nd)
        ss = slice(c["seq"] * s // n, (c["seq"] + 1) * s // n)
        hs = slice(c["tensor"] * h // t, (c["tensor"] + 1) * h // t)
        ks = slice(c["tensor"] * hkv // t, (c["tensor"] + 1) * hkv // t) if kv_split else slice(None)
        full["out"][bs, hs, ss] = r["out"]
        full["dq"][bs, hs, ss] = r["dq"]
        for g in ("dk", "dv"):
            if kv_split:
                full[g][bs, ks, ss] = r[g]
            else:
                full[g][bs, ks, ss] += r[g]
    return full


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_the_jax_ring(name, ranks, jax_refs):
    got = _assemble(name, ranks)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], jax_refs[name][key], err_msg=f"{name} {key}", **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_virtual_ring_equals_the_distributed_ring(name, ranks):
    mesh, *_, causal, assignment, _c = CASES[name]
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _inputs(name))
    out = ring_attention_local(q, k, v, VirtualRing(mesh["seq"]), causal=causal,
                               assignment=assignment)
    (out ** 2).sum().backward()
    got = _assemble(name, ranks)
    for key, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(t.detach().numpy(), got[key], err_msg=f"{name} {key}",
                                   **VIRTUAL_TOL)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]])
def test_block_counts_are_the_jax_counts(name, ranks, devices8):
    mesh, *_, causal, assignment, _c = CASES[name]
    q, k, v = _inputs(name)
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh), devices8[:4])
    _, want = jax.jit(lambda q, k, v: jax_ring_block_counts(
        q, k, v, jmesh, causal=causal, assignment=assignment))(q, k, v)
    want = np.asarray(want).tolist()
    n = mesh["seq"]
    # zigzag: 2n + 1 half-blocks on every rank; contiguous: 4 (r + 1)
    assert want == ([2 * n + 1] * n if assignment == "zigzag" else [4 * (r + 1) for r in range(n)])
    for o in ranks:  # every rank of the seq group gathers the same list
        assert o[name]["counts"] == want
    _, virtual = ring_block_counts(*(torch.tensor(a) for a in (q, k, v)), VirtualRing(n),
                                   causal=causal, assignment=assignment)
    assert virtual == want


@pytest.mark.parametrize("mode", ["chunked", "tile", "bf16_residual", "logits"])
def test_vocab_parallel_cross_entropy_equals_the_whole_vocabulary(mode, ranks):
    # bf16 products on both sides, the tensor group's lse summed in another
    # order: a few bf16 ulps (2^-8) of the largest gradient
    tol = 1e-2 if mode == "bf16_residual" else 1e-5
    for o in ranks:
        r = o["ce"][mode]
        whole, split = r["loss"]
        assert abs(whole - split) <= tol * abs(whole), (mode, r)
        assert r["dx"] <= tol * r["dx_scale"], (mode, r)
        assert r["dw"] <= tol * r["dw_scale"], (mode, r)


@pytest.mark.parametrize(
    "assignment, causal, sl",
    [("auto", True, 16), ("auto", True, 15), ("auto", False, 16), ("contiguous", True, 16),
     ("zigzag", False, 16), ("zigzag", True, 15), ("spiral", True, 16)],
)
def test_assignment_resolves_as_in_jax(assignment, causal, sl):
    try:
        want = jax_resolve(assignment, causal, sl)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _resolve_assignment(assignment, causal, sl)
        assert str(got.value) == str(e)
    else:
        assert _resolve_assignment(assignment, causal, sl) == want


def test_ring_falls_back_without_a_seq_axis():
    q, k, v = (torch.tensor(a) for a in _inputs("full"))
    want = reference_attention(q, k, v, causal=True)
    assert torch.equal(ring_attention(q, k, v, None), want)
    assert torch.equal(dot_product_attention(q, k, v, causal=True), want)
    with pytest.raises(ValueError, match="ring attention requires the mesh"):
        dot_product_attention(q, k, v, impl="ring")


def test_virtual_ring_in_bf16_tracks_f32_attention():
    """The kernels' bf16 route on the CPU: each block's out rounded to bf16
    before the f32 merge, the merged out rounded once more."""
    q, k, v = (torch.tensor(a) for a in _inputs("zigzag_n4_gqa"))
    want = reference_attention(q, k, v, causal=True)
    for n in (2, 4):
        got = ring_attention_local(*(t.bfloat16() for t in (q, k, v)), VirtualRing(n))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2, rtol=3e-2)
