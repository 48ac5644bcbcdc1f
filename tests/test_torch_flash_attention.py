"""The port's flash attention forward (determined_tpu_torch/ops) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_ops.py runs it.

On CPU tensors the port's wrapper computes its plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py.  Inputs are made with numpy from a seed and handed to both.
"""

import ctypes
import pathlib
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.ops.attention import _repeat_kv as jax_repeat_kv
from determined_tpu.ops.attention import reference_attention as jax_reference
from determined_tpu.ops.flash_attention import (
    DEFAULT_BLOCK,
    _flash_fwd_call,
    _pick_block,
)
from determined_tpu.ops.flash_attention import flash_attention as jax_flash
from determined_tpu_torch.ops import _build, fused_adamw
import determined_tpu_torch.ops.flash_attention as port_flash_mod
from determined_tpu_torch.ops.attention import dot_product_attention, reference_attention
from determined_tpu_torch.ops.flash_attention import (
    _check_kernel_inputs,
    _launch_kernel,
    flash_attention,
    flash_attention_fwd,
)

# the JAX package's own bound for its flash kernel against the reference
# (tests/test_ops.py:27-59): f32 reassociation of the qk and pv sums
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(b=2, h=4, s=256, d=64, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (
        rng.standard_normal((b, h, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
    )


def _jax_lse(q, k, v, causal, block=None):
    """lse straight from the Pallas call, blocks picked as the JAX wrapper
    picks them (or forced smaller to run the online-softmax kernel)."""
    n_rep = q.shape[1] // k.shape[1]
    kr = jax_repeat_kv(jnp.asarray(k), n_rep)
    vr = jax_repeat_kv(jnp.asarray(v), n_rep)
    bq = block or _pick_block(q.shape[2], DEFAULT_BLOCK)
    bk = block or _pick_block(k.shape[2], DEFAULT_BLOCK)
    scale = q.shape[-1] ** -0.5
    out, lse = _flash_fwd_call(jnp.asarray(q), kr, vr, scale, causal, bq, bk)
    return np.asarray(out), np.asarray(lse)


CASES = {
    "causal": dict(shape=dict(), causal=True),
    "full": dict(shape=dict(), causal=False),
    "gqa": dict(shape=dict(h=8, hkv=2), causal=True),
    "ragged96": dict(shape=dict(s=96), causal=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_out_matches_jax_flash(case):
    c = CASES[case]
    q, k, v = _qkv(**c["shape"])
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=c["causal"]))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=c["causal"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_lse_matches_pallas_fwd_call(case):
    c = CASES[case]
    q, k, v = _qkv(**c["shape"])
    want_out, want_lse = _jax_lse(q, k, v, c["causal"])
    out, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=c["causal"]
    )
    assert lse.shape == want_lse.shape == (q.shape[0], q.shape[1], 1, q.shape[2])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_port_matches_pallas_online_softmax_blocks(causal):
    """The TPU kernel's multi-block online softmax (block 32 over S=128)
    gives the same out and lse as the port's one-pass plain version."""
    q, k, v = _qkv(b=1, h=2, s=128, d=64, seed=3)
    want_out, want_lse = _jax_lse(q, k, v, causal, block=32)
    out, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_cpu_path_never_builds_or_counts(monkeypatch):
    """On CPU tensors the wrapper takes the plain version only because the
    tensors lie on the CPU: it never reaches nvcc, the loader or the
    launch counter."""

    def refuse(*_a, **_k):
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = port_flash_mod.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=2, s=64, d=64))
    flash_attention_fwd(q, k, v, causal=True)
    flash_attention(q, k, v, causal=False)
    dot_product_attention(q, k, v, causal=True, impl="flash")
    assert port_flash_mod.launches == before


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_reference_attention_matches_jax(q_offset, hkv):
    q, k, v = _qkv(b=1, h=4, s=32, d=16, hkv=hkv, seed=7)
    q = q[:, :, :24]
    want = np.asarray(
        jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_offset=q_offset)
    )
    got = reference_attention(
        torch.from_numpy(np.ascontiguousarray(q)), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=q_offset,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dispatcher_auto_is_reference_on_cpu_and_flash_agrees():
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=2, s=256, d=64, seed=5))
    auto = dot_product_attention(q, k, v, causal=True)
    ref = reference_attention(q, k, v, causal=True)
    assert torch.equal(auto, ref)
    flash = dot_product_attention(q, k, v, causal=True, impl="flash")
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, k, v, impl="ring")


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda q, k, v: (q.transpose(2, 3), k, v), "4-d|contiguous|does not fit"),
        (lambda q, k, v: (q.half(), k.half(), v.half()), "float32 or bfloat16"),
        (lambda q, k, v: (q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()), "head_dim"),
        (lambda q, k, v: (q, k[:, :3].contiguous(), v[:, :3].contiguous()), "divide"),
        (lambda q, k, v: (q, k.bfloat16(), v), "is torch.bfloat16"),
    ],
    ids=["noncontig", "fp16", "hd32", "bad-gqa", "mixed-dtype"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, match):
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=4, s=64, d=64))
    with pytest.raises(ValueError, match=match):
        _check_kernel_inputs(*mutate(q, k, v))


@pytest.mark.parametrize(
    "dtype, block_rows",
    [(torch.bfloat16, 96), (torch.bfloat16, -1), (torch.float32, 64), (torch.float32, 128)],
    ids=["bf16-96", "bf16-neg", "f32-64", "f32-128"],
)
def test_forward_tile_choice_is_checked_before_any_build(monkeypatch, dtype, block_rows):
    """The bf16 kernel takes 64- or 128-row q tiles (0: its own pick); f32
    has one tile.  A bad choice raises before nvcc or the loader is reached."""

    def refuse(*_a, **_k):
        raise AssertionError("a refused tile choice must not build or load the kernel")

    monkeypatch.setattr(_build, "load", refuse)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(b=1, h=2, s=64, d=64))
    with pytest.raises(ValueError, match="block_rows"):
        _launch_kernel(q, k, v, True, 0.125, block_rows)


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    return csrc


def test_library_path_follows_the_included_header(tmp_path, monkeypatch):
    """Each source builds to a name keyed on its text and on the csrc/
    headers it includes, so editing hopper.cuh rebuilds both flash kernels
    and leaves the AdamW library, which does not include it, alone."""
    csrc = _copy_csrc(tmp_path, monkeypatch)
    sources = ("flash_fwd.cu", "flash_bwd.cu", "fused_adamw.cu")
    for source in sources[:2]:
        assert '#include "hopper.cuh"' in (csrc / source).read_text()
    assert "hopper.cuh" not in (csrc / "fused_adamw.cu").read_text()
    before = {s: _build.library_path(s) for s in sources}
    assert {s: _build.library_path(s) for s in sources} == before  # stable
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in sources}
    assert after["flash_fwd.cu"] != before["flash_fwd.cu"]
    assert after["flash_bwd.cu"] != before["flash_bwd.cu"]
    assert after["fused_adamw.cu"] == before["fused_adamw.cu"]
    for path in after.values():
        assert path.startswith(_build.BUILD_DIR)


def test_library_path_follows_the_source_and_the_flags(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build.library_path("flash_fwd.cu")
    source = csrc / "flash_fwd.cu"
    source.write_text(source.read_text() + "\n")
    edited = _build.library_path("flash_fwd.cu")
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("flash_fwd.cu") != edited


def test_load_binds_each_signature_once(monkeypatch):
    """ctypes argument types are set when a library is first loaded with
    its signatures, not on every launch."""

    class FakeFn:
        pass

    class FakeLib:
        def __init__(self):
            self.fn = FakeFn()
            self.sets = 0

        def __getattr__(self, name):
            if name != "dtt_probe":
                raise AttributeError(name)
            self.sets += 1
            return self.fn

    lib = FakeLib()
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_bound", set())
    monkeypatch.setattr(_build, "build", lambda source: f"/nonexistent/{source}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    sig = {"dtt_probe": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int)}
    assert _build.load("probe.cu") is lib  # loaded without signatures first
    assert lib.sets == 0
    for _ in range(3):
        assert _build.load("probe.cu", sig) is lib
    assert lib.sets == 1
    assert lib.fn.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert lib.fn.restype is ctypes.c_int


# C parameter types of the kernels' extern "C" functions, as ctypes binds them
_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


@pytest.mark.parametrize(
    "source, name, signatures",
    [
        ("flash_fwd.cu", "dtt_flash_fwd_rows", port_flash_mod._FWD_SIGNATURES),
        ("flash_bwd.cu", "dtt_flash_bwd_dq", port_flash_mod._BWD_SIGNATURES),
        ("flash_bwd.cu", "dtt_flash_bwd_dkv", port_flash_mod._BWD_SIGNATURES),
        ("fused_adamw.cu", "dtt_fused_adamw", fused_adamw._SIGNATURES),
    ],
    ids=["fwd_rows", "bwd_dq", "bwd_dkv", "fused_adamw"],
)
def test_ctypes_signatures_match_the_c_interface(source, name, signatures):
    """Each wrapper binds the argument types of the extern "C" function in
    its source, one for one: ctypes passes a missing or extra argument
    without a word, so a changed C interface must change its binding."""
    text = (pathlib.Path(_build.CSRC_DIR) / source).read_text()
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert match, f"{name} is not an extern \"C\" function of {source}"
    params = [re.sub(r"\bconst\b", "", p).strip().rsplit(None, 1)[0]
              for p in match.group(1).split(",")]
    argtypes, restype = signatures[name]
    assert [_C_TYPES[p] for p in params] == argtypes
    assert restype is ctypes.c_int
