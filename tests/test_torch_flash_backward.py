"""The port's flash attention backward (determined_tpu_torch/ops) and its
autograd Function against the JAX package's Pallas backward, run in
interpret mode on the CPU as tests/test_ops.py runs it.

On CPU tensors the port's wrappers compute their plain versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.ops.attention import _repeat_kv as jax_repeat_kv
from determined_tpu.ops.flash_attention import (
    DEFAULT_BLOCK,
    _flash_bwd_call,
    _flash_fwd_call,
    _pick_block,
)
from determined_tpu.ops.flash_attention import flash_attention as jax_flash
import determined_tpu_torch.ops.flash_attention as port_flash_mod
from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.flash_attention import (
    _FlashAttention,
    _check_bwd_inputs,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
)

# f32 against the Pallas backward: both sum the same f32 products in
# another order (XLA's CPU dot over blocks vs one torch matmul over the
# row), so the gradients agree to f32 reassociation over up to Sk terms
TOL = dict(atol=2e-5, rtol=2e-5)
# the port's Function against jax.grad of the JAX flash_attention: the JAX
# package holds its own flash gradients to 5e-4 against its reference
# (tests/test_ops.py:42-51); the port holds to the Pallas path at 2e-5
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _arrays(b=1, h=2, s=128, d=64, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (
        rng.standard_normal((b, h, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
        rng.standard_normal((b, h, s, d), dtype=np.float32),  # do
    )


def _jax_bwd(q, k, v, do, causal, block=None):
    """(out, lse) from the Pallas forward and (dq, dk, dv) from the Pallas
    backward, with dk/dv group-summed to the kv-head shape as autodiff sums
    them through _repeat_kv; blocks picked as the JAX wrapper picks them or
    forced smaller so the k and q loops run."""
    n_rep = q.shape[1] // k.shape[1]
    kr = jax_repeat_kv(jnp.asarray(k), n_rep)
    vr = jax_repeat_kv(jnp.asarray(v), n_rep)
    bq = block or _pick_block(q.shape[2], DEFAULT_BLOCK)
    bk = block or _pick_block(k.shape[2], DEFAULT_BLOCK)
    scale = q.shape[-1] ** -0.5
    qj = jnp.asarray(q)
    out, lse = _flash_fwd_call(qj, kr, vr, scale, causal, bq, bk)
    dq, dk, dv = _flash_bwd_call(qj, kr, vr, jnp.asarray(do), out, lse, scale, causal, bq, bk)
    b, hkv, s, d = k.shape

    def group_sum(x):
        return np.asarray(x).reshape(b, hkv, n_rep, s, d).sum(axis=2)

    return np.asarray(out), np.asarray(lse), np.asarray(dq), group_sum(dk), group_sum(dv)


CASES = {
    "causal_hd64": dict(shape=dict(), causal=True),
    "full_hd64": dict(shape=dict(), causal=False),
    "gqa_8_2": dict(shape=dict(h=8, hkv=2, s=64), causal=True),
    "causal_hd128": dict(shape=dict(d=128, s=64), causal=True),
    "full_gqa_hd128": dict(shape=dict(h=4, hkv=2, d=128, s=64), causal=False),
    "ragged96": dict(shape=dict(s=96), causal=True),
    "ragged200_full": dict(shape=dict(s=200, h=1), causal=False),
}


def _port_bwd(q, k, v, do, out, lse, causal):
    t = torch.from_numpy
    return flash_attention_bwd(
        t(q), t(k), t(v), t(np.array(out)), t(np.array(lse)), t(do),
        causal=causal,
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_bwd_matches_pallas_bwd_call(case):
    c = CASES[case]
    q, k, v, do = _arrays(**c["shape"])
    out, lse, *want = _jax_bwd(q, k, v, do, c["causal"])
    got = _port_bwd(q, k, v, do, out, lse, c["causal"])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize(
    "causal, shape, block",
    [(True, dict(s=128), 32), (False, dict(s=128, h=4, hkv=2), 32), (True, dict(s=200, h=1), 40)],
    ids=["causal_block32", "full_gqa_block32", "ragged200_block40"],
)
def test_port_bwd_matches_pallas_multi_block_sweeps(causal, shape, block):
    """Forced small blocks make the Pallas dq kernel loop over k blocks and
    the dkv kernel over q blocks, with the causal block skip."""
    q, k, v, do = _arrays(seed=3, **shape)
    out, lse, *want = _jax_bwd(q, k, v, do, causal, block=block)
    got = _port_bwd(q, k, v, do, out, lse, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_function_grads_match_jax_grad(causal, hkv):
    """d(sum(out * w))/d(q, k, v) through the port's Function against
    jax.grad through the JAX flash_attention's custom VJP."""
    q, k, v, w = _arrays(h=4, hkv=hkv, s=96, seed=5)

    def jax_loss(q, k, v):
        return (jax_flash(q, k, v, causal=causal) * jnp.asarray(w)).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for name, g, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), err_msg=name, **GRAD_TOL)


def test_flash_attention_is_differentiable_through_the_kernel_route(monkeypatch):
    """The kernel route fills its outputs through ctypes, so they carry no
    autograd node.  With the forward replaced by one that returns detached
    tensors, as the kernel does, the output is still the Function's node and
    gradients reach wq, wk and wv of every layer of a flash-attention LM."""
    real_fwd = port_flash_mod.flash_attention_fwd

    def kernel_like_fwd(*args, **kw):
        return tuple(t.detach() for t in real_fwd(*args, **kw))

    monkeypatch.setattr(port_flash_mod, "flash_attention_fwd", kernel_like_fwd)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _arrays(s=32))
    out = flash_attention(q, k, v)
    assert isinstance(out.grad_fn, _FlashAttention._backward_cls)

    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2, n_heads=2, max_seq_len=32,
                            dtype=torch.float32, attention_impl="flash")
    model = TransformerLM(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, size=(2, 32)))
    model(tokens).sum().backward()
    for i, blk in enumerate(model.blocks):
        for name in ("wq", "wk", "wv"):
            grad = getattr(blk.attn, name).weight.grad
            assert grad is not None, f"block {i} {name} got no gradient"
            assert grad.abs().sum() > 0, f"block {i} {name} got a zero gradient"


def test_cpu_backward_never_builds_or_counts(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = (port_flash_mod.launches, port_flash_mod.launches_bwd_dq,
              port_flash_mod.launches_bwd_dkv)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays(s=64)[:3])
    flash_attention(q, k, v, causal=True).sum().backward()
    after = (port_flash_mod.launches, port_flash_mod.launches_bwd_dq,
             port_flash_mod.launches_bwd_dkv)
    assert after == before


def test_reset_launches_clears_every_counter(monkeypatch):
    for name in ("launches", "launches_bwd_dq", "launches_bwd_dkv"):
        monkeypatch.setattr(port_flash_mod, name, 3)
    port_flash_mod.reset_launches()
    assert (port_flash_mod.launches, port_flash_mod.launches_bwd_dq,
            port_flash_mod.launches_bwd_dkv) == (0, 0, 0)


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: dict(a, lse=a["lse"][..., :-1].contiguous()), "lse"),
        (lambda a: dict(a, lse=a["lse"].double()), "lse"),
        (lambda a: dict(a, do=a["do"][:, :, :-1].contiguous()), "do must match"),
        (lambda a: dict(a, out=a["out"].transpose(2, 3).contiguous().transpose(2, 3)),
         "contiguous"),
    ],
    ids=["lse-shape", "lse-dtype", "do-shape", "out-noncontig"],
)
def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(mutate, match):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(s=64))
    out, lse = flash_attention_fwd(q, k, v)
    args = mutate(dict(q=q, k=k, v=v, out=out, lse=lse, do=do))
    with pytest.raises(ValueError, match=match):
        _check_bwd_inputs(args["q"], args["k"], args["v"], args["out"], args["lse"], args["do"])


# a ptxas -v report in the shape nvcc prints it: the bf16 dq kernel's two
# instances, one clean and one that spilled and had its wgmmas serialised,
# beside a forward kernel that spilled
_DQ = "_ZN12_GLOBAL__N_118flash_bwd_dq_wgmmaILi{}EEEv14CUtensorMap_stS1_"
_FWD = "_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64ELi1EEEv14CUtensorMap_stS1_"
_PTXAS_REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_DQ.format(64)}' for 'sm_90a'
ptxas info    : Function properties for {_DQ.format(64)}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '{_DQ.format(128)}' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions defining accumulator registers of a wgmma between start and end of the pipeline stage in the function '{_DQ.format(128)}'
ptxas info    : Function properties for {_DQ.format(128)}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '{_FWD}' for 'sm_90a'
ptxas info    : Function properties for {_FWD}
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 528 bytes cmem[0]
"""


def test_ptxas_faults_name_the_spilling_or_serialised_instance():
    """chip_smoke.py refuses a build whose dq kernel spilled or had its
    wgmmas serialised; the report's lines are attributed to the function
    they follow or name, so the forward's spill is not the dq kernel's."""
    faults = _build.ptxas_faults(_PTXAS_REPORT, "flash_bwd_dq_wgmma")
    assert len(faults) == 2
    assert "(C7515)" in faults[0] and _DQ.format(128) in faults[0]
    assert faults[1] == "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"
    assert _build.ptxas_faults(_PTXAS_REPORT, "flash_fwd_wgmma") == [
        "16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads"
    ]
    clean = _PTXAS_REPORT.split("ptxas info    : Compiling entry function '" + _DQ.format(128))[0]
    assert _build.ptxas_faults(clean, "flash_bwd_dq_wgmma") == []
