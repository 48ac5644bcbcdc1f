"""The port's fused AdamW (determined_tpu_torch/ops/fused_adamw.py), its
non-fused optax-chain twin and its learning-rate schedule against the JAX
package and optax, on the CPU.

The JAX side runs its Pallas sweep in interpret mode on the large leaf
(``DTPU_FUSED_MIN_SIZE`` set low, the JAX package's own knob) as
tests/test_ops.py runs it; the port's wrapper takes its plain version on CPU
tensors.  The CUDA kernel is held against that plain version on the card by
chip_smoke.py.  Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
import determined_tpu_torch.ops.fused_adamw as port_adamw_mod
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.fused_adamw import (
    _check_leaf,
    adamw_leaf_,
    fused_adamw,
    global_norm,
)
from determined_tpu_torch.train._optim import ClipAdamW, warmup_cosine_decay_schedule
from tests import torch_threads  # noqa: F401  (one intra-op thread)

# the JAX package's bound for its fused sweep against optax
# (tests/test_ops.py:222-260): f32 rounding of the same operations
TOL = dict(rtol=2e-6, atol=2e-7)
# a bf16 first moment: one bf16 ulp, where an f32 value a last bit apart
# rounds the other way; a flip of a large moment (|m| <~ 1e-3 here, ulp
# ~4e-6) is carried into an element that later cancels towards zero
TOL_BF16 = dict(rtol=2 ** -7, atol=4e-6)
# p beside a bf16 first moment: where m rounds one bf16 ulp apart, p moves
# by lr * 2^-8 of the normalised update (lr <= 1e-2 here), so a few weights
# differ by up to ~4e-5 after it
TOL_P_BF16 = dict(rtol=2e-6, atol=1e-4)
# the schedule: optax's cos and the linear ramp in f32 against torch's, a
# few f32 ulps
SCHED_TOL = dict(rtol=1e-6, atol=1e-12)

SHAPES = {"w": (256, 1024), "b": (64,)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng, step):
    # step 0 large enough that the global-norm clip is active
    return {
        k: (rng.standard_normal(s) * (10.0 if step == 0 else 0.1)).astype(np.float32)
        for k, s in SHAPES.items()
    }


def _assert_tree(port, want, tol, what):
    for k in SHAPES:
        np.testing.assert_allclose(
            port[k].float().numpy(), np.asarray(want[k], np.float32), err_msg=f"{what} {k}", **tol
        )


@pytest.mark.parametrize("mu", ["f32", "bf16"])
def test_fused_adamw_matches_jax_fused_adamw(monkeypatch, mu):
    monkeypatch.setenv("DTPU_FUSED_MIN_SIZE", "4096")  # the w leaf takes the Pallas sweep
    jax_mu = jnp.bfloat16 if mu == "bf16" else None
    port_mu = torch.bfloat16 if mu == "bf16" else None
    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100)
    jopt = jax_fused_adamw(jsched, weight_decay=0.01, clip_norm=1.0, mu_dtype=jax_mu)
    popt = fused_adamw(warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100), weight_decay=0.01,
                       clip_norm=1.0, mu_dtype=port_mu)
    host = _params()
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    assert ps.mu["w"].dtype == (port_mu or torch.float32)
    rng = np.random.default_rng(1)
    step = jax.jit(jopt.apply_step)
    for i in range(3):
        g = _grads(rng, i)
        jp, js = step({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        _, ps = popt.apply_step({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        _assert_tree(pp, jp, TOL_P_BF16 if mu == "bf16" else TOL, f"step {i} p")
        _assert_tree(ps.mu, js.mu, TOL_BF16 if mu == "bf16" else TOL, f"step {i} m")
        _assert_tree(ps.nu, js.nu, TOL, f"step {i} v")
    assert int(ps.count) == int(js.count) == 3


@pytest.mark.parametrize("mu", ["f32", "bf16"])
def test_clip_adamw_matches_optax_chain(mu):
    """The non-fused path (a trial's ``fused_adamw: false``) is optax's
    chain(clip_by_global_norm, adamw) step for step."""
    jax_mu = jnp.bfloat16 if mu == "bf16" else None
    port_mu = torch.bfloat16 if mu == "bf16" else None
    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(jsched, weight_decay=0.01, mu_dtype=jax_mu))
    popt = ClipAdamW(warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100), clip_norm=1.0,
                     weight_decay=0.01, mu_dtype=port_mu)
    host = _params(2)
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    rng = np.random.default_rng(3)
    for i in range(3):
        g = _grads(rng, i)
        updates, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        _, ps = popt.apply_step({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        adam = js[1][0]
        _assert_tree(pp, jp, TOL_P_BF16 if mu == "bf16" else TOL, f"step {i} p")
        _assert_tree(ps.mu, adam.mu, TOL_BF16 if mu == "bf16" else TOL, f"step {i} m")
        _assert_tree(ps.nu, adam.nu, TOL, f"step {i} v")


@pytest.mark.parametrize(
    "args",
    [(0.0, 3e-4, 10, 100), (0.0, 1e-2, 2, 100), (1e-5, 1e-3, 0, 50), (0.0, 3e-4, 10, 100, 1e-5)],
    ids=["bench", "test_ops", "no_warmup", "end_value"],
)
def test_schedule_matches_optax_at_every_count(args):
    want_fn = optax.warmup_cosine_decay_schedule(*args)
    got_fn = warmup_cosine_decay_schedule(*args)
    counts = range(args[3] + 6)
    want = np.array([float(want_fn(jnp.asarray(c, jnp.int32))) for c in counts])
    got = torch.stack([got_fn(torch.tensor(c, dtype=torch.int32)) for c in counts])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SCHED_TOL)


def test_global_norm_matches_optax():
    host = _params(4)
    want = float(optax.global_norm({k: jnp.asarray(v) for k, v in host.items()}))
    got = float(global_norm({k: torch.from_numpy(v) for k, v in host.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_scalars_follow_the_jax_optimizer():
    """[lr at count, clip scale, 1 - b1^t, 1 - b2^t] at t = count + 1."""
    sched = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100)
    opt = fused_adamw(sched, clip_norm=1.0)
    grads = {"g": torch.full((4,), 2.0)}  # norm 4: scale 0.25
    got = opt.scalars(torch.tensor(1, dtype=torch.int32), grads)
    f32 = np.float32
    np.testing.assert_allclose(
        got.numpy(),
        [float(sched(torch.tensor(1))), 0.25, 1 - f32(0.9) ** f32(2), 1 - f32(0.999) ** f32(2)],
        rtol=1e-6,
    )
    no_clip = fused_adamw(1e-3, clip_norm=None).scalars(torch.tensor(0, dtype=torch.int32), grads)
    np.testing.assert_allclose(
        no_clip.numpy(), [1e-3, 1.0, 1 - f32(0.9), 1 - f32(0.999)], rtol=1e-6
    )


def test_cpu_step_never_builds_or_counts(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = port_adamw_mod.launches
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt = fused_adamw(1e-3)
    opt.apply_step({k: torch.ones_like(v) for k, v in p.items()}, opt.init(p), p)
    assert port_adamw_mod.launches == before


def test_leaf_step_is_in_place():
    p, m, v, g = (torch.randn(8, 4) for _ in range(4))
    v = v.abs()
    ids = [t.data_ptr() for t in (p, m, v)]
    p0 = p.clone()
    adamw_leaf_(p, m, v, g, torch.tensor([1e-2, 1.0, 0.1, 1e-3]), b1=0.9, b2=0.999, eps=1e-8,
                wd=0.01)
    assert [t.data_ptr() for t in (p, m, v)] == ids
    assert not torch.equal(p, p0)


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: dict(a, p=a["p"].double()), "f32 p"),
        (lambda a: dict(a, m=a["m"].half()), "float32 or bfloat16"),
        (lambda a: dict(a, g=a["g"][:2]), "does not match"),
        (lambda a: dict(a, v=a["v"].t()), "does not match|contiguous"),
        (lambda a: dict(a, scalars=a["scalars"][:3]), "scalars"),
    ],
    ids=["f64-p", "f16-m", "g-shape", "v-noncontig", "scalars"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, match):
    args = dict(p=torch.zeros(4, 4), m=torch.zeros(4, 4), v=torch.zeros(4, 4),
                g=torch.zeros(4, 4), scalars=torch.zeros(4))
    args = mutate(args)
    with pytest.raises(ValueError, match=match):
        _check_leaf(args["p"], args["m"], args["v"], args["g"], args["scalars"])
