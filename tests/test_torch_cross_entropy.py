"""The port's fused cross-entropy (determined_tpu_torch/ops/cross_entropy.py)
against the JAX package's ``fused_cross_entropy`` and ``naive_cross_entropy``
on the CPU: the loss and both gradients, with ignored targets, in the
single-tile, chunked (padded) and bf16-residual modes.  Inputs are made with
numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.ops.cross_entropy import fused_cross_entropy as jax_fused_ce
from determined_tpu.ops.cross_entropy import naive_cross_entropy as jax_naive_ce
import determined_tpu_torch.ops.cross_entropy as port_ce_mod
from determined_tpu_torch.ops.cross_entropy import fused_cross_entropy, naive_cross_entropy
from tests import torch_threads  # noqa: F401  (one intra-op thread)

# f32 compute: the same f32 products and logsumexp summed in another order
TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 compute: both round the bf16 product's inputs the same way, but the
# port takes the product's result in bf16 before f32 (torch.matmul in the
# compute dtype) where XLA keeps its f32 accumulator, so logits differ by
# up to a bf16 ulp (2^-8 relative) and the loss and gradients by ~1e-3
TOL_BF16 = dict(rtol=2e-2, atol=2e-3)

B, S, D, V = 2, 12, 32, 96


def _inputs(seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, D), dtype=np.float32)
    kernel = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    targets = rng.integers(0, V, size=(B, S)).astype(np.int32)
    if ignore:
        targets[0, :3] = -1
        targets[1, -2:] = -1
    return hidden, kernel, targets


def _jax(fn, hidden, kernel, targets):
    loss, (dh, dk) = jax.value_and_grad(
        lambda h, k: fn(h, k, jnp.asarray(targets)), argnums=(0, 1)
    )(jnp.asarray(hidden), jnp.asarray(kernel))
    return float(loss), np.asarray(dh), np.asarray(dk)


def _port(fn, hidden, kernel, targets):
    h = torch.from_numpy(hidden).requires_grad_()
    k = torch.from_numpy(kernel).requires_grad_()
    loss = fn(h, k, torch.from_numpy(targets))
    loss.backward()
    return float(loss.detach()), h.grad.numpy(), k.grad.numpy()


def _compare(got, want, tol):
    np.testing.assert_allclose(got[0], want[0], err_msg="loss", **tol)
    np.testing.assert_allclose(got[1], want[1], err_msg="d hidden", **tol)
    np.testing.assert_allclose(got[2], want[2], err_msg="d kernel", **tol)


MODES = {
    # name: (chunk_size, compute dtype, bf16_residual)
    "single_tile_f32": (0, "float32", False),
    "chunked_padded_f32": (7, "float32", False),   # 24 tokens: 4 chunks, 4 padded
    "chunked_exact_f32": (8, "float32", False),
    "single_tile_bf16": (0, "bfloat16", False),
    "chunked_padded_bf16": (5, "bfloat16", False),
    "bf16_residual": (0, "bfloat16", True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_ce_matches_jax(mode):
    chunk, dtype, residual = MODES[mode]
    hidden, kernel, targets = _inputs()
    want = _jax(
        lambda h, k, t: jax_fused_ce(h, k, t, chunk_size=chunk,
                                     compute_dtype=getattr(jnp, dtype), bf16_residual=residual),
        hidden, kernel, targets,
    )
    got = _port(
        lambda h, k, t: fused_cross_entropy(h, k, t, chunk_size=chunk,
                                            compute_dtype=getattr(torch, dtype),
                                            bf16_residual=residual),
        hidden, kernel, targets,
    )
    _compare(got, want, TOL if dtype == "float32" else TOL_BF16)


@pytest.mark.parametrize("ignore", [True, False], ids=["ignored_targets", "all_valid"])
def test_naive_ce_matches_jax(ignore):
    hidden, kernel, targets = _inputs(seed=1, ignore=ignore)
    want = _jax(jax_naive_ce, hidden, kernel, targets)
    got = _port(naive_cross_entropy, hidden, kernel, targets)
    _compare(got, want, TOL)


def test_fused_ce_f32_matches_naive():
    hidden, kernel, targets = _inputs(seed=2)
    want = _port(naive_cross_entropy, hidden, kernel, targets)
    for chunk in (0, 5, 64):
        got = _port(
            lambda h, k, t: fused_cross_entropy(h, k, t, chunk_size=chunk,
                                                compute_dtype=torch.float32),
            hidden, kernel, targets,
        )
        _compare(got, want, TOL)


def test_auto_chunk_picks_by_the_residual_size(monkeypatch):
    """chunk_size=None keeps the single tile while its f32 residual fits the
    limit and chunks past it; both give the same loss."""
    hidden, kernel, targets = _inputs(seed=3)
    calls = []
    real = port_ce_mod.checkpoint

    def counting_checkpoint(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_ce_mod, "checkpoint", counting_checkpoint)
    f32 = dict(compute_dtype=torch.float32)
    single = _port(lambda h, k, t: fused_cross_entropy(h, k, t, **f32), hidden, kernel, targets)
    assert not calls
    monkeypatch.setattr(port_ce_mod, "SINGLE_TILE_MAX_BYTES", B * S * V * 4 - 1)
    monkeypatch.setattr(port_ce_mod, "AUTO_CHUNK", 10)
    chunked = _port(lambda h, k, t: fused_cross_entropy(h, k, t, **f32), hidden, kernel, targets)
    assert len(calls) == 3  # 24 tokens in chunks of 10
    _compare(chunked, single, TOL)


def test_all_targets_ignored_gives_zero_loss():
    hidden, kernel, targets = _inputs(seed=4)
    targets[:] = -1
    loss = fused_cross_entropy(torch.from_numpy(hidden), torch.from_numpy(kernel),
                               torch.from_numpy(targets), compute_dtype=torch.float32)
    assert float(loss) == 0.0
