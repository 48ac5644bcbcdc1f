"""The port's quantized matmuls (determined_tpu_torch/train/_quant.py) and the
quantized flagship against the JAX package's on the CPU.

- The quantized linear against ``_quant.make_dot_general`` for int8 and fp8
  (fp8 under ``DTPU_QUANT_EMULATE=1``), 2-D and with the multi-dim
  contraction of the attention output projection; its straight-through
  gradients against the JAX ones.
- The platform gate: fp8 refused on the CPU with the JAX message.
- The model: the training forward quantized in q, k, v, o, gate, up, down
  and the logits head, the fused cross-entropy head and the serving path not.
- ``LMTrial`` at int8 tracks the JAX int8 Trainer step for step and stays
  within the JAX test's 2% of the unquantized curve.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from determined_tpu import core as jax_core
from determined_tpu import train as jax_train
from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.config.experiment import (
    InvalidExperimentConfig as JaxInvalidExperimentConfig,
)
from determined_tpu.data import to_global
from determined_tpu.models import transformer as jax_tf
from determined_tpu.models.transformer import LMTrial as JaxLMTrial
from determined_tpu.parallel.mesh import MeshConfig
from determined_tpu.train import _quant as jax_quant
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig, InvalidExperimentConfig
from determined_tpu_torch.convert import load_flax_params
from determined_tpu_torch.data import to_device
from determined_tpu_torch.models import LMTrial
from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from determined_tpu_torch.serve import DecodeKernels, ServeConfig
from determined_tpu_torch.train import _quant
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
DN = (((1,), (0,)), ((), ()))
# the attention output projection: [b, s, h, hd] against [h, hd, d]
DN_MULTI = (((2, 3), (0, 1)), ((), ()))

# The port and the JAX package quantize the same f32 values with the same
# f32 scales, so the integer (or e4m3) operands agree; their products are
# exact integers in f32 at these widths (|acc| < 2^24), and the rescale runs
# in the same order.  What is left is the f32 reduction order of the
# unquantized reference's sums, which these shapes do not reach: f32
# rounding of the rescale only.
EXACT = dict(rtol=1e-6, atol=1e-6)
# straight-through gradients: both sides transpose the unquantized product,
# in f32 (summation order only)
GRAD = dict(rtol=1e-5, atol=1e-6)


def _operands(seed, x_shape, w_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.1).astype(np.float32)
    return x.astype(dtype), w.astype(dtype)


def _port_weight(w_jax):
    """A JAX kernel [in..., out] as an nn.Linear weight [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(w_jax.reshape(-1, w_jax.shape[-1]).T))


def _jax_dot(mode, x, w, dn):
    return np.asarray(jax_quant.make_dot_general(mode)(jnp.asarray(x), jnp.asarray(w), dn))


@pytest.fixture
def emulate_fp8(monkeypatch):
    monkeypatch.setenv("DTPU_QUANT_EMULATE", "1")


# ---------------------------------------------------------------------------
# the quantized linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_linear_matches_jax_dot_general(mode, emulate_fp8):
    x, w = _operands(0, (24, 64), (64, 40))
    want = _jax_dot(mode, x, w, DN)
    got = _quant.quant_linear(torch.from_numpy(x), _port_weight(w), F32, mode)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)
    # and both stay near the unquantized product, as the JAX tests hold
    # (int8: 2% of the largest output; e4m3's 3 mantissa bits: 10%)
    ref = x @ w
    bound = 0.02 if mode == "int8" else 0.1
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < bound


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_linear_multi_dim_contraction_matches_jax(mode, emulate_fp8):
    """wo's contraction over (heads, head_dim): per-row scales over both
    dims are the scales of the flattened row, which the port multiplies."""
    x, w = _operands(1, (2, 5, 4, 8), (4, 8, 16))
    want = _jax_dot(mode, x, w, DN_MULTI)
    got = _quant.quant_linear(torch.from_numpy(x).reshape(2, 5, 32), _port_weight(w), F32,
                              mode)
    assert tuple(got.shape) == want.shape == (2, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)


def test_quantized_linear_bf16_matches_jax():
    """bf16 operands (the compute dtype): the scales are taken over the bf16
    values, in f32, and the output is bf16 on both sides.  The two sides
    round the same f32 rescale to bf16; a value that lands within an f32
    ulp of a bf16 rounding boundary may round the other way: one bf16 ulp."""
    x, w = _operands(2, (32, 64), (64, 48))
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_quant.make_dot_general("int8")(xb, wb, DN).astype(jnp.float32))
    got = _quant.quant_linear(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        _port_weight(np.array(wb.astype(jnp.float32))), torch.bfloat16, "int8",
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_straight_through_grads_equal_jax(mode, emulate_fp8):
    x, w = _operands(3, (16, 32), (32, 24))
    g = np.random.default_rng(4).standard_normal((16, 24)).astype(np.float32)
    dg = jax_quant.make_dot_general(mode)
    f = lambda a, b: (dg(a, b, DN) * g).sum()  # noqa: E731
    want_x, want_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = _port_weight(w).requires_grad_()
    (_quant.quant_linear(tx, tw, F32, mode) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **GRAD)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(want_w), **GRAD)
    # the exact transpose of the UNquantized product
    np.testing.assert_allclose(tx.grad.numpy(), g @ w.T, **GRAD)


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0]])
    q, s = _quant.quantize(x, "int8")
    assert s.item() == pytest.approx(1.0)
    assert q.tolist() == [[127, 0, 2, -2, -127]]
    q8, s8 = _quant.quantize(torch.tensor([[448.0, -1.0, 0.0]]), "fp8")
    assert q8.dtype == torch.float8_e4m3fn and s8.item() == pytest.approx(1.0)
    assert q8.float().tolist() == [[448.0, -1.0, 0.0]]


def test_none_is_the_plain_linear():
    x, w = _operands(5, (4, 8), (8, 3))
    got = _quant.quant_linear(torch.from_numpy(x), _port_weight(w), F32, "none")
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the platform gate
# ---------------------------------------------------------------------------


def test_fp8_rejected_on_the_cpu_with_the_jax_message(monkeypatch):
    monkeypatch.delenv("DTPU_QUANT_EMULATE", raising=False)
    with pytest.raises(JaxInvalidExperimentConfig) as want:
        jax_quant.require_platform("fp8")
    with pytest.raises(InvalidExperimentConfig) as got:
        _quant.require_platform("fp8", "cpu")
    assert str(got.value) == str(want.value)
    assert "fp8 is not supported" in str(got.value)
    _quant.require_platform("int8", "cpu")  # int8 runs everywhere
    with pytest.raises(InvalidExperimentConfig, match="not in"):
        _quant.require_platform("int4", "cpu")
    # and through the trial: the experiment's knob, at setup
    exp = ExperimentConfig.parse({"optimizations": {"quantized_matmul": "fp8"}})
    ctx = train.init(hparams=dict(HP), exp_config=exp, device="cpu")
    with pytest.raises(InvalidExperimentConfig, match="fp8 is not supported"):
        LMTrial(ctx).build_model()


def test_fp8_emulation_escape_is_the_jax_one(emulate_fp8):
    assert _quant.fp8_supported("cpu") and jax_quant.fp8_supported()
    _quant.require_platform("fp8", "cpu")


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H200", "NVIDIA GH200 480GB", "NVIDIA A100-SXM4-80GB",
    "NVIDIA L4", "Tesla V100-SXM2-16GB",
])
def test_fp8_gpu_markers_match_jax(kind, monkeypatch):
    monkeypatch.delenv("DTPU_QUANT_EMULATE", raising=False)
    want = jax_quant.fp8_supported("gpu", kind)
    assert _quant.fp8_supported("cuda", kind) == want
    assert want == ("H100" in kind or "H200" in kind)


def test_unknown_mode_rejected_by_the_config():
    with pytest.raises(ValueError, match="quantized_matmul"):
        TransformerConfig(quantized_matmul="int4")


# ---------------------------------------------------------------------------
# the card's branch, under the contract of the card's calls
# ---------------------------------------------------------------------------


def _card_calls(monkeypatch):
    """Stand in for ``torch._int_mm`` and ``torch._scaled_mm`` with what
    their CUDA versions accept (``_scaled_mm``: row-major e4m3 times
    column-major e4m3, K and N multiples of 16, f32 scales that are either
    single (any of bf16, f16, f32 out) or row-wise (bf16 out only);
    ``_int_mm``: more than 16 rows, K and N multiples of 8), computing the
    product on the CPU.  Returns the out dtypes ``_scaled_mm`` was asked
    for."""
    out_dtypes = []

    def scaled_mm(a, b, *, scale_a, scale_b, out_dtype):
        assert a.dtype == b.dtype == torch.float8_e4m3fn
        assert a.is_contiguous() and b.t().is_contiguous()
        assert a.shape[1] % 16 == 0 and b.shape[1] % 16 == 0
        assert scale_a.dtype == scale_b.dtype == torch.float32
        if scale_a.numel() == scale_b.numel() == 1:
            assert out_dtype in (torch.bfloat16, torch.float16, torch.float32)
        else:
            assert scale_a.shape == (a.shape[0], 1) and scale_b.shape == (1, b.shape[1])
            assert out_dtype == torch.bfloat16, "row-wise scales need a bf16 output"
        out_dtypes.append(out_dtype)
        return (a.float() @ b.float() * scale_a * scale_b).to(out_dtype)

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8 and a.shape[0] > 16
        assert a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        return a.int() @ b.int()

    monkeypatch.setattr(torch, "_scaled_mm", scaled_mm)
    monkeypatch.setattr(torch, "_int_mm", int_mm)
    return out_dtypes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_tensor_core_branch_keeps_the_card_contract(mode, dtype, monkeypatch):
    """The card's branch at each compute dtype: the calls it makes are ones
    the card accepts (fp8 at f32 takes single unit scales and an f32
    output), and it computes the plain version's function.  The stand-ins
    multiply in the plain version's order, so they agree exactly (bf16
    rounding of the same f32 value at bf16)."""
    out_dtypes = _card_calls(monkeypatch)
    x, w = _operands(6, (32, 64), (48, 64))
    x, w = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    _quant.reset_launches()
    got = _quant._tensor_core_matmul(x, w, mode)
    assert got.dtype == dtype and _quant.launches[mode] == 1
    want = _quant.quantized_matmul_reference(x, w, mode)
    torch.testing.assert_close(got.float(), want.float(), **EXACT)
    if mode == "fp8":
        assert out_dtypes == [torch.bfloat16 if dtype == torch.bfloat16 else torch.float32]


def test_float32_fp8_trial_runs_the_tensor_core_branch(monkeypatch, emulate_fp8):
    """``bf16: false`` with ``quantized_matmul: fp8`` (which the JAX package
    runs at an f32 lhs) trains through the card's branch: every product
    keeps the card's contract and the losses are the plain version's."""
    _, init_params, _ = _jax_losses("int8")
    want, _ = _port_losses("fp8", init_params)
    out_dtypes = _card_calls(monkeypatch)
    monkeypatch.setattr(_quant, "quantized_matmul", _quant._tensor_core_matmul)
    _quant.reset_launches()
    got, _ = _port_losses("fp8", init_params)
    assert out_dtypes and set(out_dtypes) == {torch.float32}
    assert _quant.launches["fp8"] == len(out_dtypes)
    np.testing.assert_allclose(got, want, **EXACT)


# ---------------------------------------------------------------------------
# the model: what is quantized and what is not
# ---------------------------------------------------------------------------

KW = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64,
          attention_impl="reference")


@functools.lru_cache(maxsize=None)
def _jax_pair(mode):
    """A tiny JAX LM quantized with ``mode`` and its weights (f32)."""
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, quantized_matmul=mode, **KW)
    jmodel = jax_tf.TransformerLM(jcfg)
    variables = flax_meta.unbox(jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    return jmodel, variables


def _port_model(mode, variables, dtype=torch.float32):
    model = TransformerLM(
        TransformerConfig(dtype=dtype, quantized_matmul=mode, **KW), device="cpu"
    )
    load_flax_params(model, variables)
    return model


def _tokens(seed=1, shape=(2, 13)):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], size=shape)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_forward_matches_jax(mode, emulate_fp8):
    """The training forward with every projection and the logits head
    quantized, against the JAX model with the same weights.  The f32
    activations between the products are summed in another order on each
    side (1e-7 relative), which leaves the quantized operands equal unless
    a value sits that close to a rounding boundary of the quantizer, and
    none does at these inputs (a crossing would move a product by one
    quantum, 1/127 of its row's absmax): held within 1e-5 of the largest
    logit."""
    jmodel, variables = _jax_pair(mode)
    tokens = _tokens()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(tokens, jnp.int32)))
    model = _port_model(mode, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    # and the quantization is on: the unquantized model differs
    plain = _port_model("none", variables)
    with torch.no_grad():
        assert not np.array_equal(plain(torch.from_numpy(tokens)).numpy(), got)


def _count_quantized(monkeypatch):
    calls = []
    real = _quant.quantized_matmul_reference

    def counted(x2, w, mode, amax=None):
        calls.append(tuple(w.shape))
        return real(x2, w, mode, amax=amax)

    monkeypatch.setattr(_quant, "quantized_matmul_reference", counted)
    return calls


def test_training_forward_quantizes_seven_products_a_layer_and_the_head(monkeypatch):
    _, variables = _jax_pair("int8")
    model = _port_model("int8", variables)
    calls = _count_quantized(monkeypatch)
    tokens = torch.from_numpy(_tokens())
    with torch.no_grad():
        model(tokens)
    d = KW["d_model"]
    ff, kvd = 4 * d, KW["n_kv_heads"] * d // KW["n_heads"]
    layer = [(d, d), (kvd, d), (kvd, d), (d, d), (ff, d), (ff, d), (d, ff)]
    assert calls == layer * KW["n_layers"] + [(KW["vocab_size"], d)]
    # the fused cross-entropy path takes the hidden states: its head is the
    # fused kernel's own bf16 contraction, never quantized
    calls.clear()
    with torch.no_grad():
        model(tokens, return_hidden=True)
    assert calls == layer * KW["n_layers"]


def test_serving_logits_of_an_int8_model_equal_the_unquantized_ones(monkeypatch):
    """The KV-cache prefill and decode stay unquantized (the JAX serving
    functions use a plain ``@``): an int8-configured model serves exactly
    the logits of the same weights with ``none``."""
    _, variables = _jax_pair("int8")
    scfg = ServeConfig(block_size=4, num_blocks=16, max_batch=2, max_prompt_len=16,
                       max_new_tokens=4)
    calls = _count_quantized(monkeypatch)
    out = {}
    for mode in ("int8", "none"):
        kernels = DecodeKernels(_port_model(mode, variables), scfg, device="cpu")
        prompt = [int(t) for t in _tokens(seed=3, shape=(9,))]
        table = list(range(1, 1 + scfg.blocks_per_seq))
        logits = [kernels.prefill(prompt, table)]
        tokens = np.array([int(np.argmax(logits[0])), 0])
        positions = np.array([len(prompt), -1])
        tables = np.array([table, [0] * len(table)])
        logits.append(kernels.decode(tokens, positions, tables)[0])
        out[mode] = logits
    assert calls == []
    for a, b in zip(out["int8"], out["none"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the slice as a whole: LMTrial at int8 against the JAX Trainer
# ---------------------------------------------------------------------------

HP = dict(
    lr=1e-2, global_batch_size=4, seq_len=64, vocab_size=256, d_model=64, n_layers=2,
    n_heads=2, dataset_size=16, attention="flash", fused_ce=False, fused_adamw=True,
    warmup_steps=2, bf16=False,
)
STEPS = 4


@functools.lru_cache(maxsize=None)
def _jax_losses(mode):
    """STEPS JAX Trainer steps at ``quantized_matmul`` ``mode`` (the
    experiment's knob): per-step losses, the initial params, the batches."""
    exp = JaxExperimentConfig.parse({"optimizations": {"quantized_matmul": mode}})
    ctx = jax_train.init(
        hparams=dict(HP), exp_config=exp, mesh_config=MeshConfig(data=1),
        core_context=jax_core._dummy_init(), seed=0, devices=jax.devices()[:1],
    )
    trainer = jax_train.Trainer(JaxLMTrial(ctx))
    trainer._setup()
    init_params = jax.device_get(trainer.state.params)
    state = trainer.state
    it = iter(trainer.train_loader)
    losses, batches = [], []
    for _ in range(STEPS):
        batch = next(it)
        batches.append(batch)
        state = trainer._train_step(state, to_global(batch, trainer.mesh))
        losses.append(state.fetch_metrics()["loss"])
        state = state.reset_metrics()
    return losses, init_params, batches


def _port_losses(mode, init_params):
    exp = ExperimentConfig.parse({"optimizations": {"quantized_matmul": mode}})
    ctx = train.init(hparams=dict(HP), exp_config=exp, seed=0, device="cpu")
    trainer = train.Trainer(LMTrial(ctx))
    trainer._setup()
    assert trainer.model.cfg.quantized_matmul == mode
    load_flax_params(trainer.model, init_params)
    it = iter(trainer.train_loader)
    losses, batches = [], []
    for _ in range(STEPS):
        batch = next(it)
        batches.append(batch)
        trainer._train_step(to_device(batch, trainer.device))
        losses.append(trainer.state.fetch_metrics()["loss"])
        trainer.state.reset_metrics()
    return losses, batches


def test_lm_trial_int8_tracks_the_jax_int8_trainer():
    """Step for step from the same weights and batches.  f32 compute; the
    quantized operands agree but for values the two frameworks' f32 sums
    put on either side of a rounding boundary (see the forward test), and
    Adam's sign-like first steps carry such a difference on: losses within
    1e-3 relative over 4 steps."""
    want, init_params, want_batches = _jax_losses("int8")
    got, got_batches = _port_losses("int8", init_params)
    for a, b in zip(got_batches, want_batches):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_lm_trial_int8_stays_within_two_percent_of_unquantized():
    """The JAX test's bound (tests/test_step_optimizations.py): the int8
    loss curve within 2% of the unquantized one, here on the port."""
    _, init_params, _ = _jax_losses("int8")
    ref, _ = _port_losses("none", init_params)
    got, _ = _port_losses("int8", init_params)
    rel = max(abs(a - b) / max(abs(b), 1e-9) for a, b in zip(got, ref))
    assert rel < 0.02, rel
    assert got != ref  # the quantized path ran


def test_quant_hparam_wins_over_the_experiment_knob():
    exp = ExperimentConfig.parse({"optimizations": {"quantized_matmul": "int8"}})
    ctx = train.init(hparams=dict(HP, quantized_matmul="none"), exp_config=exp, device="cpu")
    assert LMTrial(ctx)._cfg().quantized_matmul == "none"
    ctx = train.init(hparams=dict(HP), exp_config=exp, device="cpu")
    assert LMTrial(ctx)._cfg().quantized_matmul == "int8"
    ctx = train.init(hparams=dict(HP), device="cpu")
    assert LMTrial(ctx)._cfg().quantized_matmul == "none"


def test_quant_module_needs_no_gpu_to_import():
    """Nothing of the card is touched at import: a CUDA-less interpreter
    imports the module and quantizes on the CPU."""
    probe = (
        "import torch; torch.cuda.is_available = lambda: False\n"
        "from determined_tpu_torch.train import _quant\n"
        "x = torch.randn(20, 16)\n"
        "out = _quant.quant_linear(x, torch.randn(8, 16), torch.float32, 'int8')\n"
        "print(out.shape, _quant.launches)\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "torch.Size([20, 8]) {'int8': 0, 'fp8': 0}" in proc.stdout
