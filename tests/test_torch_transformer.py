"""The port's flagship LM (determined_tpu_torch/models/transformer.py) against
the JAX package's, from the same weights (converted with
determined_tpu_torch/convert.py) and the same inputs, on the CPU in f32.

Tolerance 1e-5 throughout: f32 reassociation between XLA's and PyTorch's
CPU kernels.  (The JAX package itself measured 1.55e-6 of such drift across
lane counts, which is why its own 1e-6 lane test fails on this tree.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from determined_tpu.models import transformer as jax_tf
from determined_tpu_torch.convert import (
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)
from determined_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
    transformer_decode,
    transformer_prefill,
    transformer_prefill_suffix,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 4


# the JAX serving functions jitted once per (cfg, static args): eager op-by-op
# dispatch would dominate these tests' time
_jax_prefill = jax.jit(jax_tf.transformer_prefill, static_argnums=0)
_jax_decode = jax.jit(jax_tf.transformer_decode, static_argnums=0, static_argnames="chunk_blocks")
_jax_suffix = jax.jit(jax_tf.transformer_prefill_suffix, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _pair(n_kv_heads=2, seed=0):
    """A tiny JAX LM and the port's copy of it (f32, CPU); shared, never
    mutated by the tests."""
    kw = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, n_kv_heads=n_kv_heads,
              max_seq_len=64, attention_impl="reference")
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **kw)
    jmodel = jax_tf.TransformerLM(jcfg)
    variables = flax_meta.unbox(
        jmodel.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    )
    model = TransformerLM(TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    load_flax_params(model, variables)
    return jcfg, jmodel, variables, model


def _prompt(n, seed=1, vocab=101):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, size=n)]


def _jax_cache(jcfg, num_blocks=16):
    return jax_tf.init_kv_cache(jcfg, num_blocks=num_blocks, block_size=BLOCK)


def _port_cache(model, num_blocks=16):
    return init_kv_cache(model.cfg, num_blocks, BLOCK, device="cpu")


def _assert_cache_close(port_cache, jax_cache):
    """Non-scratch cells (block 0 takes padded and empty-lane writes)."""
    for key in ("k", "v"):
        np.testing.assert_allclose(
            port_cache[key][:, 1:].numpy(), np.asarray(jax_cache[key])[:, 1:], **TOL
        )


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_convert_round_trip_is_exact():
    jcfg, _jm, variables, model = _pair()
    state = state_dict_from_flax(variables)
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name
        assert np.array_equal(tensor.numpy(), state[name]), name
    back = flax_from_state_dict(model.state_dict(), jcfg.n_heads, jcfg.kv_heads)
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), np.asarray(leaf)), path
    # the outer "params" key is optional, as DecodeKernels accepts either tree
    assert state_dict_from_flax(variables["params"]).keys() == state.keys()


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_forward_logits_match_flax(n_kv_heads):
    _jcfg, jmodel, variables, model = _pair(n_kv_heads)
    tokens = np.asarray([_prompt(13), _prompt(13, seed=2)])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = model(_t(tokens))
        hidden = model(_t(tokens), return_hidden=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_hidden = np.asarray(
        jmodel.apply(variables, jnp.asarray(tokens, jnp.int32), return_hidden=True)
    )
    np.testing.assert_allclose(hidden.numpy(), want_hidden, **TOL)


def test_prefill_matches_jax():
    jcfg, _jm, variables, model = _pair()
    prompt = _prompt(9)
    padded = np.zeros((1, 16), np.int64)
    padded[0, : len(prompt)] = prompt
    table = np.arange(1, 9)[None, :]
    jl, jc = _jax_prefill(
        jcfg, variables["params"], jnp.asarray(padded, jnp.int32),
        jnp.asarray([len(prompt)]), jnp.asarray(table, jnp.int32), _jax_cache(jcfg),
    )
    with torch.no_grad():
        pl_, pc = transformer_prefill(
            model, _t(padded), _t([len(prompt)]), _t(table), _port_cache(model)
        )
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(pc, jc)


@pytest.mark.parametrize("chunk_blocks", [0, 1, 2], ids=["full-gather", "chunk1", "chunk2"])
def test_decode_matches_jax(chunk_blocks):
    """Two lanes (one active at its own position, one empty at -1) stepped
    six times from the same prefilled cache."""
    jcfg, _jm, variables, model = _pair(seed=9)
    params = variables["params"]
    prompt = [11, 4, 93, 7, 55, 21, 8]
    padded = np.zeros((1, 8), np.int64)
    padded[0, : len(prompt)] = prompt
    tables = np.zeros((2, 8), np.int64)
    tables[0] = np.arange(1, 9)
    jl, jc = _jax_prefill(
        jcfg, params, jnp.asarray(padded, jnp.int32), jnp.asarray([len(prompt)]),
        jnp.asarray(tables[:1], jnp.int32), _jax_cache(jcfg),
    )
    with torch.no_grad():
        _pl, pc = transformer_prefill(
            model, _t(padded), _t([len(prompt)]), _t(tables[:1]), _port_cache(model)
        )
    tok = int(np.argmax(np.asarray(jl)[0, len(prompt) - 1]))
    for step in range(6):
        toks = np.asarray([tok, 0])
        poss = np.asarray([len(prompt) + step, -1])
        jl, jc = _jax_decode(
            jcfg, params, jnp.asarray(toks, jnp.int32), jnp.asarray(poss, jnp.int32),
            jnp.asarray(tables, jnp.int32), jc, chunk_blocks=chunk_blocks,
        )
        with torch.no_grad():
            pl_, pc = transformer_decode(
                model, _t(toks), _t(poss), _t(tables), pc, chunk_blocks=chunk_blocks
            )
        np.testing.assert_allclose(pl_[0].numpy(), np.asarray(jl)[0], **TOL)
        _assert_cache_close(pc, jc)
        tok = int(np.argmax(np.asarray(jl)[0]))


def test_decode_rejects_nondivisor_chunk():
    _jcfg, _jm, _v, model = _pair()
    with pytest.raises(ValueError, match="chunk_blocks"):
        transformer_decode(
            model, _t([1]), _t([0]), _t(np.arange(1, 9)[None, :]), _port_cache(model),
            chunk_blocks=3,
        )


@pytest.mark.parametrize("start", [0, 8], ids=["cold", "warm"])
def test_prefill_suffix_matches_jax(start):
    """Cold (start 0) and warm (the first two blocks already cached by a cold
    run) suffix prefill: logits at the last prompt token and the cache."""
    jcfg, _jm, variables, model = _pair(seed=11)
    params = variables["params"]
    prompt = list(range(30, 41))  # 11 tokens: 2 full blocks + partial tail
    padded = np.zeros((1, 12), np.int64)
    padded[0, : len(prompt)] = prompt
    table = np.arange(1, 9)[None, :]
    args_j = (jnp.asarray(padded, jnp.int32),)
    jc, pc = _jax_cache(jcfg), _port_cache(model)
    if start:
        _, jc = _jax_suffix(
            jcfg, params, *args_j, jnp.asarray([0]), jnp.asarray([len(prompt)]),
            jnp.asarray(table, jnp.int32), jc,
        )
        with torch.no_grad():
            _, pc = transformer_prefill_suffix(
                model, _t(padded), _t([0]), _t([len(prompt)]), _t(table), pc
            )
    jl, jc = _jax_suffix(
        jcfg, params, *args_j, jnp.asarray([start]), jnp.asarray([len(prompt)]),
        jnp.asarray(table, jnp.int32), jc,
    )
    with torch.no_grad():
        pl_, pc = transformer_prefill_suffix(
            model, _t(padded), _t([start]), _t([len(prompt)]), _t(table), pc
        )
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(pc, jc)


def test_prefill_suffix_rejects_unpadded_tokens():
    _jcfg, _jm, _v, model = _pair()
    with pytest.raises(ValueError, match="padded to the block size"):
        transformer_prefill_suffix(
            model, _t(np.zeros((1, 10))), _t([0]), _t([5]),
            _t(np.arange(1, 9)[None, :]), _port_cache(model),
        )


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_prefill_then_eight_decode_steps_match_full_forward(n_kv_heads):
    """Step-for-step: the port's paged serving path against the port's own
    full forward, greedy, eight decode steps after the prefill."""
    _jcfg, _jm, _v, model = _pair(n_kv_heads, seed=4)
    prompt = _prompt(9, seed=5)
    padded = np.zeros((1, 16), np.int64)
    padded[0, : len(prompt)] = prompt
    table = np.arange(1, 9)[None, :]
    with torch.no_grad():
        logits, cache = transformer_prefill(
            model, _t(padded), _t([len(prompt)]), _t(table), _port_cache(model)
        )
        full = model(_t([prompt]))
        np.testing.assert_allclose(logits[0, : len(prompt)].numpy(), full[0].numpy(), **TOL)
        seq = list(prompt)
        tok = int(logits[0, len(prompt) - 1].argmax())
        for _ in range(8):
            seq.append(tok)
            step, cache = transformer_decode(
                model, _t([tok]), _t([len(seq) - 1]), _t(table), cache, chunk_blocks=1
            )
            full = model(_t([seq]))[0, -1]
            np.testing.assert_allclose(step[0].numpy(), full.numpy(), **TOL)
            tok = int(step[0].argmax())


@pytest.mark.parametrize(
    "field, value",
    [
        ("attention_impl", "ring"),
        ("seq_axis_name", "seq"),
        ("expert_axis_name", "expert"),
    ],
)
def test_unported_configs_raise(field, value):
    if field == "attention_impl":
        # ring attention is ported: the config takes it, and without a
        # mesh the forward raises as the JAX Attention does
        model = TransformerLM(TransformerConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2,
                                                **{field: value}), device="cpu")
        with pytest.raises(ValueError, match="ring attention requires the mesh"):
            model(torch.zeros((1, 4), dtype=torch.long))
        return
    # the pipeline stage's axis names are ported: the config takes them, and
    # the KV-cache serving path refuses a stage's config as the JAX one does
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, **{field: value})
    model = TransformerLM(cfg, device="cpu")
    cache = init_kv_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="KV-cache serving runs outside pipeline stages"):
        transformer_prefill(model, torch.zeros((1, 4), dtype=torch.long), torch.tensor([4]),
                            torch.tensor([[1]]), cache)


def test_config_keeps_every_field_of_the_jax_config():
    import dataclasses

    jax_fields = {f.name for f in dataclasses.fields(jax_tf.TransformerConfig)}
    port_fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    assert jax_fields == port_fields


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 4, 2)
