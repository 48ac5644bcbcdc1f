"""The port's serving tier (determined_tpu_torch/serve) on the CPU: the
copied allocator and scheduler against the JAX package's, the engine's
greedy output against the port's full forward and the JAX engine's tokens
from the same weights, prefix caching, admission codes and HTTP."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

import determined_tpu.serve as jax_serve
import determined_tpu.serve.scheduler as jax_scheduler
import determined_tpu_torch.serve as port_serve
import determined_tpu_torch.serve.scheduler as port_scheduler
from determined_tpu.models import transformer as jax_tf
from determined_tpu_torch.convert import load_flax_params
from determined_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from determined_tpu_torch.observability import get_tracer
from determined_tpu_torch.utils import faults
from tests import torch_threads  # noqa: F401  (one intra-op thread)

# ---------------------------------------------------------------------------
# the copied allocator and scheduler behave as the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(params=["jax", "port"])
def ns(request):
    serve, sched = (jax_serve, jax_scheduler) if request.param == "jax" else (
        port_serve, port_scheduler
    )
    return dict(
        BlockAllocator=serve.BlockAllocator, CacheOOM=serve.CacheOOM,
        prefix_block_hashes=serve.prefix_block_hashes, LaneTable=serve.LaneTable,
        AdmissionQueue=serve.AdmissionQueue, AdmissionRejected=serve.AdmissionRejected,
        ActiveSeq=sched.ActiveSeq, GenRequest=sched.GenRequest,
    )


def test_allocator_alloc_free_roundtrip(ns):
    a = ns["BlockAllocator"](num_blocks=9, block_size=4)
    assert a.capacity == 8
    got = a.alloc(5)
    assert len(set(got)) == 5 and 0 not in got
    assert a.used_blocks == 5 and a.free_blocks == 3
    a.free(got)
    assert a.used_blocks == 0 and a.free_blocks == 8


def test_allocator_oom_is_all_or_nothing(ns):
    a = ns["BlockAllocator"](num_blocks=5, block_size=4)
    a.alloc(3)
    with pytest.raises(ns["CacheOOM"]):
        a.alloc(2)
    assert a.free_blocks == 1


def test_allocator_double_free_raises_and_reuse_is_lifo(ns):
    a = ns["BlockAllocator"](num_blocks=16, block_size=2)
    got = a.alloc(4)
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got)
    assert set(a.alloc(4)) == set(got)
    with pytest.raises(ValueError):
        a.free([0])


def test_allocator_no_fragmentation_under_interleaving(ns):
    a = ns["BlockAllocator"](num_blocks=17, block_size=4)
    rng = np.random.default_rng(0)
    live = []
    for _ in range(200):
        if live and (len(live) >= 4 or rng.random() < 0.4):
            a.free(live.pop(rng.integers(len(live))))
        else:
            n = int(rng.integers(1, 5))
            if a.free_blocks >= n:
                blocks = a.alloc(n)
                assert not set(blocks) & {b for g in live for b in g}
                live.append(blocks)
    for g in live:
        a.free(g)
    assert a.free_blocks == 16


def test_prefix_match_shares_and_parks_on_free(ns):
    a = ns["BlockAllocator"](num_blocks=17, block_size=4, prefix_cache=True)
    chain = ns["prefix_block_hashes"](list(range(12)), 4)
    blocks = a.alloc(3)
    a.register_prefix(chain, blocks)
    shared = a.match_prefix(chain)
    assert shared == blocks and all(a.refcount(b) == 2 for b in blocks)
    a.free(shared)
    a.free(blocks)
    assert a.used_blocks == 0 and a.cached_blocks == 3
    again = a.match_prefix(chain)
    assert again == blocks
    a.free(again)
    st = a.stats()
    assert st["prefix_hits"] == 2 and st["prefix_tokens_saved"] == 24


def test_prefix_chain_is_a_trie_and_caps_the_tail(ns):
    h = ns["prefix_block_hashes"]
    a = ns["BlockAllocator"](num_blocks=9, block_size=2, prefix_cache=True)
    blocks = a.alloc(2)
    a.register_prefix(h([1, 2, 3, 4], 2), blocks)
    assert a.match_prefix(h([9, 9, 3, 4], 2)) == []
    assert a.match_prefix(h([1, 2], 2)) == blocks[:1]
    assert len(h(list(range(8)), 4, limit_tokens=7)) == 1
    assert h([1], 4, limit_tokens=0) == []


def test_prefix_eviction_is_lru_and_never_touches_live_refs(ns):
    h = ns["prefix_block_hashes"]
    a = ns["BlockAllocator"](num_blocks=5, block_size=2, prefix_cache=True)
    c1, c2 = h([1, 2], 2), h([3, 4], 2)
    b1 = a.alloc(1)
    a.register_prefix(c1, b1)
    b2 = a.alloc(1)
    a.register_prefix(c2, b2)
    live = a.alloc(2)
    a.free(b1)
    a.free(b2)
    assert set(a.alloc(2)) == {b1[0], b2[0]}
    assert all(a.refcount(b) == 1 for b in live)
    assert a.stats()["evictions"] == 2


def test_lane_table_join_retire(ns):
    lanes = ns["LaneTable"](2)
    seq = lambda: ns["ActiveSeq"](  # noqa: E731
        request=ns["GenRequest"](prompt=[1], max_new_tokens=1),
        blocks=[1], block_table=[1, 0], pos=1, next_token=0,
    )
    assert {lanes.join(seq()), lanes.join(seq())} == {0, 1}
    with pytest.raises(RuntimeError):
        lanes.join(seq())
    lanes.retire(0)
    with pytest.raises(RuntimeError):
        lanes.retire(0)
    assert lanes.stats() == {"lanes": 2, "active": 1, "joined": 2, "retired": 1}


def test_admission_queue_429_503_and_head_requeue(ns):
    q = ns["AdmissionQueue"](2)
    reqs = [ns["GenRequest"](prompt=[i], max_new_tokens=1) for i in range(3)]
    q.submit(reqs[0])
    q.submit(reqs[1])
    with pytest.raises(ns["AdmissionRejected"]) as exc:
        q.submit(reqs[2])
    assert exc.value.status == 429
    head = q.get()
    q.requeue_head(head)
    assert q.get() is head and q.depth() == 1
    q.start_drain()
    with pytest.raises(ns["AdmissionRejected"]) as exc:
        q.submit(reqs[2])
    assert exc.value.status == 503


# ---------------------------------------------------------------------------
# the engine: one tiny LM, converted from the JAX package's weights
# ---------------------------------------------------------------------------

SERVE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_prompt_len=16,
                max_new_tokens=32, queue_depth=4)
MODEL_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, attention_impl="reference", **MODEL_KW)
    variables = flax_meta.unbox(
        jax_tf.TransformerLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    )
    model = TransformerLM(TransformerConfig(dtype=torch.float32, **MODEL_KW), device="cpu")
    load_flax_params(model, variables)
    return jcfg, variables, model


@pytest.fixture(scope="module")
def kernels(lm):
    return port_serve.DecodeKernels(lm[2], port_serve.ServeConfig(**SERVE_KW), device="cpu")


def _run(eng, requests, max_steps=200):
    """Drive a not-started engine step by step until every request is done."""
    for _ in range(max_steps):
        if all(r.done.is_set() for r in requests):
            return
        assert eng.step_once(), "scheduler stalled"
    raise AssertionError("requests did not finish")


def test_greedy_matches_full_forward_and_jax_engine(lm, kernels):
    jcfg, variables, model = lm
    prompts = [[3, 14, 15, 9, 2, 6], list(range(20, 33)), [7]]
    eng = port_serve.ServeEngine(kernels)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    _run(eng, reqs)
    jeng = jax_serve.ServeEngine(
        jax_serve.DecodeKernels(jcfg, variables, jax_serve.ServeConfig(**SERVE_KW))
    )
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    _run(jeng, jreqs)
    for prompt, req, jreq in zip(prompts, reqs, jreqs):
        assert req.error is None and len(req.output) == 6
        assert req.output == jreq.output
        seq = list(prompt)
        for tok in req.output:
            with torch.no_grad():
                logits = model(torch.tensor([seq]))
            assert tok == int(logits[0, -1].argmax())
            seq.append(tok)
    assert eng.allocator.used_blocks == 0


def test_prefix_cached_generation_matches_cold(kernels):
    prompt = list(range(3, 12))  # 9 tokens: the chain covers 2 full blocks
    eng = port_serve.ServeEngine(kernels)
    cold = eng.submit(prompt, max_new_tokens=4, temperature=0.7, seed=42)
    eng.step_once()
    warm = eng.submit(prompt, max_new_tokens=4, temperature=0.7, seed=42)
    _run(eng, [cold, warm])
    assert cold.error is None and warm.error is None
    assert cold.output == warm.output and len(cold.output) == 4
    st = eng.stats()
    assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] == 8


def test_static_batch_engine_matches_continuous(kernels):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    eng = port_serve.ServeEngine(kernels)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    _run(eng, reqs)
    static = port_serve.StaticBatchEngine(kernels).start()
    try:
        sreqs = [static.generate(p, max_new_tokens=5, timeout=60) for p in prompts]
    finally:
        static.stop()
    assert [r.output for r in sreqs] == [r.output for r in reqs]


@pytest.mark.parametrize(
    "prompt, kw, status",
    [
        ([], {}, 400),
        ([1, 2], {"max_new_tokens": 0}, 400),
        (list(range(17)), {"max_new_tokens": 1}, 413),
    ],
    ids=["empty-prompt", "zero-new-tokens", "prompt-too-long"],
)
def test_admission_rejects(kernels, prompt, kw, status):
    eng = port_serve.ServeEngine(kernels)
    with pytest.raises(port_serve.AdmissionRejected) as exc:
        eng.submit(prompt, **kw)
    assert exc.value.status == status


def test_backpressure_429_when_queue_saturated(kernels):
    eng = port_serve.ServeEngine(kernels)  # never started: nothing drains
    for _ in range(SERVE_KW["queue_depth"]):
        eng.submit([1, 2], max_new_tokens=1)
    with pytest.raises(port_serve.AdmissionRejected) as exc:
        eng.submit([1, 2], max_new_tokens=1)
    assert exc.value.status == 429
    assert eng.stats()["rejected"] == 1


def test_engine_spans_reach_the_tracer(kernels):
    tracer = get_tracer()
    tracer.reset()
    eng = port_serve.ServeEngine(kernels)
    _run(eng, [eng.submit([5, 6, 7], max_new_tokens=3)])
    spans = [e for e in tracer.chrome_events() if e["ph"] == "X"]
    assert {"serve.admit", "serve.kv_alloc", "serve.prefill", "serve.decode"} <= {
        e["name"] for e in spans
    }
    assert all(e["cat"] == "serve" for e in spans)
    gauges = {e["name"] for e in tracer.chrome_events() if e.get("cat") == "gauge"}
    assert {"serve.kv_utilization", "serve.queue_depth"} <= gauges
    assert "serve.kv_utilization" in tracer.counters()


def _http(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Raise:
    def fire(self, site, **info):
        if site == "serve.generate":
            raise RuntimeError("injected")


def test_http_generate_healthz_stats_round_trip(kernels, lm):
    model = lm[2]
    worker = port_serve.ServeWorker(port_serve.ServeEngine(kernels), host="127.0.0.1", port=0)
    url = worker.start()
    try:
        prompt = [3, 14, 15]
        status, body = _http(url, "/v1/generate", {"prompt_tokens": prompt, "max_new_tokens": 4})
        assert status == 200 and len(body["tokens"]) == 4
        assert body["usage"] == {"prompt_tokens": 3, "completion_tokens": 4}
        with torch.no_grad():
            first = int(model(torch.tensor([prompt]))[0, -1].argmax())
        assert body["tokens"][0] == first
        assert _http(url, "/healthz") == (200, {"status": "ok"})
        status, stats = _http(url, "/stats")
        assert status == 200 and stats["completed"] == 1 and stats["tokens_generated"] == 4
        assert _http(url, "/nope")[0] == 404
        assert _http(url, "/v1/generate", {"prompt_tokens": "abc"})[0] == 400
        assert _http(url, "/v1/generate", {"prompt_tokens": [1], "temperature": "hot"})[0] == 400
        faults.set_fault_injector(_Raise())
        try:
            assert _http(url, "/v1/generate", {"prompt_tokens": [1]})[0] == 500
        finally:
            faults.set_fault_injector(None)
        assert worker.stats()["http_5xx"] == 1
        worker.request_drain()
        assert _http(url, "/healthz")[0] == 503
        assert _http(url, "/v1/generate", {"prompt_tokens": [1]})[0] == 503
        assert worker.wait_drained(timeout=30)
    finally:
        worker.shutdown()
    assert not any(t.name == "dtpu-serve-engine" and t.is_alive() for t in threading.enumerate())
