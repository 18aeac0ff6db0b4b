"""The port's continuous-batching engine (bigdl_tpu_torch/serving/engine.py)
against the JAX package's InferenceEngine, on the CPU, at a tiny size
(vocab 61, dim 32, 2 heads, 2 layers, max_len 32, block_size 4).

Greedy tokens must EQUAL the JAX engine's (its XLA attention oracle):
the logits agree to ~1e-6 across the frameworks, far inside the
argmax margins of these prompts, so any differing token is a fault.
Sampled tokens are compared inside the port only — its generators are
not JAX's threefry."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu.serving import InferenceEngine as JaxEngine
from bigdl_tpu.serving import Request as JaxRequest
from bigdl_tpu_torch.models.convert import params_from_jax, tree_map
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.ops import paged_decode
from bigdl_tpu_torch.serving import (InferenceEngine, OverloadError,
                                     Request)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32)
KNOBS = dict(slots=2, prefill_buckets=(8, 16, 32), block_size=4)


@pytest.fixture(scope="module")
def models():
    jm = build_lm(**CFG)
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def _engine(tm, params, **kw):
    return InferenceEngine(tm, params, device="cpu", **{**KNOBS, **kw})


def _burst():
    """6 ragged greedy requests, 4 of them sharing a 10-token prefix."""
    rng = np.random.RandomState(7)
    pre = list(rng.randint(1, 61, 10))
    prompts = [pre + [3, 9, 4], list(rng.randint(1, 61, 5)), pre + [11],
               pre + list(rng.randint(1, 61, 6)), [8, 2, 5],
               pre[:9] + [40, 41, 42, 43, 44, 45]]
    return [dict(prompt=[int(t) for t in p], max_new_tokens=4 + i % 4)
            for i, p in enumerate(prompts)]


def test_greedy_tokens_equal_jax_engine(models):
    jm, variables, tm, params = models
    # a pool of 9 blocks (1 scratch + 8) forces LRU eviction of cached
    # prefix blocks on top of slot eviction and reuse
    jeng = JaxEngine(jm, variables, pool_blocks=9, attn_impl="xla",
                     **KNOBS)
    teng = _engine(tm, params, pool_blocks=9)
    ref = jeng.run([JaxRequest(**r) for r in _burst()])
    out = teng.run([Request(**r) for r in _burst()])
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    assert [r.finish_reason for r in out] == \
        [r.finish_reason for r in ref]
    for key in ("prefix_hits", "prefix_tokens_saved", "pool_evictions",
                "decode_steps", "prefill_calls"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefix_hits"] > 0
    assert teng.stats["pool_evictions"] > 0
    assert teng.stats["attn_kernel_launches"] == 0   # plain path on CPU


def test_cache_full_and_stop_ids(models):
    jm, variables, tm, params = models
    long = dict(prompt=list(range(1, 29)), max_new_tokens=10)
    ref = JaxEngine(jm, variables, attn_impl="xla", **KNOBS).run(
        [JaxRequest(**long)])[0]
    res = _engine(tm, params).run([Request(**long)])[0]
    assert res.finish_reason == ref.finish_reason == "cache_full"
    assert res.tokens == ref.tokens and len(res.tokens) == 5

    base = dict(prompt=[4, 8, 15, 16, 23, 42], max_new_tokens=8)
    toks = _engine(tm, params).run([Request(**base)])[0].tokens
    stop = toks[3]
    cut = toks.index(stop)
    res = _engine(tm, params).run(
        [Request(**base, stop_ids=(stop,))])[0]
    assert res.finish_reason == "stop_id"
    assert res.tokens == toks[:cut]


def test_seeded_sampling_alone_equals_cobatched(models):
    _, _, tm, params = models
    a = dict(prompt=[5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7],
             max_new_tokens=6, temperature=0.8, top_k=20, top_p=0.9,
             seed=11)
    s = dict(prompt=[30, 31, 32], max_new_tokens=9, temperature=1.1,
             seed=4)
    alone = _engine(tm, params).run([Request(**a)])[0]
    # the stranger goes first, so `a` decodes in slot 1 beside it
    _, cob = _engine(tm, params).run([Request(**s), Request(**a)])
    assert cob.tokens == alone.tokens
    assert len(alone.tokens) == 6
    other = _engine(tm, params).run([Request(**{**a, "seed": 12})])[0]
    assert other.tokens != alone.tokens


def test_warm_admission_decodes_like_cold(models):
    _, _, tm, params = models
    a = dict(prompt=[5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7],
             max_new_tokens=6, temperature=0.7, seed=3)
    eng = _engine(tm, params)
    cold = eng.run([Request(**a)])[0]
    warm, _ = eng.run([Request(**a), Request(prompt=[30, 31, 32])])
    assert eng.stats["prefix_hits"] == 1
    assert warm.tokens == cold.tokens


def test_poisoned_row_evicts_only_its_request(models):
    _, _, tm, params = models
    # a NaN positional row at 20: only a request reaching position 20
    # turns non-finite; its co-batched neighbours must not notice
    bad = tree_map(lambda t: t.clone(), params)
    bad["pos"][20] = float("nan")
    reqs = [dict(prompt=list(range(1, 23)), max_new_tokens=4),
            dict(prompt=[7, 3, 9], max_new_tokens=6),
            dict(prompt=[2, 4, 6, 8, 10], max_new_tokens=5)]
    clean = _engine(tm, params).run([Request(**r) for r in reqs[1:]])
    eng = _engine(tm, bad)
    out = eng.run([Request(**r) for r in reqs])
    assert out[0].status == "poisoned" and out[0].tokens == []
    assert [r.status for r in out[1:]] == ["done", "done"]
    assert [r.tokens for r in out[1:]] == [r.tokens for r in clean]
    assert eng.stats["poisoned"] == 1
    # the poisoned request's freed exclusive blocks were scrubbed
    freed = [b for b in range(1, eng.pool_blocks)
             if eng._pool_mgr.refcount(b) == 0
             and not eng._pool_mgr.in_tree(b)]
    for layer in eng.pool:
        assert torch.isfinite(layer["k"][freed]).all()
        assert torch.isfinite(layer["v"][freed]).all()


def test_overload_reject(models):
    _, _, tm, params = models
    eng = _engine(tm, params, max_queue=2)
    eng.submit(Request(prompt=[1, 2]))
    eng.submit(Request(prompt=[3, 4]))
    with pytest.raises(OverloadError):
        eng.submit(Request(prompt=[5, 6]))
    assert eng.stats["rejected"] == 1
    assert len(eng.run()) == 2


def test_no_device_means_the_gpu(models):
    _, _, tm, params = models
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tm, params, **KNOBS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerConfig(**CFG))
    with pytest.raises(ValueError, match="CUDA device"):
        _engine(tm, params, attn_impl="cuda")
    assert paged_decode.launches == 0
