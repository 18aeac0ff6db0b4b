"""The port's quantized serving layout (bigdl_tpu_torch/serving/quant.py
and the `_deq`/`_embed_rows` hooks of models/transformer.py) and the
engine's `weight_dtype` / `cache_dtype` layouts against the JAX
package's (bigdl_tpu/serving/quant.py), on the CPU, at the tiny size of
tests/test_torch_engine_lifecycle.py.

Tolerances:
* int8 repack: both packages compute `round(w / scale)` with round half
  to even, but the division may differ by one ulp, so a few entries may
  land one step apart — the port's `q` must equal JAX's except at most
  1e-4 of the entries, none off by more than 1; the scales to 1e-6
  relative.
* Engines: the int8/bfloat16 engine's greedy tokens must EQUAL the JAX
  int8/bfloat16 engine's. A lossy layout is held, inside the port,
  against fp32 at the JAX package's documented floor
  (tests/test_quant_serving.py): first tokens agree on all requests but
  one, and the agreed-prefix share of the horizon is >= 0.25."""

import numpy as np
import pytest
import torch

import test_torch_engine_lifecycle as lc
from bigdl_tpu.serving import quant as jquant
from bigdl_tpu_torch.serving import quant as tquant

models = lc.models
LAYOUTS = {"fp32/bfloat16": dict(cache_dtype=torch.bfloat16),
           "int8/float32": dict(weight_dtype="int8"),
           "int8/bfloat16": dict(weight_dtype="int8",
                                 cache_dtype=torch.bfloat16)}


def _pairs(jt, tt, path=""):
    """(path, JAX QuantWeight or array, port QuantWeight or tensor)."""
    if isinstance(tt, dict):
        for k in tt:
            yield from _pairs(jt[k], tt[k], f"{path}/{k}")
    elif isinstance(tt, tuple) and not hasattr(tt, "deq"):
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, jt, tt


def test_repack_matches_jax(models):
    jm, variables, tm, params = models
    jq = jquant.quantize_serving_params(jm.serving_params(variables))
    tq = tquant.quantize_serving_params(tm.serving_params(params))
    n = off = 0
    for path, j, t in _pairs(jq, tq):
        assert hasattr(j, "deq") == hasattr(t, "deq"), path
        if not hasattr(t, "deq"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            continue
        assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
        d = t.q.numpy().astype(np.int32) - np.asarray(j.q, np.int32)
        assert np.abs(d).max() <= 1, path
        n += d.size
        off += int(np.count_nonzero(d))
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-6, atol=0)
    assert off <= 1e-4 * n, f"{off} of {n} int8 entries differ"


def test_repack_structure_bound_and_bytes(models):
    _, _, tm, params = models
    sp = tm.serving_params(params)
    qp = tquant.quantize_serving_params(sp)
    assert isinstance(qp["embed"], tquant.QuantWeight)
    assert qp["embed"].scale.shape == (61, 1)        # per-row embed scales
    for bp, qbp in zip(sp["blocks"], qp["blocks"]):
        for k in bp:
            if k in ("wq", "wk", "wv", "wo", "w1", "w2"):
                assert isinstance(qbp[k], tquant.QuantWeight)
                assert qbp[k].shape == bp[k].shape
                assert qbp[k].scale.shape == (1, bp[k].shape[1])
            else:
                assert qbp[k] is bp[k]            # biases/LN pass through
    w, dq = sp["blocks"][0]["wq"], qp["blocks"][0]["wq"].deq()
    assert float((dq - w).abs().max()) <= float(w.abs().max()) / 254 + 1e-7
    assert tquant.params_bytes(sp) / tquant.params_bytes(qp) >= 2.5
    with pytest.raises(ValueError, match="serving"):
        tquant.quantize_serving_params(params)


def _wave(s):
    return [s.m.Request(id=i, prompt=[3 + i, 7, 11 + i], max_new_tokens=6)
            for i in range(4)]


def _tokens(eng, s):
    return {r.id: r.tokens for r in eng.run(_wave(s))}


def test_int8_bf16_engine_equals_jax(models):
    jx, pt = lc.sides(models)
    kw = LAYOUTS["int8/bfloat16"]
    assert _tokens(pt.engine(**kw), pt) == _tokens(jx.engine(**kw), jx)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lossy_layout_agrees_with_fp32(models, layout):
    _, pt = lc.sides(models)
    ref = _tokens(pt.engine(), pt)
    eng = pt.engine(**LAYOUTS[layout])
    got = _tokens(eng, pt)
    assert eng.layout_family == layout
    assert all(len(got[i]) == len(ref[i]) for i in ref)
    assert sum(got[i][0] == ref[i][0] for i in ref) >= len(ref) - 1
    agreed = sum(next((k for k, (a, b) in enumerate(zip(ref[i], got[i]))
                       if a != b), len(ref[i])) for i in ref)
    assert agreed / sum(len(v) for v in ref.values()) >= 0.25


def test_layout_health_and_bytes(models):
    _, pt = lc.sides(models)
    e32 = pt.engine()
    eq = pt.engine(**LAYOUTS["int8/bfloat16"])
    assert e32.layout_family == "fp32/float32"
    h = eq.health()
    assert (h["weight_dtype"], h["cache_dtype"], h["attn_impl"], h["tp"]) \
        == ("int8", "bfloat16", "torch", 1)
    assert eq.pool[0]["k"].dtype == torch.bfloat16
    assert tquant.params_bytes(e32._params) \
        / tquant.params_bytes(eq._params) >= 2.5
    with pytest.raises(ValueError, match="cache_dtype"):
        pt.engine(cache_dtype=torch.float16)


def test_swap_params_mid_wave(models):
    """Swapping in the same weights mid-wave leaves the tokens bitwise
    unchanged and counts the swap; a changed structure or shape is
    refused."""
    _, _, tm, params = models
    _, pt = lc.sides(models)
    for kw in ({}, LAYOUTS["int8/bfloat16"]):
        ref = _tokens(pt.engine(**kw), pt)
        eng = pt.engine(**kw)
        ids = [eng.submit(r) for r in _wave(pt)]
        eng.step()
        eng.step()
        eng.swap_params({k: v.clone() if torch.is_tensor(v) else
                         {kk: vv.clone() for kk, vv in v.items()}
                         for k, v in params.items()})
        lc.drain(eng)
        assert {i: eng.completed[i].tokens for i in ids} == ref
        assert eng.stats["weight_swaps"] == 1
    untied = dict(params, head=params["embed"].T.clone())
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params(untied)
    wide = dict(params, pos=torch.zeros(64, 32))
    with pytest.raises(ValueError, match="shapes"):
        eng.swap_params(wide)
    assert eng.stats["weight_swaps"] == 1
