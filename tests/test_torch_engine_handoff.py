"""The port's disaggregated prefill (bigdl_tpu_torch/serving/engine.py:
`role`, `HandoffPackage`, `take_handoffs`, `import_handoff`), inside
the port and across the two packages, on the CPU, at the tiny size of
tests/test_torch_engine_lifecycle.py.

* Port prefill engine → port decode engine: the tokens (sampled, so
  every logit bit counts) equal a one-engine port run bit for bit, in
  fp32 and with a bf16 pool (the package carries the pool's bytes).
* Across the packages, both ways in fp32 and from JAX in bf16: a
  package's `kv` is a tuple of per-layer {'k', 'v'} numpy arrays (nb,
  H, block_size, D) in both, so a JAX prefill engine's package (its
  Request rebuilt field by field) seats in the port's decode engine and
  the reverse; greedy tokens must EQUAL the importing package's own
  one-engine run."""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_engine_lifecycle as lc

models = lc.models
KW = dict(prefill_buckets=(8, 16), clock=lambda: 3.0)


def _prompts():
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(1, 61, n)] for n in (13, 5, 9, 16)]


def _reqs(s, **kw):
    return [s.m.Request(prompt=p, max_new_tokens=5, seed=i, **kw)
            for i, p in enumerate(_prompts())]


def _handoff(prefill, decode, reqs, convert=lambda pkg: pkg):
    """Every request through `prefill`'s export and `decode`'s import;
    returns the decode engine's results in request order."""
    ids = [prefill.submit(r) for r in reqs]
    while not prefill.idle:
        assert prefill.step() == []
    pkgs = prefill.take_handoffs()
    assert [p.request.id for p in pkgs] == ids and not prefill._handoffs
    pending = [convert(p) for p in pkgs]
    while pending or not decode.idle:
        while pending and decode.import_handoff(pending[0]):
            pending.pop(0)
        for res in decode.step():
            decode.completed[res.id] = res
    return [decode.completed.pop(i) for i in ids], pkgs


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_port_prefill_to_port_decode_is_bitwise(models, cache_dtype):
    _, pt = lc.sides(models)
    kw = dict(KW, cache_dtype=cache_dtype)
    one = pt.engine(**kw).run(_reqs(pt, temperature=0.9, top_k=20))
    pre = pt.engine(role="prefill", **kw)
    dec = pt.engine(role="decode", **kw)
    got, pkgs = _handoff(pre, dec, _reqs(pt, temperature=0.9, top_k=20))
    assert [r.tokens for r in got] == [r.tokens for r in one]
    assert [r.status for r in got] == ["done"] * 4
    assert pre.stats["handoffs_out"] == dec.stats["handoffs_in"] == 4
    assert pre.stats["prefill_calls"] == 4 and pre.stats["decode_steps"] == 0
    assert dec.stats["prefill_calls"] == 0
    # the package's layout: per-layer (nb, H, block_size, D) numpy arrays
    k0 = pkgs[0].kv[0]["k"]
    assert len(pkgs[0].kv) == 2 and k0.shape == (4, 2, 4, 16)
    assert k0.dtype == (np.float32 if cache_dtype == torch.float32
                        else np.int16)
    assert pkgs[0].submit_t == 3.0 and got[0].latency_s == 0.0
    h = dec.health()
    assert (h["role"], h["handoffs_in"]) == ("decode", 4)


def _rebuild(pkg, target):
    """A package of one package rebuilt for the other: the Request field
    by field (the fields both Requests have), the kv arrays as they are."""
    fields = {f.name for f in dataclasses.fields(target.m.Request)}
    req = target.m.Request(**{k: v for k, v in vars(pkg.request).items()
                              if k in fields})
    return target.m.HandoffPackage(req, pkg.kv, pkg.submit_t, pkg.source)


@pytest.mark.parametrize("direction, cache_dtype", [
    ("jax_to_port", torch.float32), ("port_to_jax", torch.float32),
    ("jax_to_port", torch.bfloat16)])
def test_handoff_across_packages(models, direction, cache_dtype):
    """(A JAX bf16 package's numpy `bfloat16` arrays seat in the port's
    bf16 pool by their bits.)"""
    jx, pt = lc.sides(models)
    src, dst = (jx, pt) if direction == "jax_to_port" else (pt, jx)
    kw = dict(KW, cache_dtype=cache_dtype)
    one = dst.engine(**kw).run(_reqs(dst))
    got, _ = _handoff(src.engine(role="prefill", **kw),
                      dst.engine(role="decode", **kw), _reqs(src),
                      convert=lambda p: _rebuild(p, dst))
    assert [r.tokens for r in got] == [r.tokens for r in one]
    assert [r.status for r in got] == ["done"] * 4


def test_import_reuses_cached_prefix_blocks(models):
    """A decode engine that already caches a prompt's prefix reuses
    those blocks for an imported package of the same prompt."""
    _, pt = lc.sides(models)
    prompt = _prompts()[0]
    dec = pt.engine(role="decode", **KW)
    cold = dec.run([pt.m.Request(prompt=prompt, max_new_tokens=5)])[0]
    got, _ = _handoff(pt.engine(role="prefill", **KW), dec,
                      [pt.m.Request(prompt=prompt, max_new_tokens=5)])
    assert got[0].tokens == cold.tokens
    assert dec.stats["prefix_hits"] == 1
    assert dec.stats["prefix_blocks_reused"] == 3


def test_handoff_refusals(models):
    _, pt = lc.sides(models)
    pre = pt.engine(role="prefill", **KW)
    with pytest.raises(ValueError, match="prefill-role"):
        pre.run(_reqs(pt))
    pre.submit(_reqs(pt)[0])
    pre.step()
    pkg = pre.take_handoffs()[0]
    with pytest.raises(ValueError, match="prefill-role"):
        pre.import_handoff(pkg)
    with pytest.raises(ValueError, match="cache_dtype"):
        pt.engine(cache_dtype=torch.bfloat16, **KW).import_handoff(pkg)
    dec = pt.engine(**KW)
    assert dec.import_handoff(pkg)
    with pytest.raises(ValueError, match="already in flight"):
        dec.import_handoff(pkg)
    dec.drain()
    with pytest.raises(lc.tserving.EngineDraining):
        dec.import_handoff(dataclasses.replace(
            pkg, request=dataclasses.replace(pkg.request, id=99)))
