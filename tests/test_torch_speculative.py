"""The port's speculative decoding (bigdl_tpu_torch/serving/
speculative.py `SpeculativeEngine`) on the CPU, at the fault drill's
tiny pair: a target LM (vocab 50, dim 32, 2 heads, 2 layers) and a
draft (dim 16, 2 heads, 1 layer), max_len 64.

* Inside the port: a speculative engine's tokens are BITWISE a
  target-only engine's for k = 1, 2, 3, greedy and seeded requests
  mixed, and stay so with the adaptive lookahead on, across a draft
  hot swap, and through the draft's fallback after a watchdog trip.
  Seeded tokens are held inside the port only: its sampling streams
  are its own (serving/sampler.py).
* Against the JAX package: on greedy traffic, with the same weights
  in both (`params_from_jax`), the speculative tokens AND the accept
  tallies (rounds, proposed, accepted, wasted, emitted) equal the JAX
  `SpeculativeEngine`'s.
* The property exactness rests on: a row's logits from
  `decode_step_paged` are bitwise the same decoded among B rows and
  among the B·(k+1) rows of a verify pass (the layer norms and products
  run over tiles of B rows, `decode_step_paged(row_tile=B)`, as the
  engine calls it), for fp32 and bf16 pools.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import obs as jobs
from bigdl_tpu import serving as jserving
from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import serving as tserving
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.utils import faults as tfaults

TARGET = dict(vocab_size=50, dim=32, num_heads=2, num_layers=2,
              max_len=64)
DRAFT = dict(TARGET, dim=16, num_layers=1)
KNOBS = dict(slots=2, prefill_buckets=(8,))


@pytest.fixture(scope="module")
def pair():
    """(JAX target, JAX draft, port target, port draft), the port's
    carrying the JAX models' weights."""
    out = []
    for cfg, seed in ((TARGET, 0), (DRAFT, 7)):
        jm = build_lm(**cfg)
        jm.build(jax.random.PRNGKey(seed))
        tm = TransformerLM(TransformerConfig(**cfg), device="cpu")
        tm.variables = params_from_jax(
            jax.device_get(jm.variables["params"]), device="cpu")
        out.append((jm, tm))
    (jt, tt), (jd, td) = out
    return jt, jd, tt, td


@pytest.fixture(autouse=True)
def _fresh():
    """Telemetry and fault plans are process-wide; the fallback test's
    draft watchdog runs on the wall clock, so one intra-op thread keeps
    a tiny CPU step from queueing behind other workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for o in (jobs, tobs):
        o.reset_all()
    jfaults.set_plan(None)
    tfaults.set_plan(None)


def _specs(n=6, sampled=True, new=6):
    return [dict(prompt=[i + 1, i + 2, i + 3, (5 * i) % 40 + 1],
                 max_new_tokens=new + i % 3,
                 temperature=(0.8 if sampled and i % 2 else 0.0),
                 top_k=(5 if i % 4 == 1 else 0), seed=50 + i)
            for i in range(n)]


def _port(model, **kw):
    return tserving.InferenceEngine(model, **{**KNOBS, "device": "cpu",
                                              **kw})


def _perturbed(tree, g):
    """Another draft of the same structure: every leaf plus noise."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, g) for k, v in tree.items()}
    return tree + 0.05 * torch.randn(tree.shape, generator=g)


def _tokens(results):
    return [(r.status, r.finish_reason, list(r.tokens)) for r in results]


# ------------------------------------------------------- inside the port
@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_tokens_are_target_only_tokens(pair, k):
    _, _, tt, td = pair
    ref = _port(tt).run([tserving.Request(**s) for s in _specs()])
    spec = tserving.SpeculativeEngine(_port(td), _port(tt), k=k)
    got = spec.run([tserving.Request(**s) for s in _specs()])
    assert _tokens(got) == _tokens(ref)
    h = spec.health()["speculative"]
    assert h["rounds"] >= 1 and h["proposed"] > 0
    assert h["emitted"] == sum(len(r.tokens) for r in got)
    # the verify pass ran the decode step once a round over B·(k+1) rows
    assert spec.stats["decode_steps"] == h["rounds"]
    assert spec.draft_engine.stats["decode_steps"] == h["draft_steps"]


@pytest.mark.parametrize("k", [1, 3])
def test_target_as_its_own_draft_accepts_every_seeded_proposal(pair, k):
    """Coupled sampling: draft proposal j of a seeded row and verify
    row j draw from the same generator state (`row_generator(seed,
    nout + j)`), so a draft that IS the target proposes exactly the
    target's samples and every proposal is accepted. Equal tokens alone
    cannot show this: they stay equal when acceptance collapses."""
    _, _, tt, _ = pair
    specs = [dict(s, temperature=0.8, top_k=(5 if i % 2 else 0))
             for i, s in enumerate(_specs(new=8))]
    ref = _port(tt).run([tserving.Request(**s) for s in specs])
    spec = tserving.SpeculativeEngine(_port(tt), _port(tt), k=k)
    got = spec.run([tserving.Request(**s) for s in specs])
    assert _tokens(got) == _tokens(ref)
    h = spec.health()["speculative"]
    assert h["proposed"] > 0
    assert h["accepted"] == h["proposed"] and h["accept_rate"] == 1.0


def test_adaptive_lookahead_and_draft_swap_keep_the_tokens(pair):
    _, _, tt, td = pair
    specs = _specs(8, new=10)
    ref = _port(tt).run([tserving.Request(**s) for s in specs])
    tobs.reset_all()
    spec = tserving.SpeculativeEngine(_port(td), _port(tt), k=3,
                                      adapt_k=True, adapt_window=2,
                                      raise_at=0.9, lower_at=0.5,
                                      collapse_at=0.4, probe_every=3)
    ids = [spec.submit(tserving.Request(**s)) for s in specs]
    got, swapped = {}, False
    g = torch.Generator().manual_seed(11)
    other_vars = _perturbed(td.variables, g)
    while not spec.idle:
        for res in spec.step():
            got[res.id] = res
        if not swapped and spec.stats["spec_rounds"] >= 2:
            spec.swap_draft(other_vars, source="test")
            swapped = True
    assert _tokens([got[i] for i in ids]) == _tokens(ref)
    h = spec.health()["speculative"]
    assert h["swaps"] == 1 and spec.swap_records[0]["source"] == "test"
    assert h["k_adjusts"] >= 1
    kinds = tobs.get_event_log().counts_by_kind()
    assert kinds.get("spec_k_adjust", 0) == h["k_adjusts"]
    assert kinds.get("draft_swap") == 1


def test_draft_watchdog_trip_falls_back_to_target_only(pair):
    """The serve_spec drill's fault: serve_slow@3 hangs the draft's
    fourth chain step past its budget; the draft quiesces (one
    engine_degraded, no request terminal of its own) and the wrapper
    finishes every request target-only, tokens unchanged."""
    _, _, tt, td = pair
    ref = _port(tt).run([tserving.Request(**s) for s in _specs()])
    tobs.reset_all()
    tfaults.set_plan(tfaults.FaultPlan("serve_slow@3"))
    draft = _port(td, step_timeout_s=0.1, obs_label="spec_d")
    spec = tserving.SpeculativeEngine(draft, _port(tt, obs_label="spec_t"),
                                      k=3)
    got = spec.run([tserving.Request(**s) for s in _specs()])
    assert _tokens(got) == _tokens(ref)
    assert spec.fallback is not None and "watchdog" in spec.fallback
    assert draft.degraded is not None
    assert draft.stats["watchdog_trips"] == 1
    log = tobs.get_event_log()
    assert [e["engine"] for e in log.events("engine_degraded")] \
        == ["spec_d"]
    assert len(log.events("spec_fallback")) == 1
    assert not log.events("request_terminal", status="failed")
    assert spec.health()["speculative"]["draft"]["state"] == "degraded"


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("k", [1, 3])
def test_greedy_spec_matches_the_reference(pair, k):
    jt, jd, tt, td = pair
    specs = _specs(sampled=False)
    out = []
    for m, t, d, eng in ((jserving, jt, jd, lambda model: jserving
                          .InferenceEngine(model, attn_impl="xla",
                                           **KNOBS)),
                         (tserving, tt, td, _port)):
        spec = m.SpeculativeEngine(eng(d), eng(t), k=k)
        res = spec.run([m.Request(**s) for s in specs])
        h = spec.health()["speculative"]
        out.append((_tokens(res), {key: h[key] for key in (
            "rounds", "draft_steps", "proposed", "accepted", "wasted",
            "emitted", "accept_rate", "tokens_per_round")}))
    assert out[1] == out[0]
    assert out[1][1]["proposed"] > 0


# ------------------------------------------------------------ row bits
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, k", [(1, 1), (1, 3), (3, 3)])
def test_decode_rows_are_bitwise_across_extents(pair, cache_dtype, b, k):
    """B rows decoded alone against the same rows inside a B·(k+1)-row
    verify-shaped call over copies of the same pools."""
    _, _, tt, _ = pair
    sp = tt.serving_params(tt.variables)
    nb = TARGET["max_len"] // 4
    pools = tt.init_block_pool(b * nb + 1, 4, cache_dtype)
    table = (1 + torch.arange(b * nb, dtype=torch.int32)).reshape(b, nb)
    rng = np.random.RandomState(3)
    lens = [9, 17, 30][:b]
    for r, n in enumerate(lens):
        toks = torch.zeros(1, 32, dtype=torch.int32)
        toks[0, :n] = torch.from_numpy(rng.randint(1, 50, n))
        tt.prefill_paged(sp, toks, pools, table[r:r + 1], table[r, :8], 0)
    clone = [{key: t.clone() for key, t in layer.items()} for layer in pools]
    tok = torch.from_numpy(rng.randint(1, 50, b)).int()
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    with torch.no_grad():
        alone, _ = tt.decode_step_paged(sp, tok, pos, pools, table,
                                        row_tile=b)
        vtok = torch.from_numpy(rng.randint(1, 50, b * (k + 1))).int()
        vtok[::k + 1] = tok
        vpos = (pos[:, None] + torch.arange(k + 1, dtype=torch.int32)
                ).reshape(-1)
        within, _ = tt.decode_step_paged(sp, vtok, vpos, clone,
                                         table.repeat_interleave(k + 1, 0),
                                         row_tile=b)
    assert torch.equal(alone, within[::k + 1])
    with pytest.raises(ValueError, match="multiple of row_tile"):
        tt.decode_step_paged(sp, vtok, vpos, clone,
                             table.repeat_interleave(k + 1, 0),
                             row_tile=b * (k + 1) + 1)
