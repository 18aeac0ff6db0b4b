"""The port's request lifecycle and admission control
(bigdl_tpu_torch/serving/engine.py: deadlines, queue-wait TTLs,
cancellation, the overload policies, priority order, knob validation,
health()) against the JAX package's InferenceEngine, on the CPU, at a
tiny size (vocab 61, dim 32, 2 heads, 2 layers, max_len 32, block 4).

Each scenario of tests/test_serving_reliability.py runs through both
engines on an injected fake clock that only moves between steps; the
statuses, finish reasons, greedy tokens, `ttft_s` and `latency_s`, and
the stats keys both engines keep must be EQUAL (the logits agree to
~1e-6 across the frameworks, far inside these prompts' argmax margins).
The other test files of the serving slice import the helpers here."""

from types import SimpleNamespace

import jax
import pytest
import torch

from bigdl_tpu import serving as jserving
from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu_torch import serving as tserving
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32)
KNOBS = dict(slots=2, prefill_buckets=(8,), block_size=4)


@pytest.fixture(scope="module")
def models():
    jm = build_lm(**CFG)
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def _still() -> float:
    return 0.0


def sides(models):
    """The JAX engine (its XLA attention oracle) and the port's, each
    with its package's Request and error classes. An engine reads a
    clock that stands at 0 unless a scenario passes its own."""
    jm, variables, tm, params = models

    def jax_engine(**kw):
        kw = {**KNOBS, "clock": _still, **kw}
        if "cache_dtype" in kw:
            kw["cache_dtype"] = {torch.float32: jax.numpy.float32,
                                 torch.bfloat16: jax.numpy.bfloat16}[
                                     kw["cache_dtype"]]
        return jserving.InferenceEngine(jm, variables, attn_impl="xla",
                                        **kw)

    def port_engine(**kw):
        return tserving.InferenceEngine(tm, params, device="cpu",
                                        **{**KNOBS, "clock": _still, **kw})

    return (SimpleNamespace(name="jax", engine=jax_engine, m=jserving),
            SimpleNamespace(name="port", engine=port_engine, m=tserving))


def drain(eng, clk=None, dt=1.0):
    """Step until empty, advancing the fake clock between steps."""
    while not eng.idle:
        for res in eng.step():
            eng.completed[res.id] = res
        if clk is not None:
            clk["t"] += dt


def result(r):
    return (r.id, r.status, r.finish_reason, list(r.tokens), r.ttft_s,
            r.latency_s)


def shared_stats(a, b):
    """The stats both engines keep, as (JAX's, the port's)."""
    keys = sorted(set(a.stats) & set(b.stats))
    return ({k: a.stats[k] for k in keys}, {k: b.stats[k] for k in keys})


# --------------------------------------------------------- scenarios
def sc_deadline_queued_vs_decoding(s):
    clk = {"t": 0.0}
    eng = s.engine(clock=lambda: clk["t"])
    eng.submit(s.m.Request(prompt=[1, 2], max_new_tokens=8, seed=1))
    eng.submit(s.m.Request(prompt=[3, 4], max_new_tokens=8, seed=2))
    qid = eng.submit(s.m.Request(prompt=[5, 6], max_new_tokens=4,
                                 deadline_s=2.0))
    drain(eng, clk)
    q = eng.completed[qid]
    assert q.status == "expired" and q.tokens == []
    clk["t"] = 0.0
    eng2 = s.engine(clock=lambda: clk["t"])
    did = eng2.submit(s.m.Request(prompt=[1, 2, 3], max_new_tokens=8,
                                  deadline_s=2.0))
    drain(eng2, clk)
    d = eng2.completed[did]
    assert d.status == "expired" and len(d.tokens) == 3
    return [result(r) for r in (*eng.completed.values(),
                                *eng2.completed.values())], [eng, eng2]


def sc_max_queue_wait(s):
    clk = {"t": 0.0}
    eng = s.engine(slots=1, clock=lambda: clk["t"])
    eng.submit(s.m.Request(prompt=[1, 2], max_new_tokens=6, seed=1))
    wid = eng.submit(s.m.Request(prompt=[3, 4], max_new_tokens=2,
                                 max_queue_wait_s=3.0))
    drain(eng, clk)
    assert eng.completed[wid].status == "expired"
    clk["t"] = 0.0
    eng2 = s.engine(slots=1, clock=lambda: clk["t"])
    oid = eng2.submit(s.m.Request(prompt=[3, 4], max_new_tokens=6,
                                  max_queue_wait_s=3.0))
    drain(eng2, clk)
    assert eng2.completed[oid].status == "done"
    return [result(r) for r in (*eng.completed.values(),
                                *eng2.completed.values())], [eng, eng2]


def sc_cancel_queued_and_inflight(s):
    clk = {"t": 0.0}
    eng = s.engine(slots=1, clock=lambda: clk["t"])
    a = eng.submit(s.m.Request(prompt=[1, 2], max_new_tokens=6, seed=1))
    b = eng.submit(s.m.Request(prompt=[3, 4], max_new_tokens=6, seed=2))
    eng.step()                                # a decoding, b queued
    clk["t"] = 1.5
    res_b = eng.cancel(b)
    assert res_b.status == "shed" and res_b.finish_reason == "cancelled"
    res_a = eng.cancel(a)
    assert res_a.status == "shed" and len(res_a.tokens) == 1
    with pytest.raises(KeyError):
        eng.cancel(a)
    assert eng.idle and eng._free_slots() == [0]
    return [result(res_b), result(res_a)], [eng]


def sc_statuses_and_run(s):
    eng = s.engine(max_queue=1, overload_policy="shed-oldest")
    out = eng.run([s.m.Request(prompt=[1, 2], max_new_tokens=2, seed=1),
                   s.m.Request(prompt=[3, 4], max_new_tokens=2, seed=2),
                   s.m.Request(prompt=[5, 6], max_new_tokens=2, seed=3)])
    assert [r.status for r in out] == ["shed", "shed", "done"]
    return [result(r) for r in out], [eng]


def sc_reject(s):
    eng = s.engine(max_queue=1, overload_policy="reject")
    eng.submit(s.m.Request(prompt=[1, 2]))
    with pytest.raises(s.m.OverloadError, match="queue full"):
        eng.submit(s.m.Request(prompt=[3, 4]))
    return [result(r) for r in eng.run()], [eng]


def sc_priority_order(s):
    eng = s.engine(slots=1)
    ids = [eng.submit(s.m.Request(prompt=p, max_new_tokens=2,
                                  priority=pr))
           for p, pr in (([1, 2], 0), ([3, 4], 9), ([5, 6], 5))]
    order = []
    while not eng.idle:
        order += [res.id for res in eng.step()]
    assert order == [ids[1], ids[2], ids[0]]
    return order, [eng]


def sc_shed_lowest_priority(s):
    eng = s.engine(max_queue=2, overload_policy="shed-lowest-priority")
    low = eng.submit(s.m.Request(prompt=[1, 2], priority=1))
    eng.submit(s.m.Request(prompt=[3, 4], priority=7))
    eng.submit(s.m.Request(prompt=[5, 6], priority=4))   # sheds `low`
    assert eng.completed[low].status == "shed"
    new = eng.submit(s.m.Request(prompt=[7, 8], priority=0))
    assert eng.completed[new].status == "shed"           # newcomer lowest
    shed = [result(eng.completed[i]) for i in (low, new)]
    return shed + [result(r) for r in eng.run()], [eng]


def sc_expired_not_overload(s):
    clk = {"t": 0.0}
    eng = s.engine(slots=1, max_queue=2, overload_policy="reject",
                   clock=lambda: clk["t"])
    eng.submit(s.m.Request(prompt=[1, 2], max_new_tokens=6, seed=1))
    eng.step()                          # slot busy, queue empty
    s1 = eng.submit(s.m.Request(prompt=[3, 4], deadline_s=1.0))
    s2 = eng.submit(s.m.Request(prompt=[5, 6], deadline_s=1.0))
    clk["t"] = 5.0                      # both queued TTLs dead
    fresh = eng.submit(s.m.Request(prompt=[7, 8], max_new_tokens=2))
    assert eng.completed[s1].status == eng.completed[s2].status \
        == "expired"
    assert eng.stats["rejected"] == 0
    drain(eng, clk)
    assert eng.completed[fresh].status == "done"
    return [result(r) for r in eng.completed.values()], [eng]


def sc_all_slots_finish_same_step(s):
    eng = s.engine()
    eng.submit(s.m.Request(prompt=[1, 2], max_new_tokens=3, seed=1))
    eng.submit(s.m.Request(prompt=[3, 4], max_new_tokens=3, seed=2))
    finished = []
    for _ in range(3):
        finished = eng.step()
    assert len(finished) == 2 and eng._free_slots() == [0, 1]
    res = eng.run([s.m.Request(prompt=[5, 6], max_new_tokens=2)])
    assert res[0].status == "done"
    return [result(r) for r in finished + res], [eng]


def sc_queue_longer_than_slots(s):
    eng = s.engine()
    out = eng.run([s.m.Request(prompt=[i + 1, i + 2], max_new_tokens=2,
                               seed=i) for i in range(5)])
    assert [r.status for r in out] == ["done"] * 5
    eng2 = s.engine()
    eng2.submit(s.m.Request(prompt=[1, 2], max_new_tokens=4, seed=1))
    eng2.submit(s.m.Request(prompt=[3, 4], max_new_tokens=4, seed=2))
    eng2.step()                            # both slots now occupied
    out2 = eng2.run([s.m.Request(prompt=[5, 6], max_new_tokens=2)])
    assert len(eng2.completed) == 2        # the pre-submitted pair
    return [result(r) for r in out + out2
            + sorted(eng2.completed.values(), key=lambda r: r.id)], \
        [eng, eng2]


def sc_health(s):
    clk = {"t": 0.0}
    eng = s.engine(max_queue=4, clock=lambda: clk["t"])
    for i, p in enumerate(([1, 2], [3, 4], [5, 6])):
        eng.submit(s.m.Request(prompt=p, max_new_tokens=3, seed=i))
    eng.step()
    h1 = eng.health()
    assert h1["state"] == "ok" and h1["degraded_reason"] is None
    assert h1["slots_active"] == 2 and h1["queue_depth"] == 1
    assert h1["queue_buckets"] == {8: 1}
    assert h1["decode_p50_ms"] > 0 and h1["decode_p95_ms"] > 0
    drain(eng, clk)
    h2 = eng.health()
    assert h2["requests_done"] == 3
    for h in (h1, h2):
        del h["attn_impl"]                  # "xla" against "torch"
        del h["metrics"]["engine"]          # a per-process label
    return [h1, h2], [eng]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_deadline_queued_vs_decoding, sc_max_queue_wait,
    sc_cancel_queued_and_inflight, sc_statuses_and_run, sc_reject,
    sc_priority_order, sc_shed_lowest_priority, sc_expired_not_overload,
    sc_all_slots_finish_same_step, sc_queue_longer_than_slots,
    sc_health)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(models, name):
    jx, pt = sides(models)
    ref, jengs = SCENARIOS[name](jx)
    got, tengs = SCENARIOS[name](pt)
    assert got == ref
    for je, te in zip(jengs, tengs):
        a, b = shared_stats(je, te)
        assert b == a


def test_knob_validation_like_jax(models):
    for s in sides(models):
        for kw, match in ((dict(overload_policy="drop-everything"),
                           "overload_policy"),
                          (dict(max_queue=0), "max_queue"),
                          (dict(step_retries=-1), "step_retries"),
                          (dict(block_size=3), "multiple of block_size"),
                          (dict(pool_blocks=4), "cannot hold"),
                          (dict(prefill_buckets=(64,)), "exceeds"),
                          (dict(role="router"), "role"),
                          (dict(role="prefill", step_retries=1),
                           "prefill-role"),
                          (dict(weight_dtype="fp16"), "weight_dtype"),
                          (dict(spill=True, prefix_cache=False),
                           "prefix_cache"),
                          (dict(host_blocks=4), "host_blocks"),
                          (dict(admit_requeue_budget=0),
                           "admit_requeue_budget")):
            with pytest.raises(ValueError, match=match):
                s.engine(**kw)


def test_max_len_cache_shorter_than_the_table(models):
    """`max_len` sizes the cache below the positional table: the
    request runs out of cache at the same token in both engines."""
    jx, pt = sides(models)
    out = []
    for s in (jx, pt):
        eng = s.engine(max_len=16, prefill_buckets=(8, 16))
        out.append([result(r) for r in eng.run(
            [s.m.Request(prompt=list(range(3, 14)), max_new_tokens=9)])])
        assert eng.cache_len == 16 and eng._table.shape == (2, 4)
    assert out[1] == out[0]
    assert out[1][0][2] == "cache_full" and len(out[1][0][3]) == 6
    with pytest.raises(ValueError, match="positional table"):
        pt.engine(max_len=64)


def test_prefix_cache_off_prefills_cold(models):
    jx, pt = sides(models)
    prompt = [5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7]
    got = []
    for s in (jx, pt):
        eng = s.engine(prefix_cache=False, prefill_buckets=(8, 16))
        for _ in range(2):
            got.append(eng.run([s.m.Request(prompt=prompt,
                                            max_new_tokens=4)])[0].tokens)
        assert eng.stats["prefix_hits"] == 0
        assert eng.health()["prefix"]["enabled"] is False
        assert eng.prefix_match_tokens(prompt) == 0
    assert got[2:] == got[:2]


def test_requests_carry_their_model_tag_and_engine_its_own(models):
    _, pt = sides(models)
    eng = pt.engine(model_tag="lm-43m")
    res = eng.run([pt.m.Request(prompt=[1, 2, 3], max_new_tokens=2,
                                model_tag="lm-43m")])
    assert res[0].status == "done"
    assert eng.health()["model_tag"] == "lm-43m"


@pytest.mark.parametrize("kw, queue", [
    (dict(tenant_kv_quotas={"a": 4}), "A.9"),
    (dict(obs_label="e0"), "A.9")])
def test_waiting_features_name_their_queue(models, kw, queue):
    _, pt = sides(models)
    with pytest.raises(NotImplementedError, match=queue):
        pt.engine(**kw)


def test_engine_with_tp_mesh_serves_as_unsharded(models):
    """`tp_mesh` (A.8 step 6) serves through serving/tp.py: on a
    one-rank mesh the engine's results equal the unsharded engine's
    and the JAX engine's (the multi-rank cases are
    tests/test_torch_tp_serving.py)."""
    from bigdl_tpu_torch.parallel import make_mesh

    jx, pt = sides(models)
    reqs = [dict(prompt=[1, 2, 3], max_new_tokens=5),
            dict(prompt=[7, 5, 3, 9, 4, 2, 8], max_new_tokens=4)]
    mesh = make_mesh({"model": 1}, device="cpu")
    try:
        eng = pt.engine(tp_mesh=mesh)
        got = [result(r) for r in eng.run(
            [pt.m.Request(**r) for r in reqs])]
        assert eng.tp == 1 and eng.health()["tp"] == 1
    finally:
        mesh.close()
    plain = [result(r) for r in pt.engine().run(
        [pt.m.Request(**r) for r in reqs])]
    ref = [result(r) for r in jx.engine().run(
        [jx.m.Request(**r) for r in reqs])]
    assert got == plain == ref
