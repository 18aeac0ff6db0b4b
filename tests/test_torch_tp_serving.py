"""Tensor-parallel serving of the port (bigdl_tpu_torch/serving/tp.py and
`InferenceEngine(tp_mesh=...)`) on gloo ranks, after
tests/test_tp_serving.py, on two ranks (the four-rank half, tp = 4 and
the reshard round trip, is tests/test_torch_tp_serving_w4.py): a
sharded engine's results are BITWISE the port's unsharded engine's
(greedy and seeded sampling, fp32 and bf16 pools, warm prefix hits, a
lifecycle wave with deadlines, a watchdog trip and retries on an
injected clock), its pools hold H/tp heads, a prefill-role sharded
engine hands off to an unsharded one, and its greedy tokens equal the
JAX engine's at tp_mesh 2 on the 8-device CPU mesh (tests/conftest.py).

The ranks are spawned once per world size (`parallel.launch.spawn`,
with a hard timeout, so a lockstep fault fails instead of hanging);
each runs the unsharded engine as its own oracle beside the sharded
one. The rank bodies import no JAX (each rank imports this module);
JAX is imported inside the tests that compare with it. Greedy tokens
across the frameworks are compared as token lists: their logits agree
to ~1e-6, far inside these prompts' argmax margins."""

import threading
from types import SimpleNamespace

import pytest
import torch

CFG = dict(vocab_size=61, dim=32, num_heads=4, num_layers=2, max_len=32)
SPAWN_TIMEOUT = 120.0
WATCHDOG_S = 0.5


def _still() -> float:
    return 0.0


# engines read a clock that stands at 0 unless a scenario passes its own
KNOBS = dict(slots=2, prefill_buckets=(8, 16), block_size=4, clock=_still)


def _init():
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    m = TransformerLM(TransformerConfig(**CFG), device="cpu")
    return tree_map(lambda t: t.numpy(),
                    m.init_params(torch.Generator().manual_seed(0)))


def _reqs(R, greedy_only=False):
    """Greedy and seeded sampling, per-row knobs, both buckets."""
    out = [R(prompt=[1, 2, 3], max_new_tokens=6, seed=1),
           R(prompt=list(range(1, 11)), max_new_tokens=6,
             temperature=0.9, top_k=5, seed=7),
           R(prompt=[4, 5], max_new_tokens=5, temperature=1.0, top_p=0.9,
             seed=3),
           R(prompt=[9] * 7, max_new_tokens=4, temperature=0.7, seed=11),
           R(prompt=[7, 3, 8, 1, 9, 2, 6, 4, 5, 11, 13, 2, 3],
             max_new_tokens=7, seed=5)]
    return [r for r in out if r.temperature <= 0] if greedy_only else out


def _res(r):
    return (r.id, r.status, r.finish_reason, list(r.tokens), r.ttft_s,
            r.latency_s)


def _join_abandoned_steps():
    for th in threading.enumerate():
        if th.name == "bigdl-serving-step":
            th.join(10.0)


def _lifecycle(make):
    """A wave on an injected clock (1.0 a step): two deadlines that run
    out mid-decode, a queue-wait TTL that runs out queued, an in-flight
    cancellation and a shed-lowest-priority victim."""
    from bigdl_tpu_torch.serving import Request

    clk = {"t": 0.0}
    eng = make(max_queue=4, overload_policy="shed-lowest-priority",
               clock=lambda: clk["t"])
    ids = [eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=8,
                              deadline_s=3.0, seed=1)),
           eng.submit(Request(prompt=[3, 4, 5, 6], max_new_tokens=8,
                              deadline_s=5.0)),
           eng.submit(Request(prompt=[5, 6], max_new_tokens=5,
                              deadline_s=1.5, priority=1)),
           eng.submit(Request(prompt=[2, 8], max_new_tokens=3,
                              max_queue_wait_s=2.0))]
    # the queue holds 4: the lowest-priority newcomer is shed
    ids.append(eng.submit(Request(prompt=[8, 8], max_new_tokens=2,
                                  priority=-1)))
    steps = 0
    while not eng.idle:
        for r in eng.step():
            eng.completed[r.id] = r
        steps += 1
        if steps == 2:
            live = [r.id for r in eng._req if r is not None]
            eng.cancel(live[-1])
        clk["t"] += 1.0
    ids.append(eng.submit(Request(prompt=[4, 4, 4], max_new_tokens=3)))
    while not eng.idle:
        for r in eng.step():
            eng.completed[r.id] = r
        clk["t"] += 1.0
    return [_res(eng.completed[i]) for i in ids], dict(eng.stats)


def _device_timed(make):
    """The wave on a clock that moves only while the device works: 0.25
    s a prefill, 1.0 s a decode dispatch, so a request's ttft and
    latency hold the work of the steps that serve it, as on a real
    clock; deadlines and a queue-wait TTL run out on it."""
    from bigdl_tpu_torch.serving import Request

    clk = {"t": 0.0}
    eng = make(clock=lambda: clk["t"])
    admit, decode = eng._admit_into, eng._decode

    def prefill_then_tick(slot, req):
        ok = admit(slot, req)
        clk["t"] += 0.25
        return ok

    def decode_then_tick(poison):
        out = decode(poison)
        clk["t"] += 1.0
        return out

    eng._admit_into, eng._decode = prefill_then_tick, decode_then_tick
    reqs = _reqs(Request)
    reqs[1].deadline_s = 3.0
    reqs[3].max_queue_wait_s = 1.0
    return [_res(r) for r in eng.run(reqs)]


def _rendezvous(make, R):
    """The sharded engine's lockstep round trips: per decode step with
    an empty queue, and what `run()` saves over one submit at a time."""
    eng = make()
    w = eng.model
    for r in _reqs(R)[:2]:
        eng.submit(r)
    eng.step()                  # admits both: the queue is empty now
    n0 = w.rendezvous
    for _ in range(3):
        eng.step()
    idle = (w.rendezvous - n0) / 3
    counts = []
    for one_by_one in (True, False):
        e = make()
        n0 = e.model.rendezvous
        if one_by_one:
            for r in _reqs(R):
                e.submit(r)
            e.run()
        else:
            e.run(_reqs(R))
        counts.append(e.model.rendezvous - n0)
    return idle, counts


def _straggler(make, rank):
    """Rank 1 alone stalls before its dispatch at step 3, so rank 0's
    worker waits in a gather rank 1 never joins: both ranks must agree
    on the trip and degrade, the abandoned wrapper must refuse reuse,
    and a fresh engine over the same model and mesh must serve."""
    from bigdl_tpu_torch.serving import InferenceEngine, Request
    from bigdl_tpu_torch.utils import faults

    eng = make(step_timeout_s=WATCHDOG_S)
    if rank == 1:
        faults.set_plan(faults.FaultPlan("serve_slow@3"))
    try:
        res = eng.run(_reqs(Request))
    finally:
        faults.set_plan(None)
    refused = None
    try:
        InferenceEngine(eng.model, slots=2, device="cpu",
                        tp_mesh=eng.model.mesh)
    except RuntimeError as e:
        refused = str(e)
    fresh = make()
    return ([_res(r) for r in res], eng.health()["state"],
            eng.stats["watchdog_trips"], refused, fresh.model is eng.model,
            [_res(r) for r in fresh.run(_reqs(Request))])


def _faulted(make, spec, **kw):
    """The wave under a fault plan: results, stats and health state."""
    from bigdl_tpu_torch.serving import EngineDegraded, Request
    from bigdl_tpu_torch.utils import faults

    eng = make(**kw)
    faults.set_plan(faults.FaultPlan(spec))
    try:
        res = eng.run(_reqs(Request))
    finally:
        faults.set_plan(None)
        _join_abandoned_steps()
    refused = False
    try:
        eng.submit(Request(prompt=[1], max_new_tokens=1))
    except EngineDegraded:
        refused = True
    return ([_res(r) for r in res], eng.health()["state"], refused,
            eng.stats["watchdog_trips"], eng.stats["retries"])


def _w2_body(rank, world, init):
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import InferenceEngine, Request

    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = tree_map(torch.from_numpy, init)
    mesh = make_mesh({"model": 2}, device="cpu")

    def plain(**kw):
        return InferenceEngine(model, params, device="cpu",
                               **{**KNOBS, **kw})

    def tp(**kw):
        return InferenceEngine(model, params, device="cpu", tp_mesh=mesh,
                               **{**KNOBS, **kw})

    out = {}
    for name, kw in (("fp32", {}), ("bf16", dict(
            cache_dtype=torch.bfloat16))):
        ref = plain(**kw).run(_reqs(Request))
        eng = tp(**kw)
        got = eng.run(_reqs(Request))
        out[name] = ([_res(r) for r in ref], [_res(r) for r in got])
    out["pool"] = (tuple(eng.pool[0]["k"].shape),
                   tuple(plain().pool[0]["k"].shape), eng.health()["tp"],
                   eng.stats["prefix_bytes_saved"])
    # warm == cold: the same prompt cold, then through a prefix hit
    # beside a stranger
    prompt = [5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7]
    wc = tp()
    cold = wc.run([Request(prompt=prompt, max_new_tokens=6)])[0]
    warm, _ = wc.run([Request(prompt=prompt, max_new_tokens=6),
                      Request(prompt=[3, 3, 1], max_new_tokens=4)])
    out["warm_cold"] = (cold.tokens, warm.tokens,
                        wc.stats["prefix_hits"])
    out["lifecycle"] = (_lifecycle(plain), _lifecycle(tp))
    out["device_timed"] = (_device_timed(plain), _device_timed(tp))
    out["rendezvous"] = _rendezvous(tp, Request)
    out["watchdog"] = tuple(
        _faulted(make, "serve_slow@3", step_timeout_s=WATCHDOG_S)
        for make in (plain, tp))
    out["retry"] = tuple(_faulted(make, "serve_err@2", step_retries=1,
                                  retry_backoff_s=0.0)
                         for make in (plain, tp))
    # a sharded prefill tier hands off to an unsharded decode engine:
    # the packages hold every head, gathered over the axis
    pre = tp(role="prefill")
    dec = plain()
    for r in _reqs(Request, greedy_only=True):
        pre.submit(r)
    pkgs = []
    while not pre.idle:
        pre.step()
        pkgs += pre.take_handoffs()
    for p in pkgs:
        assert dec.import_handoff(p)
    handed = sorted((r.id, r.tokens) for r in dec.run())
    direct = sorted((r.id, r.tokens) for r in plain().run(
        _reqs(Request, greedy_only=True)))
    out["handoff"] = (handed, direct, tuple(pkgs[0].kv[0]["k"].shape[1:]))
    # last: rank 0 keeps a worker waiting in a retired gather group
    out["straggler"] = _straggler(tp, rank)
    return out


def jax_tp_greedy_check(tp, got):
    """The JAX engine's greedy tokens at tp_mesh `tp` on the CPU mesh
    against the port's greedy rows of `got` (results of `_reqs`)."""
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models.transformer import build_lm
    from bigdl_tpu.parallel import make_mesh
    from bigdl_tpu.serving import InferenceEngine, Request
    from bigdl_tpu_torch.serving import Request as TRequest

    jm = build_lm(**CFG)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, _init()),
                 "state": {}}
    eng = InferenceEngine(jm, variables, tp_mesh=make_mesh(
        {"model": tp}, devices=jax.devices()[:tp]), **KNOBS)
    want = [list(r.tokens) for r in eng.run(_reqs(Request,
                                                  greedy_only=True))]
    port = [r[3] for r, q in zip(got, _reqs(TRequest))
            if q.temperature <= 0]
    assert len(port) == 2 and port == want


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_w2_body, 2, str(tmp_path_factory.mktemp("tp2")), _init(),
                 timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("layout", ["fp32", "bf16"])
def test_tp2_results_bitwise_equal_unsharded(w2, layout):
    for res in w2:
        ref, got = res[layout]
        assert got == ref
        assert all(r[1] == "done" and r[3] for r in got)


def test_pools_are_head_sharded(w2):
    for res in w2:
        local, whole, tp, _ = res["pool"]
        assert whole == (local[0], 4, 4, 8) and local == (local[0], 2, 4, 8)
        assert tp == 2


def test_prefix_warm_equals_cold_under_tp(w2):
    for res in w2:
        cold, warm, hits = res["warm_cold"]
        assert hits == 1 and warm == cold and len(cold) == 6


def test_lifecycle_wave_statuses_equal_unsharded(w2):
    for res in w2:
        (ref, ref_stats), (got, got_stats) = res["lifecycle"]
        assert got == ref
        assert got_stats == ref_stats
        statuses = [r[1] for r in got]
        assert statuses == ["shed", "expired", "expired", "expired",
                            "shed", "done"]
        assert [len(r[3]) for r in got][1:4] == [4, 3, 0]
        assert got[0][2] == "cancelled" and got_stats["cancelled"] == 1


def test_ttft_and_latency_equal_unsharded_on_a_moving_clock(w2):
    for res in w2:
        ref, got = res["device_timed"]
        assert got == ref
        # the first two requests' first token comes after two prefills
        # and one decode step
        assert got[0][4] == 1.5 and got[0][5] > got[0][4]
        assert [r[1] for r in got] == ["done", "expired", "done",
                                       "expired", "done"]


def test_idle_decode_step_costs_one_lockstep_round_trip(w2):
    for res in w2:
        idle, (one_by_one, batched) = res["rendezvous"]
        assert idle == 1
        assert one_by_one - batched == len(res["fp32"][1]) - 1


def test_one_rank_straggler_degrades_both_and_retires_the_wrapper(w2):
    for res in w2:
        results, state, trips, refused, same, fresh = res["straggler"]
        assert state == "degraded" and trips == 1
        assert {r[1] for r in results} == {"failed"}
        assert refused is not None and "abandoned" in refused
        assert not same
        assert fresh == res["fp32"][0]


def test_watchdog_trip_degrades_every_rank_alike(w2):
    for res in w2:
        ref, got = res["watchdog"]
        assert got == ref
        results, state, refused, trips, _ = got
        assert state == "degraded" and refused and trips == 1
        assert {r[1] for r in results} == {"failed"}


def test_retry_verdict_agreed_and_tokens_kept(w2):
    for res in w2:
        ref, got = res["retry"]
        assert got == ref
        results, state, _, _, retries = got
        assert state == "ok" and retries == 1
        assert [r[3] for r in results] == [r[3] for r in res["fp32"][0]]


def test_sharded_prefill_hands_off_to_unsharded_decode(w2):
    for res in w2:
        handed, direct, block_shape = res["handoff"]
        assert handed == direct
        assert block_shape == (4, 4, 8)        # every head, gathered


def test_greedy_tokens_equal_jax_tp2_engine(w2):
    jax_tp_greedy_check(2, w2[0]["fp32"][1])


def test_wrapper_memoized_and_rewrap_refused():
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import InferenceEngine, tp_serving_model

    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    mesh = make_mesh({"model": 1}, device="cpu")
    try:
        w = tp_serving_model(model, mesh)
        assert tp_serving_model(model, mesh) is w
        assert tp_serving_model(w, mesh) is w
        e1 = InferenceEngine(model, slots=2, device="cpu", tp_mesh=mesh)
        e2 = InferenceEngine(w, slots=2, device="cpu", tp_mesh=mesh)
        assert e1.model is w and e2.model is w and e1.tp == 1
        other = SimpleNamespace(shape={"model": 1}, device=mesh.device)
        with pytest.raises(ValueError, match="already tp-wrapped"):
            tp_serving_model(w, other)
        with pytest.raises(ValueError, match="already tp-wrapped"):
            tp_serving_model(w, mesh, axis="data")
    finally:
        mesh.close()


def test_divisibility_and_layout_guards():
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.serving import InferenceEngine, TPServingLM

    cpu = torch.device("cpu")
    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="num_heads 4 not divisible"):
        TPServingLM(model, SimpleNamespace(shape={"model": 3}, device=cpu))
    with pytest.raises(ValueError, match="mesh has no axis 'model'"):
        TPServingLM(model, SimpleNamespace(shape={"data": 2}, device=cpu))
    moe = TransformerLM(TransformerConfig(**CFG, moe_experts=2),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        TPServingLM(moe, SimpleNamespace(shape={"model": 2}, device=cpu))
    mesh = SimpleNamespace(shape={"model": 2}, device=cpu)
    with pytest.raises(ValueError, match="weight_dtype='int8' under "
                       "tp_mesh"):
        InferenceEngine(model, slots=2, device="cpu", tp_mesh=mesh,
                        weight_dtype="int8")
    armed = TransformerLM(TransformerConfig(**CFG), device="cpu",
                          tp_axis="model")
    with pytest.raises(ValueError, match="tp_axis='model' armed"):
        InferenceEngine(armed, slots=2, device="cpu")


def test_serving_specs_equal_jax():
    from bigdl_tpu.parallel import param_layout as jpl
    from bigdl_tpu_torch.parallel import param_layout as tpl

    assert tpl.TP_COL == jpl.TP_COL and tpl.TP_COL_BIAS == jpl.TP_COL_BIAS
    jspec = jpl.tp_serving_block_specs("model")
    tspec = tpl.tp_serving_block_specs("model")
    assert set(jspec) == set(tspec)
    for k in jspec:
        assert tuple(jspec[k]) == tuple(tspec[k]), k
    tree = {"embed": 0, "pos": 0, "lnf_g": 0, "lnf_b": 0,
            "blocks": ({}, {})}
    specs = tpl.tp_serving_specs(tree)
    assert set(specs) == set(tree) and len(specs["blocks"]) == 2
    assert tuple(specs["embed"]) == ()
