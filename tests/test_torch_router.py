"""The port's fleet router (bigdl_tpu_torch/serving/router.py
`EngineRouter`) over port engines against the JAX package's router
over JAX engines, on the CPU, at the serving tests' tiny size (vocab
61, dim 32, 2 heads, 2 layers, block 4; tests/test_torch_engine_lifecycle.py).

Each scenario is one script of router calls on a virtual clock with
greedy traffic and fixed obs labels, run through both packages with
fresh telemetry: health-gated, load-ranked dispatch with spillover past
bounded queues, failover off a watchdog-tripped engine, rebalance onto
an added engine, drain and removal, prefix affinity with warm-state
migration into a survivor's host tier, and the disaggregated-prefill
handoff. Statuses, finish reasons, tokens, which engine served what,
the router's stats and the WHOLE event stream (kinds, fields and
order) must be EQUAL: the router is a pure function of the call
sequence and the clock, and greedy tokens agree across the frameworks
at this size.
"""

from types import SimpleNamespace

import pytest
import torch

import test_torch_engine_lifecycle as lc
from bigdl_tpu import obs as jobs
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.utils import faults as tfaults

models = lc.models


def fleet_sides(models):
    """lc.sides plus each package's obs and fault plan, and an engine
    maker that takes the scenario's clock and label."""
    out = []
    for s, o, f in zip(lc.sides(models), (jobs, tobs),
                       (jfaults, tfaults)):
        out.append(SimpleNamespace(name=s.name, engine=s.engine, m=s.m,
                                   obs=o, faults=f))
    return out


@pytest.fixture(autouse=True)
def _fresh():
    """Telemetry and fault plans are process-wide in both packages. The
    failover scenarios' step watchdogs run on the wall clock: one
    intra-op thread keeps a tiny CPU decode step from queueing behind
    the other test workers' threads (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for o in (jobs, tobs):
        o.set_enabled(True)
    yield
    torch.set_num_threads(threads)
    for o in (jobs, tobs):
        o.reset_all()
    jfaults.set_plan(None)
    tfaults.set_plan(None)


def _run(s, scenario):
    clk = {"t": 0.0}

    def c():
        return clk["t"]

    s.obs.reset_all(clock=c)
    try:
        out = scenario(s, clk, c)
    finally:
        s.faults.set_plan(None)
    return out, s.obs.get_event_log().events()


def _settle(router, ids, clk, limit=300):
    got = {}
    n = 0
    while any(i not in got for i in ids):
        n += 1
        assert n <= limit, f"stalled: {len(got)}/{len(ids)}"
        clk["t"] += 0.5
        for res in router.step():
            got[res.id] = res
    return [(got[i].id, got[i].status, got[i].finish_reason,
             list(got[i].tokens)) for i in ids]


def _reqs(s, n, base=1, new=4, **kw):
    return [s.m.Request(prompt=[(base + 3 * i + j) % 60 + 1
                                for j in range(3 + i % 3)],
                        max_new_tokens=new, **kw) for i in range(n)]


def sc_dispatch_spillover(s, clk, c):
    e0 = s.engine(obs_label="d0", clock=c, max_queue=1)
    e1 = s.engine(obs_label="d1", clock=c, max_queue=1)
    router = s.m.EngineRouter([e0, e1], clock=c, obs_label="r0")
    ids, refused = [], []
    for r in _reqs(s, 7):
        try:
            ids.append(router.submit(r))
        except s.m.OverloadError:
            refused.append(r.id)
    where = [(e.obs_name, e.queue_depth, e.slots_active)
             for e in router.engines]
    return _settle(router, ids, clk), refused, where, router.stats


def sc_failover(s, clk, c):
    s.faults.set_plan(s.faults.FaultPlan("serve_slow@2"))
    e0 = s.engine(obs_label="f0", clock=c, step_timeout_s=0.2)
    e1 = s.engine(obs_label="f1", clock=c)
    router = s.m.EngineRouter([e0, e1], clock=c, obs_label="r0")
    ids = [router.submit(r) for r in _reqs(s, 6, new=5)]
    res = _settle(router, ids, clk)
    return res, router.stats, e0.health()["state"], e1.stats[
        "requests_done"]


def sc_rebalance_drain(s, clk, c):
    def factory():
        return s.engine(obs_label=f"b{len(made)}", clock=c)

    made = []
    e0 = factory()
    made.append(e0)
    router = s.m.EngineRouter([e0], engine_factory=lambda: made.append(
        factory()) or made[-1], clock=c, obs_label="r0")
    ids = [router.submit(r) for r in _reqs(s, 7, base=11)]
    clk["t"] += 0.5
    router.step()
    e1 = router.add_engine()
    clk["t"] += 0.5
    router.step()                        # the backlog rebalances to e1
    router.drain(e0)
    late = [router.submit(r) for r in _reqs(s, 2, base=30)]
    res = _settle(router, ids + late, clk)
    state = e0.health()["state"]
    removed = router.remove_engine(e0).obs_name
    return (res, router.stats, state, removed,
            [e.obs_name for e in router.engines],
            [e.stats["requests_done"] for e in made])


def sc_affinity_migration(s, clk, c):
    shared = [7, 3, 9, 1, 4, 8, 2, 6]
    kw = dict(clock=c, prefill_buckets=(8, 16), spill=True,
              host_blocks=32)
    e0 = s.engine(obs_label="a0", step_timeout_s=0.2, **kw)
    e1 = s.engine(obs_label="a1", **kw)
    router = s.m.EngineRouter([e0, e1], clock=c, obs_label="ra",
                              affinity=True)
    warm = router.submit(s.m.Request(prompt=shared + [9],
                                     max_new_tokens=3))
    first = _settle(router, [warm], clk)
    s.faults.set_plan(s.faults.FaultPlan(
        f"serve_slow@{e0.stats['decode_steps'] + 2}"))
    ids = [router.submit(s.m.Request(prompt=shared + [10 + i],
                                     max_new_tokens=4))
           for i in range(5)]
    res = _settle(router, ids, clk)
    return (first, res, router.stats, e0.stats["prefix_hits"],
            e1.stats["prefix_hits"], e1.health()["prefix"]["readmitted"])


def sc_handoff(s, clk, c):
    pf = s.engine(role="prefill", obs_label="pf0", clock=c,
                  prefill_buckets=(8, 16))
    e0 = s.engine(obs_label="h0", clock=c, prefill_buckets=(8, 16))
    e1 = s.engine(obs_label="h1", clock=c, prefill_buckets=(8, 16))
    router = s.m.EngineRouter([e0, e1], prefill_engines=[pf],
                              handoff_len=8, clock=c, obs_label="r0")
    longs = [s.m.Request(prompt=[(7 * i + j) % 40 + 1 for j in range(9)],
                         max_new_tokens=4) for i in range(3)]
    ids = [router.submit(r) for r in longs + _reqs(s, 2, base=41)]
    res = _settle(router, ids, clk)
    return (res, router.stats, pf.stats["handoffs_out"],
            e0.stats["handoffs_in"] + e1.stats["handoffs_in"])


@pytest.mark.parametrize("scenario", [
    sc_dispatch_spillover, sc_failover, sc_rebalance_drain,
    sc_affinity_migration, sc_handoff], ids=lambda f: f.__name__[3:])
def test_router_scenario_matches_the_reference(models, scenario):
    (want, want_ev), (got, got_ev) = (_run(s, scenario)
                                      for s in fleet_sides(models))
    assert got == want
    assert [e["kind"] for e in got_ev] == [e["kind"] for e in want_ev]
    assert got_ev == want_ev
    results = got[0] if scenario is not sc_affinity_migration else got[1]
    assert all(r[1] == "done" for r in results)
    kinds = {e["kind"] for e in got_ev}
    expect = {"sc_failover": "router_failover",
              "sc_affinity_migration": "prefix_migrate",
              "sc_handoff": "handoff_import",
              "sc_rebalance_drain": "engine_drain"}.get(scenario.__name__)
    assert expect is None or expect in kinds
