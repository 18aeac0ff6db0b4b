"""The port's tenancy controller and autoscaler
(bigdl_tpu_torch/serving/tenancy.py, autoscaler.py) against the JAX
package's, on the CPU, at the serving tests' tiny size
(tests/test_torch_engine_lifecycle.py), each over its own package's
router and engines on one virtual clock, with greedy traffic.

* Tenancy: token-bucket throttling (a flood shed past `max_pending`),
  weighted-fair release order across three tenants, and per-tenant KV
  quotas on the engine (tests/test_torch_fleet_drills.py re-enacts the
  tenant_noisy drill's deferrals); the release order, every throttle
  event, per-tenant stats, statuses and tokens must be EQUAL.
* Autoscaler: a burst against a one-engine pool with `max_engines=3`
  scales up twice, flips the overload policy at the ceiling while the
  SLO burns, and drains back down as the burst ends; the
  decision records (actions, engines, windowed p99s, backlog) and the
  event stream must be EQUAL.
"""

import pytest

import test_torch_engine_lifecycle as lc
import test_torch_router as tr

models = lc.models
_fresh = tr._fresh


def _order(router, ids, clk, limit=400):
    got, order, n = {}, [], 0
    while any(i not in got for i in ids):
        n += 1
        assert n <= limit, f"stalled: {len(got)}/{len(ids)}"
        clk["t"] += 0.5
        for res in router.step():
            got[res.id] = res
            order.append(res.id)
    return got, order


def sc_tenancy(s, clk, c):
    ctl = s.m.TenancyController(
        [s.m.TenantSpec("gold", weight=3.0, bucket_capacity=8.0,
                        refill_rate=2.0),
         s.m.TenantSpec("silver", weight=1.0, bucket_capacity=6.0,
                        refill_rate=1.0),
         s.m.TenantSpec("noisy", weight=1.0, bucket_capacity=2.0,
                        refill_rate=0.25, max_pending=4)],
        clock=c)
    e0 = s.engine(obs_label="t0", clock=c, slots=3,
                  prefill_buckets=(8, 16),
                  tenant_kv_quotas={"silver": 4})
    router = s.m.EngineRouter([e0], clock=c, obs_label="r0", tenancy=ctl)
    reqs = []
    for i in range(12):
        tenant = ("gold", "silver", "noisy")[i % 3]
        n = 9 if tenant == "silver" else 3 + i % 3
        reqs.append(s.m.Request(prompt=[(5 * i + j) % 60 + 1
                                        for j in range(n)],
                                max_new_tokens=3, tenant=tenant))
    ids = [router.submit(r) for r in reqs]
    for _ in range(2):
        clk["t"] += 0.5
        router.step()
    ids += [router.submit(s.m.Request(prompt=[i + 1, i + 2],
                                      max_new_tokens=2, tenant="noisy"))
            for i in range(6)]
    got, order = _order(router, ids, clk)
    return ([(got[i].status, got[i].finish_reason, list(got[i].tokens))
             for i in ids], order,
            {t: ctl.stats(t) for t in ctl.tenants}, ctl.health(),
            router.stats, e0.stats["requests_done"])


def sc_autoscale(s, clk, c):
    def factory():
        return s.engine(obs_label=f"s{len(router.engines)}", clock=c,
                        slots=2, overload_policy="shed-oldest")

    router = s.m.EngineRouter([s.engine(obs_label="s0", clock=c,
                                        slots=2)],
                              engine_factory=factory, clock=c,
                              obs_label="r0")
    asc = s.m.Autoscaler(router, target_p99_s=2.0, max_engines=3,
                         evaluate_every_s=0.5, backlog_high=2.0,
                         occupancy_low=0.3)
    ids = [router.submit(s.m.Request(prompt=[(3 * i + j) % 60 + 1
                                             for j in range(3)],
                                     max_new_tokens=4, priority=i % 2))
           for i in range(24)]
    got, n = {}, 0
    while any(i not in got for i in ids) or n < 60:
        n += 1
        assert n <= 400
        clk["t"] += 0.5
        for res in router.step():
            got[res.id] = res
        asc.observe()
    return ([(got[i].status, got[i].finish_reason, list(got[i].tokens))
             for i in ids], asc.decisions,
            [e.obs_name for e in router.engines], router.stats)


@pytest.mark.parametrize("scenario", [sc_tenancy, sc_autoscale],
                         ids=lambda f: f.__name__[3:])
def test_fleet_control_matches_the_reference(models, scenario):
    (want, want_ev), (got, got_ev) = (tr._run(s, scenario)
                                      for s in tr.fleet_sides(models))
    assert got == want
    assert got_ev == want_ev
    kinds = {e["kind"] for e in got_ev}
    if scenario is sc_tenancy:
        results, order, stats = got[0], got[1], got[2]
        actions = {(e["tenant"], e["action"]) for e in got_ev
                   if e["kind"] == "tenant_throttled"}
        assert ("noisy", "shed") in actions
        assert ("silver", "kv_quota") in actions
        assert stats["noisy"]["shed"] > 0 and stats["gold"]["shed"] == 0
        assert {r[0] for r in results} == {"done", "shed"}
    else:
        actions = [d["action"] for d in got[1]]
        assert actions[:2] == ["scale_up", "scale_up"]
        assert {"shed_mode", "drain", "scale_down"} <= set(actions)
        assert {"autoscale_decision", "engine_added"} <= kinds
