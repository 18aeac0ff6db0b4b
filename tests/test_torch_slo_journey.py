"""The port's live telemetry layer (bigdl_tpu_torch/obs/: slo,
exposition, journey, flightrecorder) against the JAX package's, on the
CPU.

Each scenario is one script of calls, run through both packages on
the same injected clock: the SLO objectives' measurements and the
alert rules' transitions (threshold with a pending duration, burn
rate, absence, flap suppression), `ScrapeServer`'s three routes
(`/metrics` serves `render_prometheus()`'s bytes; `/health` and
`/alerts` JSON), `build_journeys`/`summarize_journeys`/`to_perfetto`
over one event list, and the flight recorder's bundle files. All of
it is host-side strings and numbers: EQUAL, byte for byte.
"""

import json
import os
import urllib.request

import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu_torch import obs as tobs

PKGS = (jobs, tobs)


@pytest.fixture(autouse=True)
def _fresh():
    prev = [o.set_enabled(True) for o in PKGS]
    for o in PKGS:
        o.reset_all()
    yield
    for o, p in zip(PKGS, prev):
        o.reset_all()
        o.set_enabled(p)


def _bundle_bytes(outdir):
    out = {}
    for root, _, files in os.walk(outdir):
        for f in sorted(files):
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, outdir)] = fh.read()
    return out


# ------------------------------------------------------------------ SLO
def _slo_script(o, outdir):
    """A router-shaped latency histogram and a terminal-status counter
    on a virtual clock: a burn phase, a recovery phase, then silence.
    Four rules watch it; a flight recorder dumps on the firing."""
    clk = {"t": 0.0}

    def c():
        return clk["t"]

    o.reset_all(clock=c)
    reg = o.get_registry()
    lat = reg.histogram("router_request_latency_seconds",
                        labelnames=("router",),
                        buckets=(0.5, 1.0, 2.0, 4.0, 8.0, 16.0))
    req = reg.counter("serving_requests_total",
                      labelnames=("engine", "status", "tp"))
    sampler = o.MetricsSampler(interval_s=0.5, capacity=256, clock=c)
    p99 = o.SLOObjective(name="p99", kind="latency_quantile",
                         metric="router_request_latency_seconds",
                         target=2.0, q=0.99, labels={"router": "r0"})
    budget = o.SLOObjective(name="goodput", kind="error_budget",
                            metric="serving_requests_total", target=0.2)
    rules = [o.AlertRule(name="p99_burn", objective=p99, kind="burn_rate",
                         long_window_s=4.0, short_window_s=1.0,
                         clear_s=2.0),
             o.AlertRule(name="p99_hold", objective=p99, window_s=2.0,
                         for_s=1.0),
             o.AlertRule(name="budget", objective=budget, window_s=3.0),
             o.AlertRule(name="silent", objective=budget, kind="absence",
                         window_s=2.0, for_s=0.5)]
    aeng = o.AlertEngine(sampler, rules, clock=c)
    rec = o.FlightRecorder(str(outdir), clock=c)
    rec.install()
    trace = []
    for step in range(60):
        clk["t"] += 0.5
        if step < 16:                       # burn: slow, some failures
            lat.labels(router="r0").observe(3.0 + 0.1 * step)
            req.labels(engine="e0", status="failed" if step % 3 == 0
                       else "done", tp="1").inc()
        elif step < 40:                     # recovery: fast, all done
            lat.labels(router="r0").observe(0.3)
            req.labels(engine="e0", status="done", tp="1").inc()
        sampler.tick()
        trace.append(aeng.evaluate())
    rec.close()
    log = o.get_event_log()
    return (trace, aeng.alerts(), aeng.firing(), aeng.compliance(),
            aeng.compliance(4.0),
            [r.evaluate(sampler, 4.0) for r in (p99, budget)],
            log.events("alert_firing"), log.events("alert_resolved"),
            rec.bundles, _bundle_bytes(outdir))


def test_slo_transitions_and_slo_burn_bundle_equal(tmp_path):
    want, got = (_slo_script(o, tmp_path / o.__name__) for o in PKGS)
    assert got == want
    firing = [e["alert"] for e in got[6]]
    resolved = [e["alert"] for e in got[7]]
    assert {"p99_burn", "p99_hold", "budget", "silent"} <= set(firing)
    assert {"p99_burn", "p99_hold", "budget"} <= set(resolved)
    assert got[8] and got[8][0].endswith("slo_burn")


def test_slo_knob_validation_equal():
    def script(o):
        errs = []
        for bad in (
                lambda: o.SLOObjective(name="x", kind="nope", metric="m",
                                       target=1.0),
                lambda: o.SLOObjective(name="x", kind="error_budget",
                                       metric="m", target=-1.0),
                lambda: o.SLOObjective(name="x", kind="latency_quantile",
                                       metric="m", target=1.0, q=0.0),
                lambda: o.AlertRule(name="r", objective=None, kind="nope"),
                lambda: o.AlertRule(name="r", objective=None,
                                    kind="burn_rate", long_window_s=1.0,
                                    short_window_s=2.0),
                lambda: o.AlertRule(name="r", objective=None, for_s=-1)):
            try:
                bad()
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        return errs

    want, got = (script(o) for o in PKGS)
    assert got == want and None not in got


# ------------------------------------------------------------ exposition
def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _scrape_script(o):
    clk = {"t": 0.0}
    o.reset_all(clock=lambda: clk["t"])
    reg = o.get_registry()
    reg.counter("serving_requests_total",
                labelnames=("engine", "status", "tp")).labels(
                    engine="e0", status="done", tp="1").inc(3)
    h = reg.histogram("router_request_latency_seconds",
                      labelnames=("router",), buckets=(1.0, 2.0))
    sampler = o.MetricsSampler(interval_s=0.5, clock=lambda: clk["t"])
    obj = o.SLOObjective(name="p99", kind="latency_quantile",
                         metric="router_request_latency_seconds",
                         target=1.0, labels={"router": "r0"})
    aeng = o.AlertEngine(sampler, [o.AlertRule(name="p99", objective=obj,
                                               window_s=2.0)],
                         clock=lambda: clk["t"])
    for _ in range(4):
        clk["t"] += 0.5
        h.labels(router="r0").observe(1.5)
        sampler.tick()
        aeng.evaluate()
    srv = o.ScrapeServer(sampler=sampler, alert_engine=aeng)
    port = srv.start()
    try:
        metrics = _get(port, "/metrics")
        health = _get(port, "/health")
        alerts = _get(port, "/alerts")
        try:
            _get(port, "/nope")
            missing = None
        except urllib.error.HTTPError as e:
            missing = e.code
        text = reg.render_prometheus().encode()
        return (metrics, json.loads(health[2]), health[:2],
                json.loads(alerts[2]), alerts[:2], missing,
                metrics[2] == text, srv.health_view(), srv.alerts_view())
    finally:
        srv.close()


def test_scrape_server_routes_equal():
    want, got = (_scrape_script(o) for o in PKGS)
    assert got == want
    assert got[0][0] == 200 and got[6] is True and got[5] == 404
    assert got[3]["alerts"][0]["state"] == "firing"


# --------------------------------------------------------------- journey
def _journey_events():
    """A request handed off from a prefill engine, a failover hop, a
    rebalance, a shed-on-arrival and a request whose hop never seated."""
    ev = []

    def e(kind, **f):
        ev.append({"schema": 1, "ts": 0.5 * len(ev), "seq": len(ev),
                   "kind": kind, **f})

    e("request_submit", plane="serving", engine="pf0", request=0,
      prompt_len=8, priority=0, tp=1, role="prefill", trace="r0/0", hop=0)
    e("handoff_export", plane="serving", engine="pf0", request=0,
      prompt_len=8, blocks=2, trace="r0/0", hop=0)
    e("handoff_import", plane="serving", engine="e0", request=0,
      prompt_len=8, blocks=2, source="pf0", tp=2, role="decode",
      trace="r0/0", hop=1)
    e("request_submit", plane="serving", engine="e0", request=1,
      prompt_len=3, priority=0, tp=2, role="both", trace="r0/1", hop=0)
    e("engine_degraded", plane="serving", engine="e0",
      reason="watchdog trip at decode step 2")
    for r, hop in ((0, 1), (1, 0)):
        e("request_terminal", plane="serving", engine="e0", request=r,
          status="failed", reason="failed", tokens=1, ttft_s=1.0,
          latency_s=2.0, tp=2, role="both", trace=f"r0/{r}", hop=hop)
        e("router_failover", plane="serving", router="r0", request=r,
          source="e0", target="e1", trace=f"r0/{r}", hop=hop + 1)
        e("request_submit", plane="serving", engine="e1", request=r,
          prompt_len=3, priority=0, tp=1, role="both", trace=f"r0/{r}",
          hop=hop + 1)
    e("request_submit", plane="serving", engine="e1", request=2,
      prompt_len=3, priority=0, tp=1, role="both", trace="r0/2", hop=0)
    e("router_rebalance", plane="serving", router="r0", request=2,
      source="e1", target="e2", trace="r0/2", hop=1)
    e("request_submit", plane="serving", engine="e2", request=2,
      prompt_len=3, priority=0, tp=1, role="both", trace="r0/2", hop=1)
    e("request_terminal", plane="serving", engine="e0", request=3,
      status="shed", reason="shed", tokens=0, ttft_s=None,
      latency_s=0.0, tp=1, role="both", trace="r0/3", hop=0)
    e("request_terminal", plane="serving", engine="e1", request=4,
      status="done", reason="max_tokens", tokens=2, ttft_s=1.0,
      latency_s=1.5, tp=1, role="both", trace="r0/4", hop=2)
    for r, hop in ((0, 2), (1, 1), (2, 1)):
        e("request_terminal", plane="serving", engine=f"e{1 + (r == 2)}",
          request=r, status="done", reason="max_tokens", tokens=4,
          ttft_s=1.0, latency_s=5.0, tp=1, role="both",
          trace=f"r0/{r}", hop=hop)
    return ev


def test_journeys_equal():
    ev = _journey_events()
    want, got = ((o.build_journeys(ev),
                  o.summarize_journeys(o.build_journeys(ev)),
                  o.journeys_json(o.build_journeys(ev)),
                  o.to_perfetto(o.build_journeys(ev))) for o in PKGS)
    assert got == want
    summary = got[1]
    assert summary["count"] == 5 and summary["lost_hops"] >= 1
    assert summary["cross_engine"] >= 2


# -------------------------------------------------------- flight recorder
def _recorder_script(o, outdir):
    clk = {"t": 0.0}

    def c():
        return clk["t"]

    o.reset_all(clock=c)
    reg = o.get_registry()
    reg.counter("serving_decode_steps_total", labelnames=("engine", "tp")
                ).labels(engine="e0", tp="1").inc(2)
    rec = o.FlightRecorder(str(outdir), capacity=8, per_component=3,
                           max_bundles=2, clock=c)
    rec.register_health_source("e0", lambda: {"state": "degraded",
                                              "t": clk["t"]})
    rec.install()
    for ev in _journey_events():
        clk["t"] += 0.25
        if ev["kind"] == "engine_degraded":
            reg.counter("serving_decode_steps_total",
                        labelnames=("engine", "tp")).labels(
                            engine="e0", tp="1").inc()
        fields = {k: v for k, v in ev.items()
                  if k not in ("schema", "ts", "seq", "kind")}
        o.emit_event(ev["kind"], **fields)
    o.emit_event("request_terminal", plane="serving", engine="e1",
                 request=9, status="poisoned", reason="poisoned",
                 tokens=0, ttft_s=None, latency_s=1.0, tp=1, role="both")
    o.emit_event("fault_injected", fault="preempt", step=3)
    rec.close()
    o.emit_event("engine_degraded", plane="serving", engine="e5",
                 reason="after close")
    return (rec.bundles, _bundle_bytes(outdir),
            [o.default_trigger(r) for r in o.get_event_log().events()],
            o.get_event_log().counts_by_kind())


def test_flight_recorder_bundles_equal(tmp_path):
    want, got = (_recorder_script(o, tmp_path / o.__name__)
                 for o in PKGS)
    assert got == want
    bundles, files = got[0], got[1]
    assert len(bundles) == 2 and bundles[0].endswith("engine_degraded")
    assert any(k.endswith("manifest.json") for k in files)
