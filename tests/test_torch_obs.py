"""The port's telemetry plane (bigdl_tpu_torch/obs/: registry, events,
spans, timeseries and the package's switches) against the JAX
package's (bigdl_tpu/obs/), on the CPU.

Every scenario is one script of calls run through both packages on the
same injected clock; its outputs — `snapshot()` JSON, Prometheus text,
JSONL records (in the ring and on disk), Chrome-trace JSON, windowed
quantiles, rates and deltas, `provenance()` — are host-side strings
and numbers, so they must be EQUAL. The span tracer's mirror into a
`torch.profiler` capture is the port's own (the JAX tracer enters
`jax.profiler.TraceAnnotation`) and is checked on the port alone.
"""

import json

import numpy as np
import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu_torch import obs as tobs

PKGS = (jobs, tobs)


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' registry, event log and tracer are process-wide:
    fresh ones for the test, fresh defaults after it."""
    prev = [o.set_enabled(True) for o in PKGS]
    for o in PKGS:
        o.reset_all()
    yield
    for o, p in zip(PKGS, prev):
        o.reset_all()
        o.set_enabled(p)


def both(script, *args):
    """(JAX's outputs, the port's) of `script(obs_package, *args)`."""
    return tuple(script(o, *args) for o in PKGS)


# ------------------------------------------------------------- registry
def _registry_script(o):
    reg = o.set_registry(o.MetricsRegistry(clock=lambda: 7.0))
    c = reg.counter("req_total", "requests", ("status",))
    c.labels(status="shed").inc()
    c.labels(status="done").inc(3)
    reg.counter("plain_total", "no labels").inc(2.5)
    g = reg.gauge("depth", "queue depth")
    g.set(4)
    g.inc(2)
    g.dec(0.5)
    h = reg.histogram("lat_seconds", "latency", ("engine",))
    for i, v in enumerate((0.011, 0.4, 0.002, 0.011, 20.0, 1e-5)):
        h.labels(engine=f"e{i % 2}").observe(v)
    custom = reg.histogram("frac", buckets=tuple(i / 20 for i in range(21)))
    for v in np.linspace(0, 1, 37):
        custom.observe(float(v))
    errors = []
    for bad in (lambda: reg.gauge("req_total"),
                lambda: reg.counter("req_total", "x", ("other",)),
                lambda: reg.histogram("frac", buckets=(1.0, 3.0)),
                lambda: reg.counter("b_total").inc(-1),
                lambda: c.labels(wrong="v"),
                lambda: custom.quantile(1.5)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    qs = [custom.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    qs += [h.labels(engine="e0").quantile(q) for q in (0.5, 0.99)]
    qs += [reg.histogram("empty").quantile(0.5)]
    return (reg.to_json(), reg.render_prometheus(), errors, qs,
            reg.get("depth").value, reg.get("req_total").value,
            o.registry.series_key("x", {"b": "2", "a": "1"}),
            o.registry.quantile_from_buckets((1.0, 2.0), [1, 1, 2], 0.75))


def test_registry_snapshot_prometheus_and_quantiles_equal():
    want, got = both(_registry_script)
    assert got == want
    assert json.loads(got[0])["ts"] == 7.0


def test_provenance_and_metrics_snapshot_event():
    def script(o):
        o.reset_all(clock=lambda: 3.0)
        reg = o.get_registry()
        reg.counter("serving_x_total", labelnames=("engine",)).labels(
            engine="e0").inc(5)
        reg.histogram("serving_lat_seconds").observe(0.25)
        reg.gauge("other").set(1)
        rec = o.log_metrics_snapshot(run="r1")
        off = o.set_enabled(False)
        none = (o.emit_event("tick"), o.log_metrics_snapshot())
        o.set_enabled(off)
        return (o.provenance("serving_"), o.provenance(), rec, none,
                o.get_event_log().counts_by_kind())

    want, got = both(script)
    assert got == want
    assert got[3] == (None, None)


# ------------------------------------------------------------ event log
def _events_script(o, path):
    log = o.set_event_log(o.EventLog(capacity=4, path=str(path),
                                     clock=lambda: 9.0))
    for i in range(6):
        o.emit_event("tick", i=i, arr=np.int64(i), f=np.float32(0.5))
    o.emit_event("request_submit", plane="serving", engine="e0",
                 request=1, prompt_len=3, priority=0, tp=1,
                 role="both", trace="e0/1", hop=0)
    ring = log.events()
    picked = (log.events("tick", i=5), log.events("other"),
              log.counts_by_kind(), len(log))
    log.close()
    with open(path, "a") as f:
        f.write('{"schema": 1, "kind": "to')       # torn tail
    ondisk = o.read_jsonl(str(path))
    mod = o.events
    checks = [mod.validate_record(r) for r in (
        {"schema": 1, "ts": 0, "seq": 0, "kind": "request_submit"},
        {"schema": 2, "ts": 0, "seq": 0, "kind": "nope"},
        ondisk[-1])]
    return (ring, picked, ondisk, checks, mod.seat_kinds(),
            mod.required_fields("request_terminal"),
            {k: (v["required"], v["optional"])
             for k, v in mod.EVENT_KINDS.items()},
            mod.SCHEMA_VERSION)


def test_event_records_ring_jsonl_and_kind_registry_equal(tmp_path):
    want, got = (_events_script(o, tmp_path / f"{o.__name__}.jsonl")
                 for o in PKGS)
    assert got == want
    ring, (last, other, counts, n) = got[0], got[1]
    assert n == 4 and [e["seq"] for e in ring] == [3, 4, 5, 6]
    assert len(got[2]) == 7 and last[0]["i"] == 5


def test_listeners_and_the_switch(tmp_path):
    def script(o):
        log = o.set_event_log(o.EventLog(clock=lambda: 1.0))
        seen = []
        log.add_listener(seen.append)
        o.emit_event("a", x=1)
        o.set_enabled(False)
        o.emit_event("b")
        o.set_enabled(True)
        log.remove_listener(seen.append)
        o.emit_event("c")
        return seen, log.counts_by_kind(), o.enabled()

    assert both(script)[1] == both(script)[0]


# ---------------------------------------------------------------- spans
def _spans_script(o):
    clk = {"t": 1.0}
    tr = o.set_tracer(o.SpanTracer(clock=lambda: clk["t"], enabled=True,
                                   pid=7))
    with tr.span("outer", "serving", args={"request": 3}):
        clk["t"] += 0.25
        with tr.span("inner"):
            clk["t"] += 0.5
    tr.instant("poisoned", "serving", args={"slot": 0})
    tr.complete("decode_step", "serving", 2.0, 2.125, args={"step": 1})
    o.set_enabled(False)
    tr.complete("dropped", "serving", 0.0, 1.0)
    o.set_enabled(True)
    off = o.SpanTracer(clock=lambda: 0.0)
    with off.span("never"):
        pass
    trace = tr.to_chrome_trace()
    for e in trace["traceEvents"]:
        e.pop("tid")                 # the thread id is the process's own
    return trace, [e["name"] for e in tr.events("inner")], off.events()


def test_span_chrome_trace_equal():
    want, got = both(_spans_script)
    assert got == want
    names = [e["name"] for e in got[0]["traceEvents"]]
    assert names == ["inner", "outer", "poisoned", "decode_step"]


def test_spans_enter_a_profiler_capture_only_while_one_runs(tmp_path):
    """The port's tracer mirrors a span into a running
    `utils/profiler.trace()` capture as a `record_function` range (the
    JAX tracer's TraceAnnotation), and enters nothing outside one."""
    import torch
    from torch.autograd import profiler as autograd_profiler

    from bigdl_tpu_torch.utils import profiler

    tr = tobs.set_tracer(tobs.SpanTracer(enabled=True))
    entered = []
    real = autograd_profiler.record_function.__enter__

    def spy(self):
        entered.append(self.name)
        return real(self)

    autograd_profiler.record_function.__enter__ = spy
    try:
        with tr.span("outside"):
            torch.ones(2).sum()
        assert not profiler.capturing()
        with profiler.trace(str(tmp_path)):
            assert profiler.capturing()
            with tr.span("inside"):
                torch.ones(2).sum()
        assert not profiler.capturing()
    finally:
        autograd_profiler.record_function.__enter__ = real
    assert "inside" in entered and "outside" not in entered
    assert [e["name"] for e in tr.events()] == ["outside", "inside"]
    assert getattr(tr._ann, "stack", []) == []


# ----------------------------------------------------------- timeseries
def _timeseries_script(o):
    clk = {"t": 0.0}
    reg = o.set_registry(o.MetricsRegistry(clock=lambda: clk["t"]))
    lat = reg.histogram("router_request_latency_seconds",
                        labelnames=("router",),
                        buckets=(0.5, 1.0, 2.0, 4.0, 8.0))
    done = reg.counter("done_total", labelnames=("router",))
    sampler = o.MetricsSampler(registry=reg, interval_s=0.5, capacity=16,
                               clock=lambda: clk["t"])
    win = o.HistogramWindow(lat.labels(router="r0"))
    out = []
    for step in range(24):
        clk["t"] += 0.25
        for v in ((0.3, 3.0) if step < 12 else (0.2,)):
            lat.labels(router="r0").observe(v + 0.01 * step)
        done.labels(router="r0").inc()
        out.append(sampler.tick() is not None)
        if step % 5 == 4:
            out.append(win.quantile(0.99))
    ts = o.timeseries
    return (out, len(sampler.samples()), sampler.latest(),
            sampler.span(2.0),
            sampler.delta("done_total", labels={"router": "r0"},
                          window_s=2.0),
            sampler.rate("done_total", labels={"router": "r0"},
                         window_s=3.0),
            sampler.window_quantile("router_request_latency_seconds", 0.99,
                                    labels={"router": "r0"},
                                    window_s=2.0),
            sampler.window_quantile("router_request_latency_seconds", 0.5),
            sampler.series_deltas("done_total", window_s=1.0),
            ts.counts_delta([3, 5, 9], [1, 5, 2]),
            ts.delta_quantile((1.0, 2.0), [0, 4, 8], [0, 1, 2], 0.9))


def test_timeseries_windows_equal():
    want, got = both(_timeseries_script)
    assert got == want
    assert got[4] is not None and got[5] is not None
