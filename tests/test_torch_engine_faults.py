"""The port's serving fault handling (bigdl_tpu_torch/serving/engine.py:
poison isolation under `serve_nan`, step retries under `serve_err`, the
step watchdog under `serve_slow`, degradation, drain) against the JAX
package's InferenceEngine on the same fault plans, on the CPU, at the
tiny size of tests/test_torch_engine_lifecycle.py.

Statuses, greedy tokens and the retries / watchdog_trips / failed
counters must be EQUAL across the engines; inside the port, the tokens
of the requests a fault spares must equal a clean run's bit for bit.
The watchdog leg uses a real 0.2 s budget with `serve_slow` sleeping 5x
it; no assertion reads the wall clock. The fault plans are
process-global: every test leaves both packages' plans unset."""

import threading

import pytest

import test_torch_engine_lifecycle as lc
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch.serving import engine as tengine
from bigdl_tpu_torch.utils import faults as tfaults

models = lc.models
WATCHDOG_S = 0.2


@pytest.fixture(autouse=True)
def _no_plan():
    jfaults.set_plan(None)
    tfaults.set_plan(None)
    try:
        yield
    finally:
        jfaults.set_plan(None)
        tfaults.set_plan(None)


def _wave(s):
    return [s.m.Request(prompt=p, max_new_tokens=5)
            for p in ([1, 2, 3], [7, 3, 9, 4], [5, 6], [11, 12, 13, 14])]


def _run(s, spec, **kw):
    """One wave through a fresh engine under the fault plan `spec`."""
    plan = (jfaults if s.name == "jax" else tfaults)
    plan.set_plan(plan.FaultPlan(spec))
    try:
        eng = s.engine(retry_backoff_s=0.0, **kw)
        out = eng.run(_wave(s))
    finally:
        plan.set_plan(None)
    return eng, [(r.status, r.finish_reason, list(r.tokens))
                 for r in out]


def _join_abandoned_steps():
    """Wait for watchdog workers a trip abandoned (they sleep out the
    injected hang, then launch nothing)."""
    for th in threading.enumerate():
        if th.name == "bigdl-serving-step":
            th.join(10.0)


COUNTERS = ("retries", "watchdog_trips", "failed", "poisoned",
            "requests_done", "decode_steps")


@pytest.mark.parametrize("spec, kw", [
    ("serve_nan@2", {}),
    ("serve_err@1", dict(step_retries=1)),
    ("serve_err@1x2", dict(step_retries=1)),
    ("serve_slow@1", dict(step_timeout_s=WATCHDOG_S))],
    ids=["poison", "retry", "retries_exhausted", "watchdog"])
def test_fault_plan_equals_jax(models, spec, kw):
    jx, pt = lc.sides(models)
    jeng, ref = _run(jx, spec, **kw)
    teng, got = _run(pt, spec, **kw)
    _join_abandoned_steps()
    assert got == ref
    assert [teng.stats[k] for k in COUNTERS] \
        == [jeng.stats[k] for k in COUNTERS]
    assert (teng.degraded is None) == (jeng.degraded is None)
    assert teng.health()["state"] == jeng.health()["state"]


def test_poison_spares_its_cobatch_bitwise(models):
    _, pt = lc.sides(models)
    _, clean = _run(pt, "")
    eng, got = _run(pt, "serve_nan@2")
    assert got[0][:2] == ("poisoned", "poisoned")
    assert got[0][2] == clean[0][2][:2]          # tokens before step 2
    assert got[1:] == clean[1:]
    assert eng.stats["poisoned"] == 1


def test_retry_and_degrade_statuses(models):
    _, pt = lc.sides(models)
    _, clean = _run(pt, "")
    eng, got = _run(pt, "serve_err@1", step_retries=1)
    assert eng.stats["retries"] == 1 and got == clean
    eng, got = _run(pt, "serve_err@1x2", step_retries=1)
    assert eng.degraded and "2 attempt(s)" in eng.degraded
    assert {st for st, _, _ in got} == {"failed"}
    assert eng.health()["state"] == "degraded"
    with pytest.raises(tengine.EngineDegraded):
        eng.submit(pt.m.Request(prompt=[1, 2]))
    assert eng.step() == []


def test_watchdog_trip_degrades_after_warm_construction(models):
    """Arming the watchdog runs one decode step in the constructor (the
    kernel's first-use build must never trip it): one model call, no
    decode step counted; then serve_slow trips it exactly once."""
    _, pt = lc.sides(models)
    tm = models[2]
    calls = []
    real = tm.decode_step_paged

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tm.decode_step_paged = counted
    try:
        eng = pt.engine(step_timeout_s=WATCHDOG_S)
        assert len(calls) == 1 and eng.stats["decode_steps"] == 0
        tfaults.set_plan(tfaults.FaultPlan("serve_slow@2"))
        out = eng.run(_wave(pt))
    finally:
        del tm.decode_step_paged
        tfaults.set_plan(None)
    _join_abandoned_steps()
    assert eng.stats["watchdog_trips"] == 1
    assert eng.stats["decode_steps"] == 2
    assert [r.status for r in out] == ["failed"] * 4
    assert [len(r.tokens) for r in out[:2]] == [2, 2]
    h = eng.health()
    assert h["state"] == "degraded" and "watchdog" in h["degraded_reason"]
    assert len(calls) == 3           # the abandoned step launched nothing
    with pytest.raises(tengine.EngineDegraded):
        eng.submit(pt.m.Request(prompt=[1, 2]))


def _flaky(tm, fail_at, message):
    """Make the model's decode step raise `message` at its call
    `fail_at` AFTER writing the step's k/v into the pools in place."""
    real = tm.decode_step_paged
    n = [0]

    def step(*a, **k):
        out = real(*a, **k)
        n[0] += 1
        if n[0] == fail_at:
            raise RuntimeError(message)
        return out

    tm.decode_step_paged = step


def test_python_error_after_in_place_writes_is_retried(models):
    """The port's pools are written in place: a step that fails after
    its writes is retried, rewriting the same k/v at the same clocks,
    and the tokens equal the clean run's bit for bit."""
    _, pt = lc.sides(models)
    tm = models[2]
    _, clean = _run(pt, "")
    _flaky(tm, 3, "transient host error")
    try:
        eng, got = _run(pt, "", step_retries=1)
    finally:
        del tm.decode_step_paged
    assert eng.stats["retries"] == 1 and eng.degraded is None
    assert got == clean


def test_cuda_error_is_never_retried(models):
    """A CUDA error is sticky: the engine degrades at once with the
    real cause and keeps its retry budget."""
    _, pt = lc.sides(models)
    tm = models[2]
    _flaky(tm, 2, "CUDA error: an illegal memory access was encountered")
    try:
        eng, got = _run(pt, "", step_retries=3)
    finally:
        del tm.decode_step_paged
    assert eng.stats["retries"] == 0
    assert "not retryable" in eng.degraded
    assert {st for st, _, _ in got} == {"failed"}


def test_drain_mid_wave_like_jax(models):
    """drain() mid-wave: queued and in-flight requests finish 'done',
    submit raises EngineDraining, the state goes draining → drained."""
    out = []
    for s in lc.sides(models):
        eng = s.engine()
        ids = [eng.submit(r) for r in _wave(s)]
        eng.step()                        # two decoding, two queued
        eng.drain()
        eng.drain()                       # idempotent
        assert eng.draining and eng.health()["state"] == "draining"
        with pytest.raises(s.m.EngineDraining):
            eng.submit(s.m.Request(prompt=[1, 2]))
        lc.drain(eng)
        assert eng.health()["state"] == "drained"
        res = [eng.completed.pop(i) for i in ids]
        assert [r.status for r in res] == ["done"] * 4
        out.append([(r.status, r.tokens) for r in res])
    assert out[1] == out[0]


def test_health_reports_decode_percentiles(models):
    _, pt = lc.sides(models)
    ticks = iter(range(10**6))
    eng = pt.engine(clock=lambda: next(ticks) * 1e-3)
    eng.run(_wave(pt))
    m = eng.health()["metrics"]["decode_step_seconds"]
    assert m["count"] == eng.stats["decode_steps"] > 0
    assert 0 < m["p50_ms"] <= m["p95_ms"] <= m["p99_ms"]
    assert eng.health()["metrics"]["requests_total"]["done"] == 4


def test_quiesce_degrades_without_touching_requests(models):
    """quiesce() refuses further work and reports 'degraded' while the
    seated requests stay where they are (no terminal status); it is
    idempotent and counts a watchdog trip only when told to."""
    out = []
    for s in lc.sides(models):
        eng = s.engine()
        for r in _wave(s):
            eng.submit(r)
        eng.step()
        eng.quiesce("draft dispatch hung", watchdog=True)
        eng.quiesce("again", watchdog=True)
        assert eng.degraded == "draft dispatch hung"
        assert eng.step() == [] and eng.slots_active == 2
        assert eng.queue_depth == 2 and not eng.completed
        with pytest.raises(s.m.EngineDegraded):
            eng.submit(s.m.Request(prompt=[1, 2]))
        out.append((eng.health()["state"], eng.stats["watchdog_trips"],
                    eng.stats["failed"]))
    assert out[1] == out[0] == ("degraded", 1, 0)
