"""Scenario compiler for the serving fleet.

Ports bigdl_tpu/serving/scenarios.py, a host-side module, copied (the
port imports nothing of the JAX package). One arrival process is not
fleet traffic: real traffic is a composition — a diurnal curve under
everything, a flash crowd at the worst moment, agentic multi-turn
sessions with tool-call gaps, tenants with different appetites, a
regional wave failing over into the surviving region — plus the
faults. This module compiles a declarative scenario (a JSON file or a
built-in name) down to the trace dict a replay loop consumes —
`{"arrivals": [Arrival...], "sessions": {...}}` — with three read-only
sections the replay surfaces as events:

- "phases": named workload segments with start times and arrival
  counts — the replay emits a `scenario_phase` event as the virtual
  clock crosses each boundary;
- "chaos": a fault timeline in the fault drill's vocabulary
  (watchdog_trip / drain / tenant_flood) — the replay emits a
  `chaos_inject` marker and applies the action;
- "name"/"seed": provenance stamped into the report.

Determinism contract: every draw comes from one
`np.random.RandomState(seed)` consumed in spec order — times first
(inverse transform on the shape's intensity, vectorized), then each
arrival's request fields in time order. Two compiles of one spec are
identical lists, and equal to the JAX package's; no wall clock, no
global RNG, no environment reads.

Shapes (each entry in spec["shapes"], drawn in list order):

- diurnal: raised-cosine day — rate(t) = base + (peak-base) *
  0.5*(1-cos(2*pi*(t-t0)/period)); `n` arrivals inverse-transform
  sampled over `duration` (default one period). Four phases a period
  (trough/ramp/peak/decay).
- flash_crowd: `n` arrivals uniform in [t0, t0+width].
- steady: Poisson at `rate` from t0.
- regional_wave: one raised-cosine bump per region, each time-shifted
  and tenant-stamped — the regional-failover traffic, usually paired
  with a chaos watchdog_trip on the region's engine.
- sessions: agentic multi-turn traffic — `count` session heads arrive
  Poisson at `rate`; each session resubmits its whole history plus a
  pre-drawn continuation block `think_s` virtual seconds (the
  tool-call gap) after the previous turn completes. At most one
  sessions shape per scenario (the trace holds one sessions section).

Tenants: spec["tenants"] is a list of TenantSpec kwargs dicts; a shape
picks each arrival's tenant from its `tenant_mix` weight dict (default:
uniform over the declared tenants). spec["fleet"] carries fleet-sizing
kwargs for the fleet builder.

Chaos actions: `watchdog_trip` (simulated engines only — the
`SimulatedEngine.degrade()` hook; a real engine's trip is a fault-drill
concern) and `drain` apply at replay time; `tenant_flood` compiles to
arrivals here (a flash crowd billed to one tenant) and keeps its marker
in the timeline.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Arrival", "BUILTIN_SCENARIOS", "load_scenario",
           "compile_scenario", "list_scenarios"]


@dataclass
class Arrival:
    """One scheduled submission, the load generator's Arrival (a replay
    loop duck-types it)."""
    t: float
    spec: dict
    session: Optional[int] = None
    turn: int = 0

_SHAPE_KINDS = ("diurnal", "flash_crowd", "steady", "regional_wave",
                "sessions")
_CHAOS_ACTIONS = ("watchdog_trip", "drain", "tenant_flood")

# request-field defaults every shape may override (the make_trace
# vocabulary, so compiled traffic is drop-in for the existing fleet)
_SPEC_DEFAULTS = dict(prompt_len_choices=(3, 5, 8),
                      max_new_choices=(3, 4, 6),
                      temperature=0.8, priorities=(0, 0, 0, 5),
                      deadline_frac=0.0, deadline_s=30.0, vocab=50)


BUILTIN_SCENARIOS: Dict[str, dict] = {
    # THE acceptance scenario: a >=1e5-request diurnal day, two
    # tenants (tenant1 noisy: 3x the arrival mass, a quarter the
    # budget), chaos mid-morning — watchdog trip at the ramp, a
    # 2000-request tenant flood at the peak, a drain on the decay.
    "diurnal_noisy": {
        "name": "diurnal_noisy",
        "seed": 0,
        "tenants": [
            {"name": "tenant0", "weight": 1.0,
             "bucket_capacity": 64.0, "refill_rate": 24.0},
            {"name": "tenant1", "weight": 1.0,
             "bucket_capacity": 16.0, "refill_rate": 6.0,
             "max_pending": 4096},
        ],
        "fleet": {"engines": 4, "slots": 8, "max_queue": 4096,
                  "overload_policy": "shed-oldest",
                  "pacing": "throughput"},
        "shapes": [
            {"kind": "diurnal", "n": 100_000, "t0": 0.0,
             "period": 3600.0, "base_rate": 6.0, "peak_rate": 55.0,
             "tenant_mix": {"tenant0": 1.0, "tenant1": 3.0}},
        ],
        "chaos": [
            {"t": 900.0, "action": "watchdog_trip", "target": "sim1"},
            {"t": 1800.0, "action": "tenant_flood",
             "tenant": "tenant1", "n": 2000, "width": 30.0},
            {"t": 2500.0, "action": "drain", "target": "sim2"},
        ],
    },
    # a flash crowd landing on a steady floor — the autoscale shape
    "flash_crowd": {
        "name": "flash_crowd",
        "seed": 0,
        "fleet": {"engines": 2, "slots": 8, "max_queue": 512,
                  "overload_policy": "shed-oldest",
                  "pacing": "throughput"},
        "shapes": [
            {"kind": "steady", "n": 2000, "t0": 0.0, "rate": 4.0},
            {"kind": "flash_crowd", "n": 3000, "t0": 120.0,
             "width": 20.0},
        ],
        "chaos": [],
    },
    # agentic multi-turn sessions (tool-call gaps) over a diurnal floor
    "agentic_sessions": {
        "name": "agentic_sessions",
        "seed": 0,
        "fleet": {"engines": 2, "slots": 8, "pacing": "throughput"},
        "shapes": [
            {"kind": "diurnal", "n": 4000, "t0": 0.0, "period": 1200.0,
             "base_rate": 2.0, "peak_rate": 12.0},
            {"kind": "sessions", "count": 200, "turns": 3,
             "think_s": 8.0, "t0": 0.0, "rate": 1.0},
        ],
        "chaos": [],
    },
    # two regional waves; the first region's engine trips at its peak
    # and the fleet absorbs the failover
    "regional_failover": {
        "name": "regional_failover",
        "seed": 0,
        "tenants": [
            {"name": "region_a", "weight": 1.0,
             "bucket_capacity": 64.0, "refill_rate": 32.0},
            {"name": "region_b", "weight": 1.0,
             "bucket_capacity": 64.0, "refill_rate": 32.0},
        ],
        "fleet": {"engines": 3, "slots": 8, "max_queue": 1024,
                  "overload_policy": "shed-oldest",
                  "pacing": "throughput"},
        "shapes": [
            {"kind": "regional_wave", "regions": [
                {"tenant": "region_a", "t0": 0.0, "n": 3000,
                 "width": 300.0},
                {"tenant": "region_b", "t0": 150.0, "n": 3000,
                 "width": 300.0},
            ]},
        ],
        "chaos": [
            {"t": 150.0, "action": "watchdog_trip", "target": "sim0"},
        ],
    },
    # compact two-tenant chaos scenario — the scenario_chaos drill's
    # input (small enough for tier-1, every chaos action exercised)
    "chaos_smoke": {
        "name": "chaos_smoke",
        "seed": 0,
        "tenants": [
            {"name": "tenant0", "weight": 1.0,
             "bucket_capacity": 16.0, "refill_rate": 8.0},
            {"name": "tenant1", "weight": 1.0,
             "bucket_capacity": 4.0, "refill_rate": 1.0,
             "max_pending": 24},
        ],
        "fleet": {"engines": 2, "slots": 4, "max_queue": 64,
                  "overload_policy": "shed-oldest",
                  "pacing": "throughput"},
        "shapes": [
            {"kind": "steady", "n": 96, "t0": 0.0, "rate": 4.0,
             "tenant_mix": {"tenant0": 1.0, "tenant1": 1.0}},
        ],
        "chaos": [
            {"t": 6.0, "action": "watchdog_trip", "target": "sim1"},
            {"t": 10.0, "action": "tenant_flood",
             "tenant": "tenant1", "n": 48, "width": 4.0},
        ],
    },
}


def list_scenarios() -> List[str]:
    return sorted(BUILTIN_SCENARIOS)


def load_scenario(name_or_path: str) -> dict:
    """A built-in scenario by name, or a JSON spec from a path."""
    if name_or_path in BUILTIN_SCENARIOS:
        # deep-ish copy so callers may mutate (e.g. rescale) freely
        return json.loads(json.dumps(BUILTIN_SCENARIOS[name_or_path]))
    if os.path.exists(name_or_path):
        with open(name_or_path) as f:
            return json.load(f)
    raise ValueError(
        f"unknown scenario {name_or_path!r}: not a built-in "
        f"({', '.join(list_scenarios())}) and not a file")


# --------------------------------------------------------------- draws
def _shape_field(shape: dict, key: str):
    return shape.get(key, _SPEC_DEFAULTS[key])


def _tenant_pick(rng, shape: dict, tenant_names: Sequence[str]):
    """Per-arrival tenant from the shape's mix (uniform over declared
    tenants when the shape doesn't say). One rng draw per arrival
    whenever tenants exist — shapes with and without an explicit mix
    consume the stream identically."""
    if not tenant_names:
        return None
    mix = shape.get("tenant_mix")
    if mix:
        names = sorted(mix)
        w = np.asarray([float(mix[nm]) for nm in names])
    else:
        names = list(tenant_names)
        w = np.ones(len(names))
    j = int(rng.choice(len(names), p=w / w.sum()))
    return names[j]


def _draw_spec(rng, shape: dict, tenant_names: Sequence[str],
               tenant: Optional[str] = None) -> dict:
    """One Request kwargs dict — the make_trace field set, drawn in
    the make_trace order (prompt len, prompt, max_new, seed, priority,
    deadline, tenant)."""
    vocab = _shape_field(shape, "vocab")
    n = int(rng.choice(_shape_field(shape, "prompt_len_choices")))
    spec = dict(
        prompt=[int(x) for x in rng.randint(1, vocab, n)],
        max_new_tokens=int(rng.choice(
            _shape_field(shape, "max_new_choices"))),
        temperature=_shape_field(shape, "temperature"),
        seed=int(rng.randint(0, 2 ** 31 - 1)),
        priority=int(rng.choice(_shape_field(shape, "priorities"))),
    )
    frac = _shape_field(shape, "deadline_frac")
    if frac and float(rng.rand()) < frac:
        spec["deadline_s"] = _shape_field(shape, "deadline_s")
    if tenant is not None:
        spec["tenant"] = tenant
    else:
        t = _tenant_pick(rng, shape, tenant_names)
        if t is not None:
            spec["tenant"] = t
    return spec


def _inverse_transform(rng, n: int, t0: float, duration: float,
                       rate_fn, grid_points: int = 2048) -> np.ndarray:
    """`n` arrival times from an inhomogeneous-Poisson intensity via
    inverse transform on the cumulative rate (trapezoid on a fixed
    grid) — vectorized and exactly reproducible, unlike thinning."""
    grid = np.linspace(t0, t0 + duration, grid_points)
    rate = np.maximum(np.asarray(rate_fn(grid), dtype=float), 0.0)
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (rate[1:] + rate[:-1]) * np.diff(grid))])
    if cum[-1] <= 0:
        raise ValueError("shape intensity integrates to zero")
    u = rng.rand(n) * cum[-1]
    return np.sort(np.interp(u, cum, grid))


def _diurnal_times(rng, shape: dict) -> np.ndarray:
    t0 = float(shape.get("t0", 0.0))
    period = float(shape.get("period", 3600.0))
    duration = float(shape.get("duration", period))
    base = float(shape.get("base_rate", 1.0))
    peak = float(shape.get("peak_rate", 10.0))

    def rate(t):
        return base + (peak - base) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * (t - t0) / period))

    return _inverse_transform(rng, int(shape["n"]), t0, duration, rate)


def _bump_times(rng, n: int, t0: float, width: float) -> np.ndarray:
    """Raised-cosine bump over [t0, t0+width] (a regional wave)."""

    def rate(t):
        return 0.5 * (1.0 - np.cos(2.0 * np.pi * (t - t0) / width))

    return _inverse_transform(rng, n, t0, width, rate)


def _diurnal_phases(shape: dict, times: np.ndarray) -> List[dict]:
    """Four named phases per period (trough/ramp/peak/decay), with the
    arrival count each contributed — replay emits one scenario_phase
    event per boundary crossing."""
    t0 = float(shape.get("t0", 0.0))
    period = float(shape.get("period", 3600.0))
    duration = float(shape.get("duration", period))
    names = ("trough", "ramp", "peak", "decay")
    out = []
    nper = max(int(np.ceil(duration / period)), 1)
    for p in range(nper):
        for q in range(4):
            lo = t0 + p * period + q * period / 4.0
            hi = lo + period / 4.0
            if lo >= t0 + duration:
                break
            cnt = int(np.sum((times >= lo) & (times < hi)))
            label = names[q] if nper == 1 else f"day{p}.{names[q]}"
            out.append({"name": f"diurnal:{label}",
                        "t": round(lo, 6), "arrivals": cnt})
    return out


# ------------------------------------------------------------- compile
def compile_scenario(spec, *, scale: float = 1.0) -> dict:
    """Compile a scenario spec (dict, built-in name, or JSON path)
    into the loadgen trace format, extended with phases/chaos/
    provenance sections. `scale` multiplies every shape's `n` (and
    flood sizes) — `--scenario-scale 0.01` shrinks the 1e5-request day
    to a smoke test without touching the spec."""
    if isinstance(spec, str):
        spec = load_scenario(spec)
    if not isinstance(spec, dict) or "shapes" not in spec:
        raise ValueError("scenario spec must be a dict with 'shapes'")
    if scale <= 0:
        raise ValueError("scale must be > 0")
    seed = int(spec.get("seed", 0))
    rng = np.random.RandomState(seed)
    tenants = [dict(t) for t in spec.get("tenants", [])]
    for t in tenants:
        if "name" not in t:
            raise ValueError("every tenant spec needs a 'name'")
    tenant_names = [t["name"] for t in tenants]

    def _n(raw) -> int:
        return max(int(round(int(raw) * scale)), 1)

    arrivals: List[tuple] = []     # (t, seq, spec_dict, session, turn)
    seq = 0
    phases: List[dict] = []
    sessions = {"count": 0, "turns": 1, "think_s": 0.0,
                "continuations": {}}
    seen_sessions = False

    for shape in spec["shapes"]:
        shape_kind = shape.get("kind")
        if shape_kind not in _SHAPE_KINDS:
            raise ValueError(f"shape kind {shape_kind!r}: "
                             f"expected one of "
                             f"{_SHAPE_KINDS}")
        mix = shape.get("tenant_mix") or {}
        for nm in mix:
            if nm not in tenant_names:
                raise ValueError(f"shape tenant_mix names undeclared "
                                 f"tenant {nm!r}")
        if shape_kind == "diurnal":
            times = _diurnal_times(rng, dict(shape, n=_n(shape["n"])))
            phases.extend(_diurnal_phases(shape, times))
            for t in times:
                arrivals.append((round(float(t), 6), seq,
                                 _draw_spec(rng, shape, tenant_names),
                                 None, 0))
                seq += 1
        elif shape_kind == "flash_crowd":
            n = _n(shape["n"])
            t0 = float(shape.get("t0", 0.0))
            width = float(shape.get("width", 10.0))
            times = np.sort(t0 + rng.rand(n) * width)
            phases.append({"name": "flash_crowd", "t": round(t0, 6),
                           "arrivals": n})
            for t in times:
                arrivals.append((round(float(t), 6), seq,
                                 _draw_spec(rng, shape, tenant_names),
                                 None, 0))
                seq += 1
        elif shape_kind == "steady":
            n = _n(shape["n"])
            rate = float(shape.get("rate", 4.0))
            t = float(shape.get("t0", 0.0))
            phases.append({"name": "steady", "t": round(t, 6),
                           "arrivals": n})
            for _ in range(n):
                t += float(rng.exponential(1.0 / rate))
                arrivals.append((round(t, 6), seq,
                                 _draw_spec(rng, shape, tenant_names),
                                 None, 0))
                seq += 1
        elif shape_kind == "regional_wave":
            regions = shape.get("regions") or []
            if not regions:
                raise ValueError("regional_wave needs 'regions'")
            for region in regions:
                tenant = region.get("tenant")
                if tenant is not None and tenant not in tenant_names:
                    raise ValueError(f"region tenant {tenant!r} "
                                     "undeclared")
                n = _n(region["n"])
                t0 = float(region.get("t0", 0.0))
                width = float(region.get("width", 60.0))
                times = _bump_times(rng, n, t0, width)
                phases.append({"name": f"wave:{tenant or 'all'}",
                               "t": round(t0, 6), "arrivals": n})
                for t in times:
                    arrivals.append((round(float(t), 6), seq,
                                     _draw_spec(rng, shape,
                                                tenant_names,
                                                tenant=tenant),
                                     None, 0))
                    seq += 1
        elif shape_kind == "sessions":
            if seen_sessions:
                raise ValueError("at most one sessions shape per "
                                 "scenario (the trace format holds "
                                 "one sessions section)")
            seen_sessions = True
            count = _n(shape.get("count", 8))
            turns = int(shape.get("turns", 3))
            think = float(shape.get("think_s", 1.0))
            rate = float(shape.get("rate", 1.0))
            vocab = _shape_field(shape, "vocab")
            t = float(shape.get("t0", 0.0))
            phases.append({"name": "sessions", "t": round(t, 6),
                           "arrivals": count})
            for s in range(count):
                t += float(rng.exponential(1.0 / rate))
                arrivals.append((round(t, 6), seq,
                                 _draw_spec(rng, shape, tenant_names),
                                 s, 0))
                seq += 1
            sessions = {
                "count": count, "turns": turns, "think_s": think,
                "continuations": {
                    s: [[int(x) for x in rng.randint(1, vocab, 3)]
                        for _ in range(max(turns - 1, 0))]
                    for s in range(count)}}

    # chaos: validate, scale floods into arrivals (billed to their
    # tenant, drawn AFTER the shapes so adding a flood never perturbs
    # the base traffic's draw stream), keep the timeline for replay
    chaos: List[dict] = []
    for entry in spec.get("chaos", []):
        action = entry.get("action")
        if action not in _CHAOS_ACTIONS:
            raise ValueError(f"chaos action {action!r}: expected one "
                             f"of {_CHAOS_ACTIONS}")
        e = {"t": round(float(entry["t"]), 6), "action": action}
        if action == "tenant_flood":
            tenant = entry.get("tenant")
            if tenant is None or tenant not in tenant_names:
                raise ValueError("tenant_flood needs a declared "
                                 "'tenant'")
            n = _n(entry.get("n", 100))
            width = float(entry.get("width", 10.0))
            times = np.sort(e["t"] + rng.rand(n) * width)
            for t in times:
                arrivals.append((round(float(t), 6), seq,
                                 _draw_spec(rng, entry, tenant_names,
                                            tenant=tenant),
                                 None, 0))
                seq += 1
            e.update(target=tenant, note=f"{n} requests over "
                     f"{width}s")
        else:
            target = entry.get("target")
            if not target:
                raise ValueError(f"chaos {action} needs a 'target' "
                                 "engine name")
            e["target"] = target
        chaos.append(e)
    chaos.sort(key=lambda c: c["t"])

    arrivals.sort(key=lambda a: (a[0], a[1]))
    trace = {
        "arrivals": [Arrival(t, sp, session=ss, turn=turn)
                     for t, _, sp, ss, turn in arrivals],
        "sessions": sessions,
        "phases": sorted(phases, key=lambda p: (p["t"], p["name"])),
        "chaos": chaos,
        "name": str(spec.get("name", "custom")),
        "seed": seed,
        "tenants": tenants,
        "fleet": dict(spec.get("fleet", {})),
    }
    return trace
