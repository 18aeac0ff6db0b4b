"""Deterministic traffic harness for the serving fleet, on the port.

Ports scripts/loadgen.py: `make_trace`, `replay`, `_report`,
`build_fleet`, `build_sim_fleet` and the CLI, over bigdl_tpu_torch's
serving and obs planes. The engines run on `--device` (default: the
CUDA card, where the tiny LM's decode runs the paged-decode kernel at
head dim 16; `--device cpu` runs the plain versions on the host). There
is no fallback: `--device cuda` without a card raises.

"Heavy traffic" becomes a demonstrated property instead of an asserted
one: this harness replays a SEEDED trace — Poisson or bursty arrivals,
mixed prompt lengths, priorities, deadlines, and multi-turn sessions —
against one engine or a routed pool, entirely under an injected
VIRTUAL clock, and reports goodput, latency/TTFT/per-token p50/p99
and terminal-status rates as one JSON object. Two runs of the same
trace produce byte-identical JSON: virtual
time models queueing dynamics (a scheduling round costs a fixed
`step_dt` of fake seconds), so the numbers measure LOAD BEHAVIOR —
waves, backlogs, sheds, autoscaling — not host speed, and they
reproduce on any machine.

The same `make_trace`/`replay` pair drives the fleet drills
(bigdl_tpu_torch/scripts/fault_drill.py: fleet_autoscale,
scenario_chaos) and chip_smoke.py's fleet phases, so the traffic shape
in the tests, the drills and the card's runs is one artifact. The CLI
report also carries a "journeys" rollup: requests reconstructed from
the trace/hop stamps, how many crossed engines, zero lost hops.

Multi-turn sessions: a session's turn k+1 resubmits its whole history
(previous prompt + generated tokens) plus a pre-drawn continuation
block, `think_s` virtual seconds after turn k completes. Continuation
tokens are drawn up front from the trace seed, so follow-up prompts
are independent of completion order. Size `prompt_len_choices`,
`max_new`, turns, and the engine's prefill buckets together: a
session's final-turn prompt must still fit the largest bucket.

SLO mode: `--slo-target-p99` / `--slo-goodput` attach
declarative objectives (obs/slo.py) to the run — a MetricsSampler
ticks once per scheduling round on the same virtual clock, burn-rate/
threshold alerts evaluate deterministically, and the report gains an
"slo" section (per-objective compliance over the whole run + alert
counts and final states). Byte-identity is preserved: the SLO plane
is a pure function of the trace.

Multi-tenant mode: `--tenants N` stamps every request with
a tenant and arms the router's TenancyController — deterministic
token-bucket admission plus weighted-fair release on the SAME virtual
clock. `--noisy-tenant i` makes tenant i submit `--noisy-mult`x the
arrival mass while budgeting it with a tighter bucket: the containment
demo is that the quiet tenants' p99 stays put while the noisy tenant
is throttled by ITS OWN budget. `--vision-frac` mixes in vision
classification requests served by a `model_tag="vision"` engine group
next to the LM pool (dispatch/failover never cross groups). The
report gains "tenants" (per-tenant goodput/p99/throttle counts) and
`pool.groups` sections; byte-identity is preserved.

Tensor parallelism (`--tp n`) runs one process a rank: launch the CLI
with `torchrun --nproc_per_node n` (NCCL, one card a rank, with
`--device cuda`; gloo with `--device cpu`). Every rank replays the same
seeded trace on the same virtual clock and rank 0 prints the report.

Usage (reproducible; add `--device cpu` to run on the host):
    python -m bigdl_tpu_torch.scripts.loadgen --requests 32 \
        --engines 2 --arrival bursty --seed 0
    python -m bigdl_tpu_torch.scripts.loadgen --requests 32 \
        --autoscale --target-p99 8.0 --max-engines 3
    python -m bigdl_tpu_torch.scripts.loadgen --requests 32 \
        --slo-target-p99 6.0 --slo-goodput 0.95
    python -m bigdl_tpu_torch.scripts.loadgen --requests 24 \
        --tenants 2 --noisy-tenant 1 --vision-frac 0.25 --seed 0
    torchrun --nproc_per_node 2 -m bigdl_tpu_torch.scripts.loadgen \
        --requests 32 --tp 2
"""

from __future__ import annotations

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

import argparse
import heapq
import itertools
import json
import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

# the CLI's tiny LMs: the target (head dim 16) and the speculative
# draft (head dim 8), and the seeds their weights are drawn from
LM_CONFIG = dict(vocab_size=50, dim=32, num_heads=2, num_layers=2)
DRAFT_CONFIG = dict(vocab_size=50, dim=16, num_heads=2, num_layers=1)
LM_SEED, DRAFT_SEED, VISION_SEED = 0, 1, 2


@dataclass
class Arrival:
    """One scheduled submission: virtual arrival time, Request kwargs,
    and (for multi-turn traffic) its session id + turn index."""
    t: float
    spec: dict
    session: Optional[int] = None
    turn: int = 0


def make_trace(n_requests: int = 32, *, seed: int = 0,
               arrival: str = "poisson", rate: float = 4.0,
               burst_size: int = 8, burst_gap_s: float = 4.0,
               prompt_len_choices=(3, 5, 8),
               max_new_choices=(3, 4, 6),
               temperature: float = 0.8,
               priorities=(0, 0, 0, 5),
               deadline_frac: float = 0.0, deadline_s: float = 30.0,
               sessions: int = 0, session_turns: int = 3,
               think_s: float = 1.0, vocab: int = 50,
               shared_prefix_len: int = 0,
               shared_frac: float = 0.9,
               tenants: int = 0, noisy_tenant: Optional[int] = None,
               noisy_mult: float = 4.0,
               vision_frac: float = 0.0,
               feature_len: int = 8) -> dict:
    """Build a deterministic trace: `n_requests` single-shot requests
    plus `sessions` multi-turn sessions (their heads arrive through
    the same arrival process; later turns are scheduled at replay
    time). Everything — gaps, prompts, sampling seeds, priorities,
    deadline draws, continuation blocks — comes from ONE
    RandomState(seed), so the trace is a pure function of its
    arguments.

    `shared_prefix_len` > 0 switches on the shared-prompt
    workload: one common prefix of that many tokens is drawn once from
    the trace seed, and each request prepends it with probability
    `shared_frac` (its unique tail still comes from
    prompt_len_choices) — the traffic shape whose prefill the paged
    prefix cache amortizes away. Non-shared requests draw a fully
    unique prompt of the same total length, keeping the two
    populations comparable.

    `tenants` > 0 stamps each request with one of `tenants` tenant
    names, drawn from the same RandomState; the tenant at
    index `noisy_tenant` submits `noisy_mult`x the per-request
    probability mass — the noisy-neighbor arrival mix the tenancy
    gate contains. `vision_frac` > 0 makes that fraction of the
    single-shot requests vision classifications (`model_tag='vision'`,
    a `feature_len`-int feature vector as the prompt) interleaved on
    the same arrival process — the heterogeneous-fleet mixed trace;
    sessions always stay LM."""
    if arrival not in ("poisson", "bursty"):
        raise ValueError(f"arrival {arrival!r}: expected poisson|bursty")
    rng = np.random.RandomState(seed)
    shared_prefix = [int(x) for x in rng.randint(1, vocab,
                                                 shared_prefix_len)] \
        if shared_prefix_len else []
    arrivals: List[Arrival] = []
    t = 0.0
    for i in range(n_requests + sessions):
        if arrival == "poisson":
            t += float(rng.exponential(1.0 / rate))
        elif i and i % burst_size == 0:          # bursty: waves
            t += burst_gap_s
        n = int(rng.choice(prompt_len_choices))
        if shared_prefix_len:
            tail = [int(x) for x in rng.randint(1, vocab, n)]
            prompt = (shared_prefix + tail
                      if float(rng.rand()) < shared_frac
                      else [int(x) for x in rng.randint(
                          1, vocab, shared_prefix_len)] + tail)
        else:
            prompt = [int(x) for x in rng.randint(1, vocab, n)]
        spec = dict(
            prompt=prompt,
            max_new_tokens=int(rng.choice(max_new_choices)),
            temperature=temperature,
            seed=int(rng.randint(0, 2 ** 31 - 1)),
            priority=int(rng.choice(priorities)),
        )
        if deadline_frac and float(rng.rand()) < deadline_frac:
            spec["deadline_s"] = deadline_s
        # draws ride AFTER the pre-existing ones, each behind
        # its own flag — traces built without these knobs keep the
        # exact pre-19 draw sequence (the drills pin those bytes)
        if tenants:
            w = np.ones(tenants)
            if noisy_tenant is not None:
                w[noisy_tenant] = noisy_mult
            j = int(rng.choice(tenants, p=w / w.sum()))
            spec["tenant"] = f"tenant{j}"
        if vision_frac and i < n_requests \
                and float(rng.rand()) < vision_frac:
            # single-shot only: a session's history concat is an LM
            # notion. The feature "prompt" reuses the token alphabet
            spec["prompt"] = [int(x) for x in rng.randint(
                1, vocab, feature_len)]
            spec["model_tag"] = "vision"
            spec["max_new_tokens"] = 1
        arrivals.append(Arrival(
            round(t, 6), spec,
            session=i - n_requests if i >= n_requests else None))
    continuations = {
        s: [[int(x) for x in rng.randint(1, vocab, 3)]
            for _ in range(max(session_turns - 1, 0))]
        for s in range(sessions)}
    return {"arrivals": arrivals,
            "sessions": {"count": sessions, "turns": session_turns,
                         "think_s": think_s,
                         "continuations": continuations}}


def _pctl(xs: List[float], q: float) -> Optional[float]:
    """Exact nearest-rank percentile (deterministic, no interpolation
    surprises across platforms)."""
    if not xs:
        return None
    s = sorted(xs)
    return round(s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))],
                 6)


def replay(router, trace: dict, *, clock: Dict[str, float],
           step_dt: float = 0.25, autoscaler=None, observer=None,
           on_result=None, max_rounds: int = 200_000) -> dict:
    """Replay `trace` against `router` on the virtual clock.

    `clock` is the {"t": float} cell the router AND every engine (and
    the autoscaler's router) were built over (`clock=lambda:
    clk["t"]`) — replay advances it by `step_dt` per scheduling round
    and jumps idle gaps to the next arrival. `observer` is
    called once per scheduling round after the step and the autoscale
    evaluation — the SLO plane's tick point (sampler.tick() +
    alert_engine.evaluate()), on the same virtual clock so two runs
    stay byte-identical. `on_result` is called once per
    settled result in completion order — the speculation flywheel's
    ingestion point (distiller corpus + swap cadence), between router
    steps so a hot-swap lands while the engines are quiescent.
    Returns the load report (see _report); deterministic for a fixed
    (router config, trace, step_dt).

    Scenario traces may carry "phases" and "chaos"
    timelines (serving/scenarios.py): as the virtual clock crosses
    each entry, replay emits a `scenario_phase` / `chaos_inject` event
    and applies the chaos action — `watchdog_trip` calls the target
    engine's `degrade()` hook (SimulatedEngine; a REAL engine's trip
    is injected inside its step and belongs to fault_drill, so naming
    one here is a spec error), `drain` works on both, `tenant_flood`
    was compiled into the arrivals and fires as a marker only. The
    idle-gap jump never skips a pending timeline entry."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.serving import NoHealthyEngine, OverloadError

    from bigdl_tpu_torch.serving import Request

    sess = trace["sessions"]
    scen_name = trace.get("name")
    timeline = [("phase", p["t"], p) for p in trace.get("phases", [])]
    timeline += [("chaos", c["t"], c) for c in trace.get("chaos", [])]
    timeline.sort(key=lambda e: (e[1], 0 if e[0] == "phase" else 1))
    tl_idx = [0]
    tl_fired = {"phase": 0, "chaos": 0}

    def _apply_chaos(entry):
        action = entry["action"]
        if action == "tenant_flood":
            return                        # arrivals were compiled in
        target = entry.get("target")
        eng = next((e for e in router.engines
                    if e.obs_name == target), None)
        if eng is None:
            raise ValueError(
                f"chaos target {target!r} names no pool engine "
                f"(have {[e.obs_name for e in router.engines]})")
        if action == "drain":
            eng.drain()
        elif action == "watchdog_trip":
            if not hasattr(eng, "degrade"):
                raise ValueError(
                    f"chaos watchdog_trip targets {target!r}, which "
                    "has no degrade() hook — real-engine trips are "
                    "fault_drill territory (serve_watchdog leg)")
            eng.degrade("chaos_watchdog")

    def fire_timeline():
        while tl_idx[0] < len(timeline) \
                and timeline[tl_idx[0]][1] <= clock["t"] + 1e-9:
            kind, t, e = timeline[tl_idx[0]]
            tl_idx[0] += 1
            tl_fired[kind] += 1
            if kind == "phase":
                obs.emit_event("scenario_phase", plane="serving",
                               scenario=scen_name, phase=e["name"],
                               t=t, arrivals=e.get("arrivals"))
            else:
                obs.emit_event("chaos_inject", plane="serving",
                               scenario=scen_name, action=e["action"],
                               target=e.get("target"), t=t,
                               note=e.get("note"))
                _apply_chaos(e)

    heap = [(a.t, i, a) for i, a in enumerate(trace["arrivals"])]
    heapq.heapify(heap)
    seqc = itertools.count(len(heap))
    expected = len(heap) + sess["count"] * max(sess["turns"] - 1, 0)
    results: Dict[int, object] = {}
    owner: Dict[int, Arrival] = {}
    rejected = 0

    def submit_due():
        nonlocal rejected, expected
        while heap and heap[0][0] <= clock["t"] + 1e-9:
            _, _, a = heapq.heappop(heap)
            try:
                rid = router.submit(Request(**a.spec))
            except (OverloadError, NoHealthyEngine):
                rejected += 1
                if a.session is not None:        # dead session: drop
                    expected -= sess["turns"] - 1 - a.turn
                continue
            owner[rid] = a

    rounds = 0
    while len(results) + rejected < expected:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"replay did not converge in {max_rounds} rounds "
                f"({len(results)}/{expected} settled)")
        fire_timeline()
        submit_due()
        # the pool is only IDLE when no work is parked behind a tenant
        # gate either — jumping while tenancy holds requests would skip
        # the refill rounds that release them (and hide throttling)
        parked = router.tenancy.pending if router.tenancy is not None \
            else 0
        if heap and heap[0][0] > clock["t"] and not parked \
                and all(e.idle for e in router.engines):
            jump = heap[0][0]                    # jump the idle gap —
            if tl_idx[0] < len(timeline):        # never past a pending
                jump = min(jump, timeline[tl_idx[0]][1])  # timeline hit
            clock["t"] = jump
            continue
        # the round costs step_dt BEFORE its results land: a request
        # admitted this round sees TTFT >= step_dt, like a real step
        clock["t"] = round(clock["t"] + step_dt, 9)
        out = router.step()
        if autoscaler is not None:
            autoscaler.observe()
        if observer is not None:
            observer()
        for res in out:
            results[res.id] = res
            if on_result is not None:
                on_result(res)
            a = owner.get(res.id)
            if a is not None and a.session is not None \
                    and a.turn < sess["turns"] - 1:
                nspec = dict(a.spec)
                nspec["prompt"] = (list(res.prompt) + list(res.tokens)
                                   + sess["continuations"][a.session]
                                   [a.turn])
                nxt = Arrival(round(clock["t"] + sess["think_s"], 6),
                              nspec, a.session, a.turn + 1)
                heapq.heappush(heap, (nxt.t, next(seqc), nxt))
    tenants_of = {rid: (a.spec.get("tenant") or "default")
                  for rid, a in owner.items()}
    report = _report(results, clock["t"], router, rejected, autoscaler,
                     step_dt, tenants_of=tenants_of)
    if scen_name is not None:
        # scenario provenance: the compiled timelines plus
        # how much of each actually fired before the traffic drained —
        # pure functions of the trace, so the section rides the
        # byte-identical acceptance
        report["scenario"] = {
            "name": scen_name,
            "seed": trace.get("seed"),
            "phases": trace.get("phases", []),
            "chaos": [{k: c[k] for k in ("t", "action", "target")
                       if k in c} for c in trace.get("chaos", [])],
            "fired": dict(tl_fired),
        }
    return report


def _report(results, makespan, router, rejected, autoscaler,
            step_dt, tenants_of=None) -> dict:
    """The load report: goodput + SLO percentiles from the results'
    engine-clock lifecycle stamps (virtual seconds)."""
    done = [r for r in results.values() if r.status == "done"]
    by_status: Dict[str, int] = {}
    for r in results.values():
        by_status[r.status] = by_status.get(r.status, 0) + 1
    lat = [r.latency_s for r in done if r.latency_s is not None]
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    per_tok = [(r.latency_s - r.ttft_s) / max(len(r.tokens) - 1, 1)
               for r in done
               if r.latency_s is not None and r.ttft_s is not None]
    goodput = sum(len(r.tokens) for r in done)
    # prefix-cache rollup: reuse counters straight from the
    # engines' host-side stats — deterministic, so shared-prefix and
    # multi-turn runs show their reuse in the byte-identical report
    prompt_tokens = sum(len(r.prompt) for r in results.values())
    saved = blocks = hits = evictions = 0
    spilled = readmitted = host_evict = host_in_use = 0
    tiered = False
    for e in router.engines:
        s = e.stats
        hits += s.get("prefix_hits", 0)
        saved += s.get("prefix_tokens_saved", 0)
        blocks += s.get("prefix_blocks_reused", 0)
        evictions += s.get("pool_evictions", 0)
        # host spill tier rollup — host-side counters only
        if getattr(e, "spill_enabled", False):
            tiered = True
            spilled += s.get("kv_spill_blocks", 0)
            readmitted += s.get("kv_readmit_blocks", 0)
            host_evict += s.get("kv_host_evictions", 0)
            host_in_use += e.health()["prefix"].get("host_in_use", 0)
    report = {
        "requests": len(results) + rejected,
        "rejected": rejected,
        "prefix": {
            "hits": hits,
            "blocks_reused": blocks,
            "prefill_tokens_saved": saved,
            "prompt_tokens": prompt_tokens,
            "saved_frac": (round(saved / prompt_tokens, 4)
                           if prompt_tokens else 0.0),
            "pool_evictions": evictions,
        },
        "by_status": dict(sorted(by_status.items())),
        "makespan_s": round(makespan, 6),
        "step_dt_s": step_dt,
        "goodput_tokens": goodput,
        "goodput_tokens_per_s": (round(goodput / makespan, 6)
                                 if makespan > 0 else None),
        "latency_p50_s": _pctl(lat, 0.50),
        "latency_p99_s": _pctl(lat, 0.99),
        "ttft_p50_s": _pctl(ttft, 0.50),
        "ttft_p99_s": _pctl(ttft, 0.99),
        "per_token_p50_s": _pctl(per_tok, 0.50),
        "per_token_p99_s": _pctl(per_tok, 0.99),
        "pool": {"engines_final": len(router.engines),
                 "router": router.stats},
    }
    if tiered:
        # kv-tier rollup: spill/re-admit traffic plus the
        # fleet's migration tally — pure host-side stats, so the
        # section rides the byte-identical acceptance; hit_rate is the
        # request-level prefix hit rate AFTER any failover reshuffle
        report["kv_tier"] = {
            "spilled_blocks": spilled,
            "readmitted_blocks": readmitted,
            "host_evictions": host_evict,
            "host_blocks_in_use": host_in_use,
            "migrations": router.stats.get("migrations", 0),
            "migrated_blocks": router.stats.get("migrated_blocks", 0),
            "hit_rate": (round(hits / len(results), 4)
                         if results else 0.0),
        }
    groups = router.groups if hasattr(router, "groups") else {}
    if len(groups) > 1:
        report["pool"]["groups"] = {
            g: len(members) for g, members in sorted(groups.items())}
    ctl = getattr(router, "tenancy", None)
    if ctl is not None:
        # per-tenant rollup: terminal stamps split by the
        # tenant each request billed against, plus the controller's
        # own admission counters — all host-side, so the section rides
        # the byte-identical acceptance like spec/kv_tier
        tsec = {}
        for name in ctl.tenants:
            rs = [r for r in results.values()
                  if (tenants_of or {}).get(r.id) == name]
            tdone = [r for r in rs if r.status == "done"]
            tlat = [r.latency_s for r in tdone
                    if r.latency_s is not None]
            st = ctl.stats(name)
            tsec[name] = {
                "requests": len(rs),
                "done": len(tdone),
                "goodput_tokens": sum(len(r.tokens) for r in tdone),
                "latency_p50_s": _pctl(tlat, 0.50),
                "latency_p99_s": _pctl(tlat, 0.99),
                "throttled": {"deferred": st["deferred"],
                              "shed": st["shed"]},
                "expired": st["expired"],
                "weight": ctl.spec(name).weight,
            }
        report["tenants"] = tsec
    if autoscaler is not None:
        report["autoscale"] = {
            "target_p99_s": autoscaler.target_p99_s,
            "decisions": [d for d in autoscaler.decisions
                          if d["action"] not in ("hold", "draining")],
        }
    return report


def tiny_lm(config: dict, seed: int, max_len: int, device=None,
            variables=None):
    """A TransformerLM of `config` (LM_CONFIG, DRAFT_CONFIG) on
    `device`, its weights drawn from a CPU torch.Generator seeded with
    `seed`, or copied from `variables`: a parameter tree of host arrays
    in the JAX package's layout (models/convert.params_from_jax), as
    the CPU tests carry the JAX package's weights in."""
    import torch

    from bigdl_tpu_torch.models.convert import params_from_jax
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    model = TransformerLM(TransformerConfig(max_len=max_len, **config),
                          device=device)
    params = (model.init_params(torch.Generator().manual_seed(seed))
              if variables is None
              else params_from_jax(variables, device=model.device))
    model.variables = {"params": params, "state": {}}
    return model


def build_fleet(engines: int = 1, *, slots: int = 4,
                prefill_buckets=(8, 16, 32), max_len: int = 96,
                block_size: int = 16,
                max_queue: Optional[int] = None,
                overload_policy: str = "reject",
                clock: Optional[Dict[str, float]] = None,
                autoscale: bool = False, target_p99_s: float = 8.0,
                max_engines: int = 4, evaluate_every_s: float = 1.0,
                tp: Optional[int] = None, tp_axis: str = "model",
                spec_draft: bool = False, spec_k: int = 4,
                spec_adaptive: bool = False,
                spec_adapt_window: int = 4,
                spec_probe_every: int = 16,
                host_blocks: Optional[int] = None,
                affinity: bool = False,
                tenant_specs=None,
                vision: bool = False, vision_engines: int = 1,
                vision_batch: int = 4, feature_len: int = 8,
                device=None, weights: Optional[dict] = None):
    """Tiny-LM fleet for the CLI and the drills: a routed pool over
    ONE model object, every clock the same virtual cell. Returns
    (router, autoscaler-or-None, clk).

    The LM is LM_CONFIG (head dim 16) with weights drawn from
    torch.Generator seed LM_SEED, on `device` (None: the card).
    `weights` may hand in host arrays instead (tiny_lm): {"lm": tree,
    "draft": tree, "vision": (feature_len, 10) array}, any subset.

    `tp` serves every engine tensor-parallel over a mesh {tp_axis: tp}
    spanning the process group — one process a rank, every rank running
    this same fleet (serving/tp.py), one shared wrapper, the emitted
    tokens bitwise the tp=None tokens; tp must divide the tiny model's
    2 heads and equal the group's size.

    `spec_draft` fronts every pool engine with a
    SpeculativeEngine over a shared even-tinier draft model (head dim
    8) — same virtual clock, one draft model object, tokens bitwise the
    spec_draft=False tokens (coupled acceptance,
    serving/speculative.py); `spec_k` is the per-round draft lookahead.
    `spec_adaptive` arms the adaptive-lookahead ladder on every wrapper
    (`adapt_k=True` with the given window/probe cadence): k_live
    follows the measured accept rate and collapses to target-only
    cruise on hostile traffic — host-side only, tokens unchanged.

    `host_blocks` arms every engine's host-RAM spill tier (refcount-0
    radix blocks park in host memory instead of dying; prefix hits
    re-admit the bytes), and `affinity=True` routes admissions to the
    engine whose radix tree already holds the longest prompt prefix —
    both pure placement, so tokens and the byte-identical acceptance
    are unchanged.

    `tenant_specs` arms a TenancyController on the SAME virtual clock
    (per-tenant token-bucket admission + WFQ release at the router),
    and `vision=True` adds a `model_tag='vision'` engine group
    (`vision_engines` x VisionEngine over one shared predict function)
    next to the LM pool, with a dict-valued engine_factory so the
    Autoscaler can grow either group."""
    import torch

    from bigdl_tpu_torch.serving import (Autoscaler, EngineRouter,
                                         InferenceEngine)
    from bigdl_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    weights = weights or {}
    clk = clock if clock is not None else {"t": 0.0}
    model = tiny_lm(LM_CONFIG, LM_SEED, max_len, device,
                    weights.get("lm"))
    mesh = None
    if tp:
        import torch.distributed as dist

        from bigdl_tpu_torch.parallel import make_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if tp != world:
            raise ValueError(
                f"--tp {tp} needs {tp} processes, one a rank (launch "
                f"with torchrun --nproc_per_node {tp}); this group has "
                f"{world}")
        mesh = make_mesh({tp_axis: tp}, device=device)
    draft_model = None
    if spec_draft:
        draft_model = tiny_lm(DRAFT_CONFIG, DRAFT_SEED, max_len, device,
                              weights.get("draft"))

    def factory():
        eng = InferenceEngine(model, slots=slots,
                              prefill_buckets=prefill_buckets,
                              block_size=block_size,
                              max_queue=max_queue,
                              overload_policy=overload_policy,
                              clock=lambda: clk["t"],
                              tp_mesh=mesh, tp_axis=tp_axis,
                              spill=host_blocks is not None,
                              host_blocks=host_blocks, device=device)
        if not spec_draft:
            return eng
        from bigdl_tpu_torch.serving import SpeculativeEngine

        draft = InferenceEngine(draft_model, slots=slots,
                                prefill_buckets=prefill_buckets,
                                block_size=block_size,
                                clock=lambda: clk["t"], device=device)
        return SpeculativeEngine(draft, eng, k=spec_k,
                                 adapt_k=spec_adaptive,
                                 adapt_window=spec_adapt_window,
                                 probe_every=spec_probe_every)

    pool = [factory() for _ in range(engines)]
    fleet_factory = factory
    if vision:
        from bigdl_tpu_torch.serving import VisionEngine

        # one predict function (closed-over weights) per fleet: every
        # vision engine here (and any the autoscaler adds) shares it
        w_vis = weights.get("vision")
        if w_vis is None:
            w_vis = torch.randn(feature_len, 10,
                                generator=torch.Generator().manual_seed(
                                    VISION_SEED))
        w_vis = torch.tensor(np.asarray(w_vis), dtype=torch.float32,
                             device=device)

        def predict_fn(feats, _w=w_vis):
            return feats @ _w

        def vision_factory():
            return VisionEngine(predict_fn, batch=vision_batch,
                                feature_len=feature_len,
                                model_tag="vision",
                                clock=lambda: clk["t"], device=device)

        pool.extend(vision_factory() for _ in range(vision_engines))
        fleet_factory = {"default": factory, "vision": vision_factory}
    # the router requires clock IDENTITY with its tenancy controller
    # (one virtual timeline), so both get the same callable object
    router_clock = lambda: clk["t"]  # noqa: E731
    tenancy = None
    if tenant_specs is not None:
        from bigdl_tpu_torch.serving import TenancyController

        tenancy = TenancyController(tenant_specs, clock=router_clock)
    router = EngineRouter(pool,
                          engine_factory=fleet_factory,
                          clock=router_clock,
                          affinity=affinity,
                          tenancy=tenancy)
    asc = Autoscaler(router, target_p99_s=target_p99_s,
                     max_engines=max_engines,
                     evaluate_every_s=evaluate_every_s) \
        if autoscale else None
    return router, asc, clk


def build_sim_fleet(engines: int = 1, *, slots: int = 4,
                    prefill_buckets=(8, 16, 32),
                    max_queue: Optional[int] = None,
                    overload_policy: str = "reject",
                    clock: Optional[Dict[str, float]] = None,
                    pacing: str = "throughput",
                    autoscale: bool = False,
                    target_p99_s: float = 8.0,
                    max_engines: int = 4,
                    evaluate_every_s: float = 1.0,
                    tenant_specs=None, cost=None):
    """Simulated fleet: the same router/autoscaler/tenancy
    control plane as build_fleet, but every engine is a
    SimulatedEngine over ONE shared CostModel — `cost`, by default
    `CostModel.default()`, the committed card reading
    (serving/sim_calibration.json) — with no device work, so a
    10^5-request scenario replays in wall-clock seconds. The shared
    CostModel object doubles as the router's group identity (engines
    in a group must share a model object). Returns
    (router, autoscaler-or-None, clk), same shape as build_fleet so
    the replay/report path is identical."""
    from bigdl_tpu_torch.serving import Autoscaler, EngineRouter
    from bigdl_tpu_torch.serving.sim import CostModel, SimulatedEngine

    clk = clock if clock is not None else {"t": 0.0}
    router_clock = lambda: clk["t"]  # noqa: E731
    if cost is None:
        cost = CostModel.default()
    # per-fleet engine names (sim0..simN-1, autoscaler growth
    # continues the sequence): scenario chaos entries target engines
    # BY NAME, and the ctor's fallback counter is process-global — a
    # second fleet in one process would drift to sim2/sim3 and break
    # every compiled "target": "sim1"
    ids = itertools.count()

    def factory():
        return SimulatedEngine(cost, clock=router_clock, slots=slots,
                               prefill_buckets=prefill_buckets,
                               max_queue=max_queue,
                               overload_policy=overload_policy,
                               pacing=pacing,
                               obs_label=f"sim{next(ids)}")

    pool = [factory() for _ in range(engines)]
    tenancy = None
    if tenant_specs is not None:
        from bigdl_tpu_torch.serving import TenancyController

        tenancy = TenancyController(tenant_specs, clock=router_clock)
    router = EngineRouter(pool, engine_factory=factory,
                          clock=router_clock, tenancy=tenancy)
    asc = Autoscaler(router, target_p99_s=target_p99_s,
                     max_engines=max_engines,
                     evaluate_every_s=evaluate_every_s) \
        if autoscale else None
    return router, asc, clk


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--engines", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--rate", type=float, default=4.0,
                    help="poisson arrivals per virtual second")
    ap.add_argument("--burst-size", type=int, default=8)
    ap.add_argument("--burst-gap", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sessions", type=int, default=0,
                    help="multi-turn sessions (3 turns each)")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared-prompt workload: prepend a "
                         "common prefix of this many tokens to "
                         "--shared-frac of the requests; the report's "
                         "prefix section shows the prefill amortized "
                         "away by the paged radix cache")
    ap.add_argument("--shared-frac", type=float, default=0.9)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size (engine constructor knob)")
    ap.add_argument("--deadline-frac", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--step-dt", type=float, default=0.25,
                    help="virtual seconds per scheduling round")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound each engine's queue (unbounded "
                         "default; required for overload policies — "
                         "and the autoscaler's at-capacity shed "
                         "flip — to have any effect)")
    ap.add_argument("--overload-policy", default="reject",
                    choices=("reject", "shed-oldest",
                             "shed-lowest-priority"))
    ap.add_argument("--tp", type=int, default=None,
                    help="serve every engine tensor-parallel over this "
                         "many ranks, one process a rank (launch with "
                         "torchrun --nproc_per_node N; must divide the "
                         "tiny model's 2 heads — tokens stay bitwise == "
                         "unsharded)")
    ap.add_argument("--spec-draft", action="store_true",
                    help="front every engine with a SpeculativeEngine "
                         "over a shared tiny draft model: "
                         "tokens stay bitwise the non-spec tokens "
                         "(coupled acceptance) and the report gains a "
                         "'spec' section (accept rate, draft-overhead "
                         "share); two runs stay byte-identical")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft lookahead per speculative round")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="adaptive lookahead: each wrapper's k_live follows "
                         "its windowed accept rate between 1 and "
                         "--spec-k, collapsing to target-only cruise "
                         "on hostile traffic; the 'spec' section gains "
                         "the k trajectory; two runs stay "
                         "byte-identical")
    ap.add_argument("--spec-adapt-window", type=int, default=4,
                    help="proposing rounds per ladder evaluation")
    ap.add_argument("--spec-probe-every", type=int, default=16,
                    help="suspended rounds between speculation probes")
    ap.add_argument("--spec-distill", action="store_true",
                    help="online draft distillation: a background ZeRO-2 loop "
                         "trains the draft on the run's own completed "
                         "token streams and hot-swaps the improved "
                         "weights into every wrapper (zero new "
                         "executables); the 'spec' section gains the "
                         "swap events (accept before/after); two runs "
                         "stay byte-identical")
    ap.add_argument("--spec-swap-every", type=int, default=16,
                    help="completed results between distill+swap "
                         "cycles")
    ap.add_argument("--host-blocks", type=int, default=None,
                    help="arm the host-RAM KV spill tier with this "
                         "many host blocks per engine: "
                         "refcount-0 radix blocks park in host "
                         "arrays instead of dying and prefix hits "
                         "re-admit the bytes; the report gains a "
                         "'kv_tier' section (spills, re-admits, "
                         "migrations) and prefix-affinity routing "
                         "turns on; two runs stay byte-identical")
    ap.add_argument("--affinity", dest="affinity", default=None,
                    action="store_true",
                    help="route admissions to the engine whose radix "
                         "tree holds the longest prompt prefix "
                         "(health-gated; on by default with "
                         "--sessions or --host-blocks)")
    ap.add_argument("--no-affinity", dest="affinity",
                    action="store_false")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant mode: stamp each "
                         "request with one of N tenant names and arm "
                         "the router's TenancyController (per-tenant "
                         "token-bucket admission + weighted-fair "
                         "release); the report gains a 'tenants' "
                         "section (per-tenant goodput/p99/throttle "
                         "counts); two runs stay byte-identical")
    ap.add_argument("--noisy-tenant", type=int, default=None,
                    help="index of the noisy tenant: it submits "
                         "--noisy-mult x the arrival mass but is "
                         "budgeted by a tight bucket "
                         "(--noisy-bucket-capacity/--noisy-refill) — "
                         "the containment demo")
    ap.add_argument("--noisy-mult", type=float, default=4.0)
    ap.add_argument("--bucket-capacity", type=float, default=8.0,
                    help="token-bucket burst capacity for ordinary "
                         "tenants")
    ap.add_argument("--bucket-refill", type=float, default=1.0,
                    help="token-bucket refill per virtual second for "
                         "ordinary tenants")
    ap.add_argument("--noisy-bucket-capacity", type=float, default=2.0)
    ap.add_argument("--noisy-refill", type=float, default=0.5)
    ap.add_argument("--noisy-max-pending", type=int, default=None,
                    help="shed the noisy tenant's arrivals past this "
                         "many deferred requests (its own bound — "
                         "other tenants unbounded)")
    ap.add_argument("--vision-frac", type=float, default=0.0,
                    help="mixed heterogeneous trace: this "
                         "fraction of the single-shot requests become "
                         "vision classifications served by a "
                         "model_tag='vision' engine group next to the "
                         "LM pool (dispatch/failover never cross "
                         "groups)")
    ap.add_argument("--vision-engines", type=int, default=1)
    ap.add_argument("--feature-len", type=int, default=8)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--target-p99", type=float, default=8.0)
    ap.add_argument("--max-engines", type=int, default=4)
    ap.add_argument("--slo-target-p99", type=float, default=None,
                    help="attach a p99-latency SLOObjective (virtual "
                         "seconds) to the run: a burn-rate "
                         "alert watches it per round and the report "
                         "gains an 'slo' section (compliance + alert "
                         "counts); two runs stay byte-identical")
    ap.add_argument("--slo-goodput", type=float, default=None,
                    help="attach a goodput error-budget objective: at "
                         "least this fraction of requests must finish "
                         "'done' (e.g. 0.95 -> bad-terminal budget "
                         "0.05); threshold alert + report section as "
                         "above")
    ap.add_argument("--scenario", default=None,
                    help="drive a compiled scenario instead of "
                         "make_trace: a built-in name "
                         "(serving/scenarios.py — diurnal_noisy, "
                         "flash_crowd, agentic_sessions, "
                         "regional_failover, chaos_smoke) or a JSON "
                         "spec path; the scenario's tenants/fleet/"
                         "chaos sections override the corresponding "
                         "flags and the report gains a 'scenario' "
                         "section (phases, chaos timeline, fired "
                         "counts)")
    ap.add_argument("--scenario-scale", type=float, default=1.0,
                    help="multiply every scenario shape's request "
                         "count (0.01 shrinks the 1e5-request day to "
                         "a smoke test)")
    ap.add_argument("--sim", action="store_true",
                    help="serve the trace with SimulatedEngines: "
                         "the identical router/autoscaler/"
                         "tenancy/SLO/journey control plane over a "
                         "cost model calibrated from the committed "
                         "card reading (serving/sim_calibration.json) "
                         "— no device work, "
                         "10^5-request scenarios replay in wall-clock "
                         "seconds; the report gains a 'sim' section "
                         "(pacing + calibration provenance)")
    ap.add_argument("--sim-pacing", default=None,
                    choices=("per_step", "throughput"),
                    help="sim scheduling mode: per_step mirrors the "
                         "real engine's one-token-per-round structure "
                         "(the divergence-test mode), throughput is "
                         "the fluid large-scale mode (default; "
                         "scenario fleet specs may set it)")
    ap.add_argument("--json", default=None,
                    help="also write the report to this path")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default; raises "
                         "without a card) or cpu")
    return ap


def run(argv=None, *, weights: Optional[dict] = None,
        cost=None) -> dict:
    """The CLI's load report for `argv` (a dict, not printed).
    `weights` hands build_fleet its parameter trees and `cost`
    build_sim_fleet its CostModel (the CPU tests' seams)."""
    import torch

    ap = _parser()
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch sees no CUDA device (pass "
            "--device cpu to run the engines on the host)")
    if args.tp and args.tp > 1:
        import torch.distributed as dist

        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            # torchrun's environment: one process a rank
            dist.init_process_group(
                "nccl" if args.device.startswith("cuda") else "gloo")
    if args.spec_adaptive or args.spec_distill:
        args.spec_draft = True           # flywheel knobs ride the pool
    if args.sim:
        for flag, name in ((args.tp, "--tp"),
                           (args.spec_draft, "--spec-draft/--spec-*"),
                           (args.host_blocks, "--host-blocks"),
                           (args.vision_frac, "--vision-frac"),
                           (args.shared_prefix, "--shared-prefix")):
            if flag:
                ap.error(f"{name} exercises real-engine machinery "
                         "(device KV, drafts, shards) that the cost "
                         "model replaces — run it without --sim")

    # scenario mode: compile the declarative spec down to
    # the same trace format; its tenants/fleet sections override the
    # corresponding CLI knobs below
    scenario_trace = None
    if args.scenario:
        from bigdl_tpu_torch.serving.scenarios import compile_scenario

        scenario_trace = compile_scenario(args.scenario,
                                          scale=args.scenario_scale)

    # size the in-memory event ring to the trace BEFORE any engine
    # emits: the journeys rollup below reads the ring, and
    # the default 4096 records would roll early seat events off a
    # large run — terminal-only traces would then masquerade as
    # incomplete journeys. ~16 events/request is a safe ceiling
    # (submit/terminal/prefix/handoff/router records); the
    # BIGDL_OBS_EVENTS file sink is unaffected (disk keeps all).
    # the ring is CAPPED at 2^18 records — a 10^5-request
    # scenario would otherwise pin ~1.6M dicts of host RAM. When the
    # cap bites, the report says so ("events" section) and the
    # journeys rollup steps aside instead of mis-reporting journeys
    # whose early hops rolled off; the file sink keeps everything for
    # scripts/obs_report.py's streaming parser.
    from bigdl_tpu_torch import obs

    if scenario_trace is not None:
        sess_cfg = scenario_trace["sessions"]
        expected_requests = len(scenario_trace["arrivals"]) \
            + sess_cfg["count"] * max(sess_cfg["turns"] - 1, 0)
    else:
        expected_requests = args.requests + args.sessions * args.turns
    ring_cap = min(max(4096, 16 * expected_requests), 1 << 18)
    obs.set_event_log(obs.EventLog(
        capacity=ring_cap,
        path=os.environ.get("BIGDL_OBS_EVENTS") or None))

    if scenario_trace is not None:
        trace = scenario_trace
    else:
        trace = make_trace(args.requests, seed=args.seed,
                           arrival=args.arrival, rate=args.rate,
                           burst_size=args.burst_size,
                           burst_gap_s=args.burst_gap,
                           deadline_frac=args.deadline_frac,
                           deadline_s=args.deadline,
                           sessions=args.sessions,
                           session_turns=args.turns,
                           shared_prefix_len=args.shared_prefix,
                           shared_frac=args.shared_frac,
                           tenants=args.tenants,
                           noisy_tenant=args.noisy_tenant,
                           noisy_mult=args.noisy_mult,
                           vision_frac=args.vision_frac,
                           feature_len=args.feature_len)
    # shared-prefix prompts are prefix + tail long: grow the bucket
    # ladder (and keep max_len a block multiple) so the COLD first
    # request of each prefix still fits one prefill bucket
    buckets = (8, 16, 32)
    max_len = 96
    if args.shared_prefix:
        need = args.shared_prefix + 8
        while max(buckets) < need:
            buckets = buckets + (2 * max(buckets),)
        max_len = max(max_len, max(buckets) + 32)
        max_len += (-max_len) % args.block_size
    # affinity defaults on for the workloads with reuse to protect:
    # multi-turn sessions and spill-tier runs
    affinity = args.affinity if args.affinity is not None \
        else bool(args.sessions or args.host_blocks is not None)
    # multi-tenant mode: every tenant gets a deterministic
    # token bucket on the fleet's virtual clock; the noisy tenant (if
    # any) is budgeted tighter — containment comes from ITS bucket,
    # never from penalizing the others
    tenant_specs = None
    if scenario_trace is not None and scenario_trace.get("tenants"):
        # the scenario declares its tenants (TenantSpec kwargs dicts)
        from bigdl_tpu_torch.serving import TenantSpec

        tenant_specs = [TenantSpec(**kw)
                        for kw in scenario_trace["tenants"]]
    elif args.tenants:
        from bigdl_tpu_torch.serving import TenantSpec

        tenant_specs = []
        for j in range(args.tenants):
            noisy = args.noisy_tenant is not None \
                and j == args.noisy_tenant
            tenant_specs.append(TenantSpec(
                f"tenant{j}",
                weight=1.0,
                bucket_capacity=(args.noisy_bucket_capacity if noisy
                                 else args.bucket_capacity),
                refill_rate=(args.noisy_refill if noisy
                             else args.bucket_refill),
                max_pending=(args.noisy_max_pending if noisy
                             else None)))
    # a scenario's fleet section overrides the sizing flags
    fleet_cfg = dict(engines=args.engines, slots=args.slots,
                     max_queue=args.max_queue,
                     overload_policy=args.overload_policy)
    sim_pacing = "throughput"
    if scenario_trace is not None:
        fc = scenario_trace.get("fleet", {})
        fleet_cfg.update({k: fc[k] for k in fleet_cfg if k in fc})
        sim_pacing = fc.get("pacing", sim_pacing)
    if args.sim_pacing is not None:
        sim_pacing = args.sim_pacing
    if args.sim:
        router, asc, clk = build_sim_fleet(
            fleet_cfg["engines"], slots=fleet_cfg["slots"],
            max_queue=fleet_cfg["max_queue"],
            overload_policy=fleet_cfg["overload_policy"],
            prefill_buckets=buckets, pacing=sim_pacing,
            autoscale=args.autoscale, target_p99_s=args.target_p99,
            max_engines=args.max_engines, tenant_specs=tenant_specs,
            cost=cost)
    else:
        router, asc, clk = build_fleet(
            fleet_cfg["engines"], slots=fleet_cfg["slots"],
            max_queue=fleet_cfg["max_queue"],
            overload_policy=fleet_cfg["overload_policy"],
            prefill_buckets=buckets, max_len=max_len,
            block_size=args.block_size,
            autoscale=args.autoscale,
            target_p99_s=args.target_p99,
            max_engines=args.max_engines,
            tp=args.tp, spec_draft=args.spec_draft,
            spec_k=args.spec_k,
            spec_adaptive=args.spec_adaptive,
            spec_adapt_window=args.spec_adapt_window,
            spec_probe_every=args.spec_probe_every,
            host_blocks=args.host_blocks, affinity=affinity,
            tenant_specs=tenant_specs,
            vision=args.vision_frac > 0,
            vision_engines=args.vision_engines,
            feature_len=args.feature_len, device=args.device,
            weights=weights)
    # speculation flywheel: the distiller ingests every
    # completed stream in completion order (deterministic under the
    # virtual clock) and every --spec-swap-every results trains +
    # hot-swaps the shared draft into each wrapper — pure
    # re-placement, so the byte-identical acceptance holds
    on_result = None
    if args.spec_distill:
        from bigdl_tpu_torch.serving import DraftDistiller, SpeculativeEngine

        spec_pool = [e for e in router.engines
                     if isinstance(e, SpeculativeEngine)]
        distiller = DraftDistiller(spec_pool[0].draft_engine.model,
                                   seq_len=8, epochs=2, seed=args.seed)
        fresh = [0]

        def on_result(res):
            if res.status != "done":
                return
            distiller.ingest(res)
            fresh[0] += 1
            if fresh[0] < args.spec_swap_every:
                return
            fresh[0] = 0
            new_vars = distiller.distill()
            for e in router.engines:
                if isinstance(e, SpeculativeEngine) \
                        and e.fallback is None:
                    e.swap_draft(new_vars, source="loadgen-distill")
    # SLO plane: a sampler ticking once per scheduling
    # round plus declarative objectives/alerts over the same virtual
    # clock — pure function of the trace, so the byte-identical
    # acceptance extends to the new section
    slo = None
    if args.slo_target_p99 is not None or args.slo_goodput is not None:
        from bigdl_tpu_torch.obs.slo import (AlertEngine, AlertRule,
                                       SLOObjective)
        from bigdl_tpu_torch.obs.timeseries import MetricsSampler

        sampler = MetricsSampler(interval_s=args.step_dt,
                                 capacity=8192,
                                 clock=lambda: clk["t"])
        rules = []
        if args.slo_target_p99 is not None:
            rules.append(AlertRule(
                name="latency_p99_burn",
                objective=SLOObjective(
                    name="latency_p99", kind="latency_quantile",
                    metric="router_request_latency_seconds",
                    target=args.slo_target_p99, q=0.99,
                    labels={"router": router._obs_name}),
                kind="burn_rate",
                long_window_s=20 * args.step_dt,
                short_window_s=5 * args.step_dt,
                clear_s=5 * args.step_dt))
            # per-tenant objectives: same burn-rate shape
            # over the tenant-labelled latency family, one objective
            # per tenant, so the report/console can show which
            # tenant's budget is burning (the quiet tenant should
            # stay compliant while the noisy one throttles)
            for j in range(args.tenants):
                tn = f"tenant{j}"
                rules.append(AlertRule(
                    name=f"latency_p99_burn_{tn}",
                    objective=SLOObjective(
                        name=f"latency_p99_{tn}",
                        kind="latency_quantile",
                        metric="router_tenant_request_latency_seconds",
                        target=args.slo_target_p99, q=0.99,
                        labels={"router": router._obs_name,
                                "tenant": tn}),
                    kind="burn_rate",
                    long_window_s=20 * args.step_dt,
                    short_window_s=5 * args.step_dt,
                    clear_s=5 * args.step_dt))
        if args.slo_goodput is not None:
            # under --sim the engine-side serving_requests_total family
            # is silent (SimulatedEngine registers no metric families —
            # engine.py is that family's one registration site), so the
            # budget watches the router-side per-tenant counter
            # instead; it is only fed for tenant-stamped traffic, so a
            # tenant-less sim run measures None (never violates)
            gmetric, glabels = ("serving_requests_total", None)
            if args.sim:
                gmetric = "serving_tenant_requests_total"
                glabels = {"router": router._obs_name}
            rules.append(AlertRule(
                name="goodput_budget",
                objective=SLOObjective(
                    name="goodput", kind="error_budget",
                    metric=gmetric, labels=glabels,
                    target=round(1.0 - args.slo_goodput, 9)),
                kind="threshold", window_s=20 * args.step_dt,
                for_s=2 * args.step_dt, clear_s=5 * args.step_dt))
        aeng = AlertEngine(sampler, rules, clock=lambda: clk["t"])
        slo = (sampler, aeng)

    def slo_observer():
        sampler.tick()
        aeng.evaluate()

    report = replay(router, trace, clock=clk, step_dt=args.step_dt,
                    autoscaler=asc,
                    observer=slo_observer if slo else None,
                    on_result=on_result)
    if slo:
        sampler, aeng = slo
        sampler.sample()              # close the run-wide window
        report["slo"] = {
            "objectives": aeng.compliance(),   # whole-run window
            "alerts": {
                "fired": aeng.fired, "resolved": aeng.resolved,
                "final": {a["alert"]: a["state"]
                          for a in aeng.alerts()},
            },
        }
    if args.tp:
        report["pool"]["tp"] = args.tp
    if args.spec_draft:
        # speculation rollup: tallies straight from the
        # wrappers' host-side stats — deterministic, so the section
        # rides the byte-identical acceptance like everything else
        from bigdl_tpu_torch.serving import SpeculativeEngine

        agg = {"k": args.spec_k, "rounds": 0, "proposed": 0,
               "accepted": 0, "wasted": 0, "emitted": 0,
               "fallbacks": 0}
        for e in router.engines:
            if not isinstance(e, SpeculativeEngine):
                continue
            s = e.stats
            agg["rounds"] += s["spec_rounds"]
            for key in ("proposed", "accepted", "wasted", "emitted",
                        "fallbacks"):
                agg[key] += s[key]
        agg["accept_rate"] = (round(agg["accepted"] / agg["proposed"],
                                    4) if agg["proposed"] else None)
        agg["draft_overhead_share"] = (
            round(agg["wasted"] / agg["proposed"], 4)
            if agg["proposed"] else None)
        if args.spec_adaptive:
            # k trajectory: the spec_k_adjust event stream
            # in ring order — one entry per ladder evaluation; plus
            # the final per-wrapper state. Host-side + rounded, so the
            # section rides the byte-identical acceptance
            agg["adaptive"] = {
                "window": args.spec_adapt_window,
                "probe_every": args.spec_probe_every,
                "k_final": [e.k_live for e in router.engines
                            if isinstance(e, SpeculativeEngine)],
                "suspended_final": [
                    e.health()["speculative"]["suspended"]
                    for e in router.engines
                    if isinstance(e, SpeculativeEngine)],
                "k_trajectory": [
                    {"engine": ev.get("engine"),
                     "round": ev.get("round"),
                     "k_from": ev.get("k_from"),
                     "k_to": ev.get("k_to"),
                     "accept": ev.get("accept"),
                     "suspended": ev.get("suspended")}
                    for ev in obs.get_event_log().events()
                    if ev.get("kind") == "spec_k_adjust"],
            }
        if args.spec_distill:
            # swap events: per-wrapper hot-swap records
            # with the accept rate before/after each swap
            swaps = []
            for e in router.engines:
                if isinstance(e, SpeculativeEngine):
                    swaps.extend(dict(r, engine=e.obs_name)
                                 for r in e.swap_records)
            agg["swaps"] = sorted(
                swaps, key=lambda r: (r["engine"], r["swap"]))
        report["spec"] = agg
    # journey rollup: the CLI runs with the default event
    # log armed, so the trace/hop stamps are already there — report
    # how many requests moved between engines (rebalance/failover/
    # handoff) and that no hop was lost; counts only, so the
    # two-runs-byte-identical acceptance is unaffected by labels
    from bigdl_tpu_torch import obs

    if args.sim:
        # calibration provenance in the report: where every
        # simulated millisecond came from — deterministic floats, so
        # the section rides the byte-identical acceptance
        prov = router.engines[0].model.provenance()
        report["sim"] = {
            "pacing": sim_pacing,
            "decode_ms_per_token": prov["decode_ms_per_token"],
            "prefill_ms_per_token": prov["prefill_ms_per_token"],
            "calibration_sources": len(prov["sources"]),
            "calibration_spread_frac":
                prov["factors"]["calibration_spread_frac"],
        }
    ring_rolled = False
    if obs.enabled():
        nring = len(obs.get_event_log())
        ring_rolled = nring >= ring_cap
        # honest accounting for capped runs (no silent truncation):
        # the ring holds the TAIL of the run; the file sink (if set)
        # holds everything
        report["events"] = {"ring_capacity": ring_cap,
                            "ring_events": nring,
                            "ring_rolled": ring_rolled}
    if obs.enabled() and len(obs.get_event_log()) and not ring_rolled:
        from bigdl_tpu_torch.obs.journey import (build_journeys,
                                           summarize_journeys)

        report["journeys"] = summarize_journeys(
            build_journeys(obs.get_event_log().events()))
    elif ring_rolled:
        # early hops rolled off the ring — a journey rollup here would
        # mis-report rolled journeys as lost hops; obs_report over the
        # JSONL sink is the honest path at this scale
        report["journeys"] = {
            "skipped": "event ring rolled "
                       f"({ring_cap} capacity) — use "
                       "BIGDL_OBS_EVENTS + python -m "
                       "bigdl_tpu_torch.scripts.obs_report"}
    if args.json and _rank() == 0:
        with open(args.json, "w") as f:
            f.write(json.dumps(report, sort_keys=True) + "\n")
    return report


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def main(argv=None) -> int:
    report = run(argv)
    if _rank() == 0:
        print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
