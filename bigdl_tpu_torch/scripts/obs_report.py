"""Render a run summary from a telemetry JSONL event file.

Ports scripts/obs_report.py over bigdl_tpu_torch.obs (its registry's
bucket quantiles and series keys, the events' kind registry and stream
parser, obs/journey.py). It reads a file and renders text: it runs
nothing on a device.

Input: a file written by the structured event log
(`BIGDL_OBS_EVENTS=/tmp/run.jsonl python <anything>`, or an explicit
`EventLog(path=...)`). Output: a human-readable report —

* event counts by kind (the run's shape at a glance)
* training summary: steps, loss first→last, throughput, anomalies
* serving summary: requests by terminal status, tokens generated,
  degradations
* latency-SLO section: per-engine goodput, TTFT and
  per-token p50/p99, shed/expired/poisoned rates — computed from the
  `ttft_s`/`latency_s` lifecycle stamps the engine puts on every
  `request_terminal` event (engine clock, so a drill log yields
  bit-deterministic percentiles); adds each engine's tp/role
  and a per-layout rollup (sharded vs unsharded traffic split)
* journeys section: per-request cross-engine hop table
  reconstructed by obs/journey.py from the trace/hop stamps — engines
  visited, seat kind per hop, per-hop dwell (the cross-engine TTFT
  attribution), terminal outcome; `--perfetto PATH` exports one
  Perfetto track per request
* alerts / SLO section: per-objective compliance table and
  the firing→resolved timeline reconstructed from the
  `alert_firing`/`alert_resolved` events (obs/slo.py), cross-linked
  to the slo_burn incident bundles those firings dumped
* incidents section: flight-recorder bundles indexed by
  their `incident_dump` events (obs/flightrecorder.py)
* metrics tables + latency percentiles, when the file carries a
  `metrics_snapshot` event (`obs.log_metrics_snapshot()` embeds the
  registry, making the JSONL self-contained)
* a timeline tail (the last N events)

Measurement caveat: wall-clock numbers recorded around an un-fenced
asynchronous CUDA launch measure the launch, not the work. Trust
`train_step`/`decode_step` timings only where the emitting loop fenced
them with a real device→host fetch (the shipped instrumentation does:
the loss fetch fences training steps, the token fetch fences decode).

Scale: the CLI stream-parses the JSONL (one pass,
`obs.stream_jsonl`, torn-tail tolerant) so a 10⁶-event simulator run
summarizes without materializing the file as one list; every rendered
section table is row-capped with an honest "N more rows not shown"
footer, and journey reconstruction — the one hold that needs every
trace-stamped event — is capped with a named skip, never a silent
subset.

Usage:
    python -m bigdl_tpu_torch.scripts.obs_report /tmp/run.jsonl [--tail 20]
"""

from __future__ import annotations

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

import argparse
import math
import sys
from typing import Dict, List, Optional

# THE bucket-quantile estimator and series-key rendering, shared with
# the live registry so report percentiles/keys can never drift from
# engine.health()'s or bench-row provenance
from bigdl_tpu_torch.obs.registry import quantile_from_buckets, series_key
# the machine-readable kind registry: the report flags any
# kind outside it instead of keeping its own hand-maintained list
from bigdl_tpu_torch.obs.events import EVENT_KINDS, validate_record


# -------------------------------------------------- streaming digest
#
# a 10⁶-event simulator run must not be materialized as one
# list just to be summarized. `summarize` makes a SINGLE pass over any
# iterable of events (a list in tests, `obs.stream_jsonl(path)` from
# the CLI), keeping only what the sections need: trimmed terminal
# stamps, the low-volume section events, streamed accumulators for the
# high-volume counters, the LAST metrics snapshot, and a bounded
# timeline tail. The one unavoidable high-volume hold is journey
# reconstruction (every trace-stamped event) — that is capped at
# _JOURNEY_EVENT_CAP with an HONEST skipped note, never a silent
# truncation.

_JOURNEY_EVENT_CAP = 500_000   # trace-stamped events held for journeys
_JOURNEY_TABLE_CAP = 200       # per-request rows kept in the digest
_TAIL_KEEP = 64                # timeline tail held during the pass

# the only request_terminal fields any section reads — a million
# trimmed stamps is a few hundred MB smaller than a million full
# events with prompts and provenance attached
_TERM_FIELDS = ("kind", "status", "tokens", "ts", "ttft_s",
                "latency_s", "tp", "role", "engine", "tenant")


def summarize(events,
              journey_event_cap: int = _JOURNEY_EVENT_CAP
              ) -> Dict[str, object]:
    """Machine-readable digest of an event iterable (the report
    renders this; tests assert on it). Single pass, bounded memory
    modulo the per-request stamp lists and the capped journey hold."""
    from collections import deque

    total = 0
    by_kind: Dict[str, int] = {}
    nonconformant = 0
    ts_min = ts_max = None
    train = {"steps": 0, "first_loss": None, "last_loss": None,
             "thr_sum": 0.0, "updates": 0}
    term: List[dict] = []
    throttles: List[dict] = []
    alert_ev: List[dict] = []
    incident_ev: List[dict] = []
    prefix = {"hits": 0, "tokens_saved": 0, "blocks_reused": 0,
              "evicts": 0, "blocks_evicted": 0}
    kv = {"spills": 0, "spilled_blocks": 0, "readmits": 0,
          "readmitted_blocks": 0}
    migrate_ev: List[dict] = []
    spec_rounds: Dict[str, dict] = {}
    spec_fallbacks: List[dict] = []
    spec_adjusts: List[dict] = []
    spec_swaps: List[dict] = []
    faults: List[str] = []
    ckpt_ev: List[dict] = []
    snapshot = None
    trace_events: List[dict] = []
    trace_event_count = 0
    tail = deque(maxlen=_TAIL_KEEP)

    for e in events:
        total += 1
        kind = e.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if validate_record(e):
            nonconformant += 1
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            ts_min = ts if ts_min is None else min(ts_min, ts)
            ts_max = ts if ts_max is None else max(ts_max, ts)
        tail.append(e)
        if e.get("trace") is not None:
            trace_event_count += 1
            if trace_event_count <= journey_event_cap:
                trace_events.append(e)
        if kind == "train_step":
            train["steps"] += 1
            if "loss" in e:
                if train["first_loss"] is None:
                    train["first_loss"] = e["loss"]
                train["last_loss"] = e["loss"]
            train["thr_sum"] += e.get("throughput", 0.0)
            if e.get("update_applied", True):
                train["updates"] += 1
        elif kind == "request_terminal":
            term.append({k: e.get(k) for k in _TERM_FIELDS})
        elif kind == "tenant_throttled":
            throttles.append({"kind": kind, "tenant": e.get("tenant"),
                              "action": e.get("action")})
        elif kind in ("alert_firing", "alert_resolved"):
            alert_ev.append(e)
        elif kind == "incident_dump":
            incident_ev.append(e)
        elif kind == "prefix_hit":
            prefix["hits"] += 1
            prefix["tokens_saved"] += e.get("matched_tokens", 0)
            prefix["blocks_reused"] += e.get("blocks", 0)
        elif kind == "prefix_evict":
            prefix["evicts"] += 1
            prefix["blocks_evicted"] += e.get("blocks", 0)
        elif kind == "kv_spill":
            kv["spills"] += 1
            kv["spilled_blocks"] += e.get("blocks", 0)
        elif kind == "kv_readmit":
            kv["readmits"] += 1
            kv["readmitted_blocks"] += e.get("blocks", 0)
        elif kind == "prefix_migrate":
            migrate_ev.append(e)
        elif kind == "spec_verify":
            eng = spec_rounds.setdefault(e.get("engine", "?"), {
                "draft": e.get("draft_engine"), "rounds": 0,
                "proposed": 0, "accepted": 0, "emitted": 0})
            eng["rounds"] += 1
            eng["proposed"] += e.get("proposed", 0)
            eng["accepted"] += e.get("accepted", 0)
            eng["emitted"] += e.get("emitted", 0)
        elif kind == "spec_fallback":
            spec_fallbacks.append(e)
        elif kind == "spec_k_adjust":
            spec_adjusts.append(e)
        elif kind == "draft_swap":
            spec_swaps.append(e)
        elif kind == "fault_injected":
            faults.append(f'{e["fault"]}@{e["step"]}')
        elif kind in ("checkpoint_save", "checkpoint_load",
                      "checkpoint_corrupt_skipped"):
            ckpt_ev.append(e)
        elif kind == "metrics_snapshot":
            snapshot = e["snapshot"]

    out: Dict[str, object] = {"total_events": total}
    out["by_kind"] = dict(sorted(by_kind.items()))
    unknown = sorted(k for k in by_kind if k not in EVENT_KINDS)
    if unknown:
        # schema drift: a producer emitted kinds the EVENT_KINDS
        # registry does not know (the lint pins committed code, but a
        # JSONL file may come from anywhere)
        out["unknown_kinds"] = unknown
    if nonconformant:
        out["nonconformant_records"] = nonconformant

    if train["steps"]:
        # loss is omitted on non-fence steps (no summary/log sink
        # needed it, so the loop never fetched it) — report from the
        # steps that carry one
        out["training"] = {
            "steps": train["steps"],
            "first_loss": train["first_loss"],
            "last_loss": train["last_loss"],
            "mean_throughput": round(
                train["thr_sum"] / train["steps"], 2),
            "updates_applied": train["updates"],
            "anomalies": by_kind.get("anomaly", 0),
        }
    if term:
        by_status: Dict[str, int] = {}
        for e in term:
            by_status[e["status"]] = by_status.get(e["status"], 0) + 1
        out["serving"] = {
            "requests": len(term),
            "by_status": dict(sorted(by_status.items())),
            "tokens_generated": sum(e.get("tokens") or 0
                                    for e in term),
            "degradations": by_kind.get("engine_degraded", 0),
            "rejected": by_kind.get("request_rejected", 0),
        }
        out["slo"] = _slo_section(term)
    tenants = _tenant_section(term + throttles)
    if tenants:
        out["tenants"] = tenants
    if trace_event_count > journey_event_cap:
        # HONEST skip: reconstructing journeys needs every
        # trace-stamped event in memory at once — over the cap the
        # section names the overflow instead of silently tabling a
        # subset of requests
        out["journeys"] = {
            "skipped": f"{trace_event_count} trace-stamped events "
                       f"exceed the {journey_event_cap}-event journey "
                       f"hold — raise summarize(journey_event_cap=) "
                       f"to reconstruct"}
    else:
        journeys = _journeys_section(trace_events)
        if journeys:
            out["journeys"] = journeys
    alerts = _alerts_section(alert_ev + incident_ev,
                             span_ts=(ts_min, ts_max))
    if alerts:
        out["alerts"] = alerts
    incidents = _incidents_section(incident_ev)
    if incidents:
        out["incidents"] = incidents
    prefix_sec = _prefix_section(prefix, snapshot)
    if prefix_sec:
        out["prefix"] = prefix_sec
    kv_tier = _kv_tier_section(kv, migrate_ev, len(term),
                               prefix["hits"], snapshot)
    if kv_tier:
        out["kv_tier"] = kv_tier
    spec = _speculation_section(spec_rounds, spec_fallbacks,
                                spec_adjusts, spec_swaps)
    if spec:
        out["speculation"] = spec
    if faults:
        out["faults"] = faults
    ckpt = _checkpoint_section(ckpt_ev, snapshot)
    if ckpt:
        out["checkpoints"] = ckpt
    if snapshot is not None:
        out["metrics"] = _digest_snapshot(snapshot)
    out["timeline_tail"] = list(tail)
    return out


def _pctl(xs: List[float], q: float) -> Optional[float]:
    """Exact nearest-rank percentile over the raw event values (the
    terminal events carry every request's stamps, so no bucket
    estimation is needed here)."""
    if not xs:
        return None
    s = sorted(xs)
    return round(s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))],
                 6)


def _slo_digest(term: List[dict]) -> dict:
    """SLO numbers for one group of request_terminal events: goodput
    (tokens of 'done' requests; per-second over the events' ts span
    when it is nonzero), TTFT / end-to-end / per-token latency
    percentiles from the engine-clock stamps, and the bad-outcome
    rates."""
    done = [e for e in term if e["status"] == "done"]
    n = len(term)
    goodput = sum(e.get("tokens", 0) for e in done)
    ts = [e["ts"] for e in term if isinstance(e.get("ts"), (int, float))]
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    ttft = [e["ttft_s"] for e in done
            if e.get("ttft_s") is not None]
    lat = [e["latency_s"] for e in done
           if e.get("latency_s") is not None]
    per_tok = [(e["latency_s"] - e["ttft_s"])
               / max(e.get("tokens", 1) - 1, 1)
               for e in done
               if e.get("latency_s") is not None
               and e.get("ttft_s") is not None]

    def rate(status):
        return round(sum(1 for e in term if e["status"] == status) / n,
                     4)

    return {
        "requests": n, "done": len(done),
        "goodput_tokens": goodput,
        "goodput_tokens_per_s": (round(goodput / span, 3)
                                 if span > 0 else None),
        "ttft_p50_s": _pctl(ttft, 0.50),
        "ttft_p99_s": _pctl(ttft, 0.99),
        "latency_p50_s": _pctl(lat, 0.50),
        "latency_p99_s": _pctl(lat, 0.99),
        "per_token_p50_s": _pctl(per_tok, 0.50),
        "per_token_p99_s": _pctl(per_tok, 0.99),
        "shed_rate": rate("shed"),
        "expired_rate": rate("expired"),
        "poisoned_rate": rate("poisoned"),
        "failed_rate": rate("failed"),
    }


def _slo_section(term: List[dict]) -> dict:
    """Latency-SLO digest, fleet-wide, per engine label, and per
    tensor-parallel layout. Each per-engine digest carries the
    engine's tp/role (from its terminal events), so dashboards can
    split SLOs by sharding layout without new metric families."""
    engines = sorted({e.get("engine", "?") for e in term})
    per_engine = {}
    for eng in engines:
        evs = [e for e in term if e.get("engine", "?") == eng]
        d = _slo_digest(evs)
        # tp/role ride every request_terminal (engine-constant)
        d["tp"] = evs[-1].get("tp")
        d["role"] = evs[-1].get("role")
        per_engine[eng] = d
    out = {"fleet": _slo_digest(term), "per_engine": per_engine}
    layouts = sorted({e.get("tp") for e in term
                      if e.get("tp") is not None})
    if len(layouts) > 1:
        out["per_layout"] = {
            f"tp={tp}": _slo_digest([e for e in term
                                     if e.get("tp") == tp])
            for tp in layouts}
    return out


def _tenant_section(events: List[dict]) -> Optional[dict]:
    """Per-tenant compliance digest: the same SLO numbers
    the per-engine table carries, split by the tenant each terminal
    billed against, plus the tenant's throttle counts (token-bucket
    defers/sheds from the router's admission gate and kv_quota blocks
    from the engines). Only present when the run carried tenant
    stamps; untagged terminals roll up under '(untagged)'. Accepts
    any event list — summarize passes just the terminal + throttle
    records its streaming pass kept."""
    term = [e for e in events if e.get("kind") == "request_terminal"]
    throttles = [e for e in events
                 if e.get("kind") == "tenant_throttled"]
    if not any(e.get("tenant") for e in term) and not throttles:
        return None
    tenants = sorted({e.get("tenant") or "(untagged)" for e in term}
                     | {e["tenant"] for e in throttles})
    out = {}
    for t in tenants:
        evs = [e for e in term
               if (e.get("tenant") or "(untagged)") == t]
        d = _slo_digest(evs) if evs else {"requests": 0, "done": 0}
        thr = [e for e in throttles if e["tenant"] == t]
        by_action: Dict[str, int] = {}
        for e in thr:
            by_action[e["action"]] = by_action.get(e["action"], 0) + 1
        d["throttled"] = dict(sorted(by_action.items()))
        out[t] = d
    return out


def _journeys_section(events: List[dict]) -> Optional[dict]:
    """Request-journey digest: summary counts plus a
    per-request hop table — engines visited, seat kind and dwell per
    hop (the cross-engine TTFT/latency attribution)."""
    from bigdl_tpu_torch.obs.journey import build_journeys, summarize_journeys

    journeys = build_journeys(events)
    if not journeys:
        return None
    table = []
    for j in journeys[:_JOURNEY_TABLE_CAP]:
        table.append({
            "trace": j["trace"], "request": j["request"],
            "status": j["status"], "tokens": j["tokens"],
            "ttft_s": j["ttft_s"], "latency_s": j["latency_s"],
            "hops": [
                {"engine": h["engine"], "tp": h["tp"],
                 "role": h["role"], "via": h["via"],
                 "dwell_s": h["dwell_s"]} for h in j["hops"]],
            "lost_hops": j["lost_hops"],
        })
    out = {"summary": summarize_journeys(journeys), "table": table}
    if len(journeys) > _JOURNEY_TABLE_CAP:
        # summary covers ALL journeys; the per-request table is capped
        # — name the overflow (no-silent-caps)
        out["table_more"] = len(journeys) - _JOURNEY_TABLE_CAP
    return out


def _alerts_section(events: List[dict],
                    span_ts: Optional[tuple] = None) -> Optional[dict]:
    """Alerts / SLO digest: the firing→resolved timeline
    reconstructed from `alert_firing`/`alert_resolved` events
    (obs/slo.py), per-objective compliance over the run (time spent
    firing vs the event span), and cross-links to the flight-recorder
    bundles those firings dumped (incident_dump events whose
    trigger_kind is alert_firing). `span_ts=(ts_min, ts_max)` lets the
    streaming pass supply the WHOLE run's span without handing over
    every event; without it the span is the passed events' ts extent
    (the original list-mode behavior, pinned by test_slo)."""
    firing = [e for e in events if e.get("kind") == "alert_firing"]
    resolved = [e for e in events if e.get("kind") == "alert_resolved"]
    if not (firing or resolved):
        return None
    if span_ts is not None and span_ts[0] is not None:
        lo, hi = span_ts
        ts = [lo, hi]
        span = hi - lo
    else:
        ts = [e["ts"] for e in events
              if isinstance(e.get("ts"), (int, float))]
        span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    timeline: List[dict] = []
    open_by_alert: Dict[str, dict] = {}
    for e in sorted(firing + resolved, key=lambda r: r.get("seq", 0)):
        if e["kind"] == "alert_firing":
            rec = {"alert": e.get("alert"),
                   "objective": e.get("objective"),
                   "fired_ts": e.get("ts"), "value": e.get("value"),
                   "target": e.get("target"),
                   "window_s": e.get("window_s"),
                   "rule_kind": e.get("rule_kind"),
                   "resolved_ts": None, "firing_s": None}
            timeline.append(rec)
            open_by_alert[e.get("alert")] = rec
        else:
            rec = open_by_alert.pop(e.get("alert"), None)
            if rec is not None:
                rec["resolved_ts"] = e.get("ts")
                rec["firing_s"] = e.get("firing_s")
    per_obj: Dict[str, dict] = {}
    intervals: Dict[str, List[tuple]] = {}
    for rec in timeline:
        key = rec["objective"] or "?"
        o = per_obj.setdefault(key, {
            "alerts": 0, "time_firing_s": 0.0, "still_firing": 0})
        o["alerts"] += 1
        if rec["resolved_ts"] is None and rec["firing_s"] is None:
            o["still_firing"] += 1
        if isinstance(rec["fired_ts"], (int, float)) and ts:
            # an open firing burns budget up to the log's end
            end = rec["resolved_ts"] \
                if isinstance(rec["resolved_ts"], (int, float)) \
                else max(ts)
            intervals.setdefault(key, []).append(
                (rec["fired_ts"], max(end, rec["fired_ts"])))
    for key, ivs in intervals.items():
        # UNION the firing intervals: two rules over one objective
        # (the standard burn_rate + threshold pairing) firing together
        # must not double-count budget and drive compliance negative
        total, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in sorted(ivs):
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        per_obj[key]["time_firing_s"] = total
    for o in per_obj.values():
        o["time_firing_s"] = round(o["time_firing_s"], 6)
        o["compliant_frac"] = (
            round(max(0.0, 1.0 - o["time_firing_s"] / span), 4)
            if span > 0 else None)
    out = {"firing_events": len(firing),
           "resolved_events": len(resolved),
           "objectives": dict(sorted(per_obj.items())),
           "timeline": timeline}
    bundles = [e.get("bundle") for e in events
               if e.get("kind") == "incident_dump"
               and e.get("trigger_kind") == "alert_firing"]
    if bundles:
        out["bundles"] = bundles
    return out


def _incidents_section(events: List[dict]) -> Optional[dict]:
    """Flight-recorder digest: every incident_dump event
    names its bundle directory, trigger and component."""
    dumps = [e for e in events if e.get("kind") == "incident_dump"]
    if not dumps:
        return None
    by_kind: Dict[str, int] = {}
    for e in dumps:
        k = e.get("incident", "?")
        by_kind[k] = by_kind.get(k, 0) + 1
    return {
        "count": len(dumps),
        "by_incident": dict(sorted(by_kind.items())),
        "bundles": [{"bundle": e.get("bundle"),
                     "incident": e.get("incident"),
                     "component": e.get("component"),
                     "trigger_kind": e.get("trigger_kind")}
                    for e in dumps],
    }


def _prefix_section(acc: dict, snapshot: Optional[dict]
                    ) -> Optional[dict]:
    """Prefix-cache digest: hit rate / tokens and bytes
    saved / pool occupancy, from the serving_prefix_* counters and the
    serving_kv_pool_blocks_in_use gauge of the last embedded
    metrics_snapshot, cross-checked against the raw prefix_hit /
    prefix_evict events (which carry per-hit matched token counts even
    when no snapshot was logged). `acc` is summarize's streamed
    hit/evict accumulator — the raw events are never held."""
    out: dict = {}
    if acc["hits"]:
        out["hits"] = acc["hits"]
        out["tokens_saved"] = acc["tokens_saved"]
        out["blocks_reused"] = acc["blocks_reused"]
    if acc["evicts"]:
        out["blocks_evicted"] = acc["blocks_evicted"]
    if snapshot is not None:
        metrics = snapshot.get("metrics", {})

        def total(name):
            fam = metrics.get(name)
            if fam is None:
                return None
            return sum(s["value"] for s in fam["series"])

        hits = total("serving_prefix_hits_total")
        prefills = total("serving_prefill_calls_total")
        if hits is not None:
            out.setdefault("hits", hits)
            out["hit_rate"] = (round(hits / prefills, 4)
                               if prefills else None)
        for key, name in (
                ("tokens_saved", "serving_prefix_tokens_saved_total"),
                ("bytes_saved", "serving_prefix_bytes_saved_total"),
                ("blocks_reused",
                 "serving_prefix_blocks_reused_total")):
            v = total(name)
            if v is not None:
                out.setdefault(key, v)
        occ = metrics.get("serving_kv_pool_blocks_in_use")
        if occ is not None:
            out["pool_blocks_in_use"] = {
                s["labels"].get("engine", "?"): s["value"]
                for s in occ["series"]}
    return out or None


def _kv_tier_section(acc: dict, migrate_ev: List[dict], n_term: int,
                     n_hits: int, snapshot: Optional[dict]
                     ) -> Optional[dict]:
    """Host spill-tier digest: spill/re-admit block flow
    from the kv_spill / kv_readmit events (streamed into `acc`),
    warm-state migrations from prefix_migrate (source -> target
    paths), per-tier occupancy from the serving_kv_tier_blocks_in_use
    gauge of the last embedded metrics snapshot, and the hit-source
    split — a prefix hit whose chain had spilled re-admits from host
    (one kv_readmit event per re-admitted hit), the rest serve
    straight from the device tree, and everything else prefilled cold
    (miss)."""
    if not (acc["spills"] or acc["readmits"] or migrate_ev):
        return None
    out: dict = {
        "spilled_blocks": acc["spilled_blocks"],
        "readmitted_blocks": acc["readmitted_blocks"],
        "migrations": len(migrate_ev),
        "migrated_blocks": sum(e.get("blocks", 0) for e in migrate_ev),
    }
    if migrate_ev:
        out["migration_paths"] = [
            {"source": e.get("source"), "target": e.get("target"),
             "blocks": e.get("blocks"), "chains": e.get("chains")}
            for e in migrate_ev]
    if n_term:
        out["hit_source"] = {
            "host": acc["readmits"],
            "device": max(n_hits - acc["readmits"], 0),
            "miss": max(n_term - n_hits, 0),
        }
    if snapshot is not None:
        occ = snapshot.get("metrics", {}).get(
            "serving_kv_tier_blocks_in_use")
        if occ is not None:
            out["tier_blocks_in_use"] = {
                f'{s["labels"].get("engine", "?")}'
                f'/{s["labels"].get("tier", "?")}': s["value"]
                for s in occ["series"]}
    return out


def _speculation_section(per_engine: Dict[str, dict],
                         fallbacks: List[dict], adjusts: List[dict],
                         swaps: List[dict]) -> Optional[dict]:
    """Speculative-decoding digest: per-engine accept rate
    and draft-overhead share streamed from the `spec_verify` round
    events (summarize accumulates them — verify rounds are per-token
    volume, never held), plus any `spec_fallback` degradations.
    `draft_overhead_share` is the fraction of draft proposals whose
    compute bought no token (wasted / proposed) — the price of
    misprediction; `tokens_per_round` is the amortization the verify
    pass achieved (1.0 = no better than target-only decode)."""
    if not (per_engine or fallbacks or adjusts or swaps):
        return None
    per_engine = {k: dict(v) for k, v in per_engine.items()}
    for eng in per_engine.values():
        prop = eng["proposed"]
        eng["accept_rate"] = (round(eng["accepted"] / prop, 4)
                              if prop else None)
        eng["draft_overhead_share"] = (
            round((prop - eng["accepted"]) / prop, 4) if prop else None)
        eng["tokens_per_round"] = (round(eng["emitted"] / eng["rounds"],
                                         4) if eng["rounds"] else None)
    out: dict = {"per_engine": dict(sorted(per_engine.items()))}
    if fallbacks:
        out["fallbacks"] = [{"engine": e.get("engine"),
                             "draft": e.get("draft_engine"),
                             "reason": e.get("reason")}
                            for e in fallbacks]
    if adjusts:
        # the adaptive-lookahead k-timeline: one entry per
        # ladder evaluation, in event order — obs_report's view of the
        # flywheel's k trajectory
        out["k_timeline"] = [
            {"engine": e.get("engine"), "round": e.get("round"),
             "k_from": e.get("k_from"), "k_to": e.get("k_to"),
             "accept": e.get("accept"),
             "suspended": e.get("suspended")}
            for e in adjusts]
    if swaps:
        # swap markers: accept_after is measured AFTER the event is
        # emitted, so pair each swap with its engine's NEXT ladder
        # evaluation (events are immutable)
        out["swaps"] = []
        for e in swaps:
            after = next(
                (a.get("accept") for a in adjusts
                 if a.get("engine") == e.get("engine")
                 and a.get("seq", 0) > e.get("seq", 0)), None)
            out["swaps"].append(
                {"engine": e.get("engine"),
                 "draft": e.get("draft_engine"),
                 "swap": e.get("swap"), "round": e.get("round"),
                 "source": e.get("source"),
                 "accept_before": e.get("accept_before"),
                 "accept_after": after})
    return out


def _checkpoint_section(events: List[dict],
                        snapshot: Optional[dict] = None
                        ) -> Optional[dict]:
    """Checkpoint digest: save cadence and durations from
    the enriched `checkpoint_save` events (`async`/`duration_s`/
    `shard`/`nshards` fields), load + corrupt-skip counts, and the
    `training_checkpoint_seconds` histogram of the last embedded
    metrics snapshot when one exists. Per-shard unit writes (events
    carrying a `shard` field) are tallied separately — the cadence and
    duration stats describe whole-checkpoint publishes only."""
    saves = [e for e in events if e.get("kind") == "checkpoint_save"]
    finals = [e for e in saves if "shard" not in e]
    units = [e for e in saves if "shard" in e]
    loads = [e for e in events if e.get("kind") == "checkpoint_load"]
    skipped = [e for e in events
               if e.get("kind") == "checkpoint_corrupt_skipped"]
    if not (saves or loads or skipped):
        return None
    out: dict = {"saves": len(finals), "loads": len(loads),
                 "corrupt_skipped": len(skipped)}
    if finals:
        out["async_saves"] = sum(1 for e in finals if e.get("async"))
        steps = sorted(e["step"] for e in finals
                       if isinstance(e.get("step"), (int, float)))
        gaps = [b - a for a, b in zip(steps, steps[1:]) if b > a]
        if gaps:
            out["save_cadence_steps"] = round(sum(gaps) / len(gaps), 2)
        durs = [e["duration_s"] for e in finals
                if isinstance(e.get("duration_s"), (int, float))]
        if durs:
            out["save_duration_p50_s"] = _pctl(durs, 0.50)
            out["save_duration_max_s"] = round(max(durs), 6)
    if units:
        out["shard_unit_writes"] = len(units)
        out["nshards"] = max(int(e.get("nshards", 1)) for e in units)
    if loads:
        out["sharded_loads"] = sum(1 for e in loads if e.get("sharded"))
    if snapshot is not None:
        fam = snapshot.get("metrics", {}).get(
            "training_checkpoint_seconds")
        if fam is not None:
            out["histogram"] = {
                s["labels"].get("mode", "?"): {
                    "count": s["count"],
                    "p50_s": quantile_from_buckets(
                        s["buckets"], s["counts"], 0.50),
                    "p95_s": quantile_from_buckets(
                        s["buckets"], s["counts"], 0.95)}
                for s in fam["series"]}
    return out


def _digest_snapshot(snapshot: dict) -> dict:
    """Counters/gauges verbatim; histograms → count/sum/p50/p95/p99."""
    out = {}
    for name, fam in sorted(snapshot.get("metrics", {}).items()):
        for s in fam["series"]:
            label = series_key(name, s["labels"])
            if fam["kind"] == "histogram":
                out[label] = {
                    "count": s["count"], "sum": round(s["sum"], 6),
                    "p50": quantile_from_buckets(
                        s["buckets"], s["counts"], 0.50),
                    "p95": quantile_from_buckets(
                        s["buckets"], s["counts"], 0.95),
                    "p99": quantile_from_buckets(
                        s["buckets"], s["counts"], 0.99)}
            else:
                out[label] = s["value"]
    return out


_SECTION_ROW_CAP = 24  # rendered rows per section table


def _capped(rows: List[tuple],
            cap: int = _SECTION_ROW_CAP) -> List[tuple]:
    """Cap a section's rendered rows with an HONEST footer naming how
    many were dropped (no-silent-caps) — a million-request run must
    not print a million per-engine lines, and must not pretend it
    printed them all either."""
    if len(rows) <= cap:
        return rows
    return rows[:cap] + [("…", f"{len(rows) - cap} more rows "
                               f"not shown")]


def _fmt_table(rows: List[tuple], indent: str = "  ") -> str:
    if not rows:
        return ""
    w = max(len(str(r[0])) for r in rows)
    return "\n".join(f"{indent}{str(k):<{w}}  {v}" for k, v in rows)


def render(events, tail: int = 15) -> str:
    """Render the report text from any event iterable (list or
    `obs.stream_jsonl` generator — one pass either way). Every
    section table is row-capped with an honest footer (_capped)."""
    s = summarize(events)
    lines = [f"telemetry report — {s['total_events']} events"]
    lines.append("\nevents by kind:")
    lines.append(_fmt_table(_capped(
        [(k + ("" if k in EVENT_KINDS else " [unregistered]"), n)
         for k, n in sorted(s["by_kind"].items())])))
    if "training" in s:
        t = s["training"]
        lines.append("\ntraining:")
        loss_txt = "n/a" if t["first_loss"] is None else \
            f"{t['first_loss']:.6g} -> {t['last_loss']:.6g}"
        lines.append(_fmt_table([
            ("steps", t["steps"]),
            ("loss", loss_txt),
            ("mean throughput", f"{t['mean_throughput']} rec/s"),
            ("updates applied", f"{t['updates_applied']}/{t['steps']}"),
            ("anomalies", t["anomalies"])]))
    if "serving" in s:
        v = s["serving"]
        lines.append("\nserving:")
        lines.append(_fmt_table(
            [("requests", v["requests"]),
             ("tokens generated", v["tokens_generated"]),
             ("degradations", v["degradations"]),
             ("rejected", v["rejected"])]
            + [(f"status {k}", n)
               for k, n in v["by_status"].items()]))
    if "slo" in s:
        def fmt_slo(d):
            def sec(v):
                return "-" if v is None else f"{v:.4g}s"
            gps = d["goodput_tokens_per_s"]
            return (f"done {d['done']}/{d['requests']}"
                    f"  goodput {d['goodput_tokens']} tok"
                    + (f" ({gps}/s)" if gps is not None else "")
                    + f"  ttft p50/p99 {sec(d['ttft_p50_s'])}"
                      f"/{sec(d['ttft_p99_s'])}"
                    + f"  per-tok {sec(d['per_token_p50_s'])}"
                      f"/{sec(d['per_token_p99_s'])}"
                    + f"  shed/exp/poison {d['shed_rate']}"
                      f"/{d['expired_rate']}/{d['poisoned_rate']}")
        lines.append("\nserving SLO:")
        rows = [("fleet", fmt_slo(s["slo"]["fleet"]))]
        for eng, d in s["slo"]["per_engine"].items():
            tag = eng
            if d.get("tp") is not None:
                tag += f" (tp={d['tp']}"
                tag += f", {d['role']})" if d.get("role") else ")"
            rows.append((tag, fmt_slo(d)))
        for layout, d in s["slo"].get("per_layout", {}).items():
            rows.append((layout, fmt_slo(d)))
        lines.append(_fmt_table(_capped(rows)))
    if "tenants" in s:
        lines.append("\ntenants:")
        rows = []
        for t, d in s["tenants"].items():
            thr = d.get("throttled", {})
            thr_txt = ("none" if not thr else
                       " ".join(f"{k}={n}"
                                for k, n in thr.items()))
            if d["requests"]:
                p99 = d.get("latency_p99_s")
                p99_txt = "-" if p99 is None else f"{p99:.4g}s"
                rows.append((t, f"done {d['done']}/{d['requests']}"
                                f"  goodput {d['goodput_tokens']} tok"
                                f"  p99 {p99_txt}"
                                f"  throttled {thr_txt}"))
            else:
                rows.append((t, f"no terminals  throttled {thr_txt}"))
        lines.append(_fmt_table(_capped(rows)))
    if "journeys" in s:
        lines.append("\nrequest journeys:")
        if "skipped" in s["journeys"]:
            lines.append(f"  skipped: {s['journeys']['skipped']}")
        else:
            jm = s["journeys"]["summary"]
            lines.append(_fmt_table([
                ("requests", jm["count"]),
                ("complete", jm["complete"]),
                ("cross-engine", jm["cross_engine"]),
                ("cross-layout", jm["cross_layout"]),
                ("max hops", jm["max_hops"]),
                ("lost hops", jm["lost_hops"]),
                ("superseded terminals", jm["superseded_terminals"])]))
            rows = []
            for j in s["journeys"]["table"][:20]:
                path = " -> ".join(
                    f"{h['engine'] or '?'}"
                    + (f"[tp{h['tp']}]"
                       if h["tp"] not in (None, 1) else "")
                    + (f"({h['dwell_s']:.3g}s)"
                       if h["dwell_s"] is not None else "")
                    for h in j["hops"])
                rows.append((j["trace"], f"{path} => {j['status']} "
                                         f"({j['tokens']} tok)"))
            # the digest table is itself capped — count BOTH cuts in
            # the footer so nothing is silently dropped
            more = (len(s["journeys"]["table"]) - 20
                    if len(s["journeys"]["table"]) > 20 else 0) \
                + s["journeys"].get("table_more", 0)
            if more:
                rows.append(("…", f"{more} more rows not shown"))
            lines.append(_fmt_table(rows))
    if "alerts" in s:
        al = s["alerts"]
        lines.append("\nalerts / SLO:")
        rows = []
        for obj, o in al["objectives"].items():
            comp = ("-" if o["compliant_frac"] is None
                    else f"{o['compliant_frac']:.2%}")
            extra = (f", {o['still_firing']} still firing"
                     if o["still_firing"] else "")
            rows.append((obj, f"{o['alerts']} alert(s), "
                              f"{o['time_firing_s']}s firing, "
                              f"compliant {comp}{extra}"))
        for rec in al["timeline"]:
            state = ("resolved after "
                     f"{rec['firing_s']}s" if rec["firing_s"]
                     is not None else "STILL FIRING")
            rows.append((
                f"{rec['alert']} @ {rec['fired_ts']}",
                f"{rec['objective']} value {rec['value']} > target "
                f"{rec['target']} (window {rec['window_s']}s, "
                f"{rec['rule_kind']}) -> {state}"))
        for b in al.get("bundles", []):
            rows.append((b, "post-mortem bundle (slo_burn)"))
        lines.append(_fmt_table(_capped(rows)))
    if "incidents" in s:
        inc = s["incidents"]
        lines.append("\nincidents (flight recorder):")
        rows = [(f"{k}", n) for k, n in inc["by_incident"].items()]
        rows += [(b["bundle"],
                  f"{b['incident']} @ {b['component']} "
                  f"(trigger {b['trigger_kind']})")
                 for b in inc["bundles"]]
        lines.append(_fmt_table(_capped(rows)))
    if "prefix" in s:
        p = s["prefix"]
        lines.append("\nprefix cache:")
        rows = [(k, v) for k, v in p.items()
                if k != "pool_blocks_in_use"]
        if "pool_blocks_in_use" in p:
            rows += [(f"pool in use [{eng}]", v)
                     for eng, v in p["pool_blocks_in_use"].items()]
        lines.append(_fmt_table(_capped(rows)))
    if "kv_tier" in s:
        kt = s["kv_tier"]
        lines.append("\nkv tier (host spill):")
        rows = [("spilled blocks", kt["spilled_blocks"]),
                ("re-admitted blocks", kt["readmitted_blocks"]),
                ("migrations", kt["migrations"]),
                ("migrated blocks", kt["migrated_blocks"])]
        if "hit_source" in kt:
            hs = kt["hit_source"]
            rows.append(("hit source",
                         f"device {hs['device']} / host {hs['host']}"
                         f" / miss {hs['miss']}"))
        for path in kt.get("migration_paths", []):
            rows.append((f"{path['source']} -> {path['target']}",
                         f"{path['blocks']} blocks "
                         f"({path['chains']} chains)"))
        for key, v in sorted(kt.get("tier_blocks_in_use",
                                    {}).items()):
            rows.append((f"tier in use [{key}]", v))
        lines.append(_fmt_table(_capped(rows)))
    if "speculation" in s:
        sp = s["speculation"]
        lines.append("\nspeculative decoding:")
        rows = []
        for eng, d in sp["per_engine"].items():
            ar = "-" if d["accept_rate"] is None \
                else f"{d['accept_rate']:.2%}"
            oh = "-" if d["draft_overhead_share"] is None \
                else f"{d['draft_overhead_share']:.2%}"
            rows.append((f"{eng} (draft {d['draft']})",
                         f"{d['rounds']} rounds, accept {ar}, "
                         f"{d['tokens_per_round']} tok/round, "
                         f"draft overhead {oh}"))
        for f in sp.get("fallbacks", []):
            rows.append((f"{f['engine']} FALLBACK",
                         f"draft {f['draft']} lost: {f['reason']}"))
        for w in sp.get("swaps", []):
            aft = "-" if w["accept_after"] is None \
                else f"{w['accept_after']:.2%}"
            bef = "-" if w["accept_before"] is None \
                else f"{w['accept_before']:.2%}"
            rows.append((f"{w['engine']} SWAP #{w['swap']}",
                         f"round {w['round']} ({w['source']}): "
                         f"accept {bef} -> {aft}"))
        lines.append(_fmt_table(_capped(rows)))
        if sp.get("k_timeline"):
            kt = sp["k_timeline"]
            traj = " ".join(
                f"{e['k_from']}->{e['k_to']}"
                + ("S" if e.get("suspended") else "")
                for e in kt[:24])
            if len(kt) > 24:
                traj += f" … (+{len(kt) - 24} more)"
            lines.append(f"  k-timeline ({len(kt)} evaluations): "
                         f"{traj}")
    if "faults" in s:
        lines.append("\ninjected faults: " + ", ".join(s["faults"]))
    if "checkpoints" in s:
        c = s["checkpoints"]
        lines.append("\ncheckpoints:")
        rows = [(k, v) for k, v in sorted(c.items())
                if k != "histogram"]
        for mode, h in sorted(c.get("histogram", {}).items()):
            def sec(v):
                return "-" if v is None else f"{v * 1e3:.3g}ms"
            rows.append((f"{mode} save (hist)",
                         f"n={h['count']} p50/p95="
                         f"{sec(h['p50_s'])}/{sec(h['p95_s'])}"))
        lines.append(_fmt_table(_capped(rows)))
    if "metrics" in s:
        lines.append("\nmetrics (last snapshot):")
        rows = []
        for k, v in s["metrics"].items():
            if isinstance(v, dict):
                pcts = "/".join(
                    "-" if v[p] is None else f"{v[p] * 1e3:.3g}ms"
                    for p in ("p50", "p95", "p99"))
                rows.append((k, f"n={v['count']} sum={v['sum']}s "
                                f"p50/p95/p99={pcts}"))
            else:
                rows.append((k, v))
        lines.append(_fmt_table(_capped(rows, cap=64)))
    tail_events = s.get("timeline_tail", [])
    if tail and tail_events:
        shown = tail_events[-min(tail, len(tail_events)):]
        lines.append(f"\ntimeline (last {len(shown)} of "
                     f"{s['total_events']}):")
        rows = []
        for e in shown:
            extra = {k: v for k, v in e.items()
                     if k not in ("schema", "ts", "seq", "kind",
                                  "snapshot")}
            rows.append((f"[{e.get('seq', '?')}] {e.get('kind')}",
                         " ".join(f"{k}={v}" for k, v in extra.items())))
        lines.append(_fmt_table(rows))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="JSONL event file (EventLog sink / "
                                 "BIGDL_OBS_EVENTS)")
    ap.add_argument("--tail", type=int, default=15,
                    help="timeline tail length (0 disables)")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="also export the reconstructed request "
                         "journeys as a Perfetto/chrome-trace JSON "
                         "(one track per request, obs/journey.py)")
    args = ap.parse_args(argv)
    from bigdl_tpu_torch.obs.events import stream_jsonl

    # stream, never materialize: a 10⁶-event sim run summarizes in
    # one pass with bounded holds
    try:
        text = render(stream_jsonl(args.path), tail=args.tail)
    except OSError as e:
        print(f"obs-report: cannot read {args.path}: {e}")
        return 2
    if text.startswith("telemetry report — 0 events"):
        print(f"obs-report: no events in {args.path}")
        return 2
    print(text)
    if args.perfetto:
        import json as _json

        from bigdl_tpu_torch.obs.journey import build_journeys, to_perfetto

        # second streaming pass: only the trace-stamped lifecycle
        # events feed build_journeys
        trace_events = [e for e in stream_jsonl(args.path)
                        if e.get("trace") is not None]
        with open(args.perfetto, "w") as f:
            _json.dump(to_perfetto(build_journeys(trace_events)), f)
        print(f"\nperfetto journey tracks -> {args.perfetto}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
