"""Request-journey reconstruction — one cross-engine timeline per
request.

Ports bigdl_tpu/obs/journey.py (pure Python, copied). The fleet moves
a request between engines (rebalance, failover, disaggregated-prefill
handoff), while each event names ONE engine; this module ties a
request's hops together on the READ side of a host-side trace
context:

* every `Request` is stamped with a `trace_id` + `hop` counter at
  admission (router or engine — serving/router.py / engine.py), and
  the hop increments each time the request MOVES: failover
  resubmission, rebalance (`steal_queued` → receiver submit), and
  disaggregated-prefill `import_handoff`;
* every request-lifecycle event (`request_submit`, `prefix_hit`,
  `handoff_export`, `handoff_import`, `router_handoff`,
  `router_failover`, `request_terminal`, ...) carries `trace` + `hop`,
  and the seat-point events also carry the engine's `tp` and `role`;
* `build_journeys` folds a JSONL event list back into one journey per
  trace: an ordered hop table (engine / tp / role / seat kind / dwell
  time per hop), the terminal outcome, and integrity flags (`lost_hops`
  — a hop index that never seated; `superseded_terminals` — the
  transitional 'failed' records a failover replaced).

Everything here is pure host-side post-processing over already-emitted
dicts: zero device syncs, and bit-deterministic for a fixed event
list.

Export: `to_perfetto` renders one track per request (thread-name
metadata + one complete "X" span per hop), loadable in
chrome://tracing / ui.perfetto.dev next to the span tracer's doc.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from bigdl_tpu_torch.obs.events import seat_kinds

__all__ = ["SEAT_KINDS", "build_journeys", "summarize_journeys",
           "journeys_json", "to_perfetto"]

# the event kinds that SEAT a request on an engine — each opens a hop
# (request_submit covers initial dispatch, failover resubmission and
# rebalance moves; handoff_import seats a disaggregated-prefill
# package on its decode engine). Derived from the machine-readable
# EVENT_KINDS registry (obs/events.py) — the `seat` flag
# there is the single source of truth, not a hand-maintained list.
SEAT_KINDS = seat_kinds()

def _new_hop(hop: int) -> dict:
    return {"hop": hop, "engine": None, "tp": None, "role": None,
            "via": None, "t_start": None, "dwell_s": None,
            "events": {}}


def build_journeys(events: List[dict]) -> List[dict]:
    """Fold an event list (oldest first — `EventLog.events()` order or
    a `read_jsonl` file) into one journey dict per trace id, sorted by
    trace id. Events without a `trace` field are ignored.

    Journey shape::

        {"trace": str, "request": id, "hops": [hop...],
         "status"/"reason"/"tokens"/"ttft_s"/"latency_s": <terminal>,
         "t_submit": first seat ts, "t_terminal": terminal ts,
         "engines": [engine per hop], "layouts": [tp per hop],
         "cross_engine": bool, "cross_layout": bool,
         "lost_hops": [missing hop indexes],
         "rejected_attempts": int, "complete": bool,
         "superseded_terminals": int}

    Each hop: engine / tp / role from its seat event, `via`
    ("request_submit" | "handoff_import"), `t_start`, `dwell_s` (seat →
    next seat, or seat → terminal on the last hop — the cross-engine
    latency attribution), and an `events` tally of every other event
    kind that landed on it. A terminal that is FOLLOWED by a later
    seat (the failover's transitional 'failed') is counted superseded,
    exactly mirroring the router's settlement semantics; a hop with a
    terminal but no seat (a request shed/expired at admission) is
    terminal-only, NOT lost."""
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        t = e.get("trace")
        if t is not None:
            by_trace.setdefault(t, []).append(e)
    out = []
    for trace in sorted(by_trace):
        evs = by_trace[trace]
        hops: Dict[int, dict] = {}
        terminal: Optional[dict] = None
        superseded = 0
        request_id = None
        for e in evs:
            kind = e.get("kind")
            hop = int(e.get("hop", 0))
            request_id = e.get("request", request_id)
            rec = hops.get(hop)
            if kind in SEAT_KINDS:
                if terminal is not None:
                    # a seat after a terminal: the terminal was the
                    # transitional 'failed' of a failover — superseded
                    superseded += 1
                    terminal = None
                if rec is None:
                    rec = hops[hop] = _new_hop(hop)
                if rec["via"] is None:
                    rec.update(engine=e.get("engine"), tp=e.get("tp"),
                               role=e.get("role"), via=kind,
                               t_start=e.get("ts"))
                else:
                    # double-seat on one hop index (spillover retries
                    # keep hop 0): keep the first seat, tally the rest
                    rec["events"]["reseat"] = \
                        rec["events"].get("reseat", 0) + 1
            else:
                if rec is None:
                    rec = hops[hop] = _new_hop(hop)
                rec["events"][kind] = rec["events"].get(kind, 0) + 1
                if kind == "request_terminal":
                    terminal = e
        # a hop record holding ONLY rejected-attempt records is a move
        # that bounced off a full queue before any seat (the router
        # pre-increments the hop, the target's _overload emits
        # request_rejected, the router undoes the increment and the
        # request settles elsewhere) — an ATTEMPT, not a hop the
        # request ever made: tally it, never report it lost
        rejected_attempts = 0
        for h in [h for h, r in hops.items()
                  if r["via"] is None
                  and set(r["events"]) == {"request_rejected"}]:
            rejected_attempts += hops[h]["events"]["request_rejected"]
            del hops[h]
        ordered = [hops[h] for h in sorted(hops)]
        for i, rec in enumerate(ordered):
            t0 = rec["t_start"]
            if t0 is None:
                continue
            if i + 1 < len(ordered) and ordered[i + 1]["t_start"] \
                    is not None:
                t1 = ordered[i + 1]["t_start"]
            elif terminal is not None:
                t1 = terminal.get("ts")
            else:
                t1 = None
            if t1 is not None:
                rec["dwell_s"] = round(max(t1 - t0, 0.0), 9)
        max_hop = max(hops) if hops else -1
        # a hop is LOST only if nothing seated it AND nothing settled
        # it: a request shed/expired at admission (the fleet's
        # shed-on-arrival path) yields a legitimate TERMINAL-ONLY hop
        # — the journey is complete, just never seated there
        lost = [h for h in range(max_hop + 1)
                if h not in hops
                or (hops[h]["via"] is None
                    and "request_terminal" not in hops[h]["events"])]
        engines = [r["engine"] for r in ordered]
        layouts = [r["tp"] for r in ordered]
        seated_engines = {e for e in engines if e is not None}
        seated_layouts = {t for t in layouts if t is not None}
        j = {
            "trace": trace,
            "request": request_id,
            "hops": ordered,
            "engines": engines,
            "layouts": layouts,
            "cross_engine": len(seated_engines) > 1,
            "cross_layout": len(seated_layouts) > 1,
            "lost_hops": lost,
            "rejected_attempts": rejected_attempts,
            "superseded_terminals": superseded,
            "complete": terminal is not None and not lost,
            "t_submit": ordered[0]["t_start"] if ordered else None,
            "t_terminal": terminal.get("ts") if terminal else None,
            "status": terminal.get("status") if terminal else None,
            "reason": terminal.get("reason") if terminal else None,
            "tokens": terminal.get("tokens") if terminal else None,
            "ttft_s": terminal.get("ttft_s") if terminal else None,
            "latency_s": terminal.get("latency_s") if terminal else None,
        }
        out.append(j)
    return out


def summarize_journeys(journeys: List[dict]) -> dict:
    """Compact rollup for reports (obs_report / loadgen): counts only,
    deterministic for a fixed journey list."""
    return {
        "count": len(journeys),
        "complete": sum(1 for j in journeys if j["complete"]),
        "cross_engine": sum(1 for j in journeys if j["cross_engine"]),
        "cross_layout": sum(1 for j in journeys if j["cross_layout"]),
        "max_hops": max((len(j["hops"]) for j in journeys), default=0),
        "lost_hops": sum(len(j["lost_hops"]) for j in journeys),
        "superseded_terminals": sum(j["superseded_terminals"]
                                    for j in journeys),
    }


def journeys_json(journeys: List[dict]) -> str:
    """Canonical JSON rendering (sorted keys) — the byte-identity
    surface the drills compare across runs."""
    return json.dumps(journeys, sort_keys=True)


def to_perfetto(journeys: List[dict]) -> dict:
    """Chrome-trace document with ONE track per request: a thread-name
    metadata record per journey plus one complete "X" span per hop
    (span args carry engine/tp/role/events), and an instant "i" marker
    at the terminal. Merges cleanly with SpanTracer.to_chrome_trace()
    output when both use the same clock."""
    evs: List[dict] = []
    for tid, j in enumerate(journeys):
        label = f"{j['trace']}"
        if j["status"] is not None:
            label += f" [{j['status']}]"
        evs.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid, "args": {"name": label}})
        for rec in j["hops"]:
            if rec["t_start"] is None:
                continue
            name = f"hop{rec['hop']} {rec['engine'] or '?'}"
            if rec["tp"] is not None:
                name += f" tp={rec['tp']}"
            evs.append({
                "name": name, "cat": "journey", "ph": "X",
                "ts": rec["t_start"] * 1e6,
                "dur": max(rec["dwell_s"] or 0.0, 0.0) * 1e6,
                "pid": 1, "tid": tid,
                "args": {"engine": rec["engine"], "tp": rec["tp"],
                         "role": rec["role"], "via": rec["via"],
                         "events": rec["events"]}})
        if j["t_terminal"] is not None:
            evs.append({"name": f"terminal[{j['status']}]",
                        "cat": "journey", "ph": "i", "s": "t",
                        "ts": j["t_terminal"] * 1e6, "pid": 1,
                        "tid": tid,
                        "args": {"reason": j["reason"],
                                 "tokens": j["tokens"]}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}
