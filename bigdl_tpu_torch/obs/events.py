"""Structured JSONL event log — one schema-versioned record per
step / request / anomaly / checkpoint / fault-injection / degradation.

Ports bigdl_tpu/obs/events.py (pure Python, copied): a drill or a
benchmark asserts on what a run DID from machine-readable records, and
the records of the two packages have one shape and one kind registry.

Record shape (every record)::

    {"schema": 1, "ts": <clock seconds>, "seq": <monotonic int>,
     "kind": "<event kind>", ...kind-specific fields}

The kinds in use across the codebase live in the machine-readable
`EVENT_KINDS` registry below — kind → required/optional
fields + a one-line doc. It is THE single source of truth: the journey
reconstruction derives its seat/lifecycle sets from it, `obs_report` flags
kinds outside it, and `validate_record` checks a parsed record against
it. Emitting an unregistered kind still WORKS at runtime (the schema
stays open for experiments).

Request-journey tracing: the kinds marked `journey` in the
registry additionally carry `trace` (the host-side trace id stamped
on the Request at admission) and `hop` (how many times the request has
moved between engines — failover, rebalance, handoff import), and the
`seat`-marked kinds (request_submit, handoff_import) carry the
engine's `tp` + `role`; `obs/journey.py` folds a JSONL file back into
one cross-engine timeline per request.

The log is ring-buffered in memory (default 4096 records) with an
optional JSONL file sink; both the clock and the buffer are injectable
so fault drills assert on bit-reproducible records. Listeners
(`add_listener`) observe every record synchronously AFTER it lands in
the ring — the flight recorder's subscription point; a process with no
listener installed pays one empty-list check per emit.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from typing import Dict, IO, Iterable, List, Optional

__all__ = ["SCHEMA_VERSION", "EVENT_KINDS", "EventLog",
           "get_event_log", "set_event_log", "read_jsonl",
           "required_fields", "seat_kinds", "validate_record"]

SCHEMA_VERSION = 1

# Machine-readable event-kind registry. Per kind:
#   required — fields every record of the kind carries
#              (validate_record checks parsed records at runtime);
#   optional — fields a record MAY carry;
#   journey  — carries trace/hop journey stamps (obs/journey.py);
#   seat     — opens a journey hop on an engine (SEAT_KINDS);
#   doc      — one line for humans.
# The envelope fields schema/ts/seq/kind are stamped by EventLog.emit
# and never listed. "plane" (training|serving) is conventional on most
# kinds and listed per kind.
EVENT_KINDS: Dict[str, dict] = {
    # ---- training plane ------------------------------------------------
    "train_step": {
        "required": ("plane", "step", "epoch", "lr", "throughput",
                     "update_applied"),
        "optional": ("loss", "gnorm"),
        "doc": "one optimizer step (obs/training.py; loss omitted when "
               "nothing else fenced it — the piggyback contract)"},
    "anomaly": {
        "required": ("plane", "step", "action", "policy", "gnorm"),
        "optional": (),
        "doc": "anomaly-guard observation (utils/anomaly.py)"},
    "fault_injected": {
        "required": ("fault", "step"),
        "optional": ("plane",),
        "doc": "a utils/faults shot fired (drill provenance)"},
    "preempted": {
        "required": ("plane", "step"),
        "optional": (),
        "doc": "worker preemption re-raised out of a training loop "
               "(flight-recorder trigger)"},
    "checkpoint_save": {
        "required": ("step", "path", "async", "duration_s", "nshards"),
        "optional": ("shard", "mid_cycle", "plane"),
        "doc": "one save unit; the whole-checkpoint publish record is "
               "the one WITHOUT a shard field"},
    "checkpoint_load": {
        "required": ("path",),
        "optional": ("sharded", "nshards", "plane"),
        "doc": "a checkpoint directory loaded (sharded dirs carry "
               "sharded/nshards)"},
    "checkpoint_corrupt_skipped": {
        "required": ("path", "error"),
        "optional": ("plane",),
        "doc": "a corrupt checkpoint skipped during latest-discovery "
               "fallback (flight-recorder trigger)"},
    "perf_result": {
        "required": ("plane", "model", "batch_size", "iterations",
                     "compile_s", "steady_wall_s", "images_per_sec"),
        "optional": (),
        "doc": "models/perf.py benchmark result row"},
    # ---- serving plane: request lifecycle ------------------------------
    "request_submit": {
        "required": ("plane", "engine", "request", "prompt_len",
                     "priority", "tp", "role"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True, "seat": True,
        "doc": "request admitted to an engine queue (initial dispatch, "
               "failover resubmission, rebalance move)"},
    "request_rejected": {
        "required": ("plane", "engine", "request", "queue_depth"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True,
        "doc": "submission bounced off a full queue "
               "(overload_policy='reject')"},
    "request_terminal": {
        "required": ("plane", "engine", "request", "status", "reason",
                     "tokens", "ttft_s", "latency_s", "tp", "role"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True,
        "doc": "request reached a terminal status "
               "(done/shed/expired/poisoned/failed)"},
    "prefix_hit": {
        "required": ("plane", "engine", "request", "matched_tokens",
                     "blocks", "prompt_len"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True,
        "doc": "paged-KV prefix reuse at admission"},
    "tenant_throttled": {
        "required": ("plane", "tenant", "action"),
        "optional": ("router", "engine", "request", "queued"),
        "doc": "a tenant's request was held back by ITS OWN isolation "
               "contract: action 'defer' (token bucket "
               "empty — waits for refill), 'shed' (deferred queue at "
               "max_pending — terminal status 'shed'), or 'kv_quota' "
               "(engine admission skipped it, exclusive KV blocks at "
               "quota). Other tenants' traffic is untouched by "
               "construction — the tenant_noisy drill pins it"},
    "prefix_evict": {
        "required": ("plane", "engine", "blocks"),
        "optional": (),
        "doc": "LRU prefix blocks evicted under pool pressure"},
    "kv_spill": {
        "required": ("plane", "engine", "blocks"),
        "optional": ("host_in_use", "host_evicted", "tp"),
        "doc": "refcount-0 device blocks spilled to the host-RAM tier "
               "instead of dying: `blocks` moved in one "
               "batched transfer; `host_evicted` = host-LRU nodes "
               "pushed to oblivion to make room"},
    "kv_readmit": {
        "required": ("plane", "engine", "blocks"),
        "optional": ("host_in_use", "tp"),
        "doc": "host-tier blocks re-admitted to device pools on a "
               "prefix hit — a device_put + table patch, "
               "bytes never recomputed"},
    "handoff_export": {
        "required": ("plane", "engine", "request", "prompt_len",
                     "blocks"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True,
        "doc": "prefill-role engine detached a prefilled request "
               ""},
    "handoff_import": {
        "required": ("plane", "engine", "request", "prompt_len",
                     "blocks", "source", "tp", "role"),
        "optional": ("trace", "hop", "tenant"),
        "journey": True, "seat": True,
        "doc": "serving engine seated a disaggregated-prefill package"},
    "spec_verify": {
        "required": ("plane", "engine", "draft_engine", "step",
                     "active", "proposed", "accepted", "emitted"),
        "optional": (),
        "doc": "one speculative draft-verify round: the "
               "draft proposed `proposed` tokens across `active` "
               "slots, the target's coupled samples accepted "
               "`accepted` of them, and `emitted` tokens (accepted + "
               "per-slot mismatch/bonus samples) left the engine"},
    "spec_fallback": {
        "required": ("plane", "engine", "draft_engine", "reason"),
        "optional": (),
        "doc": "the SpeculativeEngine lost its draft (watchdog trip / "
               "dispatch failure / pool exhaustion) and degraded to "
               "target-only decode — tokens bit-identical by "
               "construction (the draft's own "
               "engine_degraded event rides alongside)"},
    "spec_k_adjust": {
        "required": ("plane", "engine", "draft_engine", "round",
                     "k_from", "k_to", "accept"),
        "optional": ("suspended", "window"),
        "doc": "one adaptive-lookahead evaluation: every "
               "`adapt_window` speculative rounds the windowed accept "
               "rate (obs/timeseries.HistogramWindow over the per-"
               "round accept-fraction histogram) moves k_live "
               "k_from→k_to (equal = held); `suspended` marks the "
               "~0-tax collapse mode where rounds run target-only "
               "between probe rounds — emitted every evaluation, so "
               "the sequence IS obs_report's k-timeline"},
    "draft_swap": {
        "required": ("plane", "engine", "draft_engine", "swap",
                     "accept_before"),
        "optional": ("accept_after", "round", "source"),
        "doc": "improved draft weights hot-swapped into the live "
               "engine: pure re-placement through the "
               "param_layout spine — zero new executables, no "
               "quiesce, tokens stay the target's bitwise. "
               "accept_before = windowed accept at swap time; "
               "accept_after lands in health()['speculative'] at the "
               "first post-swap evaluation (events are immutable — "
               "obs_report pairs the swap with the NEXT spec_k_adjust "
               "instead)"},
    # ---- serving plane: fleet ------------------------------------------
    "engine_degraded": {
        "required": ("plane", "engine", "reason"),
        "optional": (),
        "doc": "watchdog trip / retry exhaustion (flight-recorder "
               "trigger)"},
    "engine_drain": {
        "required": ("plane", "engine", "queued", "active"),
        "optional": (),
        "doc": "engine entered drain mode (stop-admission)"},
    "engine_added": {
        "required": ("plane", "router", "engine", "pool_size"),
        "optional": (),
        "doc": "router grew the pool (autoscale / add_engine)"},
    "engine_removed": {
        "required": ("plane", "router", "engine", "state", "pool_size"),
        "optional": (),
        "doc": "router removed a drained/degraded engine"},
    "router_failover": {
        "required": ("plane", "router", "request", "source", "target"),
        "optional": ("trace", "hop"),
        "journey": True,
        "doc": "request rerouted off a degraded engine (tokens "
               "bit-identical by contract)"},
    "router_rebalance": {
        "required": ("plane", "router", "source", "target", "moved",
                     "requests"),
        "optional": (),
        "doc": "queued requests moved between engines at step time"},
    "router_handoff": {
        "required": ("plane", "router", "request", "source", "target",
                     "blocks"),
        "optional": ("trace", "hop"),
        "journey": True,
        "doc": "router moved a prefilled package to a serving engine"},
    "prefix_migrate": {
        "required": ("plane", "router", "source", "target", "blocks"),
        "optional": ("chains",),
        "doc": "a degraded/draining engine's radix tree migrated into "
               "a survivor's host tier: `blocks` grafted "
               "out of `chains` exported nodes — warm hit-rate "
               "survives failover"},
    "autoscale_decision": {
        "required": ("plane", "router", "action"),
        "optional": ("t", "p99_s", "engines", "target_p99_s",
                     "backlog", "occupancy", "objective", "q",
                     "group"),
        "doc": "autoscaler acted on the SLO loop (scale_up/scale_down/"
               "drain/shed_mode/restore_policy/rebalance_groups)"},
    "group_rebalance": {
        "required": ("plane", "router", "from_group", "to_group",
                     "action"),
        "optional": ("engine",),
        "doc": "capacity moved BETWEEN engine groups: "
               "action 'move' = EngineRouter.move_engine retagged a "
               "same-model engine compile-free; 'rebalance' = the "
               "Autoscaler drained an idle group's engine and grew "
               "the breaching group via its factory"},
    # ---- scenario plane -------------------------------------
    "scenario_phase": {
        "required": ("plane", "scenario", "phase", "t"),
        "optional": ("arrivals", "note"),
        "doc": "a compiled scenario crossed a phase boundary during "
               "replay: `t` is the virtual-clock time, "
               "`arrivals` the number of requests the phase "
               "contributed — obs_report's scenario timeline reads "
               "the sequence"},
    "chaos_inject": {
        "required": ("plane", "scenario", "action", "target", "t"),
        "optional": ("note",),
        "doc": "a chaos-schedule entry fired during scenario replay "
               ": action watchdog_trip/drain/tenant_flood "
               "applied to `target` (engine name or tenant) at "
               "virtual time `t` — the marker that lets a post-mortem "
               "separate injected faults from organic ones"},
    "sim_calibration": {
        "required": ("plane", "sources", "decode_ms_per_token",
                     "prefill_ms_per_token"),
        "optional": ("engine", "factors"),
        "doc": "a SimulatedEngine cost model announced its provenance "
               ": `sources` names the committed "
               "BENCH_r0*.json rows the ms/token figures derive from "
               "and `factors` the documented transformation constants "
               "— the honesty trail behind every simulated latency"},
    # ---- observability plane -------------------------------------------
    "metrics_snapshot": {
        "required": ("snapshot",),
        "optional": ("plane", "note"),
        "doc": "full registry snapshot embedded as an event "
               "(obs.log_metrics_snapshot) — self-contained JSONL"},
    "incident_dump": {
        "required": ("incident", "bundle", "component", "trigger_kind",
                     "events_in_tail"),
        "optional": (),
        "doc": "the flight recorder wrote a post-mortem bundle "
               "(obs_report's incidents section)"},
    "alert_firing": {
        "required": ("plane", "alert", "objective", "value", "target",
                     "window_s"),
        "optional": ("rule_kind", "burn", "long_value", "short_value",
                     "pending_s"),
        "doc": "an AlertRule crossed into firing ("
               "obs/slo.py): value vs target over the window_s that "
               "breached (burn-rate rules name the long window and "
               "carry long/short values + the burn multiple); a "
               "flight-recorder trigger — an SLO burn dumps a "
               "slo_burn post-mortem bundle"},
    "alert_resolved": {
        "required": ("plane", "alert", "objective", "value", "target",
                     "firing_s"),
        "optional": ("rule_kind", "window_s"),
        "doc": "a firing alert measured healthy for its clear_s "
               "streak and resolved (firing_s = time spent "
               "firing — obs_report's firing→resolved timeline and "
               "compliance table read it)"},
}


def required_fields(kind: str) -> tuple:
    """Fields every record of `kind` must carry (empty for unknown
    kinds — the schema stays open at runtime)."""
    return tuple(EVENT_KINDS.get(kind, {}).get("required", ()))


def seat_kinds() -> tuple:
    """Kinds that open a journey hop on an engine, in registry order
    (obs/journey.py's SEAT_KINDS)."""
    return tuple(k for k, v in EVENT_KINDS.items() if v.get("seat"))


def validate_record(rec: dict) -> list:
    """Problems with one parsed event record against EVENT_KINDS:
    unknown kind, or a registered kind missing required fields. Empty
    list = conformant. Pure host-side; obs_report uses it to flag
    schema drift in a JSONL file."""
    kind = rec.get("kind")
    if kind not in EVENT_KINDS:
        return [f"unknown kind {kind!r}"]
    missing = [f for f in required_fields(kind) if f not in rec]
    if missing:
        return [f"kind {kind!r} missing required field(s): "
                + ", ".join(missing)]
    return []


class EventLog:
    """In-memory ring buffer of event dicts + optional JSONL sink.

    `clock` is injectable (drills pass a fake); `path` opens an append
    sink whose lines are flushed per record (events must survive the
    crash legs — a torn final line is tolerated by `read_jsonl`)."""

    def __init__(self, capacity: int = 4096,
                 path: Optional[str] = None, clock=None):
        import time as _time

        self._clock = clock or _time.time
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self._sink: Optional[IO[str]] = None
        self._listeners: List = []
        self.path = path
        if path:
            self._sink = open(path, "a")

    # ------------------------------------------------------------- emit
    def emit(self, kind: str, **fields) -> dict:
        with self._lock:
            rec = {"schema": SCHEMA_VERSION, "ts": self._clock(),
                   "seq": self._seq, "kind": kind, **fields}
            self._seq += 1
            self._ring.append(rec)
            if self._sink is not None:
                self._sink.write(json.dumps(rec, sort_keys=True,
                                            default=_jsonable) + "\n")
                self._sink.flush()
        # outside the lock: a listener (the flight recorder) may emit
        # its own record (incident_dump) re-entrantly
        for fn in list(self._listeners):
            try:
                fn(rec)
            except Exception:
                logging.getLogger("bigdl_tpu_torch.obs").exception(
                    "event listener failed")
        return rec

    # -------------------------------------------------------- listeners
    def add_listener(self, fn) -> None:
        """Subscribe `fn(record)` to every emitted record (called
        synchronously, after the ring append, outside the lock). The
        flight recorder's hook; listeners must never emit
        unconditionally (re-entrancy is bounded, not infinite)."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    # ------------------------------------------------------------ query
    def events(self, kind: Optional[str] = None,
               **match) -> List[dict]:
        """Records (oldest first), optionally filtered by kind and by
        exact field values (`events("request_terminal",
        status="poisoned")`)."""
        out = []
        for rec in self._ring:
            if kind is not None and rec["kind"] != kind:
                continue
            if any(rec.get(k) != v for k, v in match.items()):
                continue
            out.append(rec)
        return out

    def counts_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self._ring:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return dict(sorted(out.items()))

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


def _jsonable(o):
    """Sink fallback for numpy scalars etc. — never let a telemetry
    write throw out of a training/serving loop, and NEVER fetch a
    device array: emission consumes already-fetched host values (the
    obs contract), so a device tensor reaching the sink is a caller bug —
    it is repr'd, not synced (a silent `.item()` here would stall the
    decode loop once per event)."""
    import numpy as np

    if isinstance(o, np.generic) or (isinstance(o, np.ndarray)
                                     and o.ndim == 0):
        # host-memory numpy scalar: .item() is a pure host conversion
        return o.item()  # graftlint: disable=hidden-device-sync
    return repr(o)


def stream_jsonl(path: str):
    """Yield events from a JSONL file one record at a time — the
    streaming twin of `read_jsonl`: a 10⁶-event simulator
    run must never be materialized as one list just to be summarized.
    Same torn-tail tolerance: an undecodable line (crash mid-write) is
    skipped, not an error."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail


def read_jsonl(path: str) -> List[dict]:
    """Parse a JSONL event file; a torn final line (crash mid-write)
    is dropped, not an error. Record conformance is judged against
    the EVENT_KINDS registry above — run each record through
    `validate_record` (obs_report does) rather than keeping a local
    kind list. Large files should prefer `stream_jsonl`."""
    return list(stream_jsonl(path))


# BIGDL_OBS_EVENTS=<path> attaches a JSONL file sink to the default
# log at import — `BIGDL_OBS_EVENTS=/tmp/run.jsonl python train.py`
# writes every record there; `read_jsonl` reads it back
import os as _os

_log = EventLog(path=_os.environ.get("BIGDL_OBS_EVENTS") or None)


def get_event_log() -> EventLog:
    return _log


def set_event_log(log: Optional[EventLog]) -> EventLog:
    """Install an event log (None → fresh default); returns the active
    one. (Explicit None check: an EMPTY EventLog is falsy via
    __len__.) A fresh default re-attaches the BIGDL_OBS_EVENTS file
    sink if the env var is set — resets must not silently drop the
    operator's JSONL sink (append mode, so prior records survive)."""
    global _log
    if log is None:
        log = EventLog(path=_os.environ.get("BIGDL_OBS_EVENTS") or None)
    if log is not _log:
        _log.close()   # don't leak the replaced log's file handle;
        _log = log     # its in-memory ring stays readable
    return _log
