"""Unified telemetry plane (counterpart: bigdl_tpu/obs/).

One process-wide home for what the serving engine, the fleet and the
training loop report:

* `registry`   — counters, gauges and fixed-bucket histograms with
  label sets; deterministic snapshot, Prometheus text, JSON export;
* `events`     — the schema-versioned JSONL event log (ring buffer and
  optional file sink) with the `EVENT_KINDS` registry;
* `spans`      — host-side spans as Chrome-trace JSON, mirrored into a
  `utils/profiler.trace()` capture as `record_function` ranges;
* `timeseries` — windowed queries over registry samples;
* `slo`        — SLO objectives and the deterministic alert engine;
* `exposition` — the stdlib HTTP scrape endpoint;
* `journey`    — per-request cross-engine timelines from the events;
* `flightrecorder` — post-mortem bundles on incidents;
* `training`   — `StepTelemetry`'s summary sink and log line.

Copied from the JAX package, pure Python: the two packages emit the
same records, series and bundles for the same calls under the same
injected clock. Telemetry reads only host values the loop already
fetched; it never synchronises the device. `BIGDL_OBS=off` (read at
import) or `set_enabled(False)` turns every emission path off; the
engines' own bookkeeping (`stats`, `health()`) does not depend on it.
`BIGDL_OBS_EVENTS=<path>` attaches a JSONL file sink to the default
event log. The training loop's registry series and events
(`StepTelemetry`'s, the anomaly guard's, the checkpoint writer's) wait
for ROADMAP.md queue A.9.
"""

from __future__ import annotations

import os
from typing import Optional

from bigdl_tpu_torch.obs.events import (EventLog, get_event_log, read_jsonl,
                                  set_event_log, stream_jsonl)
from bigdl_tpu_torch.obs.exposition import ScrapeServer
from bigdl_tpu_torch.obs.flightrecorder import FlightRecorder, default_trigger
from bigdl_tpu_torch.obs.journey import (build_journeys, journeys_json,
                                   summarize_journeys, to_perfetto)
from bigdl_tpu_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS, Counter,
                                    Gauge, Histogram, MetricsRegistry,
                                    get_registry, series_key,
                                    set_registry)
from bigdl_tpu_torch.obs.slo import AlertEngine, AlertRule, SLOObjective
from bigdl_tpu_torch.obs.spans import SpanTracer, get_tracer, set_tracer
from bigdl_tpu_torch.obs.timeseries import HistogramWindow, MetricsSampler

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "get_registry", "set_registry",
    "EventLog", "get_event_log", "set_event_log", "read_jsonl",
    "stream_jsonl",
    "SpanTracer", "get_tracer", "set_tracer",
    "FlightRecorder", "default_trigger",
    "build_journeys", "journeys_json", "summarize_journeys",
    "to_perfetto",
    "MetricsSampler", "HistogramWindow",
    "SLOObjective", "AlertRule", "AlertEngine", "ScrapeServer",
    "enabled", "set_enabled", "emit_event", "log_metrics_snapshot",
    "provenance", "reset_all",
]

_enabled = os.environ.get("BIGDL_OBS", "on").lower() not in (
    "off", "0", "false", "no")


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> bool:
    """Runtime switch for every emission path (registry mirrors, event
    records, spans). Returns the previous value."""
    global _enabled
    prev, _enabled = _enabled, bool(value)
    return prev


def emit_event(kind: str, **fields) -> Optional[dict]:
    """Emit into the active event log iff telemetry is enabled — THE
    call every instrumented site uses (optimizer, engine, checkpoint,
    faults, anomaly guard)."""
    if not _enabled:
        return None
    return get_event_log().emit(kind, **fields)


def log_metrics_snapshot(**extra) -> Optional[dict]:
    """Embed a full registry snapshot as a `metrics_snapshot` event,
    making a JSONL file self-contained."""
    if not _enabled:
        return None
    return get_event_log().emit("metrics_snapshot",
                                snapshot=get_registry().snapshot(),
                                **extra)


def provenance(prefix: Optional[str] = None) -> dict:
    """Compact registry view for attaching to benchmark rows: counter and
    gauge values (histograms reduced to count/sum), optionally
    restricted to names starting with `prefix`. Deterministic ordering
    (sorted)."""
    snap = get_registry().snapshot()
    out = {}
    for name, fam in snap["metrics"].items():
        if prefix is not None and not name.startswith(prefix):
            continue
        for s in fam["series"]:
            key = series_key(name, s["labels"])
            if fam["kind"] == "histogram":
                out[key] = {"count": s["count"],
                            "sum": round(s["sum"], 6)}
            else:
                out[key] = s["value"]
    return {"telemetry": "on" if _enabled else "off", "metrics": out}


def reset_all(clock=None) -> None:
    """Fresh registry + event log + (disabled) tracer — drill/test
    isolation. `clock` (if given) is injected into all three. The
    fresh event log keeps the BIGDL_OBS_EVENTS file sink (append), so
    resetting never silently drops the operator's JSONL record.

    Caveat: objects that cache registry children at construction
    (InferenceEngine, Optimizer loops, AnomalyGuard, optim.Metrics)
    keep writing to the registry that was active WHEN THEY WERE BUILT
    — install custom telemetry first, construct after (the fault
    drills do exactly this)."""
    set_registry(MetricsRegistry(clock=clock))
    set_event_log(EventLog(
        path=os.environ.get("BIGDL_OBS_EVENTS") or None, clock=clock))
    set_tracer(SpanTracer(clock=clock))
