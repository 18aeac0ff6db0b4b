"""Incident flight recorder — a bounded black box that dumps a
post-mortem bundle the moment something goes wrong.

Ports bigdl_tpu/obs/flightrecorder.py (pure Python, copied). The serving and training planes already EMIT the truth (structured
events, registry counters, health() snapshots), but an incident dumps
nothing: by the time an operator looks, the ring buffer has rolled and
the registry only shows totals. `FlightRecorder` subscribes to the
active event log (EventLog listener — zero cost when no recorder is
installed), keeps bounded per-component rings of recent events, and on
a trigger event writes one self-contained bundle directory:

    <outdir>/incident-NNN-<kind>/
        manifest.json    trigger event, bundle name, recorder clock ts
        events.jsonl     global tail (the last `capacity` events,
                         trigger included — the record that names the
                         failing step)
        components.json  per-component tails (engine / router / plane)
        health.json      every registered health source's snapshot
        registry.json    registry snapshot + counter deltas since
                         install()
        journeys.json    journey fragments reconstructed from the tail
                         (obs/journey.py) — the requests in flight when
                         it happened

Triggers (the reference's incident set): a watchdog trip or
any engine degradation (`engine_degraded`), a poisoned request or a
pool-exhausted finish (`request_terminal`), a worker preemption
(`preempted`, emitted by the optimizer loops when a Preempted
propagates — plus the injected `fault_injected fault=preempt`), and
checkpoint corruption (`checkpoint_corrupt_skipped`), and SLO
burns: an `alert_firing` event (obs/slo.py) dumps a `slo_burn`
bundle whose trigger record names the alert, objective, and the
window that breached — the post-mortem exists the moment the page
does.

Contracts (the standing obs rules):
* BIGDL_OBS=off kills it — the listener early-outs on `obs.enabled()`
  (and emission never reaches it anyway);
* zero device syncs: everything recorded is an
  already-emitted host dict;
* bit-deterministic under injected clocks: bundle content is a pure
  function of the event sequence + the injected registry/recorder
  clocks (all JSON sorted), so drills pin bundle bytes across runs;
* a dump emits one `incident_dump` event (bundle name, trigger kind,
  component) so the JSONL record itself indexes its bundles.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["FlightRecorder", "default_trigger"]


def _obs():
    """Call-time import (obs/__init__ imports this module — a
    top-level import would cycle)."""
    from bigdl_tpu_torch import obs

    return obs


def default_trigger(rec: dict) -> Optional[str]:
    """The reference's incident set. Returns a short slug naming the
    incident kind, or None for a non-incident event."""
    kind = rec.get("kind")
    if kind == "engine_degraded":
        return "engine_degraded"
    if kind == "request_terminal":
        if rec.get("status") == "poisoned":
            return "poisoned"
        if rec.get("reason") == "pool_exhausted":
            return "pool_exhausted"
        return None
    if kind == "preempted":
        return "preempted"
    if kind == "fault_injected" and rec.get("fault") == "preempt":
        return "preempted"
    if kind == "checkpoint_corrupt_skipped":
        return "checkpoint_corrupt"
    if kind == "alert_firing":
        # an SLO burn is an incident — the bundle's trigger
        # record names the alert, its objective, and the window that
        # breached; resolution is not an incident
        return "slo_burn"
    return None


class FlightRecorder:
    """Bounded black box over the active event log.

    >>> rec = FlightRecorder(outdir, clock=clk)    # injectable clock
    >>> rec.register_health_source("e0", engine.health)
    >>> rec.install()          # subscribe to the ACTIVE event log
    >>> ... traffic ...
    >>> rec.close()            # unsubscribe; rec.bundles lists dumps

    Knobs are constructor args, never env:
    `capacity` (global tail length), `per_component` (per-component
    ring length), `max_bundles` (dump budget — a poison storm writes
    the first N bundles, then only counts), `trigger` (predicate
    `event -> slug|None`, default `default_trigger`), `clock`
    (seconds source for the manifest stamp — inject the drill clock
    for bit-deterministic bundles)."""

    def __init__(self, outdir: str, capacity: int = 256,
                 per_component: int = 64, max_bundles: int = 8,
                 trigger: Callable[[dict], Optional[str]] = None,
                 clock: Callable[[], float] = None):
        import time as _time

        self.outdir = outdir
        self._clock = clock or _time.time
        self._trigger = trigger or default_trigger
        self._capacity = capacity
        self._per_component = per_component
        self.max_bundles = max_bundles
        self._ring: deque = deque(maxlen=capacity)
        self._components: Dict[str, deque] = {}
        self._health: Dict[str, Callable[[], dict]] = {}
        self._counter_base: Dict[str, float] = {}
        self._log = None
        self._n = 0
        # EventLog calls listeners OUTSIDE its lock, so concurrent
        # emitters (the async checkpoint writer thread, a serving
        # loop) can reach _on_event simultaneously — serialize ring
        # mutation and bundle numbering. REENTRANT because _dump's
        # own incident_dump emission re-enters the listener on the
        # same thread.
        self._lock = threading.RLock()
        self.triggers_seen = 0
        self.bundles: List[str] = []

    # ---------------------------------------------------------- wiring
    def install(self, log=None) -> "FlightRecorder":
        """Subscribe to `log` (default: the active event log) and
        baseline the registry counters for the per-bundle delta."""
        obs = _obs()
        self._log = log if log is not None else obs.get_event_log()
        self._log.add_listener(self._on_event)
        self._counter_base = self._flat_counters()
        os.makedirs(self.outdir, exist_ok=True)
        return self

    def close(self) -> None:
        if self._log is not None:
            self._log.remove_listener(self._on_event)
            self._log = None

    def register_health_source(self, name: str,
                               fn: Callable[[], dict]) -> None:
        """Attach a health() callable (engine, router) whose snapshot
        rides in every bundle under `name`."""
        self._health[name] = fn

    # -------------------------------------------------------- recording
    @staticmethod
    def _component_of(rec: dict) -> str:
        return str(rec.get("engine") or rec.get("router")
                   or rec.get("plane") or "global")

    def _on_event(self, rec: dict) -> None:
        obs = _obs()
        if not obs.enabled():
            return
        with self._lock:
            self._ring.append(rec)
            comp = self._component_of(rec)
            ring = self._components.get(comp)
            if ring is None:
                ring = self._components[comp] = deque(
                    maxlen=self._per_component)
            ring.append(rec)
            slug = None
            if rec.get("kind") != "incident_dump":
                try:
                    slug = self._trigger(rec)
                except Exception:
                    logger.exception("flight-recorder trigger failed")
            if slug is not None:
                self.triggers_seen += 1
                if len(self.bundles) < self.max_bundles:
                    try:
                        self._dump(rec, slug, comp)
                    except Exception:
                        # the black box must never take down the loop
                        # it observes; the failure stays diagnosable
                        logger.exception("flight-recorder dump failed")

    # ----------------------------------------------------------- dumps
    def _flat_counters(self) -> Dict[str, float]:
        from bigdl_tpu_torch.obs.registry import series_key

        obs = _obs()
        out: Dict[str, float] = {}
        snap = obs.get_registry().snapshot()
        for name, fam in snap["metrics"].items():
            if fam["kind"] != "counter":
                continue
            for s in fam["series"]:
                out[series_key(name, s["labels"])] = s["value"]
        return out

    def _write(self, bundle: str, fname: str, obj) -> None:
        with open(os.path.join(bundle, fname), "w") as f:
            if fname.endswith(".jsonl"):
                for rec in obj:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
            else:
                json.dump(obj, f, sort_keys=True, indent=1)

    def _dump(self, trigger_rec: dict, slug: str, component: str) -> str:
        from bigdl_tpu_torch.obs.journey import build_journeys

        obs = _obs()
        name = f"incident-{self._n:03d}-{slug}"
        self._n += 1
        bundle = os.path.join(self.outdir, name)
        os.makedirs(bundle, exist_ok=True)
        # tails in seq order: listeners run outside the EventLog lock,
        # so concurrent emitters can deliver records to the ring out
        # of stamp order — the bundle is canonicalized on the seq the
        # log stamped under ITS lock (stable for equal seqs)
        tail = sorted(self._ring, key=lambda r: r.get("seq", 0))
        self._write(bundle, "events.jsonl", tail)
        self._write(bundle, "components.json",
                    {c: sorted(r, key=lambda x: x.get("seq", 0))
                     for c, r in sorted(self._components.items())})
        health = {}
        for hname in sorted(self._health):
            try:
                health[hname] = self._health[hname]()
            except Exception as e:        # a degraded source still dumps
                health[hname] = {"error": repr(e)}
        self._write(bundle, "health.json", health)
        now_counters = self._flat_counters()
        delta = {k: round(v - self._counter_base.get(k, 0.0), 9)
                 for k, v in sorted(now_counters.items())
                 if v != self._counter_base.get(k, 0.0)}
        self._write(bundle, "registry.json",
                    {"snapshot": obs.get_registry().snapshot(),
                     "counters_delta_since_install": delta})
        self._write(bundle, "journeys.json", build_journeys(tail))
        manifest = {
            "schema": 1,
            "bundle": name,
            "ts": self._clock(),
            "incident": slug,
            "component": component,
            "trigger": trigger_rec,
            "events_in_tail": len(tail),
            "components": sorted(self._components),
            "health_sources": sorted(self._health),
        }
        self._write(bundle, "manifest.json", manifest)
        self.bundles.append(name)
        obs.emit_event("incident_dump", incident=slug,
                       bundle=name, component=component,
                       trigger_kind=trigger_rec.get("kind"),
                       events_in_tail=len(tail))
        return bundle
