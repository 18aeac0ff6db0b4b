"""Declarative SLOs + deterministic alerting over the time-series
plane.

Ports bigdl_tpu/obs/slo.py (pure Python, copied). An `SLOObjective` says what "healthy"
means (windowed p99 under a target, bad-terminal fraction inside an
error budget), an `AlertRule` says when to page (threshold with a
pending duration, multi-window burn rate, absence), and `AlertEngine`
walks the rule state machines once per scheduling round.

Determinism contract: every evaluation is a PURE FUNCTION of (the sampler's
window contents, the injected clock) — no wall-clock reads, no RNG.
Two replays of the same traffic under the same virtual clock produce
byte-identical alert transitions, so a drill pins firing AND
resolution bit for bit, bundle bytes included.

State machine per rule::

    inactive --breach--> pending --for_s held--> firing
        ^                   |                       |
        |<---heals----------+        heals >= clear_s (flap
        |<--------------------------- suppression: any re-breach
                                      resets the healthy streak)

Transitions emit `alert_firing` / `alert_resolved` events (kinds +
required fields registered in obs/events.py::EVENT_KINDS), and `alert_firing` is a FlightRecorder
trigger: an SLO burn dumps a post-mortem bundle whose trigger record
names the window that breached (obs/flightrecorder.py, slo_burn
bundles).

The Autoscaler consumes the same `SLOObjective` (serving/autoscaler.py
`objective=`): at max_engines its shed-mode decision asks the
objective, not its own threshold math — one definition of "missing the
SLO" across scaling and alerting.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from bigdl_tpu_torch.obs.timeseries import MetricsSampler

__all__ = ["BAD_STATUSES", "SLOObjective", "AlertRule", "AlertEngine"]

# the serving plane's bad terminal statuses (engine.py's terminal set
# minus 'done') — the default error-budget numerator
BAD_STATUSES: Tuple[str, ...] = ("shed", "expired", "poisoned",
                                 "failed")

_OBJECTIVE_KINDS = ("latency_quantile", "error_budget")
_RULE_KINDS = ("threshold", "burn_rate", "absence")


def _obs():
    """Call-time import (obs/__init__ imports this module — a
    top-level import would cycle)."""
    from bigdl_tpu_torch import obs

    return obs


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(float(v), 9)


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One declarative service-level objective.

    kind='latency_quantile': the `q`-quantile of the `metric`
    histogram series (`labels` selects it exactly) over the evaluation
    window must stay <= `target` seconds.

    kind='error_budget': of the `metric` counter family's increments
    over the window (optionally filtered to series whose labels
    contain `labels`), the fraction whose `bad_label` value is in
    `bad_values` must stay <= `target` — the goodput-error-budget
    form: `--slo-goodput 0.95` becomes target 0.05.

    `measure()` returns None with no data in the window (no
    completions, series not born yet) — "no data" is not a violation;
    the absence AlertRule exists for silence-is-an-incident cases."""

    name: str
    kind: str
    metric: str
    target: float
    q: float = 0.99
    labels: Optional[Mapping[str, str]] = None
    bad_label: str = "status"
    bad_values: Tuple[str, ...] = BAD_STATUSES

    def __post_init__(self):
        if self.kind not in _OBJECTIVE_KINDS:
            raise ValueError(f"objective kind {self.kind!r}: expected "
                             f"one of {_OBJECTIVE_KINDS}")
        if self.target < 0:
            raise ValueError("target must be >= 0")
        if not 0.0 < self.q <= 1.0:
            raise ValueError("q must be in (0, 1]")

    # --------------------------------------------------------- evaluation
    def measure(self, sampler: MetricsSampler,
                window_s: Optional[float] = None) -> Optional[float]:
        """The objective's current value over `window_s` (None: no
        data)."""
        if self.kind == "latency_quantile":
            return sampler.window_quantile(
                self.metric, self.q,
                labels=dict(self.labels) if self.labels else None,
                window_s=window_s)
        want = {k: str(v) for k, v in (self.labels or {}).items()}
        total = bad = 0.0
        for labels, d in sampler.series_deltas(self.metric,
                                               window_s=window_s):
            if any(labels.get(k) != v for k, v in want.items()):
                continue
            total += d
            if labels.get(self.bad_label) in self.bad_values:
                bad += d
        if total <= 0:
            return None
        return bad / total

    def violated(self, value: Optional[float]) -> bool:
        """Whether a measured value misses the objective (None — no
        data — never violates)."""
        return value is not None and value > self.target

    def evaluate(self, sampler: MetricsSampler,
                 window_s: Optional[float] = None) -> dict:
        """Compliance record: measured value vs target over the
        window (deterministic dict — report surfaces embed it)."""
        v = self.measure(sampler, window_s)
        return {"objective": self.name, "kind": self.kind,
                "metric": self.metric, "value": _round(v),
                "target": self.target, "ok": not self.violated(v),
                "window_s": window_s}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """When an objective's breach becomes a page.

    kind='threshold': objective violated over `window_s` continuously
    for `for_s` (pending duration) → firing.

    kind='burn_rate': the classic multi-window form — the objective's
    value exceeds `burn_factor * target` on BOTH `long_window_s` (the
    page is real) and `short_window_s` (it is STILL happening) →
    firing immediately (`for_s` is implicit in the long window).

    kind='absence': the `metric` family saw ZERO increments over
    `window_s` while the sampler has data → firing after `for_s` —
    the emitter died, which no value-threshold can see.

    `clear_s` is flap suppression on the way out: a firing rule must
    measure healthy for `clear_s` CONTINUOUSLY before it resolves;
    any re-breach resets the streak."""

    name: str
    objective: SLOObjective
    kind: str = "threshold"
    window_s: Optional[float] = None
    for_s: float = 0.0
    clear_s: float = 0.0
    long_window_s: float = 60.0
    short_window_s: float = 5.0
    burn_factor: float = 1.0

    def __post_init__(self):
        if self.kind not in _RULE_KINDS:
            raise ValueError(f"alert kind {self.kind!r}: expected one "
                             f"of {_RULE_KINDS}")
        if self.kind == "burn_rate" \
                and self.short_window_s > self.long_window_s:
            raise ValueError("burn_rate needs short_window_s <= "
                             "long_window_s")
        if self.for_s < 0 or self.clear_s < 0:
            raise ValueError("for_s/clear_s must be >= 0")

    @property
    def breach_window_s(self) -> Optional[float]:
        """The window a firing record names (the long window for burn
        rate — the one that makes the page real)."""
        return self.long_window_s if self.kind == "burn_rate" \
            else self.window_s


class AlertEngine:
    """Walk every rule's state machine once per `evaluate()` call.

    >>> eng = AlertEngine(sampler, [rule])     # clock: sampler's
    >>> while serving:
    ...     router.step(); sampler.tick(); eng.evaluate()

    Knobs are constructor args, never env: `sampler`, `rules`,
    `plane` (stamped on the alert events), `clock` (defaults to the
    sampler's injected clock so one virtual cell drives sampling and
    transitions). State is lock-guarded because the scrape endpoint
    (obs/exposition.py) serves `alerts()` from its own thread."""

    def __init__(self, sampler: MetricsSampler,
                 rules: List[AlertRule], *, plane: str = "serving",
                 clock: Optional[Callable[[], float]] = None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self._sampler = sampler
        self._clock = clock or sampler.clock
        self.plane = plane
        self.rules = list(rules)
        self._st: Dict[str, dict] = {
            r.name: {"state": "inactive", "since": None,
                     "healthy_since": None, "fired_at": None,
                     "value": None}
            for r in rules}
        self._lock = threading.Lock()
        self.fired = 0
        self.resolved = 0

    # ----------------------------------------------------------- signals
    def _breach(self, rule: AlertRule
                ) -> Tuple[bool, Optional[float], dict]:
        """(breached, reported value, extra event fields) for one rule
        — a pure read of the sampler's windows."""
        obj = rule.objective
        if rule.kind == "burn_rate":
            lv = obj.measure(self._sampler, rule.long_window_s)
            sv = obj.measure(self._sampler, rule.short_window_s)
            thr = rule.burn_factor * obj.target
            breached = (lv is not None and sv is not None
                        and lv > thr and sv > thr)
            extra = {"long_value": _round(lv), "short_value": _round(sv)}
            if lv is not None and obj.target > 0:
                extra["burn"] = _round(lv / obj.target)
            return breached, _round(sv), extra
        if rule.kind == "absence":
            total = sum(d for _, d in self._sampler.series_deltas(
                obj.metric, window_s=rule.window_s))
            has_window = self._sampler.span(rule.window_s) is not None
            return (has_window and total <= 0), _round(total), {}
        v = obj.measure(self._sampler, rule.window_s)
        return obj.violated(v), _round(v), {}

    # ---------------------------------------------------------- evaluate
    def evaluate(self) -> List[dict]:
        """One evaluation round: read every rule's windows, advance
        its state machine, emit firing/resolution events. Returns one
        record per rule ({alert, state, value, ...}).

        Transitions are collected under the lock but EMITTED after it
        releases: emit_event runs listeners synchronously (the flight
        recorder dumps a whole bundle, calling registered health
        sources) — doing that inside this non-reentrant lock would
        block the scrape thread mid-incident and self-deadlock any
        health source that reads alerts()."""
        now = self._clock()
        out = []
        emissions: List[Tuple[str, dict]] = []
        with self._lock:
            for rule in self.rules:
                breached, value, extra = self._breach(rule)
                st = self._st[rule.name]
                st["value"] = value
                if st["state"] == "inactive":
                    if breached:
                        st["since"] = now
                        if rule.for_s <= 0:
                            emissions.append(self._fire(
                                rule, st, now, value, extra))
                        else:
                            st["state"] = "pending"
                elif st["state"] == "pending":
                    if not breached:
                        st["state"] = "inactive"
                        st["since"] = None
                    elif now - st["since"] >= rule.for_s - 1e-9:
                        extra = dict(extra)
                        extra["pending_s"] = _round(now - st["since"])
                        emissions.append(self._fire(
                            rule, st, now, value, extra))
                elif st["state"] == "firing":
                    if breached:
                        # flap suppression: the healthy streak resets
                        st["healthy_since"] = None
                    else:
                        if st["healthy_since"] is None:
                            st["healthy_since"] = now
                        if now - st["healthy_since"] \
                                >= rule.clear_s - 1e-9:
                            emissions.append(self._resolve(
                                rule, st, now, value))
                out.append({"alert": rule.name,
                            "objective": rule.objective.name,
                            "state": st["state"], "value": value,
                            **extra})
        obs = _obs()
        for kind, fields in emissions:
            obs.emit_event(kind, **fields)
        return out

    def _fire(self, rule: AlertRule, st: dict, now: float,
              value: Optional[float],
              extra: dict) -> Tuple[str, dict]:
        """Apply the firing transition (caller holds the lock) and
        return the event to emit once it releases."""
        st["state"] = "firing"
        st["fired_at"] = now
        st["healthy_since"] = None
        self.fired += 1
        return ("alert_firing", dict(
            plane=self.plane, alert=rule.name,
            objective=rule.objective.name, value=value,
            target=rule.objective.target,
            window_s=rule.breach_window_s, rule_kind=rule.kind,
            **extra))

    def _resolve(self, rule: AlertRule, st: dict, now: float,
                 value: Optional[float]) -> Tuple[str, dict]:
        """Apply the resolution transition (caller holds the lock) and
        return the event to emit once it releases."""
        firing_s = now - st["fired_at"] if st["fired_at"] is not None \
            else None
        st["state"] = "inactive"
        st["since"] = None
        st["healthy_since"] = None
        st["fired_at"] = None
        self.resolved += 1
        return ("alert_resolved", dict(
            plane=self.plane, alert=rule.name,
            objective=rule.objective.name, value=value,
            target=rule.objective.target, firing_s=_round(firing_s),
            rule_kind=rule.kind, window_s=rule.breach_window_s))

    # -------------------------------------------------------------- views
    def alerts(self) -> List[dict]:
        """Current state per rule (deterministic order: rule order) —
        the scrape endpoint's /alerts payload."""
        with self._lock:
            return [{"alert": r.name, "objective": r.objective.name,
                     "kind": r.kind, "state": self._st[r.name]["state"],
                     "value": self._st[r.name]["value"],
                     "target": r.objective.target,
                     "fired_at": self._st[r.name]["fired_at"]}
                    for r in self.rules]

    def firing(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules
                    if self._st[r.name]["state"] == "firing"]

    def compliance(self, window_s: Optional[float] = None
                   ) -> List[dict]:
        """Per-objective compliance over `window_s` (each distinct
        objective once, rule order)."""
        seen, out = set(), []
        for r in self.rules:
            if r.objective.name in seen:
                continue
            seen.add(r.objective.name)
            out.append(r.objective.evaluate(self._sampler, window_s))
        return out
