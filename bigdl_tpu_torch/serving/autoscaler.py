"""SLO-driven autoscaling for the engine pool.

Ports bigdl_tpu/serving/autoscaler.py (host-side Python, copied). The
Autoscaler watches REGISTRY metrics — the
router's `router_request_latency_seconds` histogram (windowed, by
diffing cumulative bucket counts between evaluations) and the pool's
backlog/occupancy rollup — and

* **scales up** (router.add_engine()) when the windowed p99 misses `target_p99_s` or the
  per-engine backlog passes `backlog_high`;
* **flips the overload policy** of every pool engine to
  `shed-lowest-priority` when the pool is at `max_engines` and STILL
  missing the SLO — at fixed capacity the only way to hold p99 for
  the traffic that matters is to stop queueing the traffic that
  doesn't — and restores each engine's original policy once the SLO
  recovers;
* **scales down** via drain (router.drain() → engine finishes its
  accepted work → remove_engine()) when the pool is comfortably
  under target and under-occupied; at most one engine drains at a
  time, and it leaves only after health() reports 'drained' — a
  scale-down can never lose a request. Engines drained by someone
  else, and degraded corpses whose work already failed over, are
  reaped on sight (min_engines permitting).

Every decision is a pure function of registry state and the injected
clock — `decisions` records them, so two replays of the same traffic
make the same decisions (and the port's the JAX package's).

The windowed p99 is `obs/timeseries.HistogramWindow`'s
evaluation-to-evaluation cumulative-bucket delta, and `objective=` lets the scaler consume the SAME `obs/slo.SLOObjective`
the alert engine watches: at max_engines the shed-mode decision asks
the objective, not local threshold math — one definition of "missing
the SLO" across scaling and alerting.

`group=` scopes every signal and lever to ONE model group
of a heterogeneous fleet (membership, backlog, occupancy, the engine
counts, drain target, policy flips), and adds a between-group lever:
when the watched group is at `max_engines` and still missing its SLO,
the scaler looks for an IDLE donor group (>= 2 healthy engines, zero
backlog, occupancy under `occupancy_low`), drains the donor's newest
engine and grows the breaching group through its factory — capacity
moves to where the SLO burns instead of shedding first. Scale-to-zero
for an idle group is deliberately not taken (a group always keeps one
engine — deferred stretch). One Autoscaler watches one group; run one
per group for full-fleet coverage.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs.timeseries import HistogramWindow
from bigdl_tpu_torch.serving.router import EngineRouter

logger = logging.getLogger("bigdl_tpu_torch.serving")


class Autoscaler:
    """Closed-loop pool sizing against a p99 latency target.

    >>> asc = Autoscaler(router, target_p99_s=6.0, max_engines=3)
    >>> while traffic:
    ...     router.step(); asc.observe()

    `observe()` is the only entry point: call it once per scheduling
    round; it self-rate-limits to one evaluation per
    `evaluate_every_s` of the ROUTER clock and returns the decision
    record (or None between evaluations). Windowed p99 comes from the
    router latency histogram's bucket-count delta since the previous
    evaluation — no sample retention, deterministic under the
    injected clock."""

    def __init__(self, router: EngineRouter, *,
                 target_p99_s: Optional[float] = None,
                 evaluate_every_s: float = 1.0, min_engines: int = 1,
                 max_engines: int = 4, backlog_high: float = 4.0,
                 occupancy_low: float = 0.25,
                 flip_overload_policy: bool = True, objective=None,
                 group: str = "default"):
        if objective is not None:
            # one SLO definition for scaling AND alerting —
            # the scaler takes its target AND quantile from the shared
            # objective and defers threshold judgement to it below.
            # What it measures stays the router's OWN request-latency
            # window (evaluation-to-evaluation, HistogramWindow): the
            # objective's metric/labels select the alert engine's
            # time-series view of the same router histogram; a scaler
            # can only ever judge the pool it scales.
            if objective.kind != "latency_quantile":
                raise ValueError(
                    "Autoscaler consumes a latency_quantile objective "
                    f"(got kind={objective.kind!r})")
            if target_p99_s is not None \
                    and target_p99_s != objective.target:
                # a silently diverging pair would make the recorded
                # target lie about the threshold actually applied
                raise ValueError(
                    f"target_p99_s={target_p99_s} disagrees with "
                    f"objective {objective.name!r} target "
                    f"{objective.target} — pass one or make them "
                    "equal")
            target_p99_s = objective.target
        if target_p99_s is None or target_p99_s <= 0:
            raise ValueError(
                "target_p99_s must be > 0 (or pass objective=)")
        if not 1 <= min_engines <= max_engines:
            raise ValueError("need 1 <= min_engines <= max_engines")
        self.router = router
        self.group = group
        self.target_p99_s = target_p99_s
        self.objective = objective
        self.evaluate_every_s = evaluate_every_s
        self.min_engines = min_engines
        self.max_engines = max_engines
        self.backlog_high = backlog_high
        self.occupancy_low = occupancy_low
        self.flip_overload_policy = flip_overload_policy
        self._clock = router._clock
        self._last_eval: Optional[float] = None
        # the shared evaluation-to-evaluation windowing
        # (obs/timeseries.py) — what _window_p99 used to hand-roll
        self._window = HistogramWindow(router.request_latency)
        self._saved_policies: Optional[Dict[int, str]] = None
        self._draining = None             # the one engine mid-drain
        self.decisions: List[dict] = []

    # ------------------------------------------------------------ signals
    def _members(self) -> List:
        """The watched group's serving engines, pool order."""
        return [e for e in self.router.engines
                if EngineRouter._group_of(e) == self.group]

    def _healthy(self) -> List:
        return [e for e in self._members()
                if e.degraded is None and not e.draining]

    def _misses_target(self, p99: Optional[float]) -> bool:
        """Whether a measured windowed p99 misses the SLO (None — no
        completions — never misses): the shared objective when one is
        installed, the local threshold otherwise."""
        if self.objective is not None:
            return self.objective.violated(p99)
        return p99 is not None and p99 > self.target_p99_s

    # ------------------------------------------------------------ actions
    def _scale_up(self) -> str:
        self.router.add_engine(group=self.group)
        return "scale_up"

    def _rebalance_groups(self) -> Optional[str]:
        """Between-group capacity movement: the watched
        group is at max_engines and still burning — drain an IDLE
        donor group's newest engine (the existing drain machinery
        finishes it) and grow this group through its factory. None
        when no group qualifies as a donor (then shed-mode is the
        remaining lever)."""
        factory = getattr(self.router, "engine_factory", None)
        if not isinstance(factory, dict) or self.group not in factory:
            return None           # cannot grow this group's model
        for gname, members in sorted(self.router.groups.items()):
            if gname == self.group:
                continue
            healthy = [e for e in members
                       if e.degraded is None and not e.draining]
            if len(healthy) < 2:
                continue          # scale-to-zero is the deferred stretch
            if any(e.queue_depth > 0 for e in healthy):
                continue
            slots = sum(e.slots for e in healthy)
            occ = sum(e.slots_active for e in healthy) / max(slots, 1)
            if occ >= self.occupancy_low:
                continue
            self._draining = healthy[-1]
            self.router.drain(self._draining)
            self.router.add_engine(group=self.group)
            obs.emit_event("group_rebalance", plane="serving",
                           router=self.router._obs_name,
                           from_group=gname, to_group=self.group,
                           action="rebalance",
                           engine=self._draining.obs_name)
            return "rebalance_groups"
        return None

    def _shed_mode(self) -> str:
        members = [e for e in self._members()
                   if hasattr(e, "overload_policy")]
        self._saved_policies = {
            id(e): e.overload_policy for e in members}
        for e in members:
            e.overload_policy = "shed-lowest-priority"
        if all(e.max_queue is None for e in members):
            # overload_policy is only consulted when a BOUNDED queue
            # fills — flipping it on unbounded engines changes
            # nothing. Say so instead of pretending to protect p99.
            logger.warning(
                "autoscaler flipped overload_policy to "
                "shed-lowest-priority, but every pool engine has "
                "max_queue=None (unbounded) — the flip cannot shed "
                "anything; build engines with max_queue= for the "
                "at-capacity lever to bite")
        return "shed_mode"

    def _restore_policies(self) -> str:
        for e in self._members():
            if hasattr(e, "overload_policy"):
                e.overload_policy = (self._saved_policies or {}).get(
                    id(e), e.overload_policy)
        self._saved_policies = None
        return "restore_policy"

    def _start_drain(self) -> str:
        # drain the most-loaded-index-last healthy engine: the LAST
        # healthy GROUP engine in pool order (newest first out — the
        # one the autoscaler most recently added), deterministic
        self._draining = self._healthy()[-1]
        self.router.drain(self._draining)
        return "drain"

    # ------------------------------------------------------------ observe
    def observe(self) -> Optional[dict]:
        now = self._clock()
        if self._last_eval is not None \
                and now - self._last_eval < self.evaluate_every_s:
            return None
        self._last_eval = now
        # reap corpses first: an engine someone else drained, or one
        # that degraded (its work already failed over), serves nothing
        # — remove it regardless of load, min_engines permitting
        for e in self._members():
            if e is self._draining:
                continue
            if e.health()["state"] in ("drained", "degraded") \
                    and len(self._members()) > self.min_engines:
                try:
                    self.router.remove_engine(e)
                except ValueError:      # still holds routed work
                    continue
                return self._record(now, "scale_down", None)
        # finish a drain in progress before anything else
        if self._draining is not None:
            if self._draining.health()["state"] == "drained":
                self.router.remove_engine(self._draining)
                self._draining = None
                return self._record(now, "scale_down", None)
            return self._record(now, "draining", None)
        p99 = self._window.quantile(
            self.objective.q if self.objective is not None else 0.99)
        healthy = self._healthy()
        n = len(healthy)
        slots = sum(e.slots for e in healthy)
        backlog = sum(e.queue_depth for e in healthy)
        occupancy = (sum(e.slots_active for e in healthy)
                     / max(slots, 1))
        over = (self._misses_target(p99)
                or (n > 0 and backlog / n > self.backlog_high))
        under = ((p99 is None or not self._misses_target(p99))
                 and backlog == 0
                 and occupancy < self.occupancy_low)
        if over:
            if len(self._members()) < self.max_engines:
                action = self._scale_up()
            else:
                # at capacity: move an idle group's engine here
                # before resorting to shedding
                action = self._rebalance_groups()
                if action is None:
                    if self.flip_overload_policy \
                            and self._saved_policies is None:
                        action = self._shed_mode()
                    else:
                        action = "hold"
        elif self._saved_policies is not None \
                and p99 is not None and not self._misses_target(p99):
            action = self._restore_policies()
        elif under and n > self.min_engines:
            action = self._start_drain()
        else:
            action = "hold"
        return self._record(now, action, p99, backlog=backlog,
                            occupancy=round(occupancy, 4))

    def _record(self, now: float, action: str, p99: Optional[float],
                **extra) -> dict:
        d = {"t": round(now, 6), "action": action,
             "p99_s": None if p99 is None else round(p99, 6),
             "engines": len(self.router.engines),
             "target_p99_s": self.target_p99_s, **extra}
        if self.objective is not None:
            # record which shared SLO drove the decision — and its
            # quantile, since "p99_s" then actually holds the
            # objective's q-quantile (absent in threshold mode, whose
            # record shape the JAX package's drills pin)
            d["objective"] = self.objective.name
            d["q"] = self.objective.q
        if self.group != "default":
            # homogeneous fleets keep the ungrouped record shape
            d["group"] = self.group
        self.decisions.append(d)
        if action in ("scale_up", "scale_down", "drain", "shed_mode",
                      "restore_policy", "rebalance_groups"):
            obs.emit_event("autoscale_decision", plane="serving",
                           router=self.router._obs_name, **d)
        return d
