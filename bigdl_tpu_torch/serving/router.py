"""Fleet plane: a health-gated router fronting a pool of
InferenceEngines.

Ports bigdl_tpu/serving/router.py (host-side Python, copied). The
engines stay simple; `EngineRouter` watches their health and moves work:

* **Health-gated dispatch.** submit() ranks candidate engines by load
  (occupied slots + queue depth over slot count; ties break on pool
  index — deterministic) and skips degraded or draining engines,
  reading the cheap properties `health()` is built from.
* **Priority-aware spillover.** When the chosen engine's bounded
  queue rejects (OverloadError), the request spills to the next
  engine in load order; only when EVERY healthy engine rejects does
  the router re-raise. Under the shed-* policies a high-priority
  arrival displaces the pool's lowest-priority queued request.
* **Failover.** When an engine degrades (watchdog trip, exhausted
  retry budget), every request it held — queued AND in-flight — is
  resubmitted to the survivors and re-decoded from the prompt. A
  request's sampling streams depend on (seed, tokens generated) only
  (serving/sampler.py `row_generator`), never on its slot, co-batch or
  arrival, so the rerouted requests finish with the tokens of an
  undisturbed run, bit for bit. Zero requests are lost; the
  transitional 'failed' results are superseded, not surfaced.
* **Drain and pool mutation.** drain() flips an engine to
  stop-admission; once 'drained' (or degraded) it can be
  remove_engine()'d, and add_engine() grows the pool through the
  `engine_factory` (the autoscaler's lever).
* **Prefix-affinity placement.** With `affinity=True`, submit() probes
  each healthy engine's radix tree (engine.prefix_match_tokens, a
  stamp-free peek over both KV tiers) and ranks by longest match first,
  load second, index third. Health gating overrides affinity.
* **Warm-state migration.** The first time an engine is seen degraded
  (or drained), its radix tree exports in one batched device-to-host
  copy (engine.export_tree) and grafts into the least-loaded
  spill-enabled survivor's HOST tier (engine.import_tree): the
  survivors re-admit the bytes on their next prefix hits.
* **Disaggregated prefill.** `prefill_engines=` adds a prefill tier:
  prompts of `handoff_len` tokens or more prefill on a
  `role='prefill'` engine, whose HandoffPackages `handoff()` seats on
  the least-loaded serving engine (engine.import_handoff). The block
  contents are bitwise what the importer's own prefill writes, so
  handed-off requests finish with a single engine's tokens. Packages
  that cannot seat stay in a backlog and retry every round.
* **Model-tagged engine groups.** Engines carry a `model_tag` (None →
  the 'default' group) and requests select theirs through
  `Request(model_tag=)`; dispatch, spillover, failover, rebalance,
  affinity and migration stay within a group (and within one
  `layout_family`). `add_engine(group=)` grows one group and
  `move_engine` retags an idle engine over the same model.
* **Per-tenant admission and fairness.** With
  `tenancy=TenancyController(...)`, every submission parks in the
  controller's per-tenant weighted-fair queue; step() releases in WFQ
  order, gated by the tenant's token bucket and the group's free
  capacity. The controller shares the router's injected clock.

Determinism contract: the router reads no wall clock (the clock is
injected), does no device work and draws no random numbers — its state
machine is a function of the submit/step call sequence, so the fleet
drills are reproducible, and the port's router makes the JAX router's
decisions on the same calls.

Telemetry: dispatch, spillover and failover counters and the pool-size
gauge land in the obs registry under the router's label;
`router_request_latency_seconds` (submit → done on the router clock,
across failover) is fed whatever the telemetry switch says — the
autoscaler's SLO input.

Engines fronted by a router are driven ONLY through it (the router
harvests `engine.completed`).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.serving.engine import (GenerationResult,
                                            InferenceEngine, OverloadError,
                                            Request)

# router-level latency buckets: the engine's decode histogram spans
# 100 us..10 s, but request lifecycles under queueing (and the
# loadgen harness's virtual seconds) reach far past that — one FIXED
# family-wide set, because the registry (correctly) rejects two
# routers disagreeing on a metric's buckets
ROUTER_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0,
    10.0, 20.0, 40.0, 80.0, 160.0)

_ROUTER_IDS = itertools.count()


class NoHealthyEngine(RuntimeError):
    """submit() with every pool engine degraded or draining."""


@dataclass
class _Assignment:
    """Router bookkeeping for one in-flight request: the original
    Request (resubmitted verbatim on failover), its current engine,
    a monotone sequence number (failover preserves submission order),
    and the router-clock submit time (latency survives failover)."""
    request: Request
    engine: InferenceEngine
    seq: int
    t: float


class EngineRouter:
    """Front a pool of engines behind the engine's own
    submit()/run()/step() surface.

    >>> router = EngineRouter([eng_a, eng_b])
    >>> router.submit(Request(prompt=[1, 2, 3]))
    >>> results = router.run()       # drain the whole pool

    Knobs: `engine_factory` (zero-arg callable building a
    pool-compatible engine — same model object, same clock; required
    for add_engine()/autoscaling; a DICT keys factories by engine
    group for heterogeneous fleets), `clock` (monotonic-seconds
    source shared with the request-latency bookkeeping), `obs_label`
    (registry label; lets a rebuilt router continue its series),
    `tenancy` (a serving/tenancy.TenancyController on the SAME clock
    — arms per-tenant token-bucket admission + WFQ release)."""

    def __init__(self, engines: Sequence[InferenceEngine],
                 engine_factory=None,
                 clock: Callable[[], float] = time.monotonic,
                 obs_label: Optional[str] = None,
                 prefill_engines: Sequence[InferenceEngine] = (),
                 handoff_len: Optional[int] = None,
                 affinity: bool = False,
                 tenancy=None):
        if not engines:
            raise ValueError("EngineRouter needs at least one engine")
        if tenancy is not None and tenancy.clock is not clock:
            # bucket refill and WFQ expiry MUST tick on the router's
            # clock, or a virtual-clock replay stops being a pure
            # function of the submit/step sequence
            raise ValueError("tenancy controller must share the "
                             "router's clock (pass the same callable "
                             "to both)")
        self.tenancy = tenancy
        for eng in prefill_engines:
            if eng.role != "prefill":
                raise ValueError(
                    "prefill_engines must be role='prefill' engines "
                    f"(got role={eng.role!r})")
        if handoff_len is not None and not prefill_engines:
            raise ValueError("handoff_len without prefill_engines")
        self.engines: List[InferenceEngine] = list(engines)
        self.prefill_engines: List[InferenceEngine] = \
            list(prefill_engines)
        # prompts >= handoff_len route to the prefill tier; with
        # prefill engines present the default (1) sends everything
        # through it — set the threshold where "long prompt" starts
        # for your buckets
        self.handoff_len = 1 if (prefill_engines
                                 and handoff_len is None) \
            else handoff_len
        self._handoff_backlog: List[object] = []
        # prefix-affinity dispatch: constructor arg, never
        # env; off by default — load-only ranking is the pre-16 pin
        self.affinity = bool(affinity)
        # engines whose tree already migrated (one shot per engine —
        # id()-keyed: an engine object never re-enters a pool healthy)
        self._migrated: set = set()
        self.engine_factory = engine_factory
        self._clock = clock
        self.completed: Dict[int, GenerationResult] = {}
        self._pending: Dict[int, _Assignment] = {}
        # terminals settled OUTSIDE a step() call (submit-time shed
        # victims, final-sweep harvests) are buffered and surfaced by
        # the NEXT step() return — every terminal crosses step()
        # exactly once, which is what lets a calling loop (loadgen)
        # account for every request it submitted
        self._settled_backlog: List[GenerationResult] = []
        self._ids = itertools.count()
        self._seq = itertools.count()
        self._stats: Dict[str, int] = {
            "dispatched": 0, "spillover": 0, "failover": 0,
            "failover_lost": 0, "rejected": 0, "rebalanced": 0,
            "engines_added": 0, "engines_removed": 0,
            "prefill_dispatched": 0, "handoffs": 0,
            "migrations": 0, "migrated_blocks": 0,
            "tenant_deferred": 0, "tenant_shed": 0,
            "tenant_expired": 0, "group_moves": 0,
        }
        self._obs_name = obs_label or f"router{next(_ROUTER_IDS)}"
        reg = obs.get_registry()
        self._m_dispatch = reg.counter(
            "router_dispatch_total",
            "requests dispatched to an engine",
            labelnames=("router", "engine"))
        self._m_ops = {
            key: reg.counter(f"router_{key}_total", help_,
                             labelnames=("router",)
                             ).labels(router=self._obs_name)
            for key, help_ in {
                "spillover": "dispatches that spilled past the "
                             "first-choice engine",
                "failover": "requests rerouted off a degraded engine",
                "failover_lost": "degraded-engine requests with no "
                                 "surviving engine to take them",
                "rejected": "submissions rejected by every engine",
                "rebalanced": "queued requests moved between engines",
                "prefill_dispatched": "requests routed to the "
                                      "disaggregated prefill tier",
                "handoffs": "prefilled packages seated on serving "
                            "engines",
                "migrations": "degraded/draining engines whose radix "
                              "tree migrated to a survivor",
                "migrated_blocks": "KV blocks grafted into a "
                                   "survivor's host tier",
            }.items()}
        self._m_pool = reg.gauge(
            "router_pool_size", "engines in the pool",
            labelnames=("router",)).labels(router=self._obs_name)
        self._m_pool.set(len(self.engines))
        # submit→done latency on the router clock — fed
        # unconditionally (core bookkeeping: the Autoscaler's SLO
        # input and health() percentiles read it; BIGDL_OBS=off gates
        # events and counter mirrors only, exactly like the engine's
        # decode histogram)
        self._m_latency = reg.histogram(
            "router_request_latency_seconds",
            "request submit→done wall seconds (router clock, "
            "failover included)",
            labelnames=("router",),
            buckets=ROUTER_LATENCY_BUCKETS).labels(
                router=self._obs_name)
        # per-tenant telemetry — each family registered at
        # exactly THIS site (metric-family-contract); children resolve
        # lazily per tenant label as traffic names them. The latency
        # histogram is fed unconditionally like _m_latency: it is the
        # per-tenant SLOObjective's input, core bookkeeping
        self._m_tenant_throttled = reg.counter(
            "serving_tenant_throttled_total",
            "requests deferred/shed by a tenant's own admission "
            "budget (token bucket / max_pending)",
            labelnames=("router", "tenant", "action"))
        self._m_tenant_requests = reg.counter(
            "serving_tenant_requests_total",
            "fleet-level terminal statuses per tenant",
            labelnames=("router", "tenant", "status"))
        self._m_tenant_latency = reg.histogram(
            "router_tenant_request_latency_seconds",
            "per-tenant request submit→done wall seconds (router "
            "clock, failover included)",
            labelnames=("router", "tenant"),
            buckets=ROUTER_LATENCY_BUCKETS)

    # ------------------------------------------------------------- helpers
    def _bump(self, key: str, n: int = 1) -> None:
        self._stats[key] += n
        if obs.enabled() and key in self._m_ops:
            self._m_ops[key].inc(n)

    @property
    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def healthy_engines(self) -> List[InferenceEngine]:
        """Engines accepting new work (not degraded, not draining)."""
        return [e for e in self.engines
                if e.degraded is None and not e.draining]

    # -------------------------------------------------------------- groups
    @staticmethod
    def _group_of(eng) -> str:
        """An engine's group key: its model_tag, with None
        mapping to 'default' — the homogeneous-fleet back-compat."""
        return getattr(eng, "model_tag", None) or "default"

    @staticmethod
    def _req_group(request) -> str:
        """The group a request may be served by (its model_tag)."""
        return getattr(request, "model_tag", None) or "default"

    @property
    def groups(self) -> Dict[str, List[InferenceEngine]]:
        """group key → member serving engines, in pool order."""
        out: Dict[str, List[InferenceEngine]] = {}
        for e in self.engines:
            out.setdefault(self._group_of(e), []).append(e)
        return out

    @staticmethod
    def _rank(engines) -> List[InferenceEngine]:
        """Healthy engines by load, least-loaded first; ties break on
        pool index (deterministic dispatch)."""
        scored = [((e.slots_active + e.queue_depth) / max(e.slots, 1),
                   i, e)
                  for i, e in enumerate(engines)
                  if e.degraded is None and not e.draining]
        return [e for _, _, e in sorted(scored, key=lambda s: s[:2])]

    def _ranked(self, prompt: Optional[Sequence[int]] = None,
                group: Optional[str] = None
                ) -> List[InferenceEngine]:
        """Healthy serving engines in dispatch order, scoped to one
        engine `group` when given (every request-driven
        caller passes its request's group, making cross-group routing
        structurally impossible). With affinity on and a prompt in
        hand, longest radix match ranks FIRST (the stamp-free peek
        spans both KV tiers), load second, index third — health gating
        is applied before scoring, so a warm but degraded/draining
        tree is never a candidate."""
        pool = self.engines if group is None else [
            e for e in self.engines if self._group_of(e) == group]
        if not (self.affinity and prompt is not None):
            return self._rank(pool)
        scored = [(-e.prefix_match_tokens(prompt),
                   (e.slots_active + e.queue_depth) / max(e.slots, 1),
                   i, e)
                  for i, e in enumerate(pool)
                  if e.degraded is None and not e.draining]
        return [e for _, _, _, e in sorted(scored, key=lambda s: s[:3])]

    def _ranked_prefill(self, group: Optional[str] = None
                        ) -> List[InferenceEngine]:
        """Healthy prefill-tier engines, least-loaded first (the same
        ranking as the serving pool — one formula, two pools), group-
        scoped like the serving ranking."""
        pool = self.prefill_engines if group is None else [
            e for e in self.prefill_engines
            if self._group_of(e) == group]
        return self._rank(pool)

    def _resolve(self, engine) -> InferenceEngine:
        if isinstance(engine, InferenceEngine):
            if engine not in self.engines \
                    and engine not in self.prefill_engines:
                raise ValueError("engine is not in this router's pool")
            return engine
        return self.engines[engine]

    # -------------------------------------------------------------- submit
    def submit(self, request: Request) -> int:
        """Dispatch to the least-loaded healthy engine, spilling past
        bounded queues that reject. Raises NoHealthyEngine with an
        empty healthy set, or OverloadError when every healthy engine
        rejects (reject overload policy pool-wide). Under shed-*
        policies the admitting engine may shed a victim (or the
        request itself) — the result surfaces through the router like
        any other terminal, never a KeyError."""
        if request.id is None:
            rid = next(self._ids)
            while rid in self._pending or rid in self.completed:
                rid = next(self._ids)
            request.id = rid
        elif request.id in self._pending \
                or request.id in self.completed \
                or (self.tenancy is not None
                    and self.tenancy.has(request.id)):
            raise ValueError(f"request id {request.id} already in "
                             "flight or completed-unclaimed")
        if getattr(request, "trace_id", None) is None:
            # journey tracing: the trace context opens at
            # ROUTER admission — deterministic (router label + request
            # id, no clock/RNG), and every move below (failover,
            # rebalance, handoff import) increments the hop counter
            request.trace_id = f"{self._obs_name}/{request.id}"
            request.hop = 0
        if self.tenancy is not None:
            return self._submit_tenancy(request)
        return self._dispatch(request)

    def _submit_tenancy(self, request: Request) -> int:
        """Tenancy-armed admission: the request parks in
        its tenant's WFQ queue; step() releases in weighted-fair
        order, gated by the token bucket and group capacity. A
        max_pending overflow sheds HERE (status 'shed', reason
        'throttled') and the result rides the next step() return like
        any engine-side shed — a calling loop still sees every request
        exactly once."""
        verdict = self.tenancy.offer(request)
        if verdict == "shed":
            self._tenant_throttle(request.tenant, "shed", request)
            self._synthesize_terminal(request, "throttled", "shed",
                                      latency=0.0)
            return request.id
        if verdict == "deferred":
            self._tenant_throttle(request.tenant, "defer", request)
        return request.id

    def _tenant_throttle(self, tenant: str, action: str,
                         request: Optional[Request] = None) -> None:
        self._stats["tenant_deferred" if action == "defer"
                    else "tenant_shed"] += 1
        if obs.enabled():
            self._m_tenant_throttled.labels(
                router=self._obs_name, tenant=tenant,
                action=action).inc()
        obs.emit_event("tenant_throttled", plane="serving",
                       tenant=tenant, action=action,
                       router=self._obs_name,
                       request=None if request is None else request.id,
                       queued=self.tenancy.queued(tenant))

    def _synthesize_terminal(self, request: Request, reason: str,
                             status: str,
                             latency: Optional[float]) -> None:
        """Terminal for a request that never reached an engine (shed
        or expired at the tenancy gate): the router is the engine of
        record on the event (tp 0, role 'router'), and the result
        rides the settled backlog so step()/run() surface it exactly
        once, like any engine-settled terminal."""
        res = GenerationResult(request.id, list(request.prompt), [],
                               reason, status, ttft_s=None,
                               latency_s=latency)
        self.completed[request.id] = res
        self._settled_backlog.append(res)
        tenant = getattr(request, "tenant", None)
        if tenant is not None and obs.enabled():
            self._m_tenant_requests.labels(
                router=self._obs_name, tenant=tenant,
                status=status).inc()
        obs.emit_event("request_terminal", plane="serving",
                       engine=self._obs_name, request=request.id,
                       status=status, reason=reason, tokens=0,
                       ttft_s=None, latency_s=latency, tp=0,
                       role="router",
                       **InferenceEngine._trace_fields(request))

    def _dispatch(self, request: Request,
                  t0: Optional[float] = None) -> int:
        """Group-scoped dispatch: the prefill tier first for long
        prompts, then the ranked serving order, spilling past bounded
        queues that reject. `t0` back-dates the assignment's latency
        stamp to the tenancy offer time — time spent behind the tenant
        gate is part of the request's lifecycle, not free."""
        t = self._clock() if t0 is None else t0
        group = self._req_group(request)
        # disaggregated prefill: long prompts go to the prefill tier
        # (falling back to in-place prefill on the serving pool when
        # every prefill engine is unhealthy or rejects)
        if self.handoff_len is not None \
                and len(request.prompt) >= self.handoff_len:
            for eng in self._ranked_prefill(group):
                try:
                    eng.submit(request)
                except OverloadError:
                    continue
                self._pending[request.id] = _Assignment(
                    request, eng, next(self._seq), t)
                self._bump("dispatched")
                self._bump("prefill_dispatched")
                if obs.enabled():
                    self._m_dispatch.labels(
                        router=self._obs_name,
                        engine=eng.obs_name).inc()
                return request.id
        order = self._ranked(request.prompt, group)
        if not order:
            raise NoHealthyEngine(
                f"no healthy engine in group {group!r} (all degraded "
                "or draining, or the group has no engines)")
        last_err: Optional[OverloadError] = None
        for nth, eng in enumerate(order):
            try:
                eng.submit(request)
            except OverloadError as e:
                last_err = e
                continue
            self._pending[request.id] = _Assignment(
                request, eng, next(self._seq), t)
            self._bump("dispatched")
            if obs.enabled():
                self._m_dispatch.labels(
                    router=self._obs_name,
                    engine=eng.obs_name).inc()
            if nth > 0:
                self._bump("spillover")
            self._harvest(eng, None)     # shed victim / shed-self
            return request.id
        self._bump("rejected")
        raise last_err if last_err is not None else OverloadError(
            "every healthy engine rejected the request")

    # ---------------------------------------------------------- settlement
    def _settle(self, res: GenerationResult, eng: InferenceEngine,
                out: Optional[List[GenerationResult]]) -> None:
        asg = self._pending.get(res.id)
        if asg is None or asg.engine is not eng:
            return                        # stale result of a rerouted id
        if res.status == "failed" and eng.degraded is not None \
                and self._refer(asg):
            return                        # superseded by the reroute
        del self._pending[res.id]
        # lifecycle stamps tell the whole truth at the fleet level:
        # the engine stamped latency/ttft from its OWN submit time,
        # which resets when a request is rebalanced or failed over —
        # promote both to the ROUTER submit time (the clocks are the
        # same injected source in a well-formed fleet), so SLO reports
        # never under-count the queue time paid before a move
        total = self._clock() - asg.t
        if res.latency_s is None:
            res.latency_s = total
        elif total > res.latency_s:
            bump = total - res.latency_s
            res.latency_s = total
            if res.ttft_s is not None:
                res.ttft_s += bump
        self.completed[res.id] = res
        tenant = getattr(asg.request, "tenant", None)
        if res.status == "done":
            self._m_latency.observe(total)
            if tenant is not None:
                # unconditional like _m_latency — the per-tenant
                # SLOObjective's input is core bookkeeping
                self._m_tenant_latency.labels(
                    router=self._obs_name,
                    tenant=tenant).observe(total)
        if tenant is not None and obs.enabled():
            self._m_tenant_requests.labels(
                router=self._obs_name, tenant=tenant,
                status=res.status).inc()
        if out is not None:
            out.append(res)
        else:
            self._settled_backlog.append(res)

    def _refer(self, asg: _Assignment) -> bool:
        """Failover one assignment off its (degraded) engine: resubmit
        the ORIGINAL request to the least-loaded survivor. The request
        re-decodes from its prompt there; (seed, n) sampling streams
        make the regenerated tokens bit-identical to an undisturbed
        run. Deadline TTLs restart at resubmission (the original
        submit time is kept for latency accounting only). Ranking is
        prompt-aware under affinity, so a migrated tree pulls the
        rerouted requests to the survivor holding their blocks.

        Failover never crosses a layout family: a quantized
        engine's tokens agree with fp32 only to a tolerance, so a
        reroute onto a different `layout_family` would hand the client
        tokens the original engine would never have produced — the
        bit-identical-failover pin only holds within one family.

        Nor a GROUP: the ranked candidate list is scoped to
        the request's model group, so a vision engine is structurally
        never a failover target for an LM stream (and vice versa)."""
        family = getattr(asg.engine, "layout_family", None)
        for eng in self._ranked(asg.request.prompt,
                                self._req_group(asg.request)):
            if eng is asg.engine:
                continue
            if getattr(eng, "layout_family", None) != family:
                continue
            asg.request.hop += 1          # the reroute is a journey hop
            try:
                eng.submit(asg.request)
            except OverloadError:
                asg.request.hop -= 1      # nothing moved
                continue
            from_label = asg.engine.obs_name
            asg.engine = eng
            self._bump("failover")
            obs.emit_event(
                "router_failover", plane="serving",
                router=self._obs_name, request=asg.request.id,
                source=from_label,
                target=eng.obs_name,
                trace=asg.request.trace_id, hop=asg.request.hop)
            return True
        self._bump("failover_lost")
        return False

    # ----------------------------------------------------------- migration
    def _migrate_tree(self, eng: InferenceEngine) -> None:
        """Warm-state migration: the first time `eng` is
        seen degraded (or is drained), export its parked radix tree in
        one batched transfer and graft it into the least-loaded
        spill-enabled survivor's HOST tier. Pure placement — zero
        device work on the importer; the
        survivor's next prefix hits re-admit the bytes. One shot per
        engine object (id-keyed: an engine never re-enters a pool
        healthy), and a no-op when the tree is empty, unexportable
        (consumed device cache) or no survivor runs a spill tier."""
        if id(eng) in self._migrated:
            return
        self._migrated.add(id(eng))
        entries = eng.export_tree()
        if not entries:
            return
        # migration stays inside the donor's group: a
        # different group's engines serve a different model — its
        # prefill would never have written these bytes
        for target in self._ranked(None, self._group_of(eng)):
            if target is eng or not getattr(target, "spill_enabled",
                                            False):
                continue
            # migrated KV bytes embed the donor's weight/cache layout —
            # grafting them across a layout family would warm a prefix
            # the importer's own prefill would never have written
            if getattr(target, "layout_family", None) != \
                    getattr(eng, "layout_family", None):
                continue
            grafted = target.import_tree(entries)
            if not grafted:
                return
            self._bump("migrations")
            self._bump("migrated_blocks", grafted)
            obs.emit_event(
                "prefix_migrate", plane="serving",
                router=self._obs_name, source=eng.obs_name,
                target=target.obs_name, blocks=grafted,
                chains=len(entries))
            return

    def _harvest(self, eng: InferenceEngine,
                 out: Optional[List[GenerationResult]]) -> None:
        """Claim results the engine settled outside step() returns —
        shed victims at submit time, queued requests failed by a
        degradation."""
        owned = [rid for rid, res in eng.completed.items()
                 if rid in self._pending
                 and self._pending[rid].engine is eng]
        for rid in owned:
            self._settle(eng.completed.pop(rid), eng, out)

    # ----------------------------------------------------------- rebalance
    def _rebalance(self) -> None:
        """Move queued (never in-flight) requests from backlogged
        engines onto engines with idle capacity, so scale-up actually
        absorbs an existing backlog (a freshly added engine would
        otherwise sit empty while the old one's queue serializes) and
        draining engines hand their line to the rest of the pool.
        Donors give up the requests they would serve LAST
        (engine.steal_queued); receivers take only what they can admit
        on the next round, so a moved request never waits twice.

        Rebalance is scoped WITHIN each model group: a
        vision engine's idle slots can never absorb an LM backlog —
        groups iterate in sorted-key order for determinism.

        With affinity on, a donor keeps any queued request
        its radix tree matches STRICTLY better than the receiver's —
        load smoothing must not cold-start a prompt whose warm prefix
        lives on the donor (the trip-time migration path covers the
        donor actually dying)."""
        groups = self.groups
        for gname in sorted(groups):
            if len(groups[gname]) > 1:
                self._rebalance_group(groups[gname])

    def _rebalance_group(self, engines: List[InferenceEngine]) -> None:
        for ri, recv in sorted(
                ((i, e) for i, e in enumerate(engines)
                 if e.degraded is None and not e.draining),
                key=lambda ie: ((ie[1].slots_active
                                 + ie[1].queue_depth)
                                / max(ie[1].slots, 1), ie[0])):
            room = (recv.slots - recv.slots_active) - recv.queue_depth
            if recv.max_queue is not None:
                room = min(room, recv.max_queue - recv.queue_depth)
            while room > 0:
                donor = None
                excess_best = 0
                for e in engines:
                    if e is recv or e.degraded is not None:
                        continue
                    free = e.slots - e.slots_active
                    excess = e.queue_depth - (0 if e.draining
                                              else free)
                    if excess > excess_best:
                        donor, excess_best = e, excess
                if donor is None:
                    break
                moved = donor.steal_queued(min(room, excess_best))
                if not moved:
                    break
                if self.affinity:
                    keep = []
                    for req, t0 in moved:
                        if (donor.prefix_match_tokens(req.prompt)
                                > recv.prefix_match_tokens(req.prompt)):
                            donor._requeue(req, t0)  # warm stays home
                        else:
                            keep.append((req, t0))
                    if not keep:
                        break
                    moved = keep
                n_ok, moved_ids = 0, []
                for mi, (req, t0) in enumerate(moved):
                    req.hop += 1          # the move is a journey hop
                    try:
                        recv.submit(req)
                    except OverloadError:   # racing expiry shrank room
                        # bounce the whole remainder home with their
                        # ORIGINAL stamps — a failed move never resets
                        # a TTL (nor advances a journey hop), and
                        # retrying the rest is pointless
                        req.hop -= 1
                        for r, rt in moved[mi:]:
                            donor._requeue(r, rt)
                        room = 0
                        break
                    if req.id in self._pending:
                        self._pending[req.id].engine = recv
                    self._bump("rebalanced")
                    n_ok += 1
                    moved_ids.append(req.id)
                    room -= 1
                if n_ok:
                    obs.emit_event("router_rebalance", plane="serving",
                                   router=self._obs_name,
                                   source=donor.obs_name,
                                   target=recv.obs_name, moved=n_ok,
                                   requests=moved_ids)

    # ---------------------------------------------------------------- step
    def step(self) -> List[GenerationResult]:
        """One scheduling round: queued work rebalances toward idle
        capacity, then every live engine admits + decodes once;
        terminal results are settled, and a degradation triggers
        failover of everything the dead engine held. Returns the
        requests that reached a FINAL terminal state this round
        (transitional 'failed' results that were rerouted are not
        surfaced); terminals settled between steps — submit-time shed
        victims — ride the next return, so a calling loop sees every
        request it submitted exactly once."""
        self._rebalance()
        if self.tenancy is not None:
            # release BEFORE draining the backlog: expiry terminals
            # synthesized here ride THIS round's return
            self._release_tenancy()
        out: List[GenerationResult] = list(self._settled_backlog)
        self._settled_backlog.clear()
        # prefill tier first: admit+prefill+export, then seat the
        # packages (fresh and backlogged) on the serving pool — a
        # package that cannot seat this round (slots full, pool
        # pressure) retries next round; a degraded prefill engine's
        # held requests fail over through _harvest/_settle to the
        # serving pool, which prefills them in place
        for eng in list(self.prefill_engines):
            if eng.degraded is None:
                eng.step()
            self._handoff_backlog.extend(eng.take_handoffs())
            self._harvest(eng, out)
        if self._handoff_backlog:
            self._handoff_backlog = [
                pkg for pkg in self._handoff_backlog
                if self.handoff(pkg) is None]
        for eng in list(self.engines):
            results = [] if eng.degraded is not None else eng.step()
            if eng.degraded is not None:
                # a degradation happens INSIDE eng.step() — migrate
                # the parked tree BEFORE settling this round's
                # failures, so the failover resubmissions land on (and
                # re-admit from) the survivor that received it rather
                # than re-prefilling cold (incumbents win at graft)
                self._migrate_tree(eng)
            # in-flight failures first (admitted earlier), then the
            # queued ones the degradation parked in eng.completed —
            # failover preserves original admission order
            for res in sorted(
                    results,
                    key=lambda r: self._pending[r.id].seq
                    if r.id in self._pending else -1):
                self._settle(res, eng, out)
            self._harvest(eng, out)
        return out

    def _release_tenancy(self) -> None:
        """Drain the tenancy controller's queues in WFQ order, gated
        by each tenant's token bucket and each engine group's free
        capacity this round. Expired entries (deadline / queue-wait
        TTL from offer time) synthesize 'expired' terminals first,
        mirroring the engine's own queue expiry. A released request
        whose dispatch bounces off every engine returns to its queue
        head with its token refunded."""
        now = self._clock()
        for entry in self.tenancy.expire(now):
            self._stats["tenant_expired"] += 1
            self._synthesize_terminal(entry.request, "expired",
                                      "expired", latency=now - entry.t)
        # free capacity per group: slots the engine could seat plus
        # queue headroom, never negative — the WFQ release only hands
        # out what the pool can actually admit this round
        rooms: Dict[str, int] = {}
        for eng in self.engines:
            if eng.degraded is not None or eng.draining:
                continue
            room = max(0, (eng.slots - eng.slots_active)
                       - eng.queue_depth)
            if eng.max_queue is not None:
                room = min(room, max(0, eng.max_queue
                                     - eng.queue_depth))
            g = self._group_of(eng)
            rooms[g] = rooms.get(g, 0) + room
        for entry in self.tenancy.release(rooms):
            try:
                self._dispatch(entry.request, t0=entry.t)
            except (OverloadError, NoHealthyEngine):
                self.tenancy.bounce(entry)

    def handoff(self, pkg) -> Optional[InferenceEngine]:
        """Seat one prefilled HandoffPackage on the least-loaded
        healthy serving engine (engine.import_handoff); None when no
        engine can take it right now — the caller (step's backlog)
        retries next round. Reassigns the request's pending entry to
        the importer, so terminals and failover keep working across
        the disaggregation boundary."""
        for eng in self._ranked(None, self._req_group(pkg.request)):
            if not eng.import_handoff(pkg):
                continue
            asg = self._pending.get(pkg.request.id)
            if asg is not None:
                asg.engine = eng
            self._bump("handoffs")
            obs.emit_event("router_handoff", plane="serving",
                           router=self._obs_name,
                           request=pkg.request.id,
                           source=pkg.source, target=eng.obs_name,
                           blocks=len(pkg.kv[0]["k"]),
                           trace=pkg.request.trace_id,
                           hop=pkg.request.hop)
            return eng
        return None

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[GenerationResult]:
        """Submit `requests` (if given), then step the pool until every
        engine drains. Returns `requests`' results in submission order
        (or, with no argument, everything that finished, id order) —
        identical semantics to InferenceEngine.run, one level up."""
        ids = [self.submit(r) for r in requests] if requests else None
        prev_clock = None
        while any(not e.idle for e in self.engines) \
                or any(not e.idle for e in self.prefill_engines) \
                or self._handoff_backlog \
                or (self.tenancy is not None and self.tenancy.pending):
            before = len(self._handoff_backlog)
            if self.tenancy is not None and self.tenancy.pending \
                    and all(e.idle for e in self.engines) \
                    and not self._handoff_backlog:
                # the only work left is parked behind tenant gates;
                # on a frozen clock (no refill, no TTL expiry) another
                # round cannot release anything — fail loud instead of
                # spinning forever
                now = self._clock()
                if prev_clock is not None and now <= prev_clock:
                    raise RuntimeError(
                        f"{self.tenancy.pending} request(s) parked "
                        "behind tenant admission gates cannot release "
                        "(empty buckets and a non-advancing clock — "
                        "advance the virtual clock or raise the "
                        "refill rate)")
                prev_clock = now
            # stuck-backlog detection must give a TRANSIENTLY
            # unseatable package one more round: seating runs at the
            # top of step(), so slots freed later in the same round
            # are only retried next round — raise only when a round
            # that STARTED with the whole pool idle (nothing left to
            # free) still could not shrink the backlog
            idle_before = all(e.idle for e in self.engines) \
                and all(e.idle for e in self.prefill_engines)
            self.step()
            if (self._handoff_backlog
                    and len(self._handoff_backlog) >= before
                    and idle_before
                    and all(e.idle for e in self.engines)
                    and all(e.idle for e in self.prefill_engines)):
                raise RuntimeError(
                    f"{len(self._handoff_backlog)} handoff package(s) "
                    "cannot be seated on any serving engine (prompt "
                    "needs more blocks than a slot can hold?)")
        for eng in list(self.engines) + list(self.prefill_engines):
            self._harvest(eng, None)      # final sweep: late sheds
        # run() delivers through its return value — don't re-surface
        # these through a later step()
        self._settled_backlog.clear()
        if ids is None:
            out = sorted(self.completed.values(), key=lambda r: r.id)
            self.completed = {}
            return out
        return [self.completed.pop(i) for i in ids]

    # ------------------------------------------------------- pool mutation
    def add_engine(self, engine: Optional[InferenceEngine] = None,
                   group: Optional[str] = None) -> InferenceEngine:
        """Grow the pool (the autoscaler's scale-up lever). With no
        argument the `engine_factory` builds the engine. With a
        dict-valued factory (heterogeneous fleets), `group` picks
        which group's factory builds it ('default' when omitted); the
        newcomer must land in the group it was asked for."""
        if engine is None:
            if self.engine_factory is None:
                raise ValueError("add_engine() without an engine "
                                 "needs an engine_factory")
            factory = self.engine_factory
            if isinstance(factory, dict):
                key = group or "default"
                if key not in factory:
                    raise ValueError(
                        f"no engine_factory for group {key!r} "
                        f"(have: {sorted(factory)})")
                factory = factory[key]
            engine = factory()
        if group is not None:
            got = self._group_of(engine)
            if getattr(engine, "model_tag", None) is None:
                engine.model_tag = group      # tag the untagged
            elif got != group:
                raise ValueError(
                    f"engine is tagged {got!r}, asked for group "
                    f"{group!r}")
        self.engines.append(engine)
        self._bump("engines_added")
        self._m_pool.set(len(self.engines))
        obs.emit_event("engine_added", plane="serving",
                       router=self._obs_name,
                       engine=engine.obs_name,
                       pool_size=len(self.engines))
        return engine

    def move_engine(self, engine, group: str) -> InferenceEngine:
        """Retag an IDLE engine into another group —
        capacity movement between groups serving the same model object
        (a retag is pure bookkeeping). Refused when the engine still holds work, or
        when the target group's members run a DIFFERENT model — an
        engine cannot serve a model it was not built over."""
        eng = self._resolve(engine)
        src = self._group_of(eng)
        if src == group:
            return eng
        if not eng.idle:
            raise ValueError("engine still holds work; drain or step "
                             "the pool idle before moving it")
        for member in self.groups.get(group, []):
            if getattr(member, "model", None) is not None \
                    and getattr(eng, "model", None) is not member.model:
                raise ValueError(
                    f"group {group!r} serves a different model "
                    "object; move_engine only retags same-model "
                    "capacity (use add_engine(group=) with that "
                    "group's factory instead)")
            break
        eng.model_tag = group
        self._bump("group_moves")
        obs.emit_event("group_rebalance", plane="serving",
                       router=self._obs_name, from_group=src,
                       to_group=group, action="move",
                       engine=eng.obs_name)
        return eng

    def drain(self, engine) -> InferenceEngine:
        """Flip one engine (by index or identity) to stop-admission:
        the router routes new traffic around it while its accepted
        work finishes; once health() reports 'drained' it is safe to
        remove_engine()."""
        eng = self._resolve(engine)
        eng.drain()
        # hand the warm tree to a survivor now — new traffic routes
        # around this engine from this point on, so its blocks would
        # otherwise age out unused
        self._migrate_tree(eng)
        return eng

    def remove_engine(self, engine) -> InferenceEngine:
        """Retire an engine. Only a 'drained' or degraded engine with
        no router-owned work still assigned may leave the pool —
        scale-down can never lose a request."""
        eng = self._resolve(engine)
        state = eng.health()["state"]
        if state not in ("drained", "degraded"):
            raise ValueError(
                f"engine is {state!r}; drain() it (or let failover "
                "finish) before removing")
        if any(a.engine is eng for a in self._pending.values()):
            raise ValueError("engine still holds router-owned "
                             "requests; step() the pool first")
        self._harvest(eng, None)
        if eng in self.engines:
            self.engines.remove(eng)
        else:
            self.prefill_engines.remove(eng)
        self._bump("engines_removed")
        self._m_pool.set(len(self.engines))
        obs.emit_event("engine_removed", plane="serving",
                       router=self._obs_name,
                       engine=eng.obs_name,
                       state=state, pool_size=len(self.engines))
        return eng

    # --------------------------------------------------------------- views
    def health(self) -> Dict[str, object]:
        """Pool snapshot: per-engine health() plus the fleet rollup
        the autoscaler consumes (aggregate occupancy/backlog, request
        latency percentiles from the router histogram)."""
        per = [e.health() for e in self.engines]
        healthy = self.healthy_engines()

        def pct(q):
            v = self._m_latency.quantile(q)
            return None if v is None else round(v * 1e3, 3)

        groups = {
            gname: {
                "engines": len(members),
                "healthy": sum(1 for e in members
                               if e.degraded is None
                               and not e.draining),
                "slots_active": sum(e.slots_active for e in members),
                "queue_depth": sum(e.queue_depth for e in members),
            }
            for gname, members in sorted(self.groups.items())}
        return {
            "pool_size": len(self.engines),
            "healthy": len(healthy),
            "prefill_engines": len(self.prefill_engines),
            "handoff_backlog": len(self._handoff_backlog),
            "states": [h["state"] for h in per],
            "slots": sum(e.slots for e in healthy),
            "slots_active": sum(e.slots_active for e in healthy),
            "queue_depth": sum(e.queue_depth for e in healthy),
            "request_p50_ms": pct(0.50),
            "request_p99_ms": pct(0.99),
            "groups": groups,
            "tenants": None if self.tenancy is None
            else self.tenancy.health(),
            "stats": self.stats,
            "engines": per,
        }

    @property
    def request_latency(self):
        """The router's request-latency histogram child (buckets /
        counts / quantile) — the Autoscaler's SLO input."""
        return self._m_latency
