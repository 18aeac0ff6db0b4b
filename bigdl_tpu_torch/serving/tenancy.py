"""Multi-tenant admission + fairness for the serving fleet.

Ports bigdl_tpu/serving/tenancy.py (host-side Python, copied): a
deterministic token-bucket admission gate plus
weighted-fair queueing (start-time fair queueing over virtual time),
layered IN FRONT of the existing per-engine priority/deadline/overload
machinery. An over-budget tenant's requests are deferred or shed by
ITS bucket while every other tenant's queues, KV blocks, and SLOs are
untouched — noisy-neighbor containment at the router, not inside the
engines.

Design contract (mirrors the router's):

* **Every knob is a constructor arg, never env**: bucket capacity/refill, WFQ weights, per-tenant
  queue bounds and KV quotas all arrive on `TenantSpec`.
* **No wall-clock reads.** The controller shares the ROUTER's
  injectable clock (`EngineRouter(tenancy=...)` enforces identity), so
  a loadgen replay on a virtual clock is byte-identical run to run —
  bucket refill, WFQ tags and TTL expiry are pure functions of the
  submit/step sequence.
* **No device work, no RNG, no telemetry of its own.** The router owns
  the `tenant_throttled` events and per-tenant counters; the
  controller is a pure host-side state machine the fleet drills can
  replay.

Weighted-fair queueing: each admitted request gets start/finish tags
(`start = max(V, tenant_last_finish)`, `finish = start + 1/weight`)
at offer time; release picks, among tenant queue HEADS whose bucket
can pay AND whose target engine group has room, the smallest
`(finish, tenant)` — so a 10:1 flood from one tenant still yields
service shares proportional to the configured weights while both
stay backlogged, and an empty bucket or a full group never
head-of-line-blocks the other tenants (the scan skips, it does not
wait).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from bigdl_tpu_torch.serving.engine import Request

__all__ = ["TokenBucket", "TenantSpec", "TenancyController"]


class TokenBucket:
    """Deterministic token bucket on an injected clock.

    Refill is computed lazily from clock deltas (`tokens = min(cap,
    tokens + dt * rate)`) — no background thread, no wall-clock reads;
    two runs over the same clock sequence produce bit-identical token
    balances. `capacity` bounds the burst a tenant can land at once,
    `refill_rate` its sustained requests/sec."""

    def __init__(self, capacity: float, refill_rate: float, *,
                 clock: Callable[[], float],
                 initial: Optional[float] = None):
        if capacity <= 0:
            raise ValueError("bucket capacity must be > 0")
        if refill_rate < 0:
            raise ValueError("refill_rate must be >= 0")
        self.capacity = float(capacity)
        self.refill_rate = float(refill_rate)
        self._clock = clock
        self._tokens = float(capacity if initial is None else initial)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        dt = now - self._last
        if dt > 0:
            self._tokens = min(self.capacity,
                               self._tokens + dt * self.refill_rate)
        self._last = now

    def peek(self) -> float:
        """Current balance after lazy refill (no take)."""
        self._refill()
        return self._tokens

    def try_take(self, cost: float = 1.0) -> bool:
        """Pay `cost` tokens if the balance covers it."""
        self._refill()
        if self._tokens + 1e-12 >= cost:     # float-refill slack
            self._tokens -= cost
            return True
        return False

    def give(self, cost: float = 1.0) -> None:
        """Refund a paid cost (a dispatch that bounced off every
        engine puts its token back — the request did not run)."""
        self._tokens = min(self.capacity, self._tokens + cost)


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's isolation contract (all constructor-side, never
    env): WFQ `weight` (service share while backlogged),
    `bucket_capacity`/`refill_rate` (admission budget),
    `kv_block_quota` (max exclusively-owned KV blocks across an
    engine's active slots — enforced by InferenceEngine's
    `tenant_kv_quotas`, carried here so one spec describes the whole
    contract), `max_pending` (deferred-queue bound; an arrival past it
    is shed with status 'shed' / reason 'throttled')."""
    name: str
    weight: float = 1.0
    bucket_capacity: float = 8.0
    refill_rate: float = 1.0
    kv_block_quota: Optional[int] = None
    max_pending: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("tenant weight must be > 0")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if self.kv_block_quota is not None and self.kv_block_quota < 1:
            raise ValueError("kv_block_quota must be >= 1 (or None)")


@dataclass
class _Queued:
    """One deferred request with its WFQ tags and offer stamp."""
    start: float
    finish: float
    request: Request
    t: float


class TenancyController:
    """Per-tenant token-bucket admission + weighted-fair release.

    >>> ctl = TenancyController(
    ...     [TenantSpec("quiet", weight=1.0),
    ...      TenantSpec("noisy", weight=1.0, bucket_capacity=2,
    ...                 refill_rate=0.5, max_pending=8)],
    ...     clock=clk)
    >>> router = EngineRouter(engines, tenancy=ctl, clock=clk)

    With the controller armed, EVERY router submission lands in a
    per-tenant FIFO here; `EngineRouter.step()` releases in WFQ order,
    gated per request by the tenant's bucket and the target engine
    group's free capacity. The controller never touches engines,
    events or metrics — the router drives it and owns the telemetry.

    `Request.tenant` names the tenant; an unknown name (or None)
    raises unless a spec literally named "default" exists to absorb
    untagged traffic."""

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 clock: Callable[[], float],
                 group_of: Optional[Callable[[Request], str]] = None):
        if not tenants:
            raise ValueError("TenancyController needs >= 1 TenantSpec")
        self.clock = clock
        self._specs: Dict[str, TenantSpec] = {}
        for spec in tenants:
            if spec.name in self._specs:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self._specs[spec.name] = spec
        self._buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(s.bucket_capacity, s.refill_rate,
                              clock=clock)
            for name, s in self._specs.items()}
        self._queues: Dict[str, deque] = {
            name: deque() for name in self._specs}
        self._finish: Dict[str, float] = dict.fromkeys(self._specs, 0.0)
        self._vtime = 0.0
        self._group_of = group_of or (
            lambda r: getattr(r, "model_tag", None) or "default")
        self._stats: Dict[str, Dict[str, int]] = {
            name: {"submitted": 0, "released": 0, "deferred": 0,
                   "shed": 0, "expired": 0}
            for name in self._specs}

    # ------------------------------------------------------------ lookup
    def resolve(self, tenant: Optional[str]) -> str:
        """Map a request's tenant field to a registered spec name
        (None falls back to a spec literally named 'default')."""
        name = tenant if tenant is not None else "default"
        if name not in self._specs:
            raise ValueError(
                f"unknown tenant {tenant!r}: register a TenantSpec "
                "for it (or a 'default' spec for untagged traffic)")
        return name

    def spec(self, name: str) -> TenantSpec:
        return self._specs[self.resolve(name)]

    @property
    def tenants(self) -> List[str]:
        return sorted(self._specs)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def has(self, request_id) -> bool:
        """Whether an id is parked in any tenant queue (the router's
        duplicate-id guard extends here)."""
        return any(e.request.id == request_id
                   for q in self._queues.values() for e in q)

    # ------------------------------------------------------------- offer
    def offer(self, request: Request) -> str:
        """Park one request behind its tenant's gate. Returns
        'queued' (bucket can pay now — release order is still WFQ),
        'deferred' (bucket currently empty — it waits for refill) or
        'shed' (deferred queue at max_pending — the caller synthesizes
        the shed terminal). Tags are assigned HERE (arrival), so a
        backlogged tenant's requests chain finish tags 1/weight apart
        — the WFQ share while contended."""
        name = self.resolve(request.tenant)
        request.tenant = name             # lifecycle events carry it
        spec = self._specs[name]
        q = self._queues[name]
        st = self._stats[name]
        st["submitted"] += 1
        if spec.max_pending is not None and len(q) >= spec.max_pending:
            st["shed"] += 1
            return "shed"
        start = max(self._vtime, self._finish[name])
        fin = start + 1.0 / spec.weight
        self._finish[name] = fin
        q.append(_Queued(start, fin, request, self.clock()))
        if self._buckets[name].peek() < 1.0:
            st["deferred"] += 1
            return "deferred"
        return "queued"

    # ------------------------------------------------------------ expiry
    def expire(self, now: float) -> List[_Queued]:
        """Pop queued entries whose deadline_s / max_queue_wait_s TTL
        (from OFFER time) has passed — the caller synthesizes their
        'expired' terminals (entry.t gives it the true latency),
        mirroring the engine's queue expiry."""
        dead: List[_Queued] = []
        for name, q in self._queues.items():
            keep: deque = deque()
            for e in q:
                ttl = math.inf
                if e.request.deadline_s is not None:
                    ttl = min(ttl, e.t + e.request.deadline_s)
                if e.request.max_queue_wait_s is not None:
                    ttl = min(ttl, e.t + e.request.max_queue_wait_s)
                if now >= ttl:
                    dead.append(e)
                    self._stats[name]["expired"] += 1
                else:
                    keep.append(e)
            self._queues[name] = keep
        return dead

    # ----------------------------------------------------------- release
    def release(self, rooms: Dict[str, int]) -> List[_Queued]:
        """Drain queue heads in WFQ order: repeatedly pick the
        smallest `(finish, tenant)` among heads whose bucket can pay
        one token AND whose engine group has room left in `rooms`
        (mutated down as requests release). A blocked head is skipped,
        never waited on — an empty bucket or a full group cannot
        head-of-line-block other tenants. Virtual time advances to
        each released request's start tag (start-time fair queueing)."""
        out: List[_Queued] = []
        while True:
            best_key, best_name = None, None
            for name in sorted(self._queues):
                q = self._queues[name]
                if not q:
                    continue
                head = q[0]
                if rooms.get(self._group_of(head.request), 0) < 1:
                    continue
                if self._buckets[name].peek() < 1.0:
                    continue
                key = (head.finish, name)
                if best_key is None or key < best_key:
                    best_key, best_name = key, name
            if best_name is None:
                return out
            entry = self._queues[best_name].popleft()
            self._buckets[best_name].try_take(1.0)
            self._vtime = max(self._vtime, entry.start)
            self._stats[best_name]["released"] += 1
            rooms[self._group_of(entry.request)] -= 1
            out.append(entry)

    def bounce(self, entry: _Queued) -> None:
        """Undo one release whose dispatch bounced off every engine:
        the entry returns to its queue head with its original tags and
        offer stamp, and the paid token is refunded — a bounced
        dispatch must not bill or re-tag the tenant."""
        name = self.resolve(entry.request.tenant)
        self._queues[name].appendleft(entry)
        self._buckets[name].give(1.0)
        self._stats[name]["released"] -= 1

    # ------------------------------------------------------------- views
    def queued(self, name: str) -> int:
        return len(self._queues[self.resolve(name)])

    def stats(self, name: str) -> Dict[str, int]:
        return dict(self._stats[self.resolve(name)])

    def health(self) -> Dict[str, object]:
        """Per-tenant snapshot: queue depth, rounded bucket balance,
        WFQ weight and the admission counters."""
        return {
            name: {
                "queued": len(self._queues[name]),
                "bucket_tokens": round(self._buckets[name].peek(), 6),
                "weight": self._specs[name].weight,
                **self._stats[name],
            }
            for name in sorted(self._specs)}
