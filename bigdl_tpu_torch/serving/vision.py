"""Fixed-batch vision engine behind the router surface.

Ports `VisionEngine` from bigdl_tpu/serving/vision.py. BigDL's serving
surface is a model zoo behind one ingress, not only an LM:
`VisionEngine` puts a classification `Predictor`-style forward behind
the router surface `InferenceEngine` exposes (submit/step/run, drain,
health, steal_queued, the KV-plane no-ops), so an `EngineRouter` serves
a vision group beside the LM decode pool, with dispatch, rebalance,
failover and tenancy scoped by `model_tag`.

* **One fixed-shape forward.** Every step pads up to `batch` requests'
  feature vectors into one `(batch, feature_len)` float32 block on the
  engine's device and runs one forward under `torch.no_grad()` (cuDNN
  and ATen on the card: the JAX engine computes it outside any Pallas
  kernel); pad rows are computed and ignored, the LM decode idiom. The
  JAX engine jits the forward and memoizes it process-wide on
  `(id(predict_fn), batch, feature_len)`; the port runs it eagerly and
  keeps the same memo, counting a forward's first call as its build,
  so `stats["forward_traces"]` keeps its contract: engines over one
  predict function share one forward, and growing a vision group adds
  no build.
* **Requests are Requests.** `Request.prompt` carries the flattened
  feature ints (len <= feature_len; right-padded with zeros); the
  result's single token is the argmax class id, finish_reason
  'classified'. Priority admission, deadline and queue-wait expiry and
  reject-only overload keep the LM engine's semantics, so tenancy and
  the drills treat both planes alike.
* **Deterministic, host-side bookkeeping.** No RNG, an injectable
  clock; argmax ties break to the lowest index (`torch.argmax` returns
  the first maximum, on the CPU and on CUDA) — two replays are
  identical. One device-to-host read a step: the batch's classes.

The KV plane is absent: `prefix_match_tokens` is 0 and
`export_tree`/`import_tree`/`import_handoff` are refusing no-ops, so a
misconfigured fleet's cross-group migration or handoff is a no-op, not
a corruption.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.serving.engine import (EngineDraining,
                                            GenerationResult,
                                            InferenceEngine,
                                            OverloadError, Request)
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["VisionEngine"]

_VISION_IDS = itertools.count()

# process-wide build tally of the shared forwards: engines snapshot it
# at creation and report deltas (the LM engine's trace-count idiom); a
# forward counts once, at its first call
_TRACES: Dict[str, int] = {"forward": 0}

# (id(predict_fn), batch, feature_len) -> forward; engines over the
# same predict function share it, so growing a vision group builds
# nothing new
_FORWARD_CACHE: Dict[Tuple[int, int, int], Callable] = {}


class _Forward:
    """`predict_fn` then the argmax class of each row, on the device;
    its first call is its build."""

    def __init__(self, predict_fn: Callable):
        self.predict_fn = predict_fn
        self.built = False

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        if not self.built:
            self.built = True
            _TRACES["forward"] += 1
        with torch.no_grad():
            return torch.argmax(self.predict_fn(feats), dim=-1)


def _forward_for(predict_fn: Callable, batch: int,
                 feature_len: int) -> Callable:
    key = (id(predict_fn), batch, feature_len)
    fn = _FORWARD_CACHE.get(key)
    if fn is None:
        fn = _FORWARD_CACHE[key] = _Forward(predict_fn)
    return fn


class VisionEngine:
    """Fixed-batch classification engine behind the router surface.

    >>> eng = VisionEngine(predict_fn, batch=4, feature_len=64,
    ...                    model_tag="vision")
    >>> router = EngineRouter([lm_eng, eng], tenancy=ctl)

    `predict_fn(feats)` maps a `(batch, feature_len)` float32 tensor on
    the engine's `device` (None: the card) to `(batch, num_classes)`
    logits — a closed-over-weights apply, the Predictor's forward. All
    knobs are constructor arguments, never the environment."""

    role = "serving"
    tp = 1

    def __init__(self, predict_fn: Callable, *, batch: int = 4,
                 feature_len: int, model_tag: Optional[str] = "vision",
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs_label: Optional[str] = None,
                 device: DeviceLike = None):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if feature_len < 1:
            raise ValueError("feature_len must be >= 1")
        self.model = predict_fn        # the identity move_engine checks
        self.batch = batch
        self.feature_len = feature_len
        self.model_tag = model_tag
        self.max_queue = max_queue
        self.device = resolve_device(device)
        self._clock = clock
        self._forward = _forward_for(predict_fn, batch, feature_len)
        self._queue: deque = deque()
        self._meta: Dict[int, Dict[str, float]] = {}
        self._ids = itertools.count()
        self.completed: Dict[int, GenerationResult] = {}
        self._draining = False
        self._stats = {"submitted": 0, "forwards": 0, "classified": 0,
                       "rejected": 0, "expired": 0,
                       # fleet-wide key the LM engine also reports —
                       # router tests/drills read it group-agnostically
                       "requests_done": 0}
        self._obs_name = obs_label or f"vision{next(_VISION_IDS)}"
        reg = obs.get_registry()
        # a vision terminal is a serving terminal: bind the family and
        # label set the LM engine registers (the registry hands back the
        # one family and raises on a label-set drift; a vision-only
        # process on a fresh registry must still be able to create it)
        self._m_requests = reg.counter(  # graftlint: disable=metric-family-contract
            "serving_requests_total",
            "requests reaching a terminal status",
            labelnames=("engine", "status", "tp"))
        self._trace0 = dict(_TRACES)

    # -------------------------------------------------------------- router
    # surface parity with InferenceEngine — the router is layout- and
    # plane-blind, it only reads these
    @property
    def obs_name(self) -> str:
        return self._obs_name

    @property
    def layout_family(self) -> str:
        return "fp32/float32"

    @property
    def degraded(self) -> Optional[str]:
        return None                   # no watchdog/retry plane here

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def slots(self) -> int:
        return self.batch

    @property
    def slots_active(self) -> int:
        return 0                      # forwards are synchronous

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._queue

    @property
    def buckets(self) -> Tuple[int, ...]:
        return (self.feature_len,)

    @property
    def spill_enabled(self) -> bool:
        return False

    def prefix_match_tokens(self, prompt: Sequence[int]) -> int:
        return 0                      # no KV plane, nothing is warm

    def export_tree(self) -> list:
        return []

    def import_tree(self, entries) -> int:
        return 0

    def import_handoff(self, pkg) -> bool:
        return False

    def take_handoffs(self) -> list:
        return []

    @property
    def stats(self) -> Dict[str, int]:
        out = dict(self._stats)
        out["forward_traces"] = (_TRACES["forward"]
                                 - self._trace0["forward"])
        return out

    # ---------------------------------------------------------------- host
    def submit(self, request: Request) -> int:
        if self._draining:
            raise EngineDraining(
                "engine is draining (stop-admission): route new "
                "requests to another engine in the pool")
        n = len(request.prompt)
        if n == 0:
            raise ValueError("empty feature vector")
        if n > self.feature_len:
            raise ValueError(f"feature vector of {n} exceeds "
                             f"feature_len={self.feature_len}")
        in_flight = {r.id for r in self._queue} | set(self.completed)
        if request.id is None:
            rid = next(self._ids)
            while rid in in_flight:
                rid = next(self._ids)
            request.id = rid
        elif request.id in in_flight:
            raise ValueError(f"request id {request.id} already in "
                             "flight or completed-unclaimed")
        if request.trace_id is None:
            request.trace_id = f"{self._obs_name}/{request.id}"
            request.hop = 0
        self._expire_queued(self._clock())
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            # reject-only overload: a vision batch group sheds at the
            # router/tenancy layer, not per-engine
            self._stats["rejected"] += 1
            obs.emit_event("request_rejected", plane="serving",
                           engine=self._obs_name, request=request.id,
                           queue_depth=len(self._queue),
                           **self._trace_fields(request))
            raise OverloadError(
                f"queue full ({self.max_queue}); request "
                f"{request.id} rejected")
        self._meta[request.id] = {"t": self._clock()}
        self._queue.append(request)
        self._stats["submitted"] += 1
        obs.emit_event("request_submit", plane="serving",
                       engine=self._obs_name, request=request.id,
                       prompt_len=n, priority=request.priority,
                       tp=self.tp, role=self.role,
                       **self._trace_fields(request))
        return request.id

    # one journey-context builder fleet-wide — tenant/trace stamps on
    # vision lifecycle events must render exactly like the LM plane's
    _trace_fields = staticmethod(InferenceEngine._trace_fields)

    def _expire_queued(self, now: float) -> None:
        keep: deque = deque()
        for r in self._queue:
            t0 = self._meta[r.id]["t"]
            ttl = min(
                t0 + r.deadline_s if r.deadline_s is not None
                else float("inf"),
                t0 + r.max_queue_wait_s
                if r.max_queue_wait_s is not None else float("inf"))
            if now >= ttl:
                self._terminal(r, "expired", "expired")
            else:
                keep.append(r)
        self._queue = keep

    def _pop_next(self) -> Request:
        best_i, best_p = 0, None
        for i, r in enumerate(self._queue):
            if best_p is None or r.priority > best_p:
                best_i, best_p = i, r.priority
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def steal_queued(self, k: int) -> List[Tuple[Request, float]]:
        """Router-rebalance donor side: lowest priority, youngest
        within — the inverse of _pop_next (the LM engine's contract)."""
        out: List[Tuple[Request, float]] = []
        for _ in range(min(k, len(self._queue))):
            best_i, best_p = 0, None
            for i, r in enumerate(self._queue):
                if best_p is None or r.priority <= best_p:
                    best_i, best_p = i, r.priority
            req = self._queue[best_i]
            del self._queue[best_i]
            meta = self._meta.pop(req.id, None)
            out.append((req, meta["t"] if meta else self._clock()))
        return out

    def _requeue(self, request: Request,
                 t: Optional[float] = None) -> None:
        self._meta[request.id] = {"t": self._clock() if t is None
                                  else t}
        self._queue.append(request)

    def _terminal(self, req: Request, reason: str, status: str,
                  tokens: Optional[List[int]] = None) -> None:
        t0 = self._meta.pop(req.id, {}).get("t")
        now = self._clock()
        latency = None if t0 is None else now - t0
        ttft = latency if (status == "done"
                           and latency is not None) else None
        res = GenerationResult(req.id, list(req.prompt),
                               tokens or [], reason, status,
                               ttft_s=ttft, latency_s=latency)
        self.completed[req.id] = res
        self._stats["expired" if status == "expired"
                    else "classified"] += 1
        if status == "done":
            self._stats["requests_done"] += 1
        if obs.enabled():
            self._m_requests.labels(engine=self._obs_name,
                                    status=status, tp="1").inc()
        obs.emit_event("request_terminal", plane="serving",
                       engine=self._obs_name, request=req.id,
                       status=status, reason=reason,
                       tokens=len(tokens or []),
                       ttft_s=ttft, latency_s=latency,
                       tp=self.tp, role=self.role,
                       **self._trace_fields(req))

    # ---------------------------------------------------------------- step
    def step(self) -> List[GenerationResult]:
        """Form one fixed-shape batch (priority order, at most
        `batch`), run the shared forward, settle every member with its
        argmax class as the single emitted token."""
        self._expire_queued(self._clock())
        ids_before = set(self.completed)
        if self._queue:
            taken: List[Request] = []
            while self._queue and len(taken) < self.batch:
                taken.append(self._pop_next())
            feats = np.zeros((self.batch, self.feature_len),
                             dtype=np.float32)
            for i, r in enumerate(taken):
                # host-side list -> host buffer, no device involved
                feats[i, :len(r.prompt)] = np.asarray(  # graftlint: disable=hidden-device-sync
                    r.prompt, dtype=np.float32)
            # THE one deliberate device-to-host read: the batch's argmax
            # classes, once per fixed-shape batch, never per request
            # graftlint: disable=hidden-device-sync
            classes = self._forward(
                torch.from_numpy(feats).to(self.device)).cpu().numpy()
            self._stats["forwards"] += 1
            for i, r in enumerate(taken):
                self._terminal(r, "classified", "done",
                               tokens=[int(classes[i])])
        return [self.completed[rid]
                for rid in sorted(set(self.completed) - ids_before)]

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[GenerationResult]:
        ids = [self.submit(r) for r in requests] if requests else None
        while self._queue:
            self.step()
        if ids is None:
            out = sorted(self.completed.values(), key=lambda r: r.id)
            self.completed = {}
            return out
        return [self.completed.pop(i) for i in ids]

    # --------------------------------------------------------------- admin
    def drain(self) -> None:
        self._draining = True

    def health(self) -> Dict[str, object]:
        state = "ok"
        if self._draining:
            state = "drained" if self.idle else "draining"
        return {
            "state": state,
            "model_tag": self.model_tag,
            "slots": self.batch,
            "slots_active": 0,
            "queue_depth": len(self._queue),
            "max_queue": self.max_queue,
            "feature_len": self.feature_len,
            "stats": self.stats,
        }
