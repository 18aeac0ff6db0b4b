"""Numeric-anomaly guard for the training loop, and the serving
engine's per-row finite check.

Ports bigdl_tpu/utils/anomaly.py. A NaN loss in the reference silently
poisons the weights and every later checkpoint; the guard is the
health-monitoring half of the fault-tolerance contract (checkpointing
is the other, serialization/checkpoint.py).

Split of responsibilities:

* The guarded step computes a health pair — the loss's finiteness and
  the global (pre-clip) gradient norm — with `global_norm` and
  `health_ok`: `ok = isfinite(loss) & isfinite(gnorm) & (gnorm <=
  max_gnorm)`, the spike threshold `max_gnorm` fed by the host each
  step. Where the JAX step selects old or new on the device
  (`jnp.where`, its `select_update`), the port's update is in place:
  the step reads `ok` on the host before it applies the update
  (optim/optimizer.py), so an anomalous step leaves params, slots and
  module state with the same bits. `select_update` therefore has no
  port.
* On the host, `AnomalyGuard.observe(ok, gnorm, step)` tracks the
  gradient-norm EMA (arming the spike threshold after
  `warmup_steps`), counts consecutive anomalies against
  `max_consecutive`, and returns the policy action:

      skip_step  "skipped"  — the update was not applied; the step
                              still consumes its batch, so the loop
                              advances past bad data
      rollback   "rollback" — the loop reloads the latest checkpoint
      halt       raises AnomalyError immediately

  Exhausting `max_consecutive` raises AnomalyError under every policy.
  Rollback also counts rollbacks triggered by the same step number and
  raises once that replay streak exceeds `max_consecutive` (the
  replayed steps in between are healthy, so the consecutive counter
  alone would let a NaN baked into the data rollback-loop forever).

The guard is opt-in (`Optimizer.set_anomaly_guard(...)`). Its cost is
two reductions and one device-to-host fetch a step — a micro-batch
under gradient accumulation. The JAX guard's registry counter and
structured events wait for the training plane's telemetry (ROADMAP.md,
queue A.9).
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Sequence

import torch

logger = logging.getLogger("bigdl_tpu_torch.optim")

POLICIES = ("skip_step", "rollback", "halt")


class AnomalyError(RuntimeError):
    """Numeric anomaly under policy 'halt', or anomaly budget exhausted."""


def health_ok(loss: torch.Tensor, gnorm: torch.Tensor,
              max_gnorm: float) -> torch.Tensor:
    """Health predicate (a 0-d bool tensor): finite loss, finite grad
    norm, norm under the host-fed spike threshold. NaN compares false,
    so `<=` alone rejects NaN norms; the explicit isfinite terms also
    reject inf when the threshold itself is inf (disabled)."""
    return (torch.isfinite(loss) & torch.isfinite(gnorm)
            & (gnorm <= max_gnorm))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, summed in fp32."""
    return torch.stack([torch.square(t.float()).sum()
                        for t in tensors]).sum().sqrt()


def rows_finite(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) → (B,) bool, True iff every element of the row is
    finite. The decode step returns it beside the sampled tokens, so a
    NaN/inf row evicts only its own request (serving/engine.py)."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


class AnomalyGuard:
    """Policy + budget + spike detector for per-step health pairs.

    policy          'skip_step' | 'rollback' | 'halt'
    max_consecutive raise AnomalyError after this many anomalies in a
                    row (the consecutive — not lifetime — budget)
    spike_factor    None disables spike detection (finiteness only);
                    else a step whose grad norm exceeds
                    `spike_factor * EMA(grad norm)` is anomalous
    ema_decay       EMA smoothing for the grad-norm baseline
    warmup_steps    healthy steps observed before the spike threshold
                    arms (early norms are noisy; never arms on NaN)
    """

    def __init__(self, policy: str = "skip_step", max_consecutive: int = 3,
                 spike_factor: Optional[float] = None,
                 ema_decay: float = 0.95, warmup_steps: int = 10):
        if policy not in POLICIES:
            raise ValueError(
                f"policy {policy!r}: expected one of {POLICIES}")
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        if spike_factor is not None and spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        self.policy = policy
        self.max_consecutive = max_consecutive
        self.spike_factor = spike_factor
        self.ema_decay = ema_decay
        self.warmup_steps = warmup_steps
        self._ema: Optional[float] = None
        self._healthy_seen = 0
        self.consecutive = 0
        self.anomalies = 0  # every anomaly observed, any policy
        self.skipped = 0    # updates discarded-and-moved-past (skip_step)
        self.rollbacks = 0
        self.last_anomaly_step: Optional[int] = None
        self._rollback_step: Optional[int] = None
        self._rollback_streak = 0

    # ------------------------------------------------------------- threshold
    def threshold(self) -> float:
        """Current max allowed grad norm (fed to the step). inf until
        spike detection is enabled and warmed up."""
        if (self.spike_factor is None or self._ema is None
                or self._healthy_seen < self.warmup_steps):
            return math.inf
        return self.spike_factor * self._ema

    # --------------------------------------------------------------- observe
    def observe(self, ok: bool, gnorm: float, step: int) -> str:
        """Record one step's health pair; returns 'ok', 'skipped' or
        'rollback', or raises AnomalyError (halt / budget exhausted)."""
        if ok:
            self.consecutive = 0
            self._healthy_seen += 1
            if math.isfinite(gnorm):
                self._ema = gnorm if self._ema is None else (
                    self.ema_decay * self._ema
                    + (1.0 - self.ema_decay) * gnorm)
            return "ok"

        self.consecutive += 1
        self.anomalies += 1
        self.last_anomaly_step = step
        detail = (f"step {step}: non-finite or spiking update "
                  f"(grad norm {gnorm:g}, threshold {self.threshold():g})")
        if self.policy == "halt":
            raise AnomalyError(detail)
        if self.consecutive > self.max_consecutive:
            raise AnomalyError(
                f"{detail} — {self.consecutive} consecutive anomalies "
                f"exceed max_consecutive={self.max_consecutive}")
        if self.policy == "rollback":
            if step == self._rollback_step:
                self._rollback_streak += 1
            else:
                self._rollback_step, self._rollback_streak = step, 1
            if self._rollback_streak > self.max_consecutive:
                raise AnomalyError(
                    f"{detail} — step {step} re-triggered rollback on "
                    f"{self._rollback_streak} consecutive replays "
                    f"(max_consecutive={self.max_consecutive}); the "
                    f"anomaly is deterministic, rolling back again "
                    f"cannot recover")
            self.rollbacks += 1
            logger.warning("anomaly guard: %s; rolling back to the "
                           "latest checkpoint (replay %d/%d for this "
                           "step)", detail, self._rollback_streak,
                           self.max_consecutive)
            return "rollback"
        self.skipped += 1
        logger.warning("anomaly guard: %s; update skipped "
                       "(%d/%d consecutive)", detail, self.consecutive,
                       self.max_consecutive)
        return "skipped"

    def stats(self) -> dict:
        return {"policy": self.policy, "anomalies": self.anomalies,
                "skipped": self.skipped, "rollbacks": self.rollbacks,
                "consecutive": self.consecutive,
                "last_anomaly_step": self.last_anomaly_step,
                "gnorm_ema": self._ema}
