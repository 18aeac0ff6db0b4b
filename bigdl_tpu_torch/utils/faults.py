"""Deterministic fault injection for the training loop and the serving
engine.

A copy of bigdl_tpu/utils/faults.py (pure Python and numpy). The
recovery code — Checkpoint's atomic publish and newest-valid fallback
(serialization/checkpoint.py), resume's stream fast-forward and the
anomaly guard (utils/anomaly.py, optim/optimizer.py) — is a tested
contract: this registry injects the failures on demand, by step
number, so every drill is reproducible bit for bit.

Plan syntax (env `BIGDL_FAULTS` or `FaultPlan("...")`):

    kind@step[xN][,kind@step...]     e.g. "nan@4,step@7,ckpt_corrupt@6x2"

Each entry fires at most N times (default 1) when its fault point is
consulted with that step number. One-shot by default on purpose: the
recovery path replays the failed step (reload the latest checkpoint,
fast-forward the deterministic batch stream), so a fault that re-fired
on the replayed step would spin the retry budget down instead of
proving recovery.

Fault kinds and where the port consults them:

    step          raise before dispatching train step `step`
                  (LocalOptimizer.run)
    nan           poison the batch for step `step` with NaNs — loss and
                  gradients go NaN through the real math, exercising the
                  anomaly guard end to end
    data          raise from the training batch iterator at global
                  stream position `step` (optimizer._batch_iterator)
    ckpt_torn     abort Checkpoint.save(step) after the staging dir is
                  partially written, before publish; latest() must never
                  surface the leftovers
    ckpt_corrupt  complete Checkpoint.save(step) normally, then truncate
                  the published model.npz — load() must fall back to the
                  newest valid checkpoint
    preempt       simulated worker kill: raise Preempted before
                  dispatching train step `step`; recovery is a fresh
                  process with `resume_from_checkpoint()`
    ckpt_async_torn
                  kill the writer mid-way through a sharded save; parsed
                  here, consulted by no port code until sharded
                  checkpoints are ported (ROADMAP.md, queue A.8)

Serving kinds, consulted by `InferenceEngine.step`
(serving/engine.py) with the engine's decode-step number, as the JAX
engine consults them:

    serve_nan     force the lowest active slot's logits to NaN: the
                  request is evicted 'poisoned', its co-batch untouched
    serve_err     raise before the decode dispatch: retried within
                  `step_retries`, else the engine degrades
    serve_slow    sleep (step_timeout_s or 0.05) * 5 s inside the
                  watched region: trips an armed step watchdog

The plan is process-global (`get_plan()`/`set_plan()`); `get_plan()`
lazily builds one from `BIGDL_FAULTS`, so a subprocess inherits
injection through the environment. The JAX package also records each
shot as a structured event; the port logs it (the event log waits for
`obs/`, queue A.9).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.faults")

ENV_VAR = "BIGDL_FAULTS"

KINDS = ("step", "nan", "data", "ckpt_torn", "ckpt_corrupt",
         "preempt", "ckpt_async_torn",
         "serve_nan", "serve_err", "serve_slow")


class FaultInjected(RuntimeError):
    """Raised by an injected failure (never by real code paths)."""


class Preempted(FaultInjected):
    """An injected worker preemption (`preempt@step`): the modeled
    worker is gone, and recovery is a fresh process with
    `resume_from_checkpoint()`."""


class FaultPlan:
    """Parsed injection plan; `fires(kind, step)` consumes one shot."""

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self._budget: Dict[Tuple[str, int], int] = {}
        self.fired: List[Tuple[str, int]] = []
        for entry in filter(None, (e.strip() for e in self.spec.split(","))):
            m = re.fullmatch(r"([a-z_]+)@(\d+)(?:x(\d+))?", entry)
            if not m:
                raise ValueError(
                    f"bad fault entry {entry!r}: expected 'kind@step[xN]'")
            kind, step, times = m.group(1), int(m.group(2)), \
                int(m.group(3) or 1)
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}: expected one of {KINDS}")
            key = (kind, step)
            self._budget[key] = self._budget.get(key, 0) + times

    def __bool__(self):
        return bool(self._budget)

    def fires(self, kind: str, step: int) -> bool:
        """True (and consumes one shot) if `kind` is armed for `step`."""
        key = (kind, int(step))
        left = self._budget.get(key, 0)
        if left <= 0:
            return False
        self._budget[key] = left - 1
        self.fired.append(key)
        logger.warning("fault injected: %s@%d", kind, step)
        return True

    def maybe_raise(self, kind: str, step: int) -> None:
        if self.fires(kind, step):
            raise FaultInjected(f"injected fault {kind}@{int(step)}")

    def maybe_preempt(self, step: int) -> None:
        """Consulted by the training loop before the step: a preemption
        is a dead worker, not a transient step failure."""
        if self.fires("preempt", step):
            raise Preempted(
                f"injected fault preempt@{int(step)}: "
                f"worker killed before step dispatch")


_plan: Optional[FaultPlan] = None


def get_plan() -> FaultPlan:
    """The active plan — from `set_plan`, else `BIGDL_FAULTS`, else empty."""
    global _plan
    if _plan is None:
        _plan = FaultPlan(os.environ.get(ENV_VAR, ""))
    return _plan


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install a plan programmatically (None → re-read the env lazily)."""
    global _plan
    _plan = plan


def poison_minibatch(mb):
    """A NaN-input copy of a MiniBatch: every float feature becomes NaN,
    so the step's loss and gradients go non-finite through the real
    math. Raises if the batch has no float feature (integer-token
    models): a 'nan' fault that cannot poison anything would otherwise
    log 'fault injected' and let a drill pass vacuously."""
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    poisoned = [0]

    def nan_like(x):
        if isinstance(x, tuple):
            return tuple(nan_like(e) for e in x)
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            poisoned[0] += 1
            return np.full_like(a, np.nan)
        return a

    out = MiniBatch(nan_like(mb.input), mb.target)
    if not poisoned[0]:
        raise ValueError(
            "nan fault: minibatch has no floating-point input to poison "
            "(integer-token model?) — inject 'step' or 'data' faults "
            "instead, or poison the loss path directly")
    if hasattr(mb, "real_size"):
        out.real_size = mb.real_size
    return out


def corrupt_file(path: str, mode: str = "truncate") -> None:
    """Damage an on-disk checkpoint artifact in place.

    `truncate`: keep the first half of the file (a torn write or partial
    flush); `garble`: overwrite the middle third with 0xFF (bit rot).
    Checkpoint verification detects both — truncation breaks the npz
    zip directory, garbling breaks the per-array checksums.
    """
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garble":
        with open(path, "r+b") as f:
            f.seek(size // 3)
            f.write(b"\xff" * max(size // 3, 1))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
