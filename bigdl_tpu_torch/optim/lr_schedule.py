"""Learning-rate schedules.

A copy of bigdl_tpu/optim/lr_schedule.py (pure Python; the port imports
nothing of the JAX package). Reference parity: optim/SGD.scala
#LearningRateSchedule — `Default`, `Step`, `MultiStep`, `Poly`,
`Exponential`, `Plateau`, `Warmup`, `NaturalExp`, `SequentialSchedule`,
`EpochDecay`, `EpochStep`.

Schedules run on the host each iteration and the rate enters the
update as a Python float. `rate(state)` gets a dict with `neval`
(0-based iteration), `epoch` (1-based), and optionally
`score`/`loss`, and returns the positive LR.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


class LearningRateSchedule:
    def __init__(self):
        self.base_lr: float = 0.0  # set by the OptimMethod that owns this

    def rate(self, state: Dict) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval * lr_decay) (reference: SGD.Default)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        super().__init__()
        self.decay = learning_rate_decay

    def rate(self, state):
        return self.base_lr / (1.0 + state["neval"] * self.decay)


class Step(LearningRateSchedule):
    """lr * gamma^(floor(neval / step_size)) (reference: SGD.Step)."""

    def __init__(self, step_size: int, gamma: float):
        super().__init__()
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, state):
        return self.base_lr * self.gamma ** (state["neval"] // self.step_size)


class MultiStep(LearningRateSchedule):
    """Decay by gamma at each listed iteration (reference: SGD.MultiStep)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        super().__init__()
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def rate(self, state):
        k = sum(1 for s in self.step_sizes if state["neval"] >= s)
        return self.base_lr * self.gamma ** k


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor((epoch-1)/step)) (reference: SGD.EpochStep)."""

    def __init__(self, step_size: int, gamma: float):
        super().__init__()
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, state):
        return self.base_lr * self.gamma ** ((state["epoch"] - 1) // self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch) (reference: SGD.EpochDecay)."""

    def __init__(self, decay_fn):
        super().__init__()
        self.decay_fn = decay_fn

    def rate(self, state):
        return self.base_lr * 0.1 ** self.decay_fn(state["epoch"])


class Poly(LearningRateSchedule):
    """lr * (1 - neval/max_iter)^power (reference: SGD.Poly)."""

    def __init__(self, power: float, max_iteration: int):
        super().__init__()
        self.power = power
        self.max_iteration = max_iteration

    def rate(self, state):
        frac = min(state["neval"] / self.max_iteration, 1.0)
        return self.base_lr * (1.0 - frac) ** self.power


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(neval/decay_step), optionally staircased
    (reference: SGD.Exponential)."""

    def __init__(self, decay_step: int, decay_rate: float, staircase: bool = False):
        super().__init__()
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.staircase = staircase

    def rate(self, state):
        e = state["neval"] / self.decay_step
        if self.staircase:
            e = math.floor(e)
        return self.base_lr * self.decay_rate ** e


class NaturalExp(LearningRateSchedule):
    def __init__(self, decay_step: int, gamma: float):
        super().__init__()
        self.decay_step = decay_step
        self.gamma = gamma

    def rate(self, state):
        return self.base_lr * math.exp(-self.gamma * (state["neval"] // self.decay_step))


class Warmup(LearningRateSchedule):
    """Linear ramp from 0 to base lr over `delta` iterations — combined via
    SequentialSchedule (reference: SGD.Warmup)."""

    def __init__(self, delta: float):
        super().__init__()
        self.delta = delta

    def rate(self, state):
        return min(self.base_lr, (state["neval"] + 1) * self.base_lr / max(self.delta, 1))


class Plateau(LearningRateSchedule):
    """Reduce LR when the monitored metric stops improving
    (reference: SGD.Plateau). Driven by `on_metric` from the validation
    loop — host state, never traced."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "max", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_left = 0
        self._scale = 1.0

    def on_metric(self, value: float) -> None:
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._best = value if self._best is None else self._best
            return
        improved = (self._best is None
                    or (self.mode == "max" and value > self._best + self.epsilon)
                    or (self.mode == "min" and value < self._best - self.epsilon))
        if improved:
            self._best = value
            self._wait = 0
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self._scale *= self.factor
                self._wait = 0
                self._cooldown_left = self.cooldown

    def rate(self, state):
        if "score" in state and state["score"] is not None:
            pass  # scores are fed through on_metric by the optimizer loop
        return max(self.base_lr * self._scale, self.min_lr)


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for `iterations` steps
    (reference: SGD.SequentialSchedule). Typical use: Warmup then Poly."""

    def __init__(self, iteration_per_schedule: Optional[List[int]] = None):
        super().__init__()
        self.schedules: List[LearningRateSchedule] = []
        self.lengths: List[int] = []

    def add(self, schedule: LearningRateSchedule, iterations: int) -> "SequentialSchedule":
        self.schedules.append(schedule)
        self.lengths.append(iterations)
        return self

    def rate(self, state):
        neval = state["neval"]
        offset = 0
        for sched, length in zip(self.schedules, self.lengths):
            if neval < offset + length or sched is self.schedules[-1]:
                sched.base_lr = self.base_lr
                sub = dict(state)
                sub["neval"] = neval - offset
                return sched.rate(sub)
            offset += length
        return self.base_lr
