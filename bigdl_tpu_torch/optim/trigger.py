"""Triggers — when to stop / validate / checkpoint.

A copy of bigdl_tpu/optim/trigger.py (pure Python). Reference parity:
optim/Trigger.scala — `everyEpoch`, `severalIteration`, `maxEpoch`,
`maxIteration`, `minLoss`, `maxScore`, `and`, `or`.

A trigger is called with the training state dict (`epoch` 1-based,
`neval` 0-based completed iterations, `loss`, `score`) and returns
bool. `every_epoch` is stateful (fires on epoch transition), like the
reference's `everyEpoch` cached epoch. `loss` may be a 0-d tensor on
the device; `min_loss` compares it (a host sync).
"""

from __future__ import annotations

from typing import Callable, Dict


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool]):
        self._fn = fn

    def __call__(self, state: Dict) -> bool:
        return self._fn(state)

    # ------------------------------------------------------------ factories
    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s["epoch"] > n)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s["neval"] >= n)

    @staticmethod
    def every_epoch() -> "Trigger":
        holder = {"last": 1}

        def fn(s):
            if s["epoch"] > holder["last"]:
                holder["last"] = s["epoch"]
                return True
            return False

        return Trigger(fn)

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s["neval"] > 0 and s["neval"] % n == 0)

    @staticmethod
    def min_loss(v: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss") is not None and s["loss"] < v)

    @staticmethod
    def max_score(v: float) -> "Trigger":
        return Trigger(lambda s: s.get("score") is not None and s["score"] > v)

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers))
