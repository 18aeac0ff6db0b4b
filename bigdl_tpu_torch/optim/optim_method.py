"""Optimization methods: SGD and Adam.

Ports `OptimMethod`, `SGD` and `Adam` from bigdl_tpu/optim/optim_method.py
with BigDL's formulas (optim/SGD.scala, optim/Adam.scala): Adam's
`epsilon` sits outside `sqrt(v / bc2)` and the bias corrections use
`t = step + 1` — which is why this is not `torch.optim.Adam`, whose
formula differs. The other methods (Adagrad, Adamax, RMSprop,
AdaDelta, Ftrl, LBFGS) are queued (ROADMAP.md).

Where the JAX package maps a pure function over parameter pytrees,
the port updates flat lists of tensors IN PLACE with `torch._foreach_*`
under `torch.no_grad()` (one fused launch per list op instead of one
per leaf, and no second copy of the weights):

    slots = method.init_slots(params)          # params: list of tensors
    method.update(grads, params, slots, lr, step)   # params, slots mutated

`update` returns (params, slots) — the same lists — so call sites read
like the JAX package's. `lr` and `step` are host numbers from the
schedule (lr_schedule.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch.optim.lr_schedule import Default, LearningRateSchedule

Tensors = List[torch.Tensor]


class OptimMethod:
    """Base optimizer (reference: optim/OptimMethod.scala)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_schedule: Optional[LearningRateSchedule] = None,
                 weightdecay: float = 0.0):
        self.learningrate = learningrate
        self.schedule = learningrate_schedule or Default()
        self.schedule.base_lr = learningrate
        self.weightdecay = weightdecay

    def current_rate(self, state: Dict) -> float:
        """Host-side schedule evaluation (reference:
        updateHyperParameter)."""
        self.schedule.base_lr = self.learningrate
        return float(self.schedule.rate(state))

    def init_slots(self, params: Sequence[torch.Tensor]
                   ) -> Dict[str, Tensors]:
        return {}

    def update(self, grads: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], slots: Dict[str, Tensors],
               lr: float, step: int):
        raise NotImplementedError

    def _decay(self, grads, params) -> Tensors:
        """grads + weightdecay * params (new tensors; grads untouched)."""
        if self.weightdecay:
            return torch._foreach_add(list(grads), list(params),
                                      alpha=self.weightdecay)
        return list(grads)


def _zeros(params: Sequence[torch.Tensor]) -> Tensors:
    return [torch.zeros_like(p) for p in params]


class SGD(OptimMethod):
    """SGD with momentum/dampening/nesterov (reference: optim/SGD.scala)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0,
                 weightdecay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learningrate_schedule: Optional[LearningRateSchedule] = None):
        sched = learningrate_schedule or Default(learningrate_decay)
        super().__init__(learningrate, sched, weightdecay)
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and dampening = 0")

    def init_slots(self, params):
        return {"velocity": _zeros(params)} if self.momentum else {}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params = list(params)
        grads = self._decay(grads, params)
        if self.momentum:
            mu, damp = self.momentum, self.dampening
            vel = slots["velocity"]
            torch._foreach_mul_(vel, mu)
            torch._foreach_add_(vel, grads, alpha=1 - damp)
            eff = torch._foreach_add(grads, vel, alpha=mu) \
                if self.nesterov else vel
            torch._foreach_sub_(params, torch._foreach_mul(eff, lr))
            return params, slots
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
        return params, slots


class Adam(OptimMethod):
    """Adam (reference: optim/Adam.scala):
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr * (m / bc1) / (sqrt(v / bc2) + eps), bc = 1 - b^(step+1)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
                 weightdecay: float = 0.0,
                 learningrate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learningrate,
                         learningrate_schedule or Default(learningrate_decay),
                         weightdecay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params = list(params)
        grads = self._decay(grads, params)
        t = step + 1
        b1, b2 = self.beta1, self.beta2
        m, v = slots["m"], slots["v"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(params, upd)
        return params, slots
