"""Optimization methods: SGD, Adam, Adagrad, Adamax, RMSprop, AdaDelta
and Ftrl.

Ports bigdl_tpu/optim/optim_method.py with BigDL's formulas
(optim/SGD.scala, Adam.scala, Adagrad.scala, Adamax.scala,
RMSprop.scala, Adadelta.scala, Ftrl.scala): Adam's `epsilon` sits
outside `sqrt(v / bc2)` and the bias corrections use `t = step + 1` —
which is why these are not `torch.optim`'s, whose formulas differ.
LBFGS, whose contract is a closure and not a gradient, is
optim/lbfgs.py.

Where the JAX package maps a pure function over parameter pytrees,
the port updates flat lists of tensors IN PLACE with `torch._foreach_*`
under `torch.no_grad()` (one fused launch per list op instead of one
per leaf, and no second copy of the weights):

    slots = method.init_slots(params)          # params: list of tensors
    method.update(grads, params, slots, lr, step)   # params, slots mutated

`update` returns (params, slots) — the same lists — so call sites read
like the JAX package's. `lr` and `step` are host numbers from the
schedule (lr_schedule.py). The slot names are the JAX package's, so a
checkpoint of either package's slots loads in the other
(serialization/checkpoint.py).
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


class Adagrad(OptimMethod):
    """Adagrad (reference: optim/Adagrad.scala):
    a += g^2, p -= lr * g / (sqrt(a) + 1e-10)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0,
                 weightdecay: float = 0.0):
        super().__init__(learningrate, Default(learningrate_decay),
                         weightdecay)

    def init_slots(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params = list(params)
        grads = self._decay(grads, params)
        accum = slots["accum"]
        torch._foreach_addcmul_(accum, grads, grads)
        denom = torch._foreach_sqrt(accum)
        torch._foreach_add_(denom, 1e-10)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(params, upd)
        return params, slots


class Adamax(OptimMethod):
    """Adamax (reference: optim/Adamax.scala):
    m = b1 m + (1 - b1) g, u = max(b2 u, |g| + eps),
    p -= (lr / (1 - b1^(step+1))) * m / u."""

    def __init__(self, learningrate: float = 2e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-38):
        super().__init__(learningrate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params = list(params)
        b1 = self.beta1
        m, u = slots["m"], slots["u"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, list(grads), alpha=1 - b1)
        torch._foreach_mul_(u, self.beta2)
        absg = torch._foreach_abs(list(grads))
        torch._foreach_add_(absg, self.epsilon)
        torch._foreach_maximum_(u, absg)
        upd = torch._foreach_div(m, u)
        torch._foreach_mul_(upd, lr / (1 - b1 ** (step + 1)))
        torch._foreach_sub_(params, upd)
        return params, slots


class RMSprop(OptimMethod):
    """RMSprop (reference: optim/RMSprop.scala):
    s = dr s + (1 - dr) g^2, p -= lr * g / (sqrt(s) + eps)."""

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0,
                 decayrate: float = 0.99, epsilon: float = 1e-8):
        super().__init__(learningrate, Default(learningrate_decay))
        self.decayrate = decayrate
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"ms": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params, grads = list(params), list(grads)
        dr = self.decayrate
        ms = slots["ms"]
        torch._foreach_mul_(ms, dr)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - dr)
        denom = torch._foreach_sqrt(ms)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(params, upd)
        return params, slots


class AdaDelta(OptimMethod):
    """AdaDelta (reference: optim/Adadelta.scala):
    a = rho a + (1 - rho) g^2, d = sqrt(au + eps) / sqrt(a + eps) * g,
    au = rho au + (1 - rho) d^2, p -= lr * d (learning rate 1)."""

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-6):
        super().__init__(learningrate=1.0)
        self.rho = decayrate
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"accum": _zeros(params), "accum_update": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params, grads = list(params), list(grads)
        rho, eps = self.rho, self.epsilon
        accum, accum_update = slots["accum"], slots["accum_update"]
        torch._foreach_mul_(accum, rho)
        torch._foreach_addcmul_(accum, grads, grads, value=1 - rho)
        delta = torch._foreach_add(accum_update, eps)
        torch._foreach_sqrt_(delta)
        denom = torch._foreach_add(accum, eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(delta, denom)
        torch._foreach_mul_(delta, grads)
        torch._foreach_mul_(accum_update, rho)
        torch._foreach_addcmul_(accum_update, delta, delta, value=1 - rho)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(params, delta)
        return params, slots


class Ftrl(OptimMethod):
    """FTRL-proximal (reference: optim/Ftrl.scala): with n = a + g^2,
    sigma = (n^-lp - a^-lp) / lr, l += g - sigma p,
    p = (clip(l, -l1, l1) - l) / (n^-lp / lr + 2 l2), a = n."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__(learningrate)
        self.lr_power = learningrate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def init_slots(self, params):
        return {"accum": [torch.full_like(p, self.init_accum)
                          for p in params],
                "linear": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        params, grads = list(params), list(grads)
        lp = self.lr_power
        accum, linear = slots["accum"], slots["linear"]
        old_pow = torch._foreach_pow(accum, -lp)
        torch._foreach_addcmul_(accum, grads, grads)
        new_pow = torch._foreach_pow(accum, -lp)
        sigma = torch._foreach_sub(new_pow, old_pow)
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(linear, grads)
        torch._foreach_sub_(linear, torch._foreach_mul(sigma, params))
        quad = torch._foreach_div(new_pow, lr)
        torch._foreach_add_(quad, 2 * self.l2)
        pre = torch._foreach_clamp_min(linear, -self.l1)
        torch._foreach_clamp_max_(pre, self.l1)
        torch._foreach_sub_(pre, linear)
        torch._foreach_div_(pre, quad)
        torch._foreach_copy_(params, pre)
        return params, slots
