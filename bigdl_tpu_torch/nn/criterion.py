"""Loss functions.

Ports bigdl_tpu/nn/criterion.py, all 21 of its classes (reference:
nn/ClassNLLCriterion.scala, nn/CrossEntropyCriterion.scala,
nn/MSECriterion.scala, nn/AbsCriterion.scala, nn/BCECriterion.scala,
nn/SmoothL1Criterion.scala, nn/MarginCriterion.scala,
nn/MultiLabelMarginCriterion.scala, nn/HingeEmbeddingCriterion.scala,
nn/CosineEmbeddingCriterion.scala, nn/DistKLDivCriterion.scala,
nn/KLDCriterion, nn/L1Cost.scala, nn/ClassSimplexCriterion.scala,
nn/ParallelCriterion.scala, nn/MultiCriterion.scala,
nn/TimeDistributedCriterion.scala, nn/MultiMarginCriterion.scala,
nn/MarginRankingCriterion.scala, nn/CosineProximityCriterion.scala),
with the JAX package's `size_average` semantics and encodings: class
targets are 0-based integers, and `MultiLabelMarginCriterion` takes an
(N, C) 0/1 indicator, not the reference's index list. Every criterion
is a scalar function of its input; its gradient is autograd's. The
hinges are `torch.maximum` against zero, which splits the gradient at
a tie as `jnp.maximum` does. A criterion over a pair or a list of
inputs takes a `utils/table` Table, a tuple or a list.
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Criterion


def _reduce(x: torch.Tensor, size_average: bool) -> torch.Tensor:
    return x.mean() if size_average else x.sum()


def _hinge(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with jnp.maximum's half-and-half gradient at 0."""
    return torch.maximum(x, x.new_zeros(()))


def _entries(table) -> list:
    """The entries of a Table (a dict, in insertion order), a tuple or
    a list."""
    return list(table.values()) if isinstance(table, dict) else list(table)


def _pair(table) -> tuple:
    """The first two entries of a Table (keys 1 and 2), a tuple or a
    list."""
    return (table[1], table[2]) if isinstance(table, dict) \
        else (table[0], table[1])


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (N, C) against
    (N,) int class ids; `weights` (C,) weight each class, and with
    `size_average` the weighted sum is divided by the picked weights'
    sum. `logProbAsInput=False` takes probabilities (clamped at 1e-8
    before the log)."""

    def __init__(self, weights=None, size_average: bool = True,
                 logProbAsInput: bool = True):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average
        self.log_prob_as_input = logProbAsInput

    def forward(self, input, target):
        logp = input if self.log_prob_as_input \
            else torch.log(input.clamp_min(1e-8))
        target = target.long()
        picked = logp.gather(1, target[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=logp.device, dtype=logp.dtype)[target]
            loss = -(w * picked)
            return loss.sum() / w.sum() if self.size_average \
                else loss.sum()
        return _reduce(-picked, self.size_average)


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused: (N, C) logits, (N,) int ids."""

    def __init__(self, weights=None, size_average: bool = True):
        self.weights = weights
        self.size_average = size_average

    def forward(self, input, target):
        return ClassNLLCriterion(self.weights, self.size_average).forward(
            torch.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):
    """Mean (or, without `size_average`, summed) squared error."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - target) ** 2, self.size_average)


class AbsCriterion(Criterion):
    """Mean (or summed) absolute error."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(torch.abs(input - target), self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy over probabilities, clipped to [1e-12,
    1 - 1e-12]; `weights` multiply the elementwise loss."""

    def __init__(self, weights=None, size_average: bool = True):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average

    def forward(self, input, target):
        eps = 1e-12
        p = input.clamp(eps, 1.0 - eps)
        loss = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        if self.weights is not None:
            loss = loss * self.weights.to(device=loss.device,
                                          dtype=loss.dtype)
        return _reduce(loss, self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber loss with threshold 1."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        d = torch.abs(input - target)
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class MarginCriterion(Criterion):
    """Hinge loss, targets in {1, -1}; `squared` squares the hinge."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def forward(self, input, target):
        h = _hinge(self.margin - input * target)
        if self.squared:
            h = h * h
        return _reduce(h, self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """Multi-label margin over an (N, C) 0/1 indicator target: per
    sample the sum over (positive i, negative j) pairs of
    max(0, 1 - (x_i - x_j)), over C. The JAX package masks the pairs
    with +-inf; here they are multiplied by the pair mask, the same
    function without an inf that could reach the gradient."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        pos = (target > 0.5).to(input.dtype)
        pair = _hinge(1.0 - (input[..., :, None] - input[..., None, :]))
        mask = pos[..., :, None] * (1.0 - pos)[..., None, :]
        per_sample = (pair * mask).sum(dim=(-1, -2)) / input.shape[-1]
        return _reduce(per_sample, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """x where the target is positive, max(0, margin - x) elsewhere."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        loss = torch.where(target > 0, input, _hinge(self.margin - input))
        return _reduce(loss, self.size_average)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


class CosineEmbeddingCriterion(Criterion):
    """Over a pair (a, b): 1 - cos where the target is positive,
    max(0, cos - margin) elsewhere."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        a, b = _pair(input)
        cos = (a * b).sum(-1) / (_norm(a) * _norm(b)).clamp_min(1e-12)
        loss = torch.where(target > 0, 1.0 - cos, _hinge(cos - self.margin))
        return _reduce(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input) with log-probability input; averaged over
    the batch (the first axis) with `size_average`."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        loss = torch.where(
            target > 0,
            target * (torch.log(target.clamp_min(1e-12)) - input),
            input.new_zeros(()))
        return loss.sum() / input.shape[0] if self.size_average \
            else loss.sum()


class KLDCriterion(Criterion):
    """A VAE latent's KL to N(0, I) over a pair (mean, log_var), the
    batch mean; the target is ignored."""

    def forward(self, input, target=None):
        mean, log_var = _pair(input)
        kl = 0.5 * (mean ** 2 + torch.exp(log_var) - log_var - 1.0).sum(-1)
        return kl.mean()


class L1Cost(Criterion):
    """The input's summed absolute value; the target is ignored."""

    def forward(self, input, target=None):
        return torch.abs(input).sum()


class ClassSimplexCriterion(Criterion):
    """MSE against the class's vertex of a regular simplex. The simplex
    is the JAX package's numpy construction (its scalar is float64, so
    numpy computes the matrix in float64), rounded to fp32 as
    `jnp.asarray` rounds it: bit for bit the JAX package's."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n):
        a = (1.0 - np.sqrt(1.0 + n)) / n
        mat = np.eye(n, dtype=np.float32) + a / np.sqrt(n) * np.ones(
            (n, n), np.float32)
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        return torch.from_numpy(mat.astype(np.float32))

    def forward(self, input, target):
        t = self.simplex.to(device=input.device, dtype=input.dtype)[
            target.long()]
        return ((input - t) ** 2).mean()


class ParallelCriterion(Criterion):
    """Weighted sum of criterions, the i-th applied to the i-th input
    and target of a table (with `repeat_target`, every criterion sees
    the one target)."""

    def __init__(self, repeat_target: bool = False):
        self.criterions = []
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "ParallelCriterion":
        self._record_mutation("add", criterion, weight)
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        ins = _entries(input)
        tgts = [target] * len(ins) if self.repeat_target \
            else _entries(target)
        total = 0.0
        for crit, w, i, t in zip(self.criterions, self.weights, ins, tgts):
            total = total + w * crit.forward(i, t)
        return total


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target)."""

    def __init__(self):
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "MultiCriterion":
        self._record_mutation("add", criterion, weight)
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        total = 0.0
        for crit, w in zip(self.criterions, self.weights):
            total = total + w * crit.forward(input, target)
        return total


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input: the
    reference's sum over t of the inner loss, divided by T when
    `size_average` — with an inner criterion that averages over N * T
    rows the result is corrected to match."""

    def __init__(self, criterion: Criterion, size_average: bool = False,
                 dimension: int = 2):
        self.criterion = criterion
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        n, t = input.shape[0], input.shape[1]
        loss = self.criterion.forward(
            input.reshape((n * t,) + tuple(input.shape[2:])),
            target.reshape((n * t,) + tuple(target.shape[2:])))
        inner_avg = getattr(self.criterion, "size_average", True)
        if inner_avg and not self.size_average:
            loss = loss * t
        elif not inner_avg and self.size_average:
            loss = loss / t
        return loss


class MultiMarginCriterion(Criterion):
    """Multi-class margin loss over (N, C) input and (N,) class ids:
    per sample the sum over the other classes of
    max(0, margin - x_target + x_j) (squared with p = 2), over C."""

    def __init__(self, p: int = 1, margin: float = 1.0,
                 size_average: bool = True):
        if p not in (1, 2):
            raise ValueError("p must be 1 or 2")
        self.p = p
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        c = input.shape[1]
        idx = target.long()
        h = _hinge(self.margin - input.gather(1, idx[:, None]) + input)
        if self.p == 2:
            h = h * h
        mask = torch.nn.functional.one_hot(idx, c).to(input.dtype)
        per_sample = (h * (1.0 - mask)).sum(1) / c
        return _reduce(per_sample, self.size_average)


class MarginRankingCriterion(Criterion):
    """Over a pair (x1, x2) and a +-1 target y:
    max(0, -y (x1 - x2) + margin)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = _pair(input)
        y = target[1] if isinstance(target, dict) else \
            target[0] if isinstance(target, (tuple, list)) else target
        return _reduce(_hinge(-y * (x1 - x2) + self.margin),
                       self.size_average)


class CosineProximityCriterion(Criterion):
    """The negative mean cosine proximity of input and target rows."""

    def forward(self, input, target):
        xn = input / _norm(input, keepdim=True).clamp_min(1e-12)
        tn = target / _norm(target, keepdim=True).clamp_min(1e-12)
        return -(xn * tn).sum(-1).mean()


class ChunkedSoftmaxCE(Criterion):
    """Large-vocabulary softmax cross-entropy with model fusion.

    - As a plain criterion, `forward(log_probs, targets)` is the mean
      token NLL over (N, C) or (B, S, V) log-prob input.
    - As the Optimizer's criterion for a model exposing
      `apply_hidden(variables, x, training, rng)` and
      `head(variables)` (models.transformer.TransformerLM), training
      fuses through `fused_loss`: the loss comes from hidden states in
      sequence chunks (ops/losses.softmax_cross_entropy_chunked) and the
      (B, S, V) tensor is never held, forward or backward.
    """

    def __init__(self, chunk: int = 256):
        self.chunk = chunk

    def forward(self, input: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
        picked = input.gather(-1, target.long()[..., None])[..., 0]
        return -picked.mean()

    def fused_loss(self, model):
        """Model-fusion hook (ops/losses.build_train_loss): returns
        `fn(variables, x, targets, rng) -> (loss, new_state)` in
        training mode, or None when `model` has no hidden/head surface
        (the optimizer then takes apply + forward)."""
        if not (hasattr(model, "apply_hidden") and hasattr(model, "head")):
            return None
        from bigdl_tpu_torch.ops.losses import softmax_cross_entropy_chunked

        chunk = self.chunk

        def fn(variables, x, targets, rng):
            if variables.get("state"):
                # apply_hidden has no state-output channel, so fusion
                # would silently freeze running statistics — refuse
                raise ValueError(
                    f"ChunkedSoftmaxCE cannot fuse with {model!r}: the "
                    "model carries non-empty state, which the fused "
                    "path would not update; use a stateless LM or the "
                    "plain LogSoftMax+criterion path")
            if hasattr(model, "loss"):
                loss = model.loss(variables, x, targets, training=True,
                                  rng=rng, chunk=chunk)
            else:
                hidden = model.apply_hidden(variables, x, training=True,
                                            rng=rng)
                loss = softmax_cross_entropy_chunked(
                    hidden, model.head(variables), targets, chunk=chunk)
            return loss, variables["state"]

        return fn

    def __repr__(self):
        return f"ChunkedSoftmaxCE(chunk={self.chunk})"
