"""Loss functions.

Ports `ClassNLLCriterion`, `CrossEntropyCriterion`, `MSECriterion`,
`TimeDistributedCriterion` and `ChunkedSoftmaxCE` from
bigdl_tpu/nn/criterion.py (reference: nn/ClassNLLCriterion.scala,
nn/CrossEntropyCriterion.scala, nn/MSECriterion.scala,
nn/TimeDistributedCriterion.scala), with
the JAX package's `size_average` semantics. Class targets are 0-based
integers, as in the JAX package. The file's other criteria come with
the slices that use them (ROADMAP.md queue A.5).
"""

from __future__ import annotations


import torch

from bigdl_tpu_torch.nn.module import Criterion


def _reduce(x: torch.Tensor, size_average: bool) -> torch.Tensor:
    return x.mean() if size_average else x.sum()


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
