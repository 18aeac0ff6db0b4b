"""Validation methods and results.

Ports bigdl_tpu/optim/validation.py (reference:
optim/ValidationMethod.scala — `Top1Accuracy`, `Top5Accuracy`, `Loss`,
`TreeNNAccuracy`, `HitRatio`, `NDCG`, `MAE`; optim/ValidationResult.scala
— results merge with `+`). Each method's core is
`stats(output, target, real_size) -> (sum, count)` as 0-dim tensors on
the output's device; results merge associatively, so per-batch results
reduce as the reference's RDD `reduce(_ + _)` does. Ties rank as in
JAX: `argmax` takes the first maximum and the top-k methods sort
stably.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class ValidationResult:
    """Additive (value-sum, count) pair (reference:
    optim/ValidationResult.scala)."""

    def __init__(self, total: float, count: float, fmt: str = "Accuracy"):
        self.total = float(total)
        self.count = float(count)
        self.fmt = fmt

    def result(self) -> Tuple[float, int]:
        return (self.total / max(self.count, 1.0), int(self.count))

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.total + other.total,
                                self.count + other.count, self.fmt)

    def __repr__(self):
        v, n = self.result()
        return f"{self.fmt}: {v:.6f} (count {n})"


class ValidationMethod:
    name = "ValidationMethod"

    def stats(self, output, target, real_size: Optional[int] = None):
        """(metric_sum, count) as 0-dim tensors. `real_size` masks the
        padded tail rows of a final partial batch."""
        raise NotImplementedError

    def apply(self, output, target, real_size: Optional[int] = None
              ) -> ValidationResult:
        s, c = self.stats(output, target, real_size)
        return ValidationResult(float(s), float(c), self.name)

    def __repr__(self):
        return self.name


def reduce_stats(methods: Sequence[ValidationMethod], stats
                 ) -> Dict[str, ValidationResult]:
    """Each method's ValidationResult from per-batch rows of (sum, count)
    tensors, added in batch order on the host — the tensors are read
    once, at the end, not after every batch."""
    results = [ValidationResult(0.0, 0.0, m.name) for m in methods]
    for row in stats:
        for i, (s, c) in enumerate(row):
            results[i] = results[i] + ValidationResult(float(s), float(c))
    return {m.name: r for m, r in zip(methods, results)}


def _row_mask(n_rows: int, real_size, device) -> torch.Tensor:
    """real_size: None (no padding), an int prefix length, or an explicit
    per-row 0/1 mask (padded rows that are not a prefix)."""
    if real_size is None:
        return torch.ones(n_rows, device=device)
    if isinstance(real_size, (int, np.integer)):
        return (torch.arange(n_rows, device=device) < real_size).float()
    return torch.as_tensor(real_size, dtype=torch.float32, device=device)


def _masked(values: torch.Tensor, real_size):
    mask = _row_mask(values.shape[0], real_size, values.device)
    return torch.sum(values.float() * mask), torch.sum(mask)


def _top(output: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ascending (a stable argsort's
    last k, as jnp.argsort gives)."""
    return torch.argsort(output, dim=-1, stable=True)[..., -k:]


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def stats(self, output, target, real_size=None):
        pred = torch.argmax(output, dim=-1)
        return _masked(pred == target.to(pred.dtype), real_size)


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def stats(self, output, target, real_size=None):
        top5 = _top(output, 5)
        hit = torch.any(top5 == target[..., None].to(top5.dtype), dim=-1)
        return _masked(hit, real_size)


class Loss(ValidationMethod):
    """Criterion value as a validation metric (reference:
    ValidationMethod.Loss)."""

    name = "Loss"

    def __init__(self, criterion):
        self.criterion = criterion

    def stats(self, output, target, real_size=None):
        n = output.shape[0]
        dev = output.device
        if real_size is None:
            return (self.criterion(output, target) * n,
                    torch.tensor(float(n), device=dev))
        if isinstance(real_size, (int, np.integer)):
            if real_size != n:
                output, target = output[:real_size], target[:real_size]
            return (self.criterion(output, target) * real_size,
                    torch.tensor(float(real_size), device=dev))
        # A mask: padded rows repeat the last real row (MiniBatch.
        # from_samples' `pad_to` does), so the batch mean decomposes
        # exactly: sum_real = n * mean_all - (n - real) * loss(last row).
        # Holds for any criterion whose batch value is the per-row mean.
        cnt = torch.sum(torch.as_tensor(real_size, dtype=torch.float32,
                                        device=dev))
        mean_all = self.criterion(output, target)

        def take_last(x):
            return tuple(e[-1:] for e in x) if isinstance(x, tuple) \
                else x[-1:]

        l_last = self.criterion(take_last(output), take_last(target))
        return n * mean_all - (n - cnt) * l_last, cnt


class TreeNNAccuracy(ValidationMethod):
    """Accuracy on the root prediction of tree outputs (reference:
    optim/ValidationMethod.scala#TreeNNAccuracy). Output (N, T, C):
    scores per node, the root is node 0."""

    name = "TreeNNAccuracy"

    def stats(self, output, target, real_size=None):
        root_out = output[:, 0, :] if output.ndim == 3 else output
        root_tgt = target[:, 0] if target.ndim == 2 else target
        pred = torch.argmax(root_out, dim=-1)
        return _masked(pred == root_tgt.to(pred.dtype), real_size)


class HitRatio(ValidationMethod):
    """HR@k for recommendation (reference:
    optim/ValidationMethod.scala#HitRatio). output: (N, C) scores;
    target: (N,) index of the positive item."""

    name = "HitRatio"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.name = f"HitRatio@{k}"

    def stats(self, output, target, real_size=None):
        topk = _top(output, self.k)
        hit = torch.any(topk == target[..., None].to(topk.dtype), dim=-1)
        return _masked(hit, real_size)


class NDCG(ValidationMethod):
    """NDCG@k with a single positive item (reference:
    ValidationMethod.scala#NDCG)."""

    name = "NDCG"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.name = f"NDCG@{k}"

    def stats(self, output, target, real_size=None):
        order = torch.flip(torch.argsort(output, dim=-1, stable=True),
                           (-1,))[..., :self.k]
        pos = order == target[..., None].to(order.dtype)
        ranks = torch.argmax(pos.to(torch.int32), dim=-1)  # first hit
        gain = torch.where(torch.any(pos, dim=-1),
                           1.0 / torch.log2(ranks.float() + 2.0),
                           torch.zeros((), device=output.device))
        return _masked(gain, real_size)


class MAE(ValidationMethod):
    """Mean absolute error for regression outputs (reference:
    optim/ValidationMethod.scala#MAE)."""

    name = "MAE"

    def stats(self, output, target, real_size=None):
        n = output.shape[0]
        err = torch.mean(torch.abs(output - target.reshape(output.shape)),
                         dim=tuple(range(1, output.ndim)))
        if real_size is None:
            return torch.sum(err), torch.tensor(float(n),
                                                device=output.device)
        if isinstance(real_size, (int, np.integer)):
            return (torch.sum(err[:real_size]),
                    torch.tensor(float(real_size), device=output.device))
        return _masked(err, real_size)
