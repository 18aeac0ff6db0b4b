"""Fused large-vocabulary loss and the training-loss construction point.

Ports bigdl_tpu/ops/losses.py. `softmax_cross_entropy_chunked` computes
the mean token NLL straight from hidden states and the head matrix,
chunk by chunk along the sequence: each chunk holds only (B, chunk, V)
logits (fp32, as `(h @ head)` cast up) and is recomputed in the
backward (`torch.utils.checkpoint`, the counterpart of
`jax.checkpoint`), so the (B, S, V) log-prob tensor is never held.
The chunks are summed in order, as the JAX package's `lax.scan` does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def build_train_loss(model, criterion, precision=None) -> Callable:
    """The one training-loss construction point of the optimizers.

    Returns `loss_call(params, mod_state, x, y, rng) -> (loss,
    new_state)` in training mode. When the criterion implements the
    model-fusion protocol — `criterion.fused_loss(model)` returning a
    callable — that fused path is used instead of
    `criterion(model.apply(...), y)` (e.g. nn.ChunkedSoftmaxCE +
    TransformerLM: the LM loss from hidden states, never materializing
    (B, S, V)). `precision` (a utils.precision.Policy) casts params and
    inputs to its compute dtype; the cast is differentiable, so the
    gradients of fp32 master params come back in fp32."""
    fuse = getattr(criterion, "fused_loss", None)
    fused = fuse(model) if callable(fuse) else None

    if fused is not None:
        def loss_call(p, mod_state, x, y, rng):
            if precision is not None:
                p = precision.cast_to_compute(p)
                x = precision.cast_to_compute(x)
            loss, new_state = fused({"params": p, "state": mod_state},
                                    x, y, rng)
            if precision is not None:
                new_state = precision.cast_to_output(new_state)
            return loss, new_state
        return loss_call

    def loss_call(p, mod_state, x, y, rng):
        if precision is not None:
            p = precision.cast_to_compute(p)
            x = precision.cast_to_compute(x)
        out, new_state = model.apply({"params": p, "state": mod_state}, x,
                                     training=True, rng=rng)
        if precision is not None:
            out = precision.cast_to_output(out)
            new_state = precision.cast_to_output(new_state)
        return criterion(out, y), new_state
    return loss_call


def _chunk_nll(h: torch.Tensor, head: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    logits = (h @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, t[..., None])[..., 0]
    return (lse - picked).sum()


def softmax_cross_entropy_chunked(hidden: torch.Tensor, head: torch.Tensor,
                                  targets: torch.Tensor,
                                  chunk: int = 256) -> torch.Tensor:
    """Mean token NLL of `softmax(hidden @ head)` against int targets.

    hidden (B, S, E); head (E, V); targets (B, S) int. When `chunk`
    does not divide S, the largest divisor of S that is <= chunk is
    used instead (S=384 with chunk=256 runs at 192); if even that is
    tiny (< chunk/4, a prime or near-prime S) a ValueError asks for a
    padded sequence, as in the JAX package. While autograd records,
    each chunk is checkpointed."""
    b, s, _ = hidden.shape
    if s % chunk:
        best = max(d for d in range(1, min(chunk, s) + 1) if s % d == 0)
        if best * 4 < min(chunk, s):
            raise ValueError(
                f"no usable chunk size for sequence {s} (largest divisor "
                f"<= {chunk} is {best}); pad the sequence to a multiple "
                f"of a reasonable chunk")
        chunk = best
    recompute = torch.is_grad_enabled()
    targets = targets.long()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        h, t = hidden[:, i:i + chunk], targets[:, i:i + chunk]
        tot = tot + (checkpoint(_chunk_nll, h, head, t, use_reentrant=False)
                     if recompute else _chunk_nll(h, head, t))
    return tot / (b * s)
