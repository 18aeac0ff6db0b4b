"""Loss functions — the chunked LM criterion.

Ports `ChunkedSoftmaxCE` from bigdl_tpu/nn/criterion.py (the other
criteria of that file come with the slices that use them). Class
targets are 0-based integers, as in the JAX package.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Criterion


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
