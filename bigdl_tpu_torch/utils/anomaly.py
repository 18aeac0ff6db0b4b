"""Per-row finite check for the serving engine's poison guard.

Ports `rows_finite` from bigdl_tpu/utils/anomaly.py; the training-side
anomaly guard of that module comes with the training slice.
"""

from __future__ import annotations

import torch


def rows_finite(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) → (B,) bool, True iff every element of the row is
    finite. The decode step returns it beside the sampled tokens, so a
    NaN/inf row evicts only its own request (serving/engine.py)."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
