"""Shape bucketing — a copy of bigdl_tpu/serving/bucketing.py.

The port keeps its own copy because it imports nothing of the JAX
package. In the port the buckets bound the number of distinct prefill
shapes the engine launches (and with them the per-shape work of the
CUDA libraries), as they bound compilations in the JAX package.

Original notes: the anti-recompilation discipline of the serving
plane (and of `Predictor`'s ragged final batch).

XLA compiles per shape. A serving workload sees every prompt length and
every ragged tail, so the rule is: never hand jit a novel shape — pad
to the nearest bucket from a small fixed set and mask/slice the tail.
Each bucket compiles once; traffic after warmup compiles never.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def default_buckets(max_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Powers of two from min_bucket up to (and including) max_len."""
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n."""
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"length {n} exceeds largest bucket "
                     f"{max(buckets)}")


def bucket_histogram(lengths: Sequence[int],
                     buckets: Sequence[int]) -> Dict[int, int]:
    """{bucket: count} over `lengths` (zero-count buckets included) —
    the queue-composition line of the serving engine's health
    snapshot: which prefill executables the backlog will exercise."""
    out = {b: 0 for b in sorted(buckets)}
    for n in lengths:
        out[bucket_for(n, buckets)] += 1
    return out


def pad_tokens(tokens: Sequence[int], bucket: int,
               pad_id: int = 0) -> np.ndarray:
    """Right-pad a token list to `bucket` → (bucket,) int32. Causal
    attention keeps positions < len(tokens) independent of the pad."""
    out = np.full((bucket,), pad_id, np.int32)
    out[:len(tokens)] = np.asarray(tokens, np.int32)
    return out


def pad_rows(x, rows: int):
    """Pad the leading (batch) axis up to `rows` by repeating the last
    real row (mode="edge" — padded rows hold a real sample, so metrics
    and batch-norm-free forwards see no synthetic zeros). Handles the
    tuple (multi-IO) inputs NCF-style models use."""
    if isinstance(x, tuple):
        return tuple(pad_rows(e, rows) for e in x)
    x = np.asarray(x)
    if x.shape[0] >= rows:
        return x
    widths = [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths, mode="edge")
