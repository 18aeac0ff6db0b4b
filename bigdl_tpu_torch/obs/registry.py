"""Fixed-bucket latency histogram — the part of
bigdl_tpu/obs/registry.py the serving engine's `health()` needs.

Copied from the JAX package (pure Python): `DEFAULT_LATENCY_BUCKETS`,
`quantile_from_buckets` and the histogram child's `observe` and
`quantile`. The engine feeds one `LatencyHistogram` with every decode
step's dispatch+fetch seconds for its whole lifetime (bounded memory
however long it lives) and reads its p50/p95/p99 from the buckets. The
rest of the registry — named families, labels, counters, gauges, the
Prometheus rendering — waits for ROADMAP.md queue A.9.
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence, Tuple

__all__ = ["DEFAULT_LATENCY_BUCKETS", "LatencyHistogram",
           "quantile_from_buckets"]

# seconds-scale latency buckets: 100 us .. 10 s, roughly log-spaced
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)


def quantile_from_buckets(buckets: Sequence[float],
                          counts: Sequence[int],
                          q: float) -> Optional[float]:
    """Estimate the q-quantile of a fixed-bucket histogram by linear
    interpolation inside the owning bucket (Prometheus
    `histogram_quantile` semantics). `counts` has one entry per upper
    bound in `buckets` plus a trailing +Inf overflow entry. None on an
    empty histogram; the +Inf bucket clamps to the top finite edge."""
    total = sum(counts)
    if total == 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError("quantile must be in [0, 1]")
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i == len(buckets):               # +Inf bucket
                return buckets[-1] if buckets else None
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            return lo + (hi - lo) * ((rank - (cum - c)) / c)
    return buckets[-1] if buckets else None


class LatencyHistogram:
    """One fixed-bucket histogram series: counts per upper bound (plus
    +Inf), the sum and the count of the observed values."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.buckets = tuple(sorted(float(x) for x in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """See quantile_from_buckets — the one shared estimator."""
        return quantile_from_buckets(self.buckets, self.counts, q)
