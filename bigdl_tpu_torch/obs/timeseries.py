"""Metrics time-series layer — bounded ring of registry samples with
windowed queries.

Ports bigdl_tpu/obs/timeseries.py (pure Python, copied). The registry
answers "what are the totals NOW"; everything that wants
to watch the RUNNING fleet — the autoscaler, the SLO/alert engine
(obs/slo.py), the scrape endpoint's freshness view, the ops console —
needs "what happened over the last W seconds"; the primitive lives
here once:

* `delta_quantile` / `HistogramWindow` — windowed quantiles over
  cumulative-bucket deltas, the exact evaluation-to-evaluation math
  the autoscaler and the speculative engine's adaptive lookahead
  consume (same snapshot points, same delta, same shared
  `quantile_from_buckets` estimator);
* `MetricsSampler` — a bounded ring of periodic registry samples with
  `rate()` / `delta()` / `window_quantile()` queries over any window,
  the alert engine's and the scrape endpoint's data plane.

Design rules (the standing obs contracts):

* **Constructor knobs only**: `registry`,
  `interval_s`, `capacity`, `clock` — never env.
* **Driven, not driving.** `tick()` is called from the owning loop (a
  scheduling round, a drill loop, a bench wave) and self-rate-limits
  to one sample per `interval_s` of the INJECTED clock; the sampler
  never starts a thread and never reads the wall clock behind the
  caller's back, so a drill under a virtual clock samples
  bit-deterministically (the slo_alert drill pins byte-identity).
* **Host-side only.** A sample is a flattened `registry.snapshot()` —
  already-fetched host ints/floats; zero device syncs.
* **Locked on both sides.** The ring and its queries take the
  sampler's lock because the scrape endpoint (obs/exposition.py)
  reads them from its serving thread while the owning loop ticks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.obs.registry import (MetricsRegistry, get_registry,
                                    quantile_from_buckets)

__all__ = ["MetricsSampler", "HistogramWindow", "delta_quantile",
           "counts_delta"]


def counts_delta(counts_now: Sequence[int],
                 counts_then: Optional[Sequence[int]]) -> List[int]:
    """Per-bucket delta between two cumulative count vectors (`then`
    of None means "before any observation" — all zeros)."""
    if counts_then is None:
        counts_then = [0] * len(counts_now)
    return [c - p for c, p in zip(counts_now, counts_then)]


def delta_quantile(buckets: Sequence[float],
                   counts_now: Sequence[int],
                   counts_then: Optional[Sequence[int]],
                   q: float) -> Optional[float]:
    """q-quantile of the observations that landed BETWEEN two
    cumulative bucket-count snapshots — THE windowed-quantile
    primitive. `HistogramWindow` (autoscaler) and
    `MetricsSampler.window_quantile` (alert engine, ops views) both
    reduce to this one call into the shared estimator, so a windowed
    p99 can never drift between consumers."""
    return quantile_from_buckets(
        buckets, counts_delta(counts_now, counts_then), q)


class HistogramWindow:
    """Stateful delta window over one LIVE histogram child: each
    `quantile()` call reports on the observations since the PREVIOUS
    call, then re-opens the window. This is exactly the
    evaluation-to-evaluation windowing `Autoscaler._window_p99` used
    to hand-roll (cumulative counts snapshotted per evaluation, delta
    quantile between them) — hoisted here so the SLO plane shares it;
    the autoscaler's decisions are bit-identical before/after the
    refactor (fleet_autoscale drill)."""

    def __init__(self, child):
        self._child = child
        self._last: Optional[List[int]] = None

    def quantile(self, q: float) -> Optional[float]:
        """Quantile of the observations since the previous call (None
        when the window saw none)."""
        counts = list(self._child.counts)
        prev, self._last = self._last, counts
        return delta_quantile(self._child.buckets, counts, prev, q)


class MetricsSampler:
    """Bounded ring of periodic registry samples + windowed queries.

    >>> sampler = MetricsSampler(interval_s=0.5, clock=drill_clock)
    >>> while serving:
    ...     router.step(); sampler.tick()
    >>> sampler.window_quantile("router_request_latency_seconds",
    ...                         0.99, labels={"router": "r0"},
    ...                         window_s=10.0)

    Knobs are CONSTRUCTOR args, never env: `registry` (default: the
    active one at first use), `interval_s` (tick rate limit),
    `capacity` (ring length — memory is bounded at
    capacity × registry size), `clock` (seconds source; inject the
    drill/fleet virtual clock for bit-deterministic sampling —
    `time.monotonic` is only the injection-point default)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 interval_s: float = 1.0, capacity: int = 512,
                 clock: Optional[Callable[[], float]] = None):
        if interval_s < 0:
            raise ValueError("interval_s must be >= 0")
        if capacity < 2:
            raise ValueError(
                "capacity must be >= 2 (window queries diff two "
                "samples)")
        self._registry = registry
        self.interval_s = float(interval_s)
        self._clock = clock or time.monotonic
        self._samples: deque = deque(maxlen=capacity)
        # whole-run baseline: the FIRST sample ever taken,
        # held outside the ring so eviction can't touch it. Found by
        # the fleet simulator: a 10^5-request scenario ticks the
        # sampler far past any reasonable capacity, and every
        # `window_s=None` query ("whole run" by contract) silently
        # became "the last `capacity` samples" once the ring rolled —
        # loadgen's end-of-run SLO compliance read only the tail of
        # the run it claimed to summarize. `span(window_s=None)` now
        # anchors at this baseline, so whole-run deltas/quantiles
        # count from the actual start at any scale; bounded windows
        # keep the ring's memory bound.
        self._first: Optional[dict] = None
        self._lock = threading.Lock()

    @property
    def clock(self) -> Callable[[], float]:
        """The injected seconds source (the AlertEngine defaults to
        it, so one cell drives sampling AND alert transitions)."""
        return self._clock

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    # ----------------------------------------------------------- sampling
    def sample(self) -> dict:
        """Take one sample NOW (no rate limit): the flattened registry
        state stamped with the injected clock. Appends to the ring and
        returns the sample."""
        rec = {"t": self._clock(),
               "metrics": self.registry.snapshot()["metrics"]}
        with self._lock:
            self._samples.append(rec)
            if self._first is None:
                self._first = rec
        return rec

    def tick(self) -> Optional[dict]:
        """Sample iff `interval_s` has elapsed since the newest sample
        (the first call always samples). The owning loop calls this
        once per round; returns the new sample or None between
        intervals."""
        with self._lock:
            last = self._samples[-1]["t"] if self._samples else None
        if last is not None \
                and self._clock() - last < self.interval_s - 1e-9:
            return None
        return self.sample()

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def samples(self, window_s: Optional[float] = None) -> List[dict]:
        """Samples oldest-first; `window_s` keeps only those within
        that many seconds of the NEWEST sample (sample time, not wall
        time — deterministic under an injected clock)."""
        with self._lock:
            out = list(self._samples)
        if window_s is None or not out:
            return out
        cutoff = out[-1]["t"] - window_s
        return [s for s in out if s["t"] >= cutoff - 1e-9]

    def span(self, window_s: Optional[float] = None
             ) -> Optional[Tuple[dict, dict]]:
        """(oldest-in-window, newest) sample pair — the two endpoints
        every window query diffs; None with fewer than two samples in
        the window. `window_s=None` means WHOLE RUN: the old endpoint
        is the never-evicted first-sample baseline, so the answer
        stays correct after the ring rolls (the sim-found truncation
        bug — see the `_first` note in __init__)."""
        xs = self.samples(window_s)
        if window_s is None:
            with self._lock:
                first = self._first
            if first is not None and xs \
                    and first["t"] < xs[0]["t"] - 1e-9:
                xs = [first] + xs       # ring rolled past the start
        if len(xs) < 2:
            return None
        return xs[0], xs[-1]

    @staticmethod
    def _series(sample: dict, name: str,
                labels: Optional[Dict[str, str]]) -> Optional[dict]:
        fam = sample["metrics"].get(name)
        if fam is None:
            return None
        want = {k: str(v) for k, v in (labels or {}).items()}
        for s in fam["series"]:
            if s["labels"] == want:
                return s
        return None

    @staticmethod
    def _scalar(series: dict) -> float:
        """One comparable number per series: counter/gauge value,
        histogram observation count."""
        return series["count"] if "counts" in series else series["value"]

    def delta(self, name: str, *,
              labels: Optional[Dict[str, str]] = None,
              window_s: Optional[float] = None) -> Optional[float]:
        """Value increase of one series over the window (histogram:
        observation-count increase). None without two samples or when
        the newest sample lacks the series; a series absent from the
        window's OLD endpoint counts from zero (it was born inside the
        window)."""
        pair = self.span(window_s)
        if pair is None:
            return None
        old, new = pair
        sn = self._series(new, name, labels)
        if sn is None:
            return None
        so = self._series(old, name, labels)
        return self._scalar(sn) - (self._scalar(so)
                                   if so is not None else 0.0)

    def rate(self, name: str, *,
             labels: Optional[Dict[str, str]] = None,
             window_s: Optional[float] = None) -> Optional[float]:
        """delta / elapsed-seconds over the window endpoints (None on
        a zero-width window)."""
        pair = self.span(window_s)
        if pair is None:
            return None
        old, new = pair
        dt = new["t"] - old["t"]
        d = self.delta(name, labels=labels, window_s=window_s)
        if d is None or dt <= 0:
            return None
        return d / dt

    def window_quantile(self, name: str, q: float, *,
                        labels: Optional[Dict[str, str]] = None,
                        window_s: Optional[float] = None
                        ) -> Optional[float]:
        """Windowed quantile of a histogram series: the cumulative
        bucket counts at the window's two endpoints go through
        `delta_quantile` — the same estimator as the live child and
        obs_report, generalizing the autoscaler's old private
        `_window_p99` to any window over any histogram family."""
        pair = self.span(window_s)
        if pair is None:
            return None
        old, new = pair
        sn = self._series(new, name, labels)
        if sn is None or "counts" not in sn:
            return None
        so = self._series(old, name, labels)
        then = so["counts"] if so is not None and "counts" in so \
            else None
        return delta_quantile(sn["buckets"], sn["counts"], then, q)

    def series_deltas(self, name: str, *,
                      window_s: Optional[float] = None
                      ) -> List[Tuple[Dict[str, str], float]]:
        """(labels, delta) per series of a family over the window,
        series order as snapshotted (sorted) — the error-budget
        objective sums label subsets of these."""
        pair = self.span(window_s)
        if pair is None:
            return []
        old, new = pair
        fam = new["metrics"].get(name)
        if fam is None:
            return []
        out = []
        for s in fam["series"]:
            so = self._series(old, name, s["labels"])
            out.append((dict(s["labels"]),
                        self._scalar(s) - (self._scalar(so)
                                           if so is not None else 0.0)))
        return out
