"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms with label sets.

Ports bigdl_tpu/obs/registry.py (pure Python, copied): named families
with one child per label-value tuple, `MetricsRegistry` with idempotent
registration (a second caller that disagrees on a family's kind, labels
or buckets raises), `get_registry`/`set_registry`, the deterministic
`snapshot()` (names and label tuples sorted; the clock stamp is the only
time-dependent field and the clock is injectable), `to_json()` and
`render_prometheus()` (the Prometheus text format). Histograms keep
counts per upper bound plus +Inf, the sum and the count — bounded
memory however many values a long-lived engine observes — and estimate
quantiles by linear interpolation inside the owning bucket
(`quantile_from_buckets`, the one estimator the serving engine's
`health()` percentiles and the time-series windows share).
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "DEFAULT_LATENCY_BUCKETS",
           "quantile_from_buckets", "series_key"]


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Canonical flat key for one labeled series —
    `name{k1=v1,k2=v2}` with labels sorted, bare `name` when
    unlabeled. THE rendering shared by obs.provenance and the flight
    recorder's snapshot digests: the same series must key identically
    everywhere."""
    if not labels:
        return name
    return (name + "{"
            + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            + "}")

# seconds-scale latency buckets: 100 us .. 10 s, roughly log-spaced —
# wide enough for a CPU decode step and a GPU one
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
    empty histogram; the +Inf bucket clamps to the top finite edge (an
    unbounded bucket has no upper edge to lerp toward). THE estimator
    — live registry children and snapshot consumers share it, so their
    percentiles can never drift."""
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


def _label_key(labelnames: Sequence[str],
               labels: Dict[str, str]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Base: a named family holding one child per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: str):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _default_child(self):
        """The label-less child (only valid with no labelnames)."""
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} declares labels "
                f"{self.labelnames}; use .labels(...)")
        return self.labels()

    def _new_child(self):
        raise NotImplementedError

    # ------------------------------------------------------------- export
    def _sorted_children(self) -> List[Tuple[Tuple[str, ...], object]]:
        return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return sum(c.value for c in self._children.values())


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        child = self._children.get(())
        return child.value if child is not None else 0.0


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets                 # upper bounds, ascending
        self.counts = [0] * (len(buckets) + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """See quantile_from_buckets — the one shared estimator."""
        return quantile_from_buckets(self.buckets, self.counts, q)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def quantile(self, q: float) -> Optional[float]:
        return self._default_child().quantile(q)


class MetricsRegistry:
    """Named metric families; one per process by default
    (`get_registry()`), swappable for isolation (`set_registry`).

    Registration is idempotent: re-requesting a name returns the
    existing family (mismatched kind/labels/buckets raises — two call
    sites disagreeing on a metric's schema is a bug, not a merge)."""

    def __init__(self, clock=None):
        import time as _time

        self._clock = clock or _time.time
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------- registration
    def _get_or_make(self, cls, name: str, help: str,
                     labelnames: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(f"metric {name!r} labelnames mismatch: "
                             f"{m.labelnames} vs {tuple(labelnames)}")
        if kw.get("buckets") is not None \
                and tuple(sorted(float(b) for b in kw["buckets"])) \
                != getattr(m, "buckets", None):
            raise ValueError(f"histogram {name!r} bucket mismatch")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=tuple(buckets))

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every family — test/drill isolation."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Deterministic dict: metric names sorted, label tuples
        sorted; identical metric activity → byte-identical JSON (the
        clock stamp is the only time-dependent field, and it is
        injectable)."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            fam: dict = {"kind": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames), "series": []}
            for key, child in m._sorted_children():
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    fam["series"].append({
                        "labels": labels,
                        "buckets": list(m.buckets),
                        "counts": list(child.counts),
                        "sum": child.sum, "count": child.count})
                else:
                    fam["series"].append({"labels": labels,
                                          "value": child.value})
            out[name] = fam
        return {"schema": 1, "ts": self._clock(), "metrics": out}

    def to_json(self, **dumps_kw) -> str:
        dumps_kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **dumps_kw)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (families sorted, series
        sorted within a family)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in m._sorted_children():
                base = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    cum = 0
                    for ub, c in zip(list(m.buckets) + ["+Inf"],
                                     child.counts):
                        cum += c
                        lbl = _fmt_labels({**base, "le": _fmt_num(ub)})
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(base)} "
                        f"{_fmt_num(child.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(base)} {child.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(base)} "
                                 f"{_fmt_num(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_num(v) -> str:
    if isinstance(v, str):
        return v
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"')
    inner = ",".join(f'{k}="{esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install a registry (None → fresh default). Returns the active
    one, so `set_registry(MetricsRegistry(clock=fake))` reads well in
    drills."""
    global _registry
    _registry = registry or MetricsRegistry()
    return _registry
