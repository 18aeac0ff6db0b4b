"""Host-side span tracer — Chrome-trace / Perfetto JSON.

Records named spans (begin/end pairs collapsed to complete "X" events)
from the serving request lifecycle (queued → admitted → prefill →
decode×N → terminal status) and the training step phases (data / step
/ fence / checkpoint), and renders them as a `chrome://tracing` /
Perfetto-loadable JSON object.

Ports bigdl_tpu/obs/spans.py. Alignment with device traces: while a
`utils/profiler.trace()` capture is active, a span ALSO enters a
`torch.profiler.record_function` range of the same name (the JAX
tracer's `jax.profiler.TraceAnnotation`), so the host span and the
CUDA kernel timeline carry matching labels in one trace. The range is
host-side only — a span NEVER synchronises the device (wall-clock
spans around an un-fenced launch measure the launch, not the compute;
fence first, see utils/profiler.FencedTimer).

The tracer is OFF by default (`enabled=False` → `span()` is a shared
no-op context manager, ~no overhead); drills and profiling runs
turn it on. Both the clock and the buffer are injectable/bounded.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

__all__ = ["SpanTracer", "get_tracer", "set_tracer"]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _obs_enabled() -> bool:
    """Global kill-switch check (call-time import — obs/__init__
    imports this module, so a top-level import would cycle). Every
    record path honors BIGDL_OBS=off even on an enabled tracer, per
    the 'every emission path early-outs on enabled()' contract."""
    from bigdl_tpu_torch import obs

    return obs.enabled()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self.tracer._clock()
        self.tracer._enter_annotation(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer._exit_annotation()
        self.tracer._record(self.name, self.cat, self._t0,
                            self.tracer._clock(), self.args)
        return False


class SpanTracer:
    """Bounded buffer of complete spans + instant events.

    `clock` returns seconds (injectable — the serving engine passes its
    own clock so deadline drills produce deterministic spans);
    timestamps are exported in microseconds as Chrome trace requires."""

    def __init__(self, capacity: int = 65536, clock=None,
                 enabled: bool = False, pid: Optional[int] = None):
        import time as _time

        self._clock = clock or _time.perf_counter
        self._events: deque = deque(maxlen=capacity)
        self.enabled = enabled
        self._pid = os.getpid() if pid is None else pid
        self._ann = threading.local()

    # ------------------------------------------------------------ record
    def span(self, name: str, cat: str = "host",
             args: Optional[dict] = None):
        """Context manager recording one complete ("X") span."""
        if not self.enabled or not _obs_enabled():
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host",
                args: Optional[dict] = None) -> None:
        """Zero-duration marker ("i" event) — terminal statuses,
        faults."""
        if not self.enabled or not _obs_enabled():
            return
        self._events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._clock() * 1e6, "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            **({"args": args} if args else {})})

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        """Record a span from externally measured endpoints (seconds).

        Clock-domain contract: `t0`/`t1` must come from the SAME clock
        the rest of the timeline uses. The serving engine passes its
        own injectable clock's readings here (request spans must be
        deterministic under the deadline drills); the training Timer spans use this tracer's clock
        (default perf_counter). On Linux the defaults (monotonic vs
        perf_counter) share an epoch; elsewhere, or with an injected
        engine clock, build the tracer with the engine's clock
        (`SpanTracer(clock=engine_clock, enabled=True)`) to keep the
        merged timeline aligned."""
        if not self.enabled or not _obs_enabled():
            return
        self._record(name, cat, t0, t1, args)

    def _record(self, name, cat, t0, t1, args):
        self._events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            **({"args": args} if args else {})})

    # --------------------------------------------- device trace alignment
    def _enter_annotation(self, name: str) -> None:
        """Mirror the span as a `torch.profiler.record_function` range
        while a `utils/profiler.trace()` capture runs, so the capture
        shows the same label. Every span pushes one entry (None outside
        a capture), so enters and exits pair up. Never raises
        (telemetry must not take down the loop it observes)."""
        ann = None
        try:
            from bigdl_tpu_torch.utils import profiler

            if profiler.capturing():
                import torch.profiler

                ann = torch.profiler.record_function(name)
                ann.__enter__()
        except Exception:
            ann = None
        stack = getattr(self._ann, "stack", None)
        if stack is None:
            stack = self._ann.stack = []
        stack.append(ann)

    def _exit_annotation(self) -> None:
        stack = getattr(self._ann, "stack", None)
        ann = stack.pop() if stack else None
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass

    # ------------------------------------------------------------- export
    def to_chrome_trace(self) -> Dict[str, object]:
        """`{"traceEvents": [...], "displayTimeUnit": "ms"}` — loads
        in chrome://tracing and ui.perfetto.dev."""
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def events(self, name: Optional[str] = None) -> List[dict]:
        return [e for e in self._events
                if name is None or e["name"] == name]

    def clear(self) -> None:
        self._events.clear()


_tracer = SpanTracer()


def get_tracer() -> SpanTracer:
    return _tracer


def set_tracer(tracer: Optional[SpanTracer]) -> SpanTracer:
    """Install a tracer (None → fresh disabled default); returns the
    active one."""
    global _tracer
    _tracer = tracer or SpanTracer()
    return _tracer
