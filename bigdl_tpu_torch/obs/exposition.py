"""Scrape endpoint — stdlib HTTP exposition of the telemetry plane.

Ports bigdl_tpu/obs/exposition.py (pure Python, copied). `ScrapeServer`
serves a Prometheus scraper, stdlib-only (http.server on one daemon
thread):

    /metrics   the registry's Prometheus text exposition (the same
               `render_prometheus()` bytes)
    /health    JSON ops view: scrape counter, sampler freshness
               (obs/timeseries.py), per-objective compliance and
               alert states (obs/slo.py)
    /alerts    JSON alert states only

Knobs are CONSTRUCTOR args, never env:
`registry` (default: the active one per request), `sampler`,
`alert_engine`, `host`, `port` (0 → ephemeral; `start()` returns the
bound port).

Threading contract: requests are answered on the
server's daemon thread while the owning loop keeps ticking the
sampler/alert engine — every piece of shared mutable state is locked
on BOTH sides (the scrape counter under this server's lock; the
sampler ring and alert states under their own locks inside their
accessors). The handler never touches a device tensor: everything
served is an already-fetched host value, and scraping never emits telemetry of its own — observing the plane
must not change it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from bigdl_tpu_torch.obs.registry import MetricsRegistry, get_registry

__all__ = ["ScrapeServer"]


class ScrapeServer:
    """One-process scrape endpoint over registry + sampler + alerts.

    >>> srv = ScrapeServer(sampler=sampler, alert_engine=aeng)
    >>> port = srv.start()          # daemon thread; 0 → ephemeral
    >>> # curl http://127.0.0.1:<port>/metrics | /health | /alerts
    >>> srv.close()
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 sampler=None, alert_engine=None,
                 host: str = "127.0.0.1", port: int = 0):
        self._registry = registry
        self.sampler = sampler
        self.alert_engine = alert_engine
        self.host = host
        self._port = port
        self._srv: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._scrapes = 0

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def port(self) -> int:
        return self._srv.server_address[1] if self._srv is not None \
            else self._port

    # ------------------------------------------------------------ wiring
    def start(self) -> int:
        """Bind, start the daemon serving thread, return the port."""
        if self._srv is not None:
            return self.port
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                # quiet: BaseHTTPRequestHandler logs every request to
                # stderr by default — core code owns no stdio
                pass

            def do_GET(self):
                try:
                    body, ctype, code = outer._respond(self.path)
                except Exception as e:  # the endpoint must never die
                    body = json.dumps({"error": repr(e)},
                                      sort_keys=True).encode()
                    ctype, code = "application/json", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((self.host, self._port),
                                        _Handler)
        self._thread = threading.Thread(target=self._serve,
                                        name="bigdl-obs-scrape",
                                        daemon=True)
        self._thread.start()
        return self.port

    def _serve(self) -> None:
        self._srv.serve_forever(poll_interval=0.1)

    def close(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- views
    def _respond(self, path: str) -> Tuple[bytes, str, int]:
        with self._lock:
            self._scrapes += 1
        route = path.split("?", 1)[0].rstrip("/") or "/"
        if route == "/metrics":
            return (self.registry.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8", 200)
        if route == "/alerts":
            return (json.dumps(self.alerts_view(),
                               sort_keys=True).encode(),
                    "application/json", 200)
        if route in ("/", "/health", "/healthz"):
            return (json.dumps(self.health_view(),
                               sort_keys=True).encode(),
                    "application/json", 200)
        return (json.dumps({"error": f"no route {route!r}",
                            "routes": ["/metrics", "/health",
                                       "/alerts"]},
                           sort_keys=True).encode(),
                "application/json", 404)

    def alerts_view(self) -> dict:
        if self.alert_engine is None:
            return {"alerts": [], "firing": []}
        return {"alerts": self.alert_engine.alerts(),
                "firing": self.alert_engine.firing()}

    def health_view(self) -> dict:
        """The JSON ops rollup: scrape count, sampler freshness,
        objective compliance, alert states."""
        with self._lock:
            n = self._scrapes
        out: dict = {"schema": 1, "scrapes": n}
        if self.sampler is not None:
            latest = self.sampler.latest()
            out["sampler"] = {
                "samples": len(self.sampler),
                "interval_s": self.sampler.interval_s,
                "last_sample_t": latest["t"] if latest else None,
            }
        if self.alert_engine is not None:
            out.update(self.alerts_view())
            out["objectives"] = self.alert_engine.compliance()
        return out
