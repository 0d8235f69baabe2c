"""Stdlib-only HTTP exporter for the live telemetry plane
(``CRAFT_METRICS_PORT``).

Serves two endpoints from a daemon thread:

``/metrics``
    The process-local :mod:`repro_torch.core.metrics` registry rendered in
    Prometheus text exposition format.  (Fleet totals are a *caller*
    concern: rank 0 can publish a merged view via
    :func:`repro_torch.core.metrics.aggregate` — the exporter itself never
    touches the comm fabric, so a scrape can never deadlock a collective.)

``/healthz``
    A JSON liveness/readiness document built from every live
    :class:`~repro_torch.core.checkpoint.Checkpoint` in the process (registered
    weakly at ``commit()``): per-tier breaker states, last-checkpoint
    version and age, async-writer backlog and oldest pending write,
    scrubber verdicts, degraded-write counters.  Returns HTTP 200 while
    every breaker is closed/half-open and 503 while any is open — i.e.
    suitable verbatim as a k8s liveness probe for ``launch/serve.py``
    replicas: a replica whose PFS tier is dark flips unhealthy, and flips
    back the moment the breaker re-admits the tier.

The server is process-global and idempotent like the trace recorder:
``maybe_start_from_env(env)`` is called from ``Checkpoint.commit()`` and
is a no-op unless ``CRAFT_METRICS_PORT`` is set.  Port ``0`` binds an
ephemeral port (tests read :func:`port` back).
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics

__all__ = [
    "start", "stop", "port", "maybe_start_from_env",
    "register_checkpoint", "health_report",
]

# Live checkpoints, weakly held so telemetry never extends their lifetime.
_CHECKPOINTS: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_LOCK = threading.Lock()
_SERVER: Optional["_TelemetryServer"] = None


def register_checkpoint(cp) -> None:
    """Track ``cp`` for ``/healthz`` (called from ``Checkpoint.commit()``)."""
    _CHECKPOINTS[cp.name] = cp


def health_report(clock=time.monotonic) -> dict:
    """The ``/healthz`` document: healthy unless some breaker is open."""
    now = clock()
    checkpoints = {}
    healthy = True
    for name, cp in sorted(_CHECKPOINTS.items()):
        if cp is None or getattr(cp, "_closed", False):
            continue
        breakers = {}
        for slot, th in getattr(cp, "health", {}).items():
            state = th.breaker.state
            breakers[slot] = {"state": state, "last_error": th.last_error}
            if state == "open":
                healthy = False
        writer = getattr(cp, "_writer", None)
        last_t = getattr(cp, "_last_write_t", None)
        stats = cp.stats
        doc = {
            "version": cp.version,
            "last_write_age_s": (round(now - last_t, 3)
                                 if last_t is not None else None),
            "breakers": breakers,
            "async_backlog": writer.pending if writer is not None else 0,
            "async_oldest_pending_s": (
                round(writer.oldest_pending_s(now), 3)
                if writer is not None else 0.0),
            "degraded_writes": stats.get("degraded_writes", 0),
            "breaker_trips": stats.get("breaker_trips", 0),
            "retries": stats.get("retries", 0),
        }
        scrubber = getattr(cp, "scrubber", None)
        if scrubber is not None:
            s = scrubber.stats
            doc["scrubber"] = {
                k: s.get(k, 0)
                for k in ("corrupt_found", "repaired", "unrepairable",
                          "quarantined", "files_scanned")
            }
        checkpoints[name] = doc
    return {
        "status": "ok" if healthy else "unhealthy",
        "healthy": healthy,
        "checkpoints": checkpoints,
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "craft-telemetry"

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = metrics.render_prometheus(metrics.snapshot())
            self._reply(200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            report = health_report()
            code = 200 if report["healthy"] else 503
            self._reply(code, json.dumps(report, indent=1) + "\n",
                        "application/json")
        else:
            self._reply(404, "not found\n", "text/plain")

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):  # scraper went away
            pass

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        return None


class _TelemetryServer:
    def __init__(self, port: int):
        self.httpd = ThreadingHTTPServer(("", port), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="craft-telemetry", daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5.0)


def start(port_no: int = 0) -> int:
    """Start (or reuse) the exporter; returns the bound port.  Arms the
    metrics registry too — an exporter with nothing to serve is useless."""
    global _SERVER
    with _LOCK:
        if _SERVER is None:
            metrics.install()
            _SERVER = _TelemetryServer(port_no)
        return _SERVER.port


def stop() -> None:
    """Shut the exporter down (tests; end of a metered run)."""
    global _SERVER
    with _LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.stop()


def port() -> Optional[int]:
    """The bound port, or ``None`` while the exporter is down."""
    with _LOCK:
        return _SERVER.port if _SERVER is not None else None


def maybe_start_from_env(env) -> None:
    """Start the exporter when the captured env names a port
    (``Checkpoint.commit()`` calls this — the read-once contract)."""
    if getattr(env, "metrics_port", -1) >= 0:
        start(env.metrics_port)
