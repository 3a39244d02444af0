"""The live telemetry endpoint: /metrics + /healthz on a daemon thread.

Counterpart of ``qfedx_tpu/obs/server.py``, stdlib only (``http.server``):

- ``GET /metrics`` — Prometheus text exposition (0.0.4): every counter,
  gauge and bounded histogram (obs/histo.py) in the registry, names
  sanitized ``serve.requests_served`` → ``qfedx_serve_requests_served``;
  span-duration histograms render with a ``_seconds`` suffix, buckets as
  cumulative ``le`` rows over occupied buckets. A labeled
  ``qfedx_build_info`` gauge leads (torch, CUDA and device names).
- ``GET /healthz`` — liveness JSON: per-component health sources
  (``set_health_source``: the streamed trainer's last completed round
  and flush age, the batcher's queue depth and ledger); a raising source
  degrades the status instead of failing the probe, and a firing
  watchdog rule (obs/watch.py) drives 503 and is named.

Default off: ``maybe_start()`` reads ``QFEDX_METRICS_PORT`` (0/unset →
no thread, no socket), is idempotent (one server per process, the first
caller wins) and only warns when the port is taken. While a server
runs, the bounded instruments record even with QFEDX_TRACE off; spans
still need the pin. ``stop_server()`` is for tests and embedders.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from qfedx_tpu_torch.obs import flight, trace
from qfedx_tpu_torch.utils import pins

_lock = threading.Lock()
_server: "TelemetryServer | None" = None
_health_sources: dict[str, Callable[[], dict]] = {}


def metrics_port() -> int:
    """The QFEDX_METRICS_PORT pin: 0/'off'/unset = no server (default),
    else the localhost port /metrics + /healthz bind to."""
    return pins.port_pin("QFEDX_METRICS_PORT", 0)


# -- rendering ----------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, suffix: str = "") -> str:
    return "qfedx_" + _NAME_RE.sub("_", name) + suffix


def _fmt(v: float) -> str:
    return repr(round(v, 9)) if isinstance(v, float) else str(v)


def build_info_labels() -> dict[str, str] | None:
    """Labels of the ``qfedx_build_info`` gauge: the package, torch and
    CUDA versions, the device the process serves on and the RESOLVED
    route (fuse/scan/kernel booleans and the state dtype —
    ``ops/scan_body.resolved_route``), computed per scrape (the route
    pins are live). None when the environment cannot answer: the gauge
    is then omitted rather than lying."""
    try:
        import torch

        from qfedx_tpu_torch import __version__
        from qfedx_tpu_torch.ops import scan_body
        from qfedx_tpu_torch.ops.cpx import state_dtype

        route = scan_body.resolved_route()
        cuda = torch.cuda.is_available()
        return {
            "version": __version__,
            "torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "dtype": str(state_dtype()).replace("torch.", ""),
            "fuse": str(bool(route.get("fuse"))).lower(),
            "scan": str(bool(route.get("scan_layers"))).lower(),
            "pallas": str(bool(route.get("pallas"))).lower(),
        }
    except Exception:  # noqa: BLE001 — telemetry must degrade, not raise
        return None


def _render_build_info(lines: list[str]) -> None:
    labels = build_info_labels()
    if labels is None:
        return
    esc = {
        k: str(v).replace("\\", "\\\\").replace('"', '\\"')
        for k, v in labels.items()
    }
    pairs = ",".join(f'{k}="{v}"' for k, v in sorted(esc.items()))
    lines.append("# TYPE qfedx_build_info gauge")
    lines.append(f"qfedx_build_info{{{pairs}}} 1")


def render_prometheus() -> str:
    """The registry as Prometheus 0.0.4 text. Pure function of the
    registry — callable without a server (tests, ad-hoc dumps) — plus
    the one environmental constant: the labeled ``qfedx_build_info``
    gauge (value 1) leading the exposition."""
    counters, gauges, histos, span_histos = trace.registry().instruments()
    lines: list[str] = []
    _render_build_info(lines)
    for name, val in sorted(counters.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(val)}")
    for name, val in sorted(gauges.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(val)}")
    rendered = [(n, h, "") for n, h in histos.items()]
    rendered += [(n, h, "_seconds") for n, h in span_histos.items()]
    # Sort on (name, suffix) only: equal names (a value histogram
    # colliding with a span name) must never make sorted() compare the
    # Histogram objects themselves.
    for name, h, suffix in sorted(rendered, key=lambda t: (t[0], t[2])):
        pn = _prom_name(name, suffix)
        lines.append(f"# TYPE {pn} histogram")
        for le, cum in h.nonzero_buckets():
            lines.append(f'{pn}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{pn}_sum {_fmt(h.sum)}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + "\n"


def health_components() -> dict:
    """Run every registered health source once and return the component
    dict; a raising source contributes ``{"error": ...}`` instead of
    killing the caller. Shared by /healthz rendering and the
    watchdog's snapshot (obs/watch.py), which must read components
    WITHOUT the alerts section — alerts are derived from this, not
    input to it."""
    with _lock:
        sources = dict(_health_sources)
    comps = {}
    for name, fn in sorted(sources.items()):
        try:
            comps[name] = fn()
        except Exception as exc:  # noqa: BLE001 — a sick source degrades, never 500s
            comps[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return comps


# Last status health_payload computed — the flight recorder logs the
# ok→degraded→ok EDGES (a ring of identical "ok" rows is noise).
_last_status = "ok"


def health_payload() -> dict:
    """The /healthz body: per-component sources merged under one status.
    A raising source marks the payload degraded but never kills the
    probe — an orchestrator must be able to read a sick process. When
    the watchdog (obs/watch.py) is enabled the payload carries an
    ``alerts`` section, and any FIRING rule drives the same
    degraded→503 path — the probe names the rule, not just the mood."""
    from qfedx_tpu_torch.obs import watch
    from qfedx_tpu_torch.run.metrics import METRICS_SCHEMA_VERSION

    with _lock:
        srv = _server
    out: dict = {
        "status": "ok",
        "trace_enabled": trace.enabled(),
        "metrics_schema": METRICS_SCHEMA_VERSION,
    }
    if srv is not None:
        out["uptime_s"] = round(time.monotonic() - srv.started_mono, 3)
    comps = health_components()
    for comp in comps.values():
        if isinstance(comp, dict) and "error" in comp:
            out["status"] = "degraded"
    out["components"] = comps
    if watch.enabled():
        active = watch.active_alerts()
        out["alerts"] = {
            "active": active,
            "fired_total": watch.fired_totals(),
        }
        if active:
            out["status"] = "degraded"
    global _last_status
    if out["status"] != _last_status:
        flight.on_health(out["status"], _last_status)
        _last_status = out["status"]
    return out


def set_health_source(name: str, fn: Callable[[], dict]) -> None:
    """Register (or replace) a component's /healthz contributor — a
    zero-arg callable returning a JSON-able dict. Components unregister
    with ``clear_health_source`` on close so a dead batcher's stats
    don't read as live."""
    with _lock:
        _health_sources[name] = fn


def clear_health_source(name: str, only_if: Callable | None = None) -> None:
    """Unregister ``name``. With ``only_if``, pop only when the current
    registration IS that callable — a closing component must not evict
    a newer component that took the name over (latest wins on
    ``set_health_source``; the loser's close is then a no-op)."""
    with _lock:
        if only_if is None or _health_sources.get(name) is only_if:
            _health_sources.pop(name, None)


# -- the server ---------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    # http.server logs every request to stderr by default; the obs.http
    # span and counter below are the telemetry instead.
    def log_message(self, *_a):  # noqa: D102
        return None

    def _respond(self, send_body: bool) -> None:
        path = self.path.split("?", 1)[0]
        # The span closes BEFORE the response bytes go out: a client
        # that has received its reply must be able to see the request's
        # span in the registry (the write itself is µs of socket work).
        with trace.span("obs.http", path=path) as sp:
            if path == "/metrics":
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = 200
            elif path == "/healthz":
                payload = health_payload()
                body = (json.dumps(payload) + "\n").encode()
                ctype = "application/json"
                status = 200 if payload["status"] == "ok" else 503
            else:
                body = b"not found: /metrics and /healthz only\n"
                ctype = "text/plain"
                status = 404
            sp.set(status=status)
            trace.counter("obs.http_requests")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if send_body:
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._respond(send_body=True)

    def do_HEAD(self):  # noqa: N802 — orchestrator probes (curl -I,
        # k8s httpGet with a HEAD-preferring proxy) must get real
        # status codes + Content-Length without the body bytes.
        self._respond(send_body=False)


class _TelemetryHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-request error hook does not dump
    tracebacks to stderr. socketserver's default handle_error prints,
    and a client
    disconnecting mid-scrape (BrokenPipeError/ConnectionResetError:
    curl timeouts, probe cancellations) is routine under load, not an
    error. Disconnects bump a counter; anything else degrades to a
    counter too, keeping stderr clean for the actual workload."""

    def handle_error(self, request, client_address):  # noqa: D102
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            trace.counter("obs.http_client_disconnects")
            return
        trace.counter("obs.http_handler_errors")


class TelemetryServer:
    """One process-wide /metrics + /healthz server on a daemon thread."""

    def __init__(self, port: int):
        # localhost only: telemetry is an operator loopback/sidecar
        # surface, not a public listener.
        self._httpd = _TelemetryHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self.started_mono = time.monotonic()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="qfedx-metrics",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_server(port: int) -> TelemetryServer:
    """Start (or return) THE process telemetry server. Idempotent: a
    second caller gets the running instance regardless of port — one
    process, one scrape surface. Flips the live-metrics gate so the
    bounded instruments record while the endpoint is up."""
    global _server
    with _lock:
        if _server is None:
            _server = TelemetryServer(port)
            trace.set_live_metrics(True)
        return _server


def maybe_start() -> TelemetryServer | None:
    """Start the endpoint iff QFEDX_METRICS_PORT says so (default off —
    returns None, starts no thread). The one call every long-lived
    component makes at startup.

    A bind failure DEGRADES (warn, return None) instead of raising:
    two processes sharing one exported pin — the gloo pair, or trainer
    + serve on one host — must not let the loser's missing telemetry
    kill its actual work. ``start_server`` stays loud for direct
    callers (tests bind ephemeral ports and want errors)."""
    port = metrics_port()
    if port == 0:
        return None
    try:
        return start_server(port)
    except OSError as exc:
        import warnings

        warnings.warn(
            f"QFEDX_METRICS_PORT={port}: telemetry endpoint not started "
            f"({exc}) — continuing without /metrics",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


def stop_server() -> None:
    """Tear the process server down (tests / embedders); re-arms the
    default-off state and the live-metrics gate."""
    global _server
    with _lock:
        srv, _server = _server, None
        trace.set_live_metrics(False)
    if srv is not None:
        srv.stop()


def active_server() -> TelemetryServer | None:
    with _lock:
        return _server
