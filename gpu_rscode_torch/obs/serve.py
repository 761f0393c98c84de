"""Live telemetry endpoint — stdlib-only HTTP exposition for long runs.

The port's copy of the JAX package's ``obs/serve.py``: the same names,
knobs, records and payloads.

A fleet job that encodes for hours is invisible between its start and its
final ``--metrics-json`` dump.  This module makes the process scrapeable
WHILE it works, with nothing beyond ``http.server``:

- ``GET /metrics``  — Prometheus text exposition of the live registry
  (the same bytes ``rs stats --text`` prints), ``text/plain; version=0.0.4``;
- ``GET /healthz``  — liveness JSON: ok, uptime, host, run id, backend;
- ``GET /runs[?n=N]`` — the last N records of the persistent run ledger
  (obs/runlog.py) as a JSON array — the fleet's recent-history tail.

Two surfaces start it:

- ``rs serve-metrics --port P``  — a foreground server for this process;
- ``RS_METRICS_PORT=P``          — any ``rs`` file operation starts the
  server on a daemon thread for the run's duration, so a scraper can
  watch a long encode live.  Both imply metrics collection
  (``force_enable`` — an endpoint over an empty registry is noise).

The server binds ``RS_METRICS_ADDR`` (default ``0.0.0.0`` — the point is
cross-host scraping; set ``127.0.0.1`` to keep it local).  Port 0 picks an
ephemeral port (tests); the bound port is on ``server.server_address``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import metrics as _metrics, runlog as _runlog

_START_TIME = time.time()


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server(): where /runs reads its ledger.
    runlog_path: str | None = None

    server_version = "rs-metrics/1"

    def log_message(self, fmt, *args):  # scrapes every 15s — stay quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                body = _metrics.REGISTRY.render_text().encode()
                # version=0.0.4 is the Prometheus text-format identifier.
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/healthz":
                body = json.dumps({
                    "ok": True,
                    "uptime_s": round(time.time() - _START_TIME, 3),
                    "host": os.uname().nodename,
                    "run": _runlog.run_id(),
                    "backend": _runlog.backend_name(),
                    "metrics_enabled": _metrics.enabled(),
                }).encode()
                self._send(200, body, "application/json")
            elif url.path == "/runs":
                ledger = self.runlog_path or _runlog.path()
                if not ledger:
                    self._send(404, b'{"error": "no run ledger (RS_RUNLOG)"}',
                               "application/json")
                    return
                try:
                    n = int(parse_qs(url.query).get("n", ["50"])[0])
                except ValueError:
                    n = 50
                if n <= 0:  # [-0:] would return the WHOLE ledger
                    n = 50
                body = json.dumps(_runlog.tail(ledger, n)).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")
        except BrokenPipeError:
            pass  # scraper hung up mid-response; nothing to salvage


class _MetricsHTTPServer(ThreadingHTTPServer):
    # Explicit SO_REUSEADDR (HTTPServer's default, pinned here because
    # the restart paths depend on it): back-to-back CLI ops and the serve
    # daemon's restart must rebind through TIME_WAIT, not EADDRINUSE.
    allow_reuse_address = True
    daemon_threads = True


def make_server(port: int, runlog_path: str | None = None,
                addr: str | None = None) -> ThreadingHTTPServer:
    """Build (bind, don't run) the exposition server.  A per-server
    handler subclass carries the ledger path so concurrent servers in one
    process (tests) don't share state through the class attribute."""
    handler = type("_BoundHandler", (_Handler,),
                   {"runlog_path": runlog_path})
    addr = addr if addr is not None else os.environ.get(
        "RS_METRICS_ADDR", "0.0.0.0")
    return _MetricsHTTPServer((addr, port), handler)


def start(port: int, runlog_path: str | None = None,
          addr: str | None = None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread; returns the bound server
    (``server.server_address[1]`` is the real port when ``port=0``).
    Implies metrics collection — an exposition endpoint over a disabled
    registry would scrape empty forever.  The bind comes FIRST: a failed
    bind must not leave collection latched on as a side effect."""
    server = make_server(port, runlog_path, addr)
    _metrics.force_enable()
    thread = threading.Thread(
        target=server.serve_forever, name="rs-metrics-server", daemon=True
    )
    # The handle stop() joins — a shutdown that doesn't join the serving
    # thread leaves the socket lingering into the next bind.
    server._rs_thread = thread
    thread.start()
    return server


def stop(server: ThreadingHTTPServer | None) -> None:
    """Shut a :func:`start`-ed server down COMPLETELY: stop serving,
    close the listening socket, and join the daemon thread, so the port
    is immediately rebindable (back-to-back in-process CLI ops, the
    serve daemon's restart path, test teardowns).  Safe on None."""
    global _ENV_SERVER
    if server is None:
        return
    server.shutdown()
    server.server_close()
    thread = getattr(server, "_rs_thread", None)
    if thread is not None:
        thread.join(timeout=5)
    if server is _ENV_SERVER:
        _ENV_SERVER = None


_ENV_SERVER: ThreadingHTTPServer | None = None
_ENV_LOCK = threading.Lock()


def maybe_start_from_env() -> ThreadingHTTPServer | None:
    """Start the endpoint when ``RS_METRICS_PORT`` is set (the hook the
    CLI calls before every file operation); None otherwise or when the
    port cannot bind (warn, don't fail the run — the endpoint is
    observability).

    One server per process: a second call while the first still serves
    returns the existing server instead of failing the bind — the
    EADDRINUSE fix for back-to-back in-process CLI ops (tests,
    embedders) under one exported ``RS_METRICS_PORT``.  :func:`stop`
    clears the slot so the port can be re-bound deliberately."""
    global _ENV_SERVER
    port = os.environ.get("RS_METRICS_PORT")
    if not port:
        return None
    with _ENV_LOCK:
        if _ENV_SERVER is not None:
            # Reuse only a LIVE server: one that was shut down behind our
            # back (server_close leaves fileno() == -1) must not satisfy
            # the lookup forever.
            try:
                if _ENV_SERVER.socket.fileno() >= 0:
                    return _ENV_SERVER
            except (OSError, ValueError):
                pass
            _ENV_SERVER = None
        try:
            _ENV_SERVER = start(int(port))
            return _ENV_SERVER
        except (OSError, ValueError) as e:
            import warnings

            warnings.warn(
                f"RS_METRICS_PORT={port!r}: endpoint not started: {e}",
                stacklevel=2,
            )
            return None
