"""``rs serve`` — the resident encode/decode daemon (HTTP front end).

The port's copy of the JAX package's ``serve/daemon.py``: the same routes,
headers, status codes, knobs and on-disk results.  The daemon resolves its
device once, in the constructor (None: the current CUDA device, raising
with no GPU present; ``"cpu"`` only when asked), and carries that one
device into every api and store call it makes, so on the card every GEMM
of every route is K1.

One long-lived process in front of the warm plan cache (docs/SERVE.md):

* ``POST /encode?name=N&k=K&n=TOTAL[&w=8|16][&strategy=S][&generator=G]
  [&checksum=0|1][&keep=1]`` — request body is the file bytes, streamed
  to a per-tenant spool under the daemon root and encoded into an
  archive there; JSON response lists the chunk files written.  The spool
  is unlinked after a successful encode unless ``keep=1`` — the daemon
  stores the ARCHIVE, so a later /decode is a real reconstruction.
* ``POST /decode?name=N`` — auto-decode (survivor discovery, CRC
  verification, degraded-decode ladder — docs/RESILIENCE.md) of the
  named archive; the response body streams the rebuilt file bytes.
* ``POST /scrub?name=N[&syndrome=1]`` — read-only health report
  (``api.scan_file``) as JSON.
* ``POST /update?name=N&at=OFF`` / ``POST /append?name=N`` — delta-
  parity partial-stripe writes against a stored archive
  (docs/UPDATE.md): the body is the replacement/append bytes, applied
  via ``api.update_file`` / ``api.append_file`` (only the touched
  segment columns move; crash-atomic journal + generation commit).
  They ride the same admission/DRR/deadline plane, costed by payload
  size; encode accepts ``layout=interleaved`` to create archives that
  take unbounded appends.
* ``PUT/GET/DELETE /o/<bucket>/<key>`` + ``GET /o/<bucket>?list`` —
  the object-store façade (docs/STORE.md): objects pack into shared
  stripe archives under the tenant's namespace, DRR-costed by object
  bytes.  Same-bucket PUTs harvested in one ``RS_SERVE_BATCH_MS``
  window commit as ONE grouped stripe append + ONE index fsync (the
  store's write-combining path), GET reconstructs just the object's
  byte range, DELETE tombstones + zeroes.  ``GET /o/<bucket>`` lists
  (``?stats=1`` for the space-accounting report).
* ``GET /healthz`` ``/metrics`` ``/stats`` — liveness JSON, Prometheus
  exposition of the live registry, queue/batcher introspection.
* ``GET /maint`` — the background-maintenance plane's state
  (docs/MAINT.md): ``maint=True`` / ``RS_MAINT`` / ``--maint`` start a
  :class:`~..maint.controller.MaintController` whose repair, scrub and
  compaction jobs are admitted through this daemon's DRR queue as the
  ``maint`` tenant (4x cost), under the foreground per-(tenant, name)
  lock of their target, on the daemon's own device, and run on a
  one-thread lane of their own rather than a foreground worker slot
  (a repair holding a slot shows in the foreground's tail).  ``--faults SPEC``
  activates the fault plane for the daemon's life.
* ``GET /perf`` — answers 501: the baseline/drift report's plane
  (obs/perfbase) is not ported yet.

Tenancy: ``X-RS-Tenant`` header (or ``?tenant=``) names the tenant —
its own namespace directory under the root AND its own fairness queue
(serve/queue.py).  ``X-RS-Deadline-Ms`` bounds how long the request may
wait+run; expired requests fail with 504 before touching the device.

Request flow: handler threads stream the body, admit into the bounded
:class:`~.queue.AdmissionQueue` (429 past ``RS_SERVE_DEPTH``, 503 while
draining), and block on the request future.  One scheduler thread pulls
fairness-ordered work through the :class:`~.batcher.Batcher` and hands
each shape-bucketed batch to a small executor pool
(``RS_SERVE_WORKERS``); batches run as fleets (shared warm executable +
one write-behind lane), falling back to per-request execution when a
fleet fails so one poisoned request — injected faults included — cannot
take its batchmates down or wedge the queue.  Graceful drain (SIGTERM /
SIGINT): stop admitting, flush the queue, let in-flight fleets commit
their ordered writes, then close the listener.

Security note: no authentication — bind loopback (the default) or
front with a real gateway.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..maint import controller as _maint
from ..obs import (
    health as _health,
    metrics as _metrics,
    reqtrace as _reqtrace,
    runlog as _runlog,
    slo as _slo,
    tracing as _tracing,
)
from ..utils.backend import resolve_device
from ..utils.timing import PhaseTimer
from . import objcache as _objcache
from .batcher import Batcher
from .queue import AdmissionQueue, Draining, QueueFull, Request

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,199}$")
_COPY_CHUNK = 1024 * 1024

DEFAULT_PORT = 9470
DEFAULT_REQUEST_TIMEOUT_S = 300.0
DEFAULT_MAX_BODY = 1 << 30
DEFAULT_LIST_LIMIT = 1000

_PERF_REFUSAL = "the perf-baseline plane (obs/perfbase) is not ported yet"


def list_limit_env() -> int:
    """Hard cap on one ``GET /o/<bucket>?list`` page
    (``RS_STORE_LIST_LIMIT``, default 1000, min 1): a 10⁷-key bucket
    never serializes whole into one response — pages chain through the
    opaque ``next`` cursor."""
    from ..utils.env import int_env

    return max(1, int_env("RS_STORE_LIST_LIMIT", DEFAULT_LIST_LIMIT))


def _safe_name(text: str | None, what: str) -> str:
    """One path component, no traversal: the only way request input ever
    reaches the filesystem."""
    if not text or not _NAME_RE.match(text) or ".." in text:
        raise ValueError(f"bad {what} {text!r}: want [A-Za-z0-9._-]+")
    return text


def _q1(query: dict, key: str, default: str | None = None) -> str | None:
    vals = query.get(key)
    return vals[0] if vals else default


class _ServeHTTPServer(ThreadingHTTPServer):
    # Explicit (HTTPServer already defaults this on): restart/drain paths
    # must rebind through TIME_WAIT without EADDRINUSE.
    allow_reuse_address = True
    daemon_threads = True
    # The listen backlog: socketserver's default of 5 resets connections
    # when tens of clients connect at once (a 64-request write burst);
    # admission control, not the accept queue, is what refuses work.
    request_queue_size = 128
    rs_daemon: "ServeDaemon"


class _Handler(BaseHTTPRequestHandler):
    server_version = "rs-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # loadgen hammers this — stay quiet
        pass

    @property
    def daemon(self) -> "ServeDaemon":
        return self.server.rs_daemon  # type: ignore[attr-defined]

    # -- response helpers ----------------------------------------------------

    def _send_json(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # EVERY response of a request-bearing path echoes the request id
        # (docs/SERVE.md "Request lifecycle") — 400/404/429/503/504/500
        # rejections included, so client logs stay joinable.
        rid = getattr(self, "_rs_req_id", None)
        if rid:
            self.send_header("X-RS-Request-Id", rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code: int, msg: str,
                         headers: dict | None = None, **extra) -> None:
        # Several error paths answer BEFORE consuming the request body;
        # under HTTP/1.1 keep-alive the unread bytes would be parsed as
        # the next request line.  Errors are rare — close the connection
        # rather than track which paths drained.
        self.close_connection = True
        self._send_json(code, {"ok": False, "error": msg, **extra},
                        headers)

    # -- GET -----------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        url = urlparse(self.path)
        if url.path.startswith("/o/"):
            # Object reads ARE requests in the lifecycle sense: DRR
            # cost = object bytes, queued like any other op.
            return self._object_request("GET", url)
        # Introspection GETs are not: clear any id a previous request
        # on this keep-alive connection left behind.
        self._rs_req_id = None
        try:
            if url.path == "/healthz":
                self._send_json(200, self.daemon.health())
            elif url.path == "/health":
                # Fleet durability report (obs/health.py): replay the
                # damage ledger, rank by stripe risk.  Distinct from
                # /healthz — that answers "is the daemon up", this
                # answers "which archives are closest to data loss".
                self._send_json(200, self.daemon.fleet_health())
            elif url.path == "/maint":
                # Maintenance-plane state (docs/MAINT.md): governor
                # pause/resume, job tallies, and a fresh work-queue
                # snapshot replayed from the damage ledger.
                self._send_json(200, self.daemon.maint_report())
            elif url.path == "/perf":
                self._send_error_json(501, _PERF_REFUSAL)
            elif url.path == "/metrics":
                # Rolling SLO windows age out without new traffic, so
                # the rs_slo_* gauges refresh at scrape time — and so do
                # scrub ages: the rs_durability_* gauges re-export too.
                # (The rs_perf_baseline_* refresh waits for obs/perfbase.)
                self.daemon.slo.export_gauges()
                self.daemon.export_fleet_health()
                body = _metrics.REGISTRY.render_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/stats":
                self._send_json(200, self.daemon.stats())
            elif url.path == "/slo":
                # Per-tenant attainment + burn rates (obs/slo.py); the
                # export also refreshes the rs_slo_* gauges.
                self._send_json(200, self.daemon.slo.export_gauges())
            elif url.path == "/debug/requests":
                query = parse_qs(url.query)
                try:
                    n = int(_q1(query, "n", "50") or 50)
                except ValueError:
                    n = 50
                self._send_json(200, {
                    "ring": _reqtrace.ring_capacity(),
                    "requests": _reqtrace.recent(n),
                })
            else:
                self._send_error_json(404, f"no such path {url.path}")
        except BrokenPipeError:
            pass

    # -- POST ----------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        query = parse_qs(url.query)
        # Request identity FIRST: the client's X-RS-Request-Id (when it
        # validates) or a minted one — echoed on every outcome path,
        # before any parsing can fail (obs/reqtrace.py).
        self._rs_req_id = _reqtrace.accept_request_id(
            self.headers.get("X-RS-Request-Id"))
        try:
            if url.path not in (
                "/encode", "/decode", "/scrub", "/update", "/append"
            ):
                self._send_error_json(404, f"no such path {url.path}")
                return
            try:
                req = self._admit(url.path[1:], query)
            except ValueError as e:  # bad name/tenant/params/body
                self._send_error_json(400, str(e))
                return
            if req is None:
                return  # error response already sent
            status = None
            try:
                status = self._respond(req)
            finally:
                # Ack boundary: response bytes written (or the client
                # went away — status None); fold the lifecycle event.
                self.daemon.finish_request(req, status)
        except BrokenPipeError:
            pass
        except Exception as e:  # defense: a handler bug must answer 500
            try:
                self._send_error_json(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    # -- object façade (/o/<bucket>[/<key>]) ---------------------------------

    def do_PUT(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if not url.path.startswith("/o/"):
            self._rs_req_id = _reqtrace.accept_request_id(
                self.headers.get("X-RS-Request-Id"))
            self._send_error_json(404, f"no such path {url.path}")
            return
        self._object_request("PUT", url)

    def do_DELETE(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if not url.path.startswith("/o/"):
            self._rs_req_id = _reqtrace.accept_request_id(
                self.headers.get("X-RS-Request-Id"))
            self._send_error_json(404, f"no such path {url.path}")
            return
        self._object_request("DELETE", url)

    def _object_request(self, method: str, url) -> None:
        """One /o/ request end to end: mint the id, admit (or answer the
        metadata paths inline), block on execution, respond, ack."""
        query = parse_qs(url.query)
        self._rs_req_id = _reqtrace.accept_request_id(
            self.headers.get("X-RS-Request-Id"))
        try:
            try:
                req = self._admit_object(method, url, query)
            except ValueError as e:
                self._send_error_json(400, str(e))
                return
            if req is None:
                return  # answered inline (list/stat) or error sent
            status = None
            try:
                status = self._respond(req)
            finally:
                self.daemon.finish_request(req, status)
        except BrokenPipeError:
            pass
        except Exception as e:  # defense: a handler bug must answer 500
            try:
                self._send_error_json(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def _admit_object(self, method: str, url, query) -> Request | None:
        from .. import store as _store

        daemon = self.daemon
        parts = [p for p in url.path.split("/") if p]  # ["o", bucket, key?]
        if len(parts) < 2 or len(parts) > 3:
            self._send_error_json(
                404, f"want /o/<bucket>[/<key>], got {url.path}")
            return None
        tenant = _safe_name(
            self.headers.get("X-RS-Tenant") or _q1(query, "tenant")
            or "default", "tenant")
        bucket = _safe_name(parts[1], "bucket")
        key = _safe_name(parts[2], "key") if len(parts) == 3 else None
        tenant_root = os.path.join(daemon.root, tenant)
        spool = daemon.tenant_path(tenant, bucket)  # the bucket dir
        deadline = None
        dl_ms = self.headers.get("X-RS-Deadline-Ms")
        if dl_ms is not None:
            deadline = time.monotonic() + max(0.0, float(dl_ms)) / 1000.0

        if method == "GET" and key is None:
            # Bucket listing/report: metadata only, answered inline —
            # it never touches the device or the stripe bytes.  Listing
            # is always paginated: one page caps at RS_STORE_LIST_LIMIT
            # (tighter with limit=), and ``next`` carries the opaque
            # cursor for the following page.
            try:
                b = _store.open_bucket(tenant_root, bucket,
                                       device=daemon.device)
                if _q1(query, "stats") == "1":
                    self._send_json(200, {"ok": True,
                                          "stats": b.stats()})
                else:
                    cap = list_limit_env()
                    raw_limit = _q1(query, "limit")
                    if raw_limit is not None and not raw_limit.isdigit():
                        self._send_error_json(
                            400, f"limit= must be an integer, got "
                            f"{raw_limit!r}")
                        return None
                    limit = min(cap, int(raw_limit)) if raw_limit \
                        else cap
                    page = b.list_page(
                        prefix=_q1(query, "prefix") or "",
                        limit=max(1, limit),
                        cursor=_q1(query, "cursor"),
                    )
                    self._send_json(200, {
                        "ok": True, "bucket": bucket,
                        "objects": page["objects"],
                        "truncated": page["truncated"],
                        "next": page["next"],
                    })
            except _store.ObjectNotFound as e:
                self._send_error_json(404, str(e))
            except (_store.ObjectStoreError, OSError, ValueError) as e:
                self._send_error_json(400, f"{type(e).__name__}: {e}")
            return None
        if key is None:
            self._send_error_json(
                404, f"{method} needs /o/<bucket>/<key>")
            return None

        if method == "PUT":
            for knob in ("k", "n", "w", "stripe_kb"):
                val = _q1(query, knob)
                if val is not None and not val.isdigit():
                    self._send_error_json(
                        400, f"{knob}= must be an integer, got {val!r}")
                    return None
            # Bucket-shape params validate at admission like /encode's:
            # a bad shape must 400 here, not 500 in the executor (or
            # silently create a default-shaped bucket from half a pair).
            k = int(_q1(query, "k", "0"))
            n = int(_q1(query, "n", "0"))
            if (k > 0) != (n > 0):
                self._send_error_json(
                    400, "pass k= and n= together (bucket shape at "
                    f"creation), got k={k or None} n={n or None}")
                return None
            if n and not n > k > 0:
                self._send_error_json(
                    400, f"need n > k > 0, got k={k} n={n}")
                return None
            w_q = int(_q1(query, "w", "0") or 0)
            if w_q not in (0, 8, 16):
                self._send_error_json(
                    400, f"w must be 8 or 16, got {w_q}")
                return None
            upload = f"{spool}.up.{daemon.next_upload_id()}"
            os.makedirs(os.path.dirname(upload), exist_ok=True)
            nbytes = self._read_body_to(upload)
            if nbytes == 0:
                os.unlink(upload)
                self._send_error_json(
                    400, "refusing an empty object body")
                return None
            req = Request(
                "object_put", tenant, bucket, spool, key=key,
                k=k, p=max(0, n - k), w=w_q,
                stripe_bytes=(int(_q1(query, "stripe_kb", "0")) * 1024
                              or None),
                cost=nbytes, deadline=deadline,
                req_id=self._rs_req_id,
            )
            req.upload = upload
        else:  # GET / DELETE of one object: cost = the object's bytes
            try:
                stat = _store.open_bucket(
                    tenant_root, bucket, device=daemon.device).stat(key)
            except _store.ObjectNotFound as e:
                self._send_error_json(404, str(e))
                return None
            except (_store.ObjectStoreError, OSError, ValueError) as e:
                self._send_error_json(400, f"{type(e).__name__}: {e}")
                return None
            req = Request(
                "object_get" if method == "GET" else "object_delete",
                tenant, bucket, spool, key=key, cost=stat["bytes"],
                deadline=deadline, req_id=self._rs_req_id,
            )

        _reqtrace.begin(req)
        try:
            daemon.queue.submit(req)
        except QueueFull as e:
            daemon.discard_upload(req)
            self._send_error_json(429, str(e), {"Retry-After": "1"})
            daemon.finish_request(req, 429)
            return None
        except Draining as e:
            daemon.discard_upload(req)
            self._send_error_json(503, str(e), {"Retry-After": "5"})
            daemon.finish_request(req, 503)
            return None
        return req

    def _read_body_to(self, spool: str) -> int:
        """Stream the request body to the spool file; returns byte count."""
        length = self.headers.get("Content-Length")
        if length is None:
            raise ValueError("Content-Length required (no chunked bodies)")
        remaining = int(length)
        if remaining > self.daemon.max_body:
            raise ValueError(
                f"body of {remaining} bytes exceeds RS_SERVE_MAX_BYTES="
                f"{self.daemon.max_body}")
        with open(spool, "wb") as fp:
            while remaining:
                block = self.rfile.read(min(_COPY_CHUNK, remaining))
                if not block:
                    raise ValueError("request body truncated")
                fp.write(block)
                remaining -= len(block)
        return int(length)

    def _admit(self, op: str, query: dict) -> Request | None:
        daemon = self.daemon
        tenant = _safe_name(
            self.headers.get("X-RS-Tenant") or _q1(query, "tenant")
            or "default", "tenant")
        name = _safe_name(_q1(query, "name"), "name")
        spool = daemon.tenant_path(tenant, name)
        deadline = None
        dl_ms = self.headers.get("X-RS-Deadline-Ms")
        if dl_ms is not None:
            deadline = time.monotonic() + max(0.0, float(dl_ms)) / 1000.0

        if op == "encode":
            k = int(_q1(query, "k", "0"))
            n = int(_q1(query, "n", "0"))
            if k <= 0 or n <= k:
                self._send_error_json(400, f"need n > k > 0, got k={k} n={n}")
                return None
            w = int(_q1(query, "w", "8"))
            if w not in (8, 16):
                self._send_error_json(400, f"w must be 8 or 16, got {w}")
                return None
            enc_layout = _q1(query, "layout", "row")
            if enc_layout not in ("row", "interleaved"):
                self._send_error_json(
                    400, f"layout must be row or interleaved, "
                    f"got {enc_layout!r}")
                return None
            # Per-request temp: concurrent same-name uploads must never
            # interleave bytes in one file.  The executor promotes it
            # onto the spool path under the per-name lock.
            upload = f"{spool}.up.{daemon.next_upload_id()}"
            nbytes = self._read_body_to(upload)
            if nbytes == 0:
                os.unlink(upload)
                self._send_error_json(400, "refusing to encode empty body")
                return None
            req = Request(
                "encode", tenant, name, spool, k=k, p=n - k, w=w,
                strategy=_q1(query, "strategy", "auto"),
                generator=_q1(query, "generator", "vandermonde"),
                checksums=_q1(query, "checksum", "1") != "0",
                keep=_q1(query, "keep", "0") == "1",
                layout=enc_layout, cost=nbytes, deadline=deadline,
                req_id=self._rs_req_id,
            )
            req.upload = upload
        elif op in ("update", "append"):
            # Partial-stripe write traffic (docs/UPDATE.md): the body is
            # the delta/append payload, spooled to a per-request temp;
            # shape key + DRR cost come from the body size and the
            # archive's own metadata (404s garbage names pre-queue).
            try:
                k, p, w, _total = daemon.archive_shape(spool)
            except FileNotFoundError:
                self._send_error_json(
                    404, f"no archive {name!r} for tenant {tenant!r}")
                return None
            except (OSError, ValueError) as e:
                self._send_error_json(400, f"unreadable archive: {e}")
                return None
            at = 0
            if op == "update":
                try:
                    at = int(_q1(query, "at", ""))
                except (TypeError, ValueError):
                    self._send_error_json(
                        400, "update needs an integer at= byte offset")
                    return None
            upload = f"{spool}.up.{daemon.next_upload_id()}"
            nbytes = self._read_body_to(upload)
            if nbytes == 0:
                os.unlink(upload)
                self._send_error_json(
                    400, f"refusing a zero-byte {op} payload")
                return None
            req = Request(
                op, tenant, name, spool, k=k, p=p, w=w,
                strategy=_q1(query, "strategy", "auto"),
                at=at, cost=nbytes, deadline=deadline,
                req_id=self._rs_req_id,
            )
            req.upload = upload
        else:
            # Drain any (bogus) body so the connection stays usable.
            length = int(self.headers.get("Content-Length") or 0)
            while length > 0:
                block = self.rfile.read(min(_COPY_CHUNK, length))
                if not block:
                    break
                length -= len(block)
            # Shape key + DRR cost from the archive's own metadata: tiny
            # read, and it 404s garbage names before they queue.
            try:
                k, p, w, total = daemon.archive_shape(spool)
            except FileNotFoundError:
                self._send_error_json(
                    404, f"no archive {name!r} for tenant {tenant!r}")
                return None
            except (OSError, ValueError) as e:
                self._send_error_json(400, f"unreadable archive: {e}")
                return None
            req = Request(
                op, tenant, name, spool, k=k, p=p, w=w,
                strategy=_q1(query, "strategy", "auto"),
                syndrome=_q1(query, "syndrome", "0") == "1",
                cost=total, deadline=deadline,
                req_id=self._rs_req_id,
            )

        _reqtrace.begin(req)  # lifecycle timeline anchored at admission
        try:
            daemon.queue.submit(req)
        except QueueFull as e:
            daemon.discard_upload(req)
            self._send_error_json(429, str(e), {"Retry-After": "1"})
            daemon.finish_request(req, 429)
            return None
        except Draining as e:
            daemon.discard_upload(req)
            self._send_error_json(503, str(e), {"Retry-After": "5"})
            daemon.finish_request(req, 503)
            return None
        return req

    def _respond(self, req: Request) -> int | None:
        """Send the response for an executed request; returns the HTTP
        status written (the ack-boundary emit's outcome field)."""
        if not req.done.wait(self.daemon.request_timeout_s):
            self._send_error_json(
                500, f"request timed out after "
                f"{self.daemon.request_timeout_s}s in the daemon")
            return 500
        base = {
            "ok": req.outcome == "ok",
            "op": req.op, "tenant": req.tenant, "name": req.name,
            "req_id": req.req_id,
            "batch": req.batch_size,
            "queue_wait_ms": round(req.queue_wait_s * 1e3, 3),
            "service_ms": round(req.service_s * 1e3, 3),
        }
        stages = _reqtrace.stage_offsets(req)
        if stages is not None:
            # The stage timeline so far (ack lands after this write):
            # offsets in ms since admission, consecutive and summing to
            # the request wall (docs/SERVE.md "Request lifecycle").
            base["stages_ms"] = {
                s: round(v * 1e3, 3) for s, v in stages.items()}
        if req.outcome == "expired":
            self._send_json(504, {
                **base, "error": "deadline exceeded before execution"})
            return 504
        elif req.outcome != "ok":
            from ..store import ObjectNotFound

            if isinstance(req.error, ObjectNotFound):
                # Raced by a DELETE between admission and execution:
                # a clean 404, not a daemon error.
                self._send_json(404, {**base, "error": str(req.error)})
                return 404
            self._send_json(500, {
                **base,
                "error": str(req.error),
                "error_type": type(req.error).__name__
                if req.error else None,
            })
            return 500
        elif req.op == "object_get":
            data: bytes = req.result
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-RS-Request-Id", req.req_id)
            # Read-plane verdicts (serve/objcache.py): which lane served
            # the bytes — loadgen captures read these per request.
            if req.cache is not None:
                self.send_header("X-RS-Cache", req.cache)
            if req.path is not None:
                self.send_header("X-RS-Read-Path", req.path)
            if stages is not None:
                self.send_header("X-RS-Stages", json.dumps(stages))
            self.end_headers()
            self.wfile.write(data)
            return 200
        elif req.op == "decode":
            out_path = req.result
            try:
                size = os.path.getsize(out_path)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(size))
                self.send_header("X-RS-Batch", str(req.batch_size))
                self.send_header("X-RS-Request-Id", req.req_id)
                if stages is not None:
                    # Decode streams bytes, not JSON — the breakdown
                    # rides a header so loadgen captures stay complete.
                    self.send_header("X-RS-Stages", json.dumps(stages))
                self.end_headers()
                with open(out_path, "rb") as fp:
                    while True:
                        block = fp.read(_COPY_CHUNK)
                        if not block:
                            break
                        self.wfile.write(block)
            finally:
                # The streamed copy is the response; the daemon keeps the
                # archive, not decode outputs.
                try:
                    os.unlink(out_path)
                except OSError:
                    pass
            return 200
        else:
            payload = dict(base)
            if req.op == "encode":
                payload["bytes"] = req.cost
                payload["files"] = [
                    os.path.basename(f) for f in (req.result or [])]
            elif req.op in ("update", "append"):
                payload["update"] = req.result  # the engine's op summary
            elif req.op in ("object_put", "object_delete"):
                payload["object"] = req.result  # location / tombstone
                payload["key"] = req.key
            else:  # scrub
                payload["report"] = req.result
            self._send_json(200, payload)
            return 200


class ServeDaemon:
    """The resident daemon: queue + batcher + scheduler + HTTP listener.

    Library surface (tests, loadgen --spawn): construct, :meth:`start`,
    talk HTTP to ``self.port``, then :meth:`close` (drains by default).
    """

    def __init__(self, root: str, *, port: int = 0, addr: str | None = None,
                 depth: int | None = None, quantum: int | None = None,
                 batch_ms: float | None = None, max_batch: int | None = None,
                 workers: int | None = None,
                 request_timeout_s: float | None = None,
                 max_body: int | None = None,
                 slo_spec: str | None = None,
                 obj_cache_bytes: int | None = None,
                 maint: bool | None = None, device=None):
        # The device comes first: a daemon that cannot run must fail
        # here, before it binds, not at its first request.
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.addr = addr if addr is not None else os.environ.get(
            "RS_SERVE_ADDR", "127.0.0.1")
        self.queue = AdmissionQueue(depth=depth, quantum=quantum)
        self.batcher = Batcher(self.queue, batch_ms=batch_ms,
                               max_batch=max_batch)
        self.workers = max(1, workers if workers is not None else int(
            os.environ.get("RS_SERVE_WORKERS", "2") or 2))
        self.request_timeout_s = (
            float(os.environ.get("RS_SERVE_TIMEOUT_S",
                                 DEFAULT_REQUEST_TIMEOUT_S))
            if request_timeout_s is None else request_timeout_s)
        self.max_body = (
            int(os.environ.get("RS_SERVE_MAX_BYTES", DEFAULT_MAX_BODY))
            if max_body is None else max_body)
        self._server = _ServeHTTPServer((self.addr, port), _Handler)
        self._server.rs_daemon = self
        self.port = self._server.server_address[1]
        self._pool: ThreadPoolExecutor | None = None
        # The maint tenant's own executor lane (one thread): a repair
        # admitted by the DRR queue runs beside the foreground's workers
        # instead of taking one of their slots for its whole duration.
        self._maint_pool: ThreadPoolExecutor | None = None
        self._serve_thread: threading.Thread | None = None
        self._sched_thread: threading.Thread | None = None
        # One slot per worker: the scheduler may not pop work out of the
        # admission queue faster than workers consume it — otherwise
        # requests pile invisibly in the executor's internal queue and
        # admission control (the 429 depth bound) never fires.
        self._slots = threading.Semaphore(self.workers)
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        # Per-(tenant, name) mutexes: all executor work on one archive
        # name serializes (concurrent same-name encodes would interleave
        # chunk .rs_tmp writes; a decode mid-encode would read a half-
        # committed archive).  Locks are never dropped — bounded by name
        # cardinality, two objects each.
        self._name_locks: dict[tuple, threading.Lock] = {}
        self._name_locks_guard = threading.Lock()
        self._upload_ids = itertools.count(1)
        # Per-tenant SLO objectives (obs/slo.py): RS_SLO by default,
        # --slo / slo_spec= override.  An empty engine costs nothing.
        self.slo = _slo.SLOEngine(spec=slo_spec)
        # Hot-object read cache (serve/objcache.py): consulted before
        # the windowed read lane on GET /o/; RS_OBJ_CACHE_BYTES caps it
        # (0 disables — every GET reports cache=bypass).
        self.objcache = _objcache.ObjectCache(obj_cache_bytes)
        # Background-maintenance plane (docs/MAINT.md): repair/scrub/
        # compaction jobs admitted through THIS queue as the maint
        # tenant, paced by the SLO burn-rate governor, on this daemon's
        # device.  Off unless RS_MAINT is set or the caller passes
        # maint=True (`rs serve --maint`); off means no controller
        # object, zero threads.
        self.maint = None
        if _maint.enabled() if maint is None else bool(maint):
            self.maint = _maint.MaintController(
                store_roots=self._maint_store_roots,
                # Restart-stable owner: a daemon that died mid-job and
                # came back on the same root reclaims its own leases.
                owner=f"{os.uname().nodename}:serve:{self.root}",
                slo_report=self.slo.export_gauges
                if self.slo.objectives else None,
                submit=self._submit_maint_job,
                device=self.device,
            )
        self._trace_cm = None  # daemon-lifetime RS_TRACE session
        self._started = time.time()
        self._closed = False
        self.requests_done = 0
        self.requests_failed = 0

    # -- paths / metadata ----------------------------------------------------

    def tenant_path(self, tenant: str, name: str) -> str:
        d = os.path.join(self.root, tenant)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def next_upload_id(self) -> int:
        return next(self._upload_ids)

    def _name_lock(self, key: tuple) -> threading.Lock:
        with self._name_locks_guard:
            lock = self._name_locks.get(key)
            if lock is None:
                lock = self._name_locks[key] = threading.Lock()
            return lock

    @contextlib.contextmanager
    def _locked_names(self, reqs: list[Request]):
        """Hold every distinct (tenant, name) lock of ``reqs`` — acquired
        in SORTED key order so concurrent fleets can never deadlock."""
        keys = sorted({(r.tenant, r.name) for r in reqs})
        with contextlib.ExitStack() as stack:
            for key in keys:
                stack.enter_context(self._name_lock(key))
            yield

    # -- maintenance plane (docs/MAINT.md) -----------------------------------

    def _maint_store_roots(self) -> list[str]:
        """Per-tenant dirs under the data root — where object-store
        buckets live (`/o/` routes open buckets at root/tenant/name)."""
        try:
            return [os.path.join(self.root, t)
                    for t in sorted(os.listdir(self.root))
                    if os.path.isdir(os.path.join(self.root, t))]
        except OSError:
            return []

    def _maint_lock_key(self, target: str) -> tuple:
        """The FOREGROUND (tenant, name) lock a maintenance job must
        hold: a repair of tenant alpha's archive excludes alpha's own
        writes to it, not just other maint jobs.  Targets outside the
        data root key on their absolute path."""
        rel = os.path.relpath(os.path.abspath(target), self.root)
        parts = rel.split(os.sep)
        if not rel.startswith("..") and len(parts) >= 2:
            return (parts[0], parts[1])
        return ("rs-maint", os.path.abspath(target))

    def _submit_maint_job(self, job, *, name: str, cost: int):
        """The controller's dispatch hook: wrap the job closure as an
        op="maint" request, admit it through the DRR queue (tenant =
        the maint tenant, cost pre-inflated by the controller), block
        until the executor ran it.  QueueFull/Draining surface as
        backpressure — the controller's pass stops and retries next
        interval instead of overwhelming a loaded daemon."""
        req = Request("maint", self.maint.tenant, name, "", cost=cost)
        req.job = job
        req.lock_key = self._maint_lock_key(name)
        try:
            self.queue.submit(req)
        except (QueueFull, Draining) as e:
            raise _maint.MaintBackpressure(str(e)) from e
        if not req.done.wait(timeout=600.0):
            raise TimeoutError(f"maint job on {name!r} did not finish")
        if req.outcome == "ok":
            return req.result
        if isinstance(req.error, BaseException):
            raise req.error
        raise RuntimeError(f"maint job outcome {req.outcome!r}")

    def maint_report(self) -> dict:
        """``GET /maint``: controller state + a fresh work-queue
        snapshot (the queue block replays the damage ledger per call —
        the same freshness contract as ``GET /health``)."""
        if self.maint is None:
            return {
                "kind": "rs_maint", "enabled": False,
                "error": "maintenance plane off (start with --maint or "
                "RS_MAINT=1)",
            }
        return {"kind": "rs_maint", "enabled": True,
                **self.maint.stats(include_queue=True)}

    @staticmethod
    def _promote_upload(req: Request) -> None:
        """Move the request's consistent upload temp onto the spool path
        (caller holds the name lock).  Idempotent — a fleet that failed
        after promotion reruns solo without an upload left to promote."""
        if req.upload is not None:
            os.replace(req.upload, req.spool)
            req.upload = None

    @staticmethod
    def discard_upload(req: Request) -> None:
        """Drop an upload temp that will never execute (admission reject,
        expired deadline)."""
        if req.upload is not None:
            try:
                os.unlink(req.upload)
            except OSError:
                pass
            req.upload = None

    @staticmethod
    def archive_shape(spool: str) -> tuple[int, int, int, int]:
        """(k, p, w, total_size) from the archive's .METADATA — the shape
        bucket and DRR cost of a decode/scrub request."""
        from ..utils.fileformat import metadata_file_name, read_archive_meta

        meta = read_archive_meta(metadata_file_name(spool))
        return (meta.native_num, meta.parity_num, meta.w,
                max(1, int(meta.total_size)))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeDaemon":
        # A daemon without metrics would serve an empty /metrics forever.
        _metrics.force_enable()
        # With RS_TRACE set, the daemon OWNS one lifetime trace session
        # (exported at close): per-op sessions join it (sessions are
        # reentrant), so one Perfetto file covers the whole serving run
        # and the ack-time request spans (obs/reqtrace.py) always find
        # an active tracer — per-op sessions would already be closed.
        if os.environ.get("RS_TRACE"):
            self._trace_cm = _tracing.session()
            self._trace_cm.__enter__()
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="rs-serve-exec")
        if self.maint is not None:
            self._maint_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rs-serve-maint")
        self._sched_thread = threading.Thread(
            target=self._schedule, name="rs-serve-sched", daemon=True)
        self._sched_thread.start()
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, name="rs-serve-http",
            daemon=True)
        self._serve_thread.start()
        if self.maint is not None:
            self.maint.start()
        return self

    def warm(self, k: int, p: int, *, w: int = 8, strategy: str = "auto",
             generator: str = "vandermonde",
             file_bytes: int | None = None) -> dict:
        """Build (and on the card capture) the encode plan for a shape
        bucket so the first real request doesn't pay it (api.warm_plan).
        ``file_bytes`` sizes the bucket like the expected requests will
        (small-file workloads hit small column buckets)."""
        from .. import api

        return api.warm_plan(k, p, w=w, strategy=strategy,
                             generator=generator, file_bytes=file_bytes,
                             device=self.device)

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain: stop admitting, flush the queue, wait for
        in-flight batches to commit their ordered writes.  Returns True
        when everything flushed inside ``timeout``."""
        _metrics.gauge("rs_serve_draining",
                       "1 while the daemon refuses new work").set(1)
        self.queue.drain()
        deadline = (time.monotonic() + timeout) if timeout else None
        if self._sched_thread is not None:
            self._sched_thread.join(
                None if deadline is None
                else max(0.0, deadline - time.monotonic()))
            if self._sched_thread.is_alive():
                return False
        with self._inflight_cond:
            while self._inflight:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        """Shut down: optional graceful drain, then stop the listener and
        join every thread (the restart path must be able to rebind)."""
        if self._closed:
            return
        self._closed = True
        if self.maint is not None:
            # Stop sourcing new maintenance jobs BEFORE the drain; an
            # in-flight job finishes inside it like any other request.
            self.maint.stop(wait=False)
        if drain:
            self.drain(timeout)
        else:
            self.queue.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=drain)
        if self._maint_pool is not None:
            self._maint_pool.shutdown(wait=drain)
        if self._serve_thread is not None:
            # shutdown() handshakes with a RUNNING serve_forever loop —
            # on a bound-but-never-started daemon it would block forever.
            self._server.shutdown()
        self._server.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5)
        if self._sched_thread is not None:
            self._sched_thread.join(5)
        if self._trace_cm is not None:
            # Export the daemon-lifetime trace after every thread that
            # could still be recording spans has joined.
            self._trace_cm.__exit__(None, None, None)
            self._trace_cm = None

    # -- introspection -------------------------------------------------------

    def health(self) -> dict:
        return {
            "ok": True,
            "role": "rs-serve",
            "uptime_s": round(time.time() - self._started, 3),
            "host": os.uname().nodename,
            "run": _runlog.run_id(),
            "backend": _runlog.backend_name(),
            "root": self.root,
            "draining": self.queue.draining,
            "queue_depth": self.queue.depth(),
            "inflight": self._inflight,
            "requests_done": self.requests_done,
            "requests_failed": self.requests_failed,
        }

    def fleet_health(self) -> dict:
        """``GET /health``: the risk-ranked fleet durability report
        (obs/health.py) replayed from the damage ledger.  Each call
        replays the current ledger — concurrent scrub appends are safe
        to read mid-write (whole-line O_APPEND records; the reader skips
        a torn tail) — and refreshes the ``rs_durability_*`` gauges."""
        if not _runlog.enabled():
            return {
                "kind": "rs_health", "enabled": False,
                "error": "no damage ledger (start the daemon with "
                "RS_RUNLOG set)",
            }
        state = _health.load()
        report = _health.fleet_report(state)
        report["enabled"] = True
        _health.export_metrics(report)
        return report

    def export_fleet_health(self) -> None:
        """Scrape-time refresh of the ``rs_durability_*`` gauges (the
        same pattern as the rs_slo_* export: scrub ages advance without
        new damage traffic, so /metrics re-derives them)."""
        if _runlog.enabled():
            try:
                _health.export_metrics(
                    _health.fleet_report(_health.load()))
            except Exception:
                pass  # exposition must not fail the scrape

    def stats(self) -> dict:
        # Warm-path facts next to the queue counters: which strategy
        # decisions this daemon is running on (measured / ledger-loaded)
        # and whether schedule compiles are being served by the
        # persistent store — the restart-latency story in one scrape
        # (docs/XOR.md "The persistent store").
        from .. import tune as _tune
        from ..ops import xor_gemm as _xg
        from ..update import group_stats as _group_stats

        return {
            "queue": self.queue.snapshot(),
            "batcher": self.batcher.snapshot(),
            "workers": self.workers,
            "inflight": self._inflight,
            "requests_done": self.requests_done,
            "requests_failed": self.requests_failed,
            "strategies": {
                "autotune_decisions": _tune.decisions(),
                "schedule_store": _xg.store_stats(),
            },
            # Write-combining facts (docs/UPDATE.md "Group commit"):
            # config (harvest window, per-group edit cap) next to the
            # live group-size / fsync tallies.
            "group_commit": {
                "window_ms": self.batcher.batch_ms,
                **_group_stats(),
            },
            # Object-store façade health (docs/STORE.md): per-tenant
            # bucket accounting — objects, live/dead bytes, pending
            # compactions.  Open buckets report their live in-memory
            # view (O(archives), no log replay per scrape); buckets
            # this daemon never opened get the read-only disk probe.
            "store": self._store_block(),
            # Hot-object read cache (serve/objcache.py): the zipf A/B's
            # scrape target — hit-rate, resident bytes, evictions.
            "objcache": self.objcache.stats(),
            # Lifecycle plane config (docs/SERVE.md "Request lifecycle").
            "slo": {
                "configured": bool(self.slo.objectives),
                "objectives": [o.describe() for o in self.slo.objectives],
                "windows_s": list(self.slo.windows),
            },
            "reqtrace": {
                "enabled": _reqtrace.enabled(),
                "ring": _reqtrace.ring_capacity(),
            },
            # Background-maintenance plane (docs/MAINT.md): controller
            # state without the queue snapshot (a ledger replay) — that
            # lives on GET /maint, not in every /stats scrape.
            "maint": ({"enabled": True, **self.maint.stats()}
                      if self.maint is not None
                      else {"enabled": False}),
        }

    def _store_block(self) -> dict:
        from .. import store as _store

        tenants = {}
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            names = []
        for t in names:
            tdir = os.path.join(self.root, t)
            if not os.path.isdir(tdir):
                continue
            buckets = {}
            cold = []  # buckets this daemon never opened
            for name in _store.list_buckets(tdir):
                b = _store.cached_bucket(tdir, name)
                if b is None:
                    cold.append(name)
                    continue
                # Live in-memory view — no on-disk log replay per
                # scrape (a monitoring poller must stay O(archives)).
                s = b.stats()
                buckets[name] = {
                    "objects": s["objects"],
                    "archives": len(s["archives"]),
                    "live_bytes": s["live_bytes"],
                    "dead_bytes": s["dead_bytes"],
                    "index_records": s["index_records"],
                    "index_active_records": s["index_active_records"],
                    "open": s["open"],
                    "pending_drops": 0,  # resolved at load by contract
                    "pending_journals": 0,
                    "pending_compactions": s["pending_compactions"],
                    "config": s["config"],
                }
            if cold:
                probed = _store.probe(tdir)["buckets"]
                for name in cold:
                    if name in probed:
                        buckets[name] = probed[name]
            if buckets:
                tenants[t] = buckets
        return {
            "tenants": tenants,
            "knobs": {
                "RS_STORE_STRIPE_BYTES": _store.stripe_bytes_env(),
                "RS_STORE_COMPACT_DEAD_FRAC": _store.compact_dead_frac(),
                "RS_STORE_SNAPSHOT_RECORDS":
                    _store.snapshot_records_env(),
                "RS_STORE_LIST_LIMIT": list_limit_env(),
            },
        }

    # -- scheduling / execution ----------------------------------------------

    def _schedule(self) -> None:
        while True:
            batches = self.batcher.next_batches(timeout=0.25)
            if batches:
                for group in batches:
                    with self._inflight_cond:
                        self._inflight += len(group)
                    if group[0].op == "maint" and self._maint_pool is not None:
                        # The controller runs one job at a time, so the
                        # lane is free whenever the queue yields a job.
                        self._maint_pool.submit(self._run_group, group, False)
                        continue
                    self._slots.acquire()  # blocks until a worker frees
                    self._pool.submit(self._run_group, group)
                continue
            if self.queue.draining and not self.queue.depth():
                return  # drained dry — scheduler done

    def finish_request(self, req: Request, status: int | None) -> None:
        """The ack boundary, called by the HANDLER after the response
        bytes are written (admission rejections included): stamp ``ack``,
        fold the wide lifecycle event (ring + ledger + stage quantiles +
        trace spans — obs/reqtrace.py), and feed the SLO engine with the
        user-visible wall (admission to response)."""
        now = time.monotonic()
        _reqtrace.mark(req, "ack", now)
        _reqtrace.emit(req, status=status)
        if status is not None:
            # status None = the CLIENT went away mid-response (broken
            # pipe): no user-visible outcome exists, and an impatient
            # load generator must not burn the daemon's availability
            # budget — the wide event above still records the abort
            # (outcome with status null).
            self.slo.observe(req.tenant, req.op, now - req.arrival,
                             ok=(status == 200), t=now)

    @staticmethod
    def _mark_device_done(req: Request, timer: PhaseTimer) -> None:
        """Derived device/drain boundary for the pipelined file ops:
        their writes OVERLAP compute (write-behind, docs/IO.md), so no
        single instant separates the two — the stamp is now minus the
        op's accumulated write-phase wall, clamped to the dispatch stamp
        so the timeline stays monotonic.  The write-group path stamps
        the true boundary instead (update/group.py stage hook)."""
        if req.stages is None or not timer.enabled:
            return
        now = time.monotonic()
        write_s = sum(v for name, v in timer.acc.items()
                      if name.startswith("write") and name.endswith("(io)"))
        _reqtrace.mark(req, "device_done",
                       min(now, max(req.t_dispatch, now - write_s)))

    def _finish(self, req: Request, outcome: str, result=None,
                error: BaseException | None = None) -> None:
        now = time.monotonic()
        # Service time stamped directly at the execution boundary, not
        # derived by subtraction: dispatch -> completion, EXCLUDING the
        # batch-form/slot waits and the response write (the old
        # arrival-minus-queue-wait formula folded both in, overstating
        # device time for every batched request).
        if req.t_dispatch:
            req.service_s = now - req.t_dispatch
            _reqtrace.mark(req, "drain_done", now)
        else:  # never dispatched (expired in the batch window)
            req.service_s = 0.0
        _metrics.counter(
            "rs_serve_requests_total", "serve requests by outcome",
        ).labels(op=req.op, tenant=req.tenant, outcome=outcome).inc()
        _metrics.quantile(
            "rs_serve_request_wall_seconds",
            "request wall (admission to completion), streaming quantiles",
        ).labels(op=req.op).observe(time.monotonic() - req.arrival)
        _metrics.quantile(
            "rs_serve_queue_wait_seconds",
            "time spent waiting for admission-queue dispatch",
        ).labels(op=req.op).observe(req.queue_wait_s)
        with self._inflight_cond:  # executor threads race these counters
            if outcome == "ok":
                self.requests_done += 1
            else:
                self.requests_failed += 1
        req.finish(outcome, result=result, error=error)

    def _run_group(self, group: list[Request], slot: bool = True) -> None:
        """Execute one batch; ``slot``: it holds a foreground worker slot
        (every batch but a maint job on the maint lane)."""
        try:
            _metrics.histogram(
                "rs_serve_batch_size",
                "requests coalesced per shape-bucketed batch",
                buckets=(1, 2, 4, 8, 16, 32, 64),
            ).observe(len(group))
            now = time.monotonic()
            live: list[Request] = []
            for req in group:
                if req.expired(now):
                    self.discard_upload(req)
                    self._finish(req, "expired", error=TimeoutError(
                        "deadline exceeded before execution"))
                else:
                    req.batch_size = len(group)
                    live.append(req)
            if not live:
                return
            t_disp = time.monotonic()
            for req in live:
                # Execution starts here — the service_s anchor (always
                # stamped; the stage dict only when the plane is on).
                req.t_dispatch = t_disp
                _reqtrace.mark(req, "dispatch", t_disp)
            if len(live) > 1 and live[0].op == "object_put":
                # Object write combining (docs/STORE.md): the shape key
                # pins these to one (tenant, bucket), so the window's
                # harvest commits as ONE grouped stripe append + ONE
                # index fsync — a PUT burst costs one journal fsync
                # chain and one stacked E·Δ GEMM.
                if self._run_object_put_group(live):
                    return
                _metrics.counter(
                    "rs_serve_batch_fallbacks_total",
                    "batches degraded to per-request execution",
                ).inc()
            if len(live) > 1 and live[0].op in ("update", "append"):
                # Write combining (docs/UPDATE.md "Group commit"): the
                # shape key pins these to one (tenant, archive), so the
                # window's harvest executes as ONE group-committed batch
                # under the per-name lock — one journal fsync chain, one
                # metadata rewrite, one generation bump — and every
                # request acks only after that commit point.
                if self._run_write_group(live):
                    return
                _metrics.counter(
                    "rs_serve_batch_fallbacks_total",
                    "batches degraded to per-request execution",
                ).inc()
            distinct = len({(r.tenant, r.name) for r in live})
            if (len(live) > 1 and distinct == len(live)
                    and live[0].op in ("encode", "decode")):
                # Duplicate (tenant, name) members force the solo path:
                # a fleet would encode one spool twice (or collapse two
                # decodes onto one output); solo runs serialize them
                # under the per-name lock with per-seq outputs.
                if self._run_fleet(live):
                    return
                # Fleet is fail-fast: one poisoned request aborts the
                # batch.  Isolation fallback — rerun each request solo so
                # only the truly failing one reports an error.
                _metrics.counter(
                    "rs_serve_batch_fallbacks_total",
                    "batches degraded to per-request execution",
                ).inc()
            for req in live:
                self._run_solo(req)
        except BaseException as e:  # scheduler must survive anything
            for req in group:
                if not req.done.is_set():
                    self.discard_upload(req)
                    self._finish(req, "error", error=e)
        finally:
            if slot:
                self._slots.release()
            with self._inflight_cond:
                self._inflight -= len(group)
                self._inflight_cond.notify_all()

    def _run_write_group(self, live: list[Request]) -> bool:
        """One group-committed update/append batch for same-archive write
        requests, forced into a SINGLE all-or-nothing group
        (``group_edits=len(edits)`` overrides ``RS_UPDATE_GROUP_WINDOW``)
        so a failed batch provably committed nothing.  Returns True when
        every request finished here; False when the caller should fall
        back to per-request isolation (a single bad edit — e.g. an
        out-of-range offset — must only fail its own request).  Fallback
        is only safe when the archive's generation did not move under the
        failed call — otherwise a solo re-run would apply already-
        committed edits twice (e.g. the journal unlink failing AFTER the
        commit point), so those requests fail with the truth instead."""
        from .. import api
        from ..utils.fileformat import metadata_file_name, read_archive_meta

        ordered = sorted(live, key=lambda r: r.seq)  # submission order
        edits = [
            {"op": r.op, "at": r.at, "src": r.upload} if r.op == "update"
            else {"op": "append", "src": r.upload}
            for r in ordered
        ]
        lead = ordered[0]
        # Group <-> request-id join (docs/SERVE.md "Request lifecycle"):
        # ONE group id covers the whole combined commit; every member
        # still acks under its own request id, and the group engine tags
        # its dispatch span + summary with the group id so the commit is
        # attributable from either side.
        group_id = f"wg-{_reqtrace.new_request_id()}"
        for r in ordered:
            r.group_id = group_id

        def _stage(stage: str) -> None:
            now = time.monotonic()
            for r in ordered:
                _reqtrace.mark(r, stage, now)

        def _generation():
            try:
                return read_archive_meta(
                    metadata_file_name(lead.spool)).generation
            except Exception:
                return None

        try:
            with self._name_lock((lead.tenant, lead.name)):
                gen0 = _generation()
                try:
                    summary = api.update_file_many(
                        lead.spool, edits, strategy=lead.strategy,
                        device=self.device,
                        group_edits=len(edits), group_tag=group_id,
                        stage_hook=_stage,
                    )
                except Exception as e:
                    # Fall back ONLY on proof nothing committed: both
                    # generation reads succeeded and match.  gen0
                    # unreadable proves the DAEMON'S read failed, not
                    # that update_file_many's did — a transient error
                    # there plus a post-commit failure would make a solo
                    # re-run double-apply.
                    if gen0 is not None and _generation() == gen0:
                        for r in ordered:  # rerun solo — not this group
                            r.group_id = None
                        return False
                    for r in ordered:
                        self.discard_upload(r)
                        self._finish(r, "error", error=e)
                    return True
        except Exception:
            for r in ordered:
                r.group_id = None
            return False
        for r in ordered:
            self.discard_upload(r)
            self._finish(r, "ok",
                         result={**summary, "grouped": len(ordered),
                                 "group_id": group_id})
        return True

    def _object_bucket(self, req: Request):
        from .. import store as _store

        return _store.open_bucket(
            os.path.join(self.root, req.tenant), req.name,
            create=req.op == "object_put",
            k=req.k or None, p=req.p or None, w=req.w or None,
            stripe_bytes=req.stripe_bytes, device=self.device,
        )

    @staticmethod
    def _object_payload(req: Request) -> bytes:
        with open(req.upload, "rb") as fp:
            return fp.read()

    def _object_get(self, req: Request) -> bytes:
        """GET /o/ read plane: consult the hot-object cache BEFORE the
        windowed read lane (caller holds the per-name lock, so the
        verdict cannot race a same-name write).  A hit is as checked as
        a miss — the cached location must equal the CURRENT index entry
        and the bytes re-verify their CRC32 (serve/objcache.py); a miss
        reads through store/readpath.py and fills the cache with the
        exact entry it served."""
        cache = self.objcache
        bucket = self._object_bucket(req)
        if not cache.enabled:
            req.cache = "bypass"
            info: dict = {}
            data = bucket.get(req.key, info=info)
            req.path = info.get("path")
            return data
        entry = bucket.entry_for(req.key)  # ObjectNotFound -> clean 404
        data = cache.get(req.tenant, req.name, req.key, entry)
        if data is not None:
            req.cache, req.path = "hit", "cached"
            _metrics.counter(
                "rs_serve_device_dispatches_avoided_total",
                "requests served without touching the device read lane",
            ).labels(op="object_get").inc()
            return data
        info = {}
        data = bucket.get(req.key, info=info)
        req.cache, req.path = "miss", info.get("path")
        served = info.get("entry")
        if served is not None:
            cache.put(req.tenant, req.name, req.key, served, data)
        return data

    def _run_object_put_group(self, live: list[Request]) -> bool:
        """One put_many batch for a same-bucket PUT harvest (submission
        order; later duplicate keys win, like sequential PUTs).
        All-or-nothing by construction — put_many commits nothing on
        failure — so the isolation fallback (return False) can always
        rerun members solo without double-applies."""
        from ..update.engine import SimulatedCrash

        ordered = sorted(live, key=lambda r: r.seq)
        group_id = f"og-{_reqtrace.new_request_id()}"
        for r in ordered:
            r.group_id = group_id
        try:
            with self._name_lock((ordered[0].tenant, ordered[0].name)):
                bucket = self._object_bucket(ordered[0])
                items = [(r.key, self._object_payload(r))
                         for r in ordered]
                locations = bucket.put_many(items)
        except SimulatedCrash:
            raise  # chaos-only: not a fallback case, the disk is torn
        except Exception:
            for r in ordered:
                r.group_id = None
            return False
        for r, loc in zip(ordered, locations):
            self.objcache.invalidate(r.tenant, r.name, r.key)
            self.discard_upload(r)
            self._finish(r, "ok", result={
                **loc, "grouped": len(ordered), "group_id": group_id})
        return True

    def _run_fleet(self, live: list[Request]) -> bool:
        """One warm-executable fleet for a same-shape batch; False when it
        failed and the caller should fall back to solo isolation."""
        from .. import api

        lead = live[0]
        try:
            with self._locked_names(live):
                if lead.op == "encode":
                    for r in live:
                        self._promote_upload(r)
                    results = api.encode_fleet(
                        [r.spool for r in live], lead.k, lead.p,
                        generator=lead.generator, strategy=lead.strategy,
                        checksums=lead.checksums, w=lead.w,
                        layout=lead.layout, device=self.device,
                    )
                    for r in live:
                        self._finish_encode(r, results[r.spool])
                else:
                    outputs = {r.spool: self._decode_out(r)
                               for r in live}
                    results = api.decode_fleet(
                        [r.spool for r in live], outputs,
                        strategy=lead.strategy, device=self.device,
                    )
                    for r in live:
                        self._finish(r, "ok", result=results[r.spool])
            return True
        except Exception:
            # The no-wedge contract: the caller re-runs each request
            # solo, on the same device, and a request that fails there
            # answers 500 with its own error.
            return False

    @staticmethod
    def _decode_out(req: Request) -> str:
        # Unique per request: concurrent decodes of one archive must not
        # race on the output path (seq is admission-unique).
        return f"{req.spool}.out.{req.seq}"

    def _finish_encode(self, req: Request, files: list[str]) -> None:
        if not req.keep:
            try:
                os.unlink(req.spool)
            except OSError:
                pass
        self._finish(req, "ok", result=files)

    def _run_solo(self, req: Request) -> None:
        from .. import api

        # Phase accounting feeds the derived device/drain stage boundary
        # (_mark_device_done); disabled with the lifecycle plane so the
        # hot path pays nothing extra when telemetry is off.
        timer = PhaseTimer(enabled=req.stages is not None)
        try:
            if req.op == "maint":
                # Maintenance job closure (docs/MAINT.md): runs under
                # the FOREGROUND (tenant, name) lock of its target so a
                # repair excludes that archive's own writes; errors land
                # in the generic handler like any other op (no-wedge).
                with self._name_lock(req.lock_key
                                     or (req.tenant, req.name)):
                    result = req.job()
                self._finish(req, "ok", result=result)
                return
            with self._name_lock((req.tenant, req.name)):
                if req.op == "encode":
                    self._promote_upload(req)
                    files = api.encode_file(
                        req.spool, req.k, req.p,
                        generator=req.generator,
                        strategy=req.strategy, checksums=req.checksums,
                        w=req.w, layout=req.layout, timer=timer,
                        device=self.device,
                    )
                    self._mark_device_done(req, timer)
                    self._finish_encode(req, files)
                elif req.op == "decode":
                    out = api.auto_decode_file(
                        req.spool, self._decode_out(req),
                        strategy=req.strategy, timer=timer,
                        device=self.device,
                    )
                    self._mark_device_done(req, timer)
                    self._finish(req, "ok", result=out)
                elif req.op == "object_put":
                    bucket = self._object_bucket(req)
                    loc = bucket.put(req.key, self._object_payload(req))
                    self.objcache.invalidate(req.tenant, req.name,
                                             req.key)
                    self._mark_device_done(req, timer)
                    self.discard_upload(req)
                    self._finish(req, "ok", result=loc)
                elif req.op == "object_get":
                    data = self._object_get(req)
                    self._mark_device_done(req, timer)
                    self._finish(req, "ok", result=data)
                elif req.op == "object_delete":
                    bucket = self._object_bucket(req)
                    out = bucket.delete(req.key)
                    self.objcache.invalidate(req.tenant, req.name,
                                             req.key)
                    self._mark_device_done(req, timer)
                    self._finish(req, "ok", result=out)
                elif req.op in ("update", "append"):
                    # The upload temp IS the payload (never promoted onto
                    # the spool — the archive's chunks are the target).
                    if req.op == "update":
                        summary = api.update_file(
                            req.spool, req.at, src=req.upload,
                            strategy=req.strategy, timer=timer,
                            device=self.device,
                        )
                    else:
                        summary = api.append_file(
                            req.spool, src=req.upload,
                            strategy=req.strategy, timer=timer,
                            device=self.device,
                        )
                    self._mark_device_done(req, timer)
                    self.discard_upload(req)
                    self._finish(req, "ok", result=summary)
                else:  # scrub
                    report = api.scan_file(req.spool,
                                           syndrome=req.syndrome,
                                           device=self.device)
                    self._finish(req, "ok", result=report)
        except Exception as e:
            # Bounded per-request failure (injected faults land here after
            # the retry plane gave up): 500 for THIS request, queue moves
            # on — the no-wedge contract.
            self.discard_upload(req)
            self._finish(req, "error", error=e)


def main(argv=None) -> int:
    """The ``rs serve`` subcommand."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs serve",
        description="Resident multi-tenant encode/decode daemon: "
        "POST /encode /decode /scrub, admission control, cross-request "
        "batching, graceful drain on SIGTERM (docs/SERVE.md).",
    )
    ap.add_argument("--root", default=None,
                    help="data root (default $RS_SERVE_ROOT or "
                    "./rs_serve_root); one namespace dir per tenant")
    ap.add_argument("--port", type=int, default=None,
                    help=f"bind port (default $RS_SERVE_PORT or "
                    f"{DEFAULT_PORT}; 0 = ephemeral)")
    ap.add_argument("--addr", default=None,
                    help="bind address (default $RS_SERVE_ADDR or "
                    "127.0.0.1 — no auth, keep it local)")
    ap.add_argument("--depth", type=int, default=None,
                    help="admission depth (default $RS_SERVE_DEPTH or 64)")
    ap.add_argument("--batch-ms", type=float, default=None,
                    help="coalescing window (default $RS_SERVE_BATCH_MS "
                    "or 5)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="batch size cap (default $RS_SERVE_MAX_BATCH "
                    "or 16)")
    ap.add_argument("--workers", type=int, default=None,
                    help="executor threads (default $RS_SERVE_WORKERS "
                    "or 2)")
    ap.add_argument("--warm", metavar="K,N[,W[,BYTES]]", action="append",
                    default=[],
                    help="build the encode plan for shape "
                    "K,N[,W] before listening, bucket-sized for BYTES-"
                    "sized files when given (repeatable)")
    ap.add_argument("--faults", metavar="SPEC", default=None,
                    help="activate the deterministic fault plane for the "
                    "daemon's lifetime (same grammar as RS_FAULTS; "
                    "docs/RESILIENCE.md)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="per-tenant SLO objectives (same grammar as "
                    "RS_SLO, e.g. 'default:encode:p99=250ms,avail=99.9'; "
                    "GET /slo reports attainment + burn rates)")
    ap.add_argument("--maint", action="store_true",
                    help="run the background-maintenance plane (repair/"
                    "scrub/compaction as a throttled tenant; also "
                    "RS_MAINT=1 — docs/MAINT.md)")
    ap.add_argument("--device", default=None,
                    help="where every GEMM runs (default: the CUDA device; "
                    "without a GPU pass --device cpu)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    root = args.root or os.environ.get("RS_SERVE_ROOT") or "rs_serve_root"
    if args.port is None:
        try:
            args.port = int(os.environ.get("RS_SERVE_PORT", DEFAULT_PORT))
        except ValueError:
            print(f"rs serve: RS_SERVE_PORT="
                  f"{os.environ['RS_SERVE_PORT']!r} is not a port",
                  file=sys.stderr)
            return 2

    fault_ctx = contextlib.nullcontext()
    if args.faults:
        from ..resilience import faults as _faults

        try:
            plan = _faults.parse_plan(args.faults, seed=_faults.env_seed())
        except ValueError as e:
            print(f"rs serve: bad --faults spec: {e}", file=sys.stderr)
            return 2
        fault_ctx = _faults.activate(plan)
    with fault_ctx:
        return _serve_until_signal(args, root)


def _serve_until_signal(args, root: str) -> int:
    """``rs serve`` once its flags are parsed: run the daemon until
    SIGTERM/SIGINT, then drain."""
    try:
        daemon = ServeDaemon(
            root, port=args.port, addr=args.addr, depth=args.depth,
            batch_ms=args.batch_ms, max_batch=args.max_batch,
            workers=args.workers, slo_spec=args.slo,
            maint=True if args.maint else None, device=args.device,
        )
    except _slo.SLOSpecError as e:
        print(f"rs serve: bad --slo/RS_SLO spec: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        # No device to run on.
        print(f"rs serve: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"rs serve: cannot bind: {e}", file=sys.stderr)
        return 1

    stop = threading.Event()

    def _on_signal(signum, frame):
        # Handler just flags; the drain (device flushes, ordered commits)
        # runs on the main thread below.
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    daemon.start()
    for spec in args.warm:
        try:
            parts = [int(x) for x in spec.split(",")]
        except ValueError:
            parts = []
        if len(parts) < 2 or parts[1] <= parts[0]:
            print(f"rs serve: bad --warm {spec!r} "
                  "(want K,N[,W[,BYTES]], n > k)", file=sys.stderr)
            daemon.close(drain=False)
            return 2
        daemon.warm(parts[0], parts[1] - parts[0],
                    w=parts[2] if len(parts) > 2 else 8,
                    file_bytes=parts[3] if len(parts) > 3 else None)
    print(f"rs serve: listening on http://{daemon.addr}:{daemon.port} "
          f"(root {daemon.root}, depth {daemon.queue.max_depth}, "
          f"batch {daemon.batcher.batch_ms}ms x{daemon.batcher.max_batch}, "
          f"{daemon.workers} workers, {daemon.device}"
          f"{', maint on' if daemon.maint is not None else ''}) "
          f"— SIGTERM drains", file=sys.stderr)
    try:
        stop.wait()
    finally:
        print("rs serve: draining...", file=sys.stderr)
        daemon.close(drain=True)
        print(f"rs serve: drained ({daemon.requests_done} ok, "
              f"{daemon.requests_failed} failed, "
              f"{daemon.queue.rejected} rejected)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
