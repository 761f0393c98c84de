"""``rs loadgen`` — open-loop load harness for the serve daemon.

The port's copy of the JAX package's ``serve/loadgen.py``: the same
arrival plan for the same seed, the same request mix and the same capture
rows.  ``device`` (``--device``) is where a spawned daemon and the A/B
arms run; None means the CUDA device and raises with no GPU present.
The maintenance A/B (``--maint-ab``, :func:`run_maint_ab`) runs two
daemons on that device, and ``--faults`` with ``--spawn`` activates the
fault plane in the spawned daemon's process for the run.

Serving performance needs a generator that does NOT slow down when the
server does: arrivals follow a seeded Poisson process (exponential
inter-arrival gaps at ``--rate`` requests/s), each fired on its own
thread at its scheduled instant regardless of how many predecessors are
still in flight — the open-loop discipline that exposes queueing
collapse, which closed-loop (wait-for-response) drivers mask.  Offered
vs achieved throughput plus client-side latency percentiles
(obs/percentile.py estimators — the same math as the Quantile metric
kind) land in a ``bench_captures/serve_*.jsonl`` capture via the shared
``capture_header`` identity envelope, so serving joins the BENCH
trajectory (``rs history`` reads it like any other capture).

Per-tenant mixes: ``--tenants alpha:3,beta:1`` weights arrivals; each
tenant alternates encode and decode-of-what-it-encoded per ``--mix``.

``--ab`` mode answers the residency question directly: encode the same
``--files`` small files once through a warm resident daemon and once as
one CLI subprocess per file (process start, CUDA init, kernel load and a
cold plan cache every time — today's deployment model), and records the
margin.  Both arms run on ``--device``.

``--spawn`` runs an in-process daemon on an ephemeral port (CI smoke,
A/B resident arm); ``--url`` points at an external one.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from ..obs import runlog as _runlog
from ..obs.percentile import QuantileEstimator

_PKG_PARENT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# Per-request rows retained for the capture (request ids + stage
# breakdowns): bounded so a long run cannot balloon the capture file.
_MAX_REQUEST_ROWS = 5000


class _Recorder:
    """Thread-safe per-(tenant, op) outcome and latency accumulator,
    plus the per-request id/stage rows the capture commits."""

    def __init__(self):
        self._lock = threading.Lock()
        self.cells: dict[tuple, dict] = {}
        self.requests: list[dict] = []
        self.request_rows_dropped = 0

    def _cell(self, tenant: str, op: str) -> dict:
        key = (tenant, op)
        cell = self.cells.get(key)
        if cell is None:
            cell = self.cells[key] = {
                "sent": 0, "ok": 0, "rejected": 0, "failed": 0,
                "bytes": 0, "lat": QuantileEstimator(),
            }
        return cell

    def record(self, tenant: str, op: str, status: int | None,
               wall_s: float, nbytes: int,
               detail: dict | None = None) -> None:
        with self._lock:
            cell = self._cell(tenant, op)
            cell["sent"] += 1
            if status == 200:
                cell["ok"] += 1
                cell["bytes"] += nbytes
                cell["lat"].observe(wall_s)
            elif status in (429, 503):
                cell["rejected"] += 1
            else:
                cell["failed"] += 1
            if len(self.requests) < _MAX_REQUEST_ROWS:
                self.requests.append({
                    "kind": "serve_request", "tenant": tenant, "op": op,
                    "status": status, "wall_s": round(wall_s, 6),
                    **(detail or {}),
                })
            else:
                self.request_rows_dropped += 1

    def rows(self) -> list[dict]:
        from ..obs.percentile import state_quantiles

        out = []
        with self._lock:
            for (tenant, op), cell in sorted(self.cells.items()):
                q = state_quantiles(cell["lat"].state())
                out.append({
                    "kind": "serve_tenant", "tenant": tenant, "op": op,
                    "sent": cell["sent"], "ok": cell["ok"],
                    "rejected": cell["rejected"],
                    "failed": cell["failed"], "bytes": cell["bytes"],
                    "latency_s": {
                        key: round(val, 6) if val is not None else None
                        for key, val in q.items()
                    },
                })
        return out

    def totals(self) -> dict:
        with self._lock:
            agg = {"sent": 0, "ok": 0, "rejected": 0, "failed": 0,
                   "bytes": 0}
            for cell in self.cells.values():
                for key in agg:
                    agg[key] += cell[key]
        return agg


def _post(url: str, tenant: str, body: bytes | None = None,
          timeout: float = 120.0, method: str = "POST",
          ) -> tuple[int | None, bytes, dict]:
    req = urllib.request.Request(
        url, data=body if body is not None else b"", method=method,
        headers={"X-RS-Tenant": tenant})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        payload = e.read()
        headers = dict(e.headers or {})
        e.close()
        return e.code, payload, headers
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        # transport failure — counted failed
        return None, str(e).encode(), {}


def _request_detail(payload: bytes, headers: dict,
                    json_body: bool) -> dict:
    """Request id + stage breakdown for the capture's per-request row:
    JSON responses carry ``req_id``/``stages_ms``/``group_id`` in the
    body, decode streams carry ``X-RS-Request-Id``/``X-RS-Stages``
    headers (stage offsets in seconds since admission)."""
    out: dict = {}
    rid = headers.get("X-RS-Request-Id")
    if rid:
        out["req_id"] = rid
    # object_get read-plane verdicts (serve/objcache.py): which lane
    # served the bytes — the zipf cache A/B validator reads hit-rate
    # straight from these capture rows.
    cache = headers.get("X-RS-Cache")
    if cache:
        out["cache"] = cache
    path = headers.get("X-RS-Read-Path")
    if path:
        out["path"] = path
    if json_body:
        try:
            doc = json.loads(payload)
        except ValueError:
            return out
        if isinstance(doc, dict):
            out.setdefault("req_id", doc.get("req_id"))
            if isinstance(doc.get("stages_ms"), dict):
                out["stages"] = {s: round(v / 1e3, 6)
                                 for s, v in doc["stages_ms"].items()}
            upd = doc.get("update")
            if isinstance(upd, dict) and upd.get("group_id"):
                out["group_id"] = upd["group_id"]
            obj = doc.get("object")
            if isinstance(obj, dict) and obj.get("group_id"):
                # Object PUT write-combining join (og-* ids).
                out["group_id"] = obj["group_id"]
    else:
        stages = headers.get("X-RS-Stages")
        if stages:
            try:
                out["stages"] = json.loads(stages)
            except ValueError:
                pass
    return out


def _scrape_json(base_url: str, path: str) -> dict:
    """One GET of a daemon introspection endpoint as JSON."""
    with urllib.request.urlopen(
            base_url.rstrip("/") + path, timeout=30) as resp:
        return json.loads(resp.read())


def _parse_tenants(spec: str) -> list[tuple[str, float]]:
    out = []
    for token in spec.split(","):
        name, _, weight = token.partition(":")
        out.append((name.strip() or "default",
                    float(weight) if weight else 1.0))
    if not out or any(w <= 0 for _, w in out):
        raise ValueError(f"bad --tenants spec {spec!r}")
    return out


def _schedule(duration_s: float, rate: float, tenants, decode_frac: float,
              seed: int, update_frac: float = 0.0,
              object_frac: float = 0.0) -> list:
    """The full open-loop arrival plan, drawn up front (seeded — the same
    offered load replays exactly).  ``update_frac`` mixes in partial-
    stripe writes (``POST /update`` of a small random range of an
    archive the tenant already encoded); ``object_frac`` mixes in
    object-façade traffic (``PUT``/``GET /o/<bucket>/<key>`` against a
    zipf-hot key space — docs/STORE.md) — the millions-of-small-objects
    workload class."""
    rng = random.Random(seed)
    names = [t for t, _ in tenants]
    weights = [w for _, w in tenants]
    plan = []
    t = 0.0
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            return plan
        tenant = rng.choices(names, weights)[0]
        roll = rng.random()
        if roll < object_frac:
            op = "object"
        elif roll < object_frac + decode_frac:
            op = "decode"
        elif roll < object_frac + decode_frac + update_frac:
            op = "update"
        else:
            op = "encode"
        plan.append((t, tenant, op))


def _zipf_weights(keys: int, s: float) -> list[float]:
    """Unnormalized zipf(s) rank weights over ``keys`` keys — the
    classic hot-key object workload (a few keys take most traffic)."""
    return [1.0 / (r + 1) ** s for r in range(keys)]


def run_open_loop(base_url: str, *, duration_s: float, rate: float,
                  tenants: list[tuple[str, float]], size_bytes: int,
                  k: int, p: int, w: int = 8, decode_frac: float = 0.3,
                  update_frac: float = 0.0, edit_burst: int = 1,
                  object_frac: float = 0.0, object_bytes: int = 4096,
                  object_keys: int = 256, object_zipf: float = 1.1,
                  object_burst: int = 1,
                  seed: int = 0, quiet: bool = False) -> dict:
    """Drive the daemon at ``base_url``; returns the summary document.

    ``edit_burst`` > 1 fires that many concurrent small ``/update``
    requests per update arrival, all against the same archive — they land
    inside one ``RS_SERVE_BATCH_MS`` harvest window, so the daemon's
    write-combining path (docs/UPDATE.md "Group commit") executes them as
    one group-committed batch and the per-request p50/p99 shows the
    amortized durability chain."""
    plan = _schedule(duration_s, rate, tenants, decode_frac, seed,
                     update_frac, object_frac)
    rec = _Recorder()
    # One shared payload buffer per size (arrival threads must not spend
    # their schedule slot generating bytes); per-request uniqueness comes
    # from the name, and decode correctness is the daemon tests' job —
    # the harness measures.
    body = random.Random(seed ^ 0x5EED).randbytes(size_bytes)
    encoded: dict[str, list[str]] = {t: [] for t, _ in tenants}
    enc_lock = threading.Lock()

    delta_len = max(1, min(4096, size_bytes))
    delta_body = random.Random(seed ^ 0xDE17A).randbytes(delta_len)

    # Object workload state: a zipf-hot key space per tenant; a key's
    # first arrival PUTs it, later arrivals GET (mostly) or re-PUT.
    # Payload is keyed so a GET's bytes are verifiable regardless of
    # how many re-PUTs raced: rows record status only.
    obj_weights = _zipf_weights(object_keys, object_zipf)
    obj_put: dict[tuple, bool] = {}
    obj_lock = threading.Lock()
    obj_body = random.Random(seed ^ 0x0B1EC7).randbytes(
        max(1, object_bytes))

    def fire(i: int, tenant: str, op: str) -> None:
        if op == "object":
            # Deterministic per-arrival key draw from the zipf weights.
            krng = random.Random((seed << 20) ^ i)
            kidx = krng.choices(range(object_keys), obj_weights)[0]
            key = f"k{kidx:05d}"
            with obj_lock:
                seen = obj_put.get((tenant, key), False)
            do_put = (not seen) or krng.random() < 0.3
            t0 = time.monotonic()
            if do_put:
                def one_put(j: int, pkey: str) -> None:
                    t1 = time.monotonic()
                    status, payload, hdrs = _post(
                        f"{base_url}/o/lg{seed}/{pkey}", tenant,
                        obj_body, method="PUT")
                    rec.record(tenant, "object_put", status,
                               time.monotonic() - t1, len(obj_body),
                               detail=_request_detail(payload, hdrs,
                                                      True))
                    if status == 200:
                        with obj_lock:
                            obj_put[(tenant, pkey)] = True
                if object_burst <= 1:
                    one_put(0, key)
                else:
                    # The salvo lands in one daemon harvest window, so
                    # the bucket's write combining commits it as ONE
                    # grouped stripe append (docs/STORE.md).
                    burst = [threading.Thread(
                        target=one_put,
                        args=(j, f"k{(kidx + j) % object_keys:05d}"),
                        daemon=True) for j in range(object_burst)]
                    for th in burst:
                        th.start()
                    for th in burst:
                        th.join(timeout=180)
            else:
                status, payload, hdrs = _post(
                    f"{base_url}/o/lg{seed}/{key}", tenant, None,
                    method="GET")
                rec.record(tenant, "object_get", status,
                           time.monotonic() - t0,
                           len(payload) if status == 200 else 0,
                           detail=_request_detail(payload, hdrs,
                                                  status != 200))
            return
        if op in ("decode", "update"):
            with enc_lock:
                pool = encoded[tenant]
                name = pool[i % len(pool)] if pool else None
            if name is None:
                op = "encode"  # nothing of ours to write against yet
        if op == "encode":
            name = f"lg{seed}_{tenant}_{i}.bin"
            t0 = time.monotonic()
            status, payload, hdrs = _post(
                f"{base_url}/encode?name={name}&k={k}&n={k + p}&w={w}",
                tenant, body)
            rec.record(tenant, "encode", status,
                       time.monotonic() - t0, size_bytes,
                       detail=_request_detail(payload, hdrs, True))
            if status == 200:
                with enc_lock:
                    encoded[tenant].append(name)
        elif op == "update":
            # A small hot write against a large cold archive — the
            # workload class rs update exists for.  Deterministic offset
            # per (arrival, burst) index keeps the run replayable.
            def one_edit(j: int) -> None:
                at = ((i * 7919) + j * 4099) % max(
                    1, size_bytes - delta_len + 1)
                t0 = time.monotonic()
                status, payload, hdrs = _post(
                    f"{base_url}/update?name={name}&at={at}", tenant,
                    delta_body)
                rec.record(tenant, "update", status,
                           time.monotonic() - t0, delta_len,
                           detail=_request_detail(payload, hdrs, True))
            if edit_burst <= 1:
                one_edit(0)
            else:
                # The burst fires concurrently so the whole salvo lands
                # in one daemon harvest window (write combining).
                burst = [threading.Thread(target=one_edit, args=(j,),
                                          daemon=True)
                         for j in range(edit_burst)]
                for th in burst:
                    th.start()
                for th in burst:
                    th.join(timeout=180)
        else:
            t0 = time.monotonic()
            status, payload, hdrs = _post(f"{base_url}/decode?name={name}",
                                          tenant)
            rec.record(tenant, "decode", status,
                       time.monotonic() - t0,
                       len(payload) if status == 200 else 0,
                       detail=_request_detail(payload, hdrs,
                                              status != 200))

    threads = []
    t_start = time.monotonic()
    for i, (t_arr, tenant, op) in enumerate(plan):
        delay = t_start + t_arr - time.monotonic()
        if delay > 0:
            time.sleep(delay)  # open loop: fire on schedule, never on
            # completion — laggards pile up in flight instead of
            # throttling the offered load
        th = threading.Thread(target=fire, args=(i, tenant, op),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=180)
    wall = time.monotonic() - t_start
    totals = rec.totals()
    summary = {
        "kind": "serve_summary",
        "duration_s": round(wall, 3),
        "offered_rps": round(len(plan) / duration_s, 3),
        "achieved_rps": round(totals["ok"] / wall, 3) if wall else None,
        "achieved_gbps": round(totals["bytes"] / wall / 1e9, 6)
        if wall else None,
        **totals,
        "config": {"k": k, "n": k + p, "w": w,
                   "size_bytes": size_bytes, "rate": rate,
                   "decode_frac": decode_frac,
                   "update_frac": update_frac,
                   "edit_burst": edit_burst,
                   "object_frac": object_frac,
                   "object_bytes": object_bytes,
                   "object_keys": object_keys,
                   "object_zipf": object_zipf,
                   "object_burst": object_burst, "seed": seed,
                   "tenants": dict(tenants)},
    }
    if rec.request_rows_dropped:
        # No silent caps: the capture must say when per-request rows
        # were bounded away.
        summary["request_rows_dropped"] = rec.request_rows_dropped
    if not quiet:
        print(f"loadgen: offered {summary['offered_rps']} rps -> "
              f"achieved {summary['achieved_rps']} rps "
              f"({totals['ok']} ok / {totals['rejected']} rejected / "
              f"{totals['failed']} failed)", file=sys.stderr)
    return {"summary": summary, "tenants": rec.rows(),
            "requests": rec.requests}


# -- A/B: resident daemon vs CLI-subprocess-per-file --------------------------

def _cli_env() -> dict:
    """Subprocess env for the per-file CLI arm: this package's checkout on
    the path and nothing else inherited; the device goes on the command
    line (``--device``), so both arms run where the caller asked."""
    return {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", ""),
        "PYTHONPATH": _PKG_PARENT,
    }


def run_ab(*, files: int, size_bytes: int, k: int, p: int, w: int = 8,
           workdir: str, quiet: bool = False, device=None) -> list[dict]:
    """Encode ``files`` small files through (a) one warm resident daemon
    and (b) one CLI subprocess per file, both on ``device``; returns the
    two arm rows plus the margin row.  The subprocess arm pays CUDA init
    and the kernel load per file: that is what the A/B measures."""
    from .daemon import ServeDaemon

    rng = random.Random(20260804)
    paths = []
    for i in range(files):
        path = os.path.join(workdir, f"ab_{i}.bin")
        with open(path, "wb") as fp:
            fp.write(rng.randbytes(size_bytes))
        paths.append(path)

    rows = []

    # Arm A — resident: spawn, warm the shape bucket, then time the
    # whole run of sequential HTTP encodes (spool upload included; the
    # daemon pays its compile during warm(), like any long-lived server).
    daemon = ServeDaemon(os.path.join(workdir, "serve_root"), port=0,
                         device=device)
    daemon.start()
    try:
        daemon.warm(k, p, w=w, file_bytes=size_bytes)
        base = f"http://127.0.0.1:{daemon.port}"
        per_file = []
        t0 = time.monotonic()
        for i, path in enumerate(paths):
            with open(path, "rb") as fp:
                body = fp.read()
            t1 = time.monotonic()
            status, _, _ = _post(
                f"{base}/encode?name=ab_{i}.bin&k={k}&n={k + p}&w={w}",
                "ab", body)
            per_file.append(time.monotonic() - t1)
            if status != 200:
                raise RuntimeError(f"resident encode {i} failed: {status}")
        wall_a = time.monotonic() - t0
    finally:
        daemon.close(drain=True, timeout=60)
    rows.append(_ab_row("resident", files, size_bytes, wall_a, per_file,
                        k, p, w))

    # Arm B — today's model: a fresh `rs` CLI process per file (process
    # start, CUDA init, kernel load and a cold plan cache, every file).
    dev_arg = ["--device", str(daemon.device)]
    per_file = []
    t0 = time.monotonic()
    for path in paths:
        t1 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "gpu_rscode_torch", "-k", str(k),
             "-n", str(k + p), "--width", str(w), "--checksum",
             "--quiet", "-e", path, *dev_arg],
            env=_cli_env(), cwd=_PKG_PARENT,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        per_file.append(time.monotonic() - t1)
        if proc.returncode != 0:
            raise RuntimeError(
                f"subprocess encode failed: {proc.stderr.decode()[-500:]}")
    wall_b = time.monotonic() - t0
    rows.append(_ab_row("subprocess", files, size_bytes, wall_b, per_file,
                        k, p, w))

    margin = wall_b / wall_a if wall_a else None
    rows.append({
        "kind": "serve_ab_margin", "files": files,
        "size_bytes": size_bytes,
        "resident_wall_s": round(wall_a, 3),
        "subprocess_wall_s": round(wall_b, 3),
        "speedup": round(margin, 3) if margin else None,
    })
    if not quiet:
        print(f"loadgen A/B: resident {wall_a:.2f}s vs subprocess "
              f"{wall_b:.2f}s over {files} files -> "
              f"{margin:.1f}x", file=sys.stderr)
    return rows


def _ab_row(arm: str, files: int, size_bytes: int, wall: float,
            per_file: list[float], k: int, p: int, w: int) -> dict:
    from ..obs.percentile import quantile_of

    return {
        "kind": "serve_ab", "arm": arm, "files": files,
        "size_bytes": size_bytes, "wall_s": round(wall, 3),
        "files_per_s": round(files / wall, 3) if wall else None,
        "per_file_p50_s": round(quantile_of(per_file, 0.5), 4),
        "per_file_p99_s": round(quantile_of(per_file, 0.99), 4),
        "config": {"k": k, "n": k + p, "w": w},
    }


# -- A/B: object façade vs one-archive-per-object ------------------------------

def run_object_ab(*, files: int, object_bytes: int, k: int, p: int,
                  w: int = 8, batch: int = 64, trials: int = 3,
                  workdir: str, quiet: bool = False,
                  device=None) -> list[dict]:
    """The façade's raison d'être, measured: store ``files`` small
    objects once through one bucket (PUT batches of ``batch`` — the
    write-combining unit a daemon harvest forms) and once as one
    archive per object (today's model: per-object metadata, k+p chunk
    files, its own commit).  Paired best-of-``trials`` per arm (the
    repo's A/B idiom — fs/scheduler noise at 4 KiB op sizes swings
    single runs ±40%), EVERY object of EVERY trial byte-verified
    outside the timed regions; the per-archive arm's file-count
    amplification is recorded alongside the walls."""
    from .. import api
    from .. import store as _store

    rng = random.Random(20260804)
    payloads = [rng.randbytes(max(1, object_bytes)) for _ in range(files)]

    # Warm the plan cache OUTSIDE both timed regions (a resident
    # process pays its compiles once; the A/B measures steady state):
    # one per-archive-shaped encode for arm B, one same-batch-shaped
    # put_many for arm A (stripe-create encode + grouped-append E·Δ
    # both hit their real plan buckets).
    warmdir = os.path.join(workdir, "warm")
    os.makedirs(warmdir, exist_ok=True)
    wseed = os.path.join(warmdir, "warm.bin")
    with open(wseed, "wb") as fp:
        fp.write(rng.randbytes(max(1, object_bytes)))
    api.encode_file(wseed, k, p, w=w, checksums=True,
                    layout="interleaved", device=device)
    wb = _store.open_bucket(
        warmdir, "warmbkt", create=True, k=k, p=p, w=w,
        stripe_bytes=max(1 << 20, 16 * object_bytes * batch),
        device=device)
    wpay = [(f"w{j}", rng.randbytes(max(1, object_bytes)))
            for j in range(batch)]
    wb.put_many(wpay)  # stripe create (encode lane)
    wb.put_many(wpay)  # grouped append (E*delta lane)

    walls_a, walls_b = [], []
    files_a = files_b = 0
    for trial in range(max(1, trials)):
        # Arm A — the façade: batched PUTs into shared stripes.
        root = os.path.join(workdir, f"store_root_{trial}")
        t0 = time.monotonic()
        bucket = _store.open_bucket(
            root, "ab", create=True, k=k, p=p, w=w,
            stripe_bytes=max(1 << 20, 16 * object_bytes * batch),
            device=device)
        for lo in range(0, files, batch):
            bucket.put_many([
                (f"o{i:06d}", payloads[i])
                for i in range(lo, min(lo + batch, files))
            ])
        walls_a.append(time.monotonic() - t0)
        for i in range(files):  # byte-verify OUTSIDE the timed region
            if bucket.get(f"o{i:06d}") != payloads[i]:
                raise RuntimeError(
                    f"facade arm verification failed at {i}")
        files_a = sum(len(fs) for _, _, fs in os.walk(root))

        # Arm B — one archive per object.
        perdir = os.path.join(workdir, f"per_archive_{trial}")
        os.makedirs(perdir, exist_ok=True)
        t0 = time.monotonic()
        for i in range(files):
            path = os.path.join(perdir, f"o{i:06d}.bin")
            with open(path, "wb") as fp:
                fp.write(payloads[i])
            api.encode_file(path, k, p, w=w, checksums=True,
                            layout="interleaved", device=device)
            os.unlink(path)  # the archive stores it now, like arm A
        walls_b.append(time.monotonic() - t0)
        files_b = sum(len(fs) for _, _, fs in os.walk(perdir))
        for i in range(files):  # byte-verify EVERY archive, like arm A
            probe = os.path.join(perdir, f"o{i:06d}.bin")
            out = api.auto_decode_file(probe, probe + ".dec",
                                       device=device)
            ok = open(out, "rb").read() == payloads[i]
            os.unlink(out)
            if not ok:
                raise RuntimeError(
                    f"per-archive arm verification failed at {i}")

    wall_a, wall_b = min(walls_a), min(walls_b)
    rows = [
        {
            "kind": "object_ab", "arm": "facade", "files": files,
            "object_bytes": object_bytes, "batch": batch,
            "wall_s": round(wall_a, 4),
            "trial_walls_s": [round(wl, 4) for wl in walls_a],
            "objects_per_s": round(files / wall_a, 2) if wall_a
            else None,
            "disk_files": files_a, "verified": True,
            "config": {"k": k, "n": k + p, "w": w},
        },
        {
            "kind": "object_ab", "arm": "per_archive", "files": files,
            "object_bytes": object_bytes,
            "wall_s": round(wall_b, 4),
            "trial_walls_s": [round(wl, 4) for wl in walls_b],
            "objects_per_s": round(files / wall_b, 2) if wall_b
            else None,
            "disk_files": files_b, "verified": True,
            "config": {"k": k, "n": k + p, "w": w},
        },
    ]
    margin = wall_b / wall_a if wall_a else None
    rows.append({
        "kind": "object_ab_margin", "files": files,
        "object_bytes": object_bytes, "batch": batch,
        "trials": max(1, trials),
        "facade_wall_s": round(wall_a, 4),
        "per_archive_wall_s": round(wall_b, 4),
        "speedup": round(margin, 2) if margin else None,
        "disk_files_facade": files_a,
        "disk_files_per_archive": files_b,
    })
    if not quiet:
        print(f"loadgen object A/B: facade {wall_a:.2f}s vs "
              f"per-archive {wall_b:.2f}s over {files} x "
              f"{object_bytes} B (best of {max(1, trials)}) -> "
              f"{margin:.1f}x ({files_a} vs {files_b} files on disk)",
              file=sys.stderr)
    return rows


# -- A/B: zipf GETs with vs without the daemon object cache --------------------

def run_object_cache_ab(*, objects: int, object_bytes: int, gets: int,
                        k: int, p: int, w: int = 8, zipf: float = 1.1,
                        trials: int = 3, cache_bytes: int | None = None,
                        workdir: str, quiet: bool = False,
                        device=None) -> list[dict]:
    """The hot-object read cache, measured end to end: the SAME seeded
    zipf GET stream over the SAME PUT corpus through two daemons — one
    with the cache at its configured capacity, one with it disabled
    (``obj_cache_bytes=0``, every GET pays the windowed read lane).
    Best-of-``trials`` walls per arm (the repo's paired A/B idiom);
    EVERY GET of EVERY trial is byte-verified against a local mirror,
    so a wrong cached byte cannot hide inside a fast number.  A third
    small-cap pass (capacity = 4 objects) proves the LRU actually
    evicts under pressure.  Per-arm rows carry the verdict counts from
    the ``X-RS-Cache`` header, the hot-key (top-decile rank) read-lane
    avoidance rate, and the daemon's own ``objcache`` stats block."""
    from .daemon import ServeDaemon
    from ..obs.percentile import quantile_of

    rng = random.Random(20260806)
    payloads = {f"c{r:05d}": rng.randbytes(max(1, object_bytes))
                for r in range(objects)}
    weights = _zipf_weights(objects, zipf)
    draw_rng = random.Random(20260806 ^ 0x21BF)
    draws = [f"c{r:05d}"
             for r in draw_rng.choices(range(objects), weights, k=gets)]
    hot = {f"c{r:05d}" for r in range(max(1, objects // 10))}

    def run_arm(arm: str, cap: int | None, arm_gets: list[str],
                arm_trials: int) -> dict:
        # batch_ms=0: object GETs are solo batches (queue.py shape_key),
        # so the coalescing window is a flat latency tax on BOTH arms
        # that drowns the read-lane delta this A/B exists to measure.
        daemon = ServeDaemon(os.path.join(workdir, f"cab_{arm}"),
                             port=0, obj_cache_bytes=cap, batch_ms=0,
                             device=device)
        daemon.start()
        try:
            base = f"http://127.0.0.1:{daemon.port}"
            for key, data in payloads.items():  # corpus load — untimed
                status, payload, _ = _post(f"{base}/o/cab/{key}", "cab",
                                           data, method="PUT")
                if status != 200:
                    raise RuntimeError(
                        f"{arm} corpus PUT {key} failed: {status} "
                        f"{payload[-200:]!r}")
            verdicts = {"hit": 0, "miss": 0, "bypass": 0}
            hot_gets = hot_hits = 0
            walls, trial_lats = [], []
            for _ in range(max(1, arm_trials)):
                lats = []
                t0 = time.monotonic()
                for key in arm_gets:
                    t1 = time.monotonic()
                    status, payload, hdrs = _post(
                        f"{base}/o/cab/{key}", "cab", None, method="GET")
                    lats.append(time.monotonic() - t1)
                    if status != 200 or payload != payloads[key]:
                        raise RuntimeError(
                            f"{arm} GET {key} wrong: status {status}")
                    verdict = hdrs.get("X-RS-Cache", "bypass")
                    verdicts[verdict] = verdicts.get(verdict, 0) + 1
                    if key in hot:
                        hot_gets += 1
                        hot_hits += verdict == "hit"
                walls.append(time.monotonic() - t0)
                trial_lats.append(lats)
            lats = trial_lats[walls.index(min(walls))]
            stats = daemon.stats().get("objcache", {})
        finally:
            daemon.close(drain=True, timeout=60)
        return {
            "kind": "object_cache_ab", "arm": arm, "objects": objects,
            "object_bytes": object_bytes, "gets": len(arm_gets),
            "wall_s": round(min(walls), 4),
            "trial_walls_s": [round(wl, 4) for wl in walls],
            "get_p50_s": round(quantile_of(lats, 0.5), 6),
            "get_p99_s": round(quantile_of(lats, 0.99), 6),
            "verdicts": verdicts,
            "hot_gets": hot_gets, "hot_hits": hot_hits,
            "hot_avoid_rate": round(hot_hits / hot_gets, 4)
            if hot_gets else None,
            "verified": True, "objcache": stats,
            "config": {"k": k, "n": k + p, "w": w, "zipf": zipf,
                       "trials": max(1, arm_trials),
                       "cap_bytes": cap},
        }

    row_on = run_arm("cache_on", cache_bytes, draws, trials)
    row_off = run_arm("cache_off", 0, draws, trials)

    # Eviction proof: capacity for only 4 objects, one pass over a
    # cold-heavy draw (uniform — maximal churn) MUST evict.
    small_cap = max(1, 4 * max(1, object_bytes))
    ev_rng = random.Random(20260806 ^ 0xE71C)
    ev_draws = [f"c{r:05d}" for r in
                (ev_rng.randrange(objects)
                 for _ in range(min(gets, 4 * objects)))]
    row_small = run_arm("cache_small", small_cap, ev_draws, 1)
    if row_small["objcache"].get("evictions", 0) <= 0:
        raise RuntimeError(
            "small-cap arm recorded no evictions — LRU cap not enforced")

    p50_speedup = (row_off["get_p50_s"] / row_on["get_p50_s"]
                   if row_on["get_p50_s"] else None)
    p99_speedup = (row_off["get_p99_s"] / row_on["get_p99_s"]
                   if row_on["get_p99_s"] else None)
    total_on = row_on["verdicts"]["hit"] + row_on["verdicts"]["miss"]
    margin = {
        "kind": "object_cache_ab_margin", "objects": objects,
        "object_bytes": object_bytes, "gets": gets, "zipf": zipf,
        "trials": max(1, trials),
        "cache_on_p50_s": row_on["get_p50_s"],
        "cache_off_p50_s": row_off["get_p50_s"],
        "p50_speedup": round(p50_speedup, 2) if p50_speedup else None,
        "p99_speedup": round(p99_speedup, 2) if p99_speedup else None,
        "hit_rate": round(row_on["verdicts"]["hit"] / total_on, 4)
        if total_on else None,
        "hot_avoid_rate": row_on["hot_avoid_rate"],
        "dispatches_avoided": row_on["objcache"].get("hits"),
        "small_cap_evictions": row_small["objcache"].get("evictions"),
    }
    if not quiet:
        print(f"loadgen cache A/B: p50 {row_off['get_p50_s'] * 1e3:.2f}ms "
              f"(off) vs {row_on['get_p50_s'] * 1e3:.2f}ms (on) -> "
              f"{p50_speedup:.1f}x, hit rate {margin['hit_rate']}, "
              f"hot-key avoidance {margin['hot_avoid_rate']}, "
              f"{margin['small_cap_evictions']} evictions under the "
              f"small cap", file=sys.stderr)
    return [row_on, row_off, row_small, margin]


def _fg_latency(report: dict, tenants: set, q: str) -> float | None:
    """Worst quantile ``q`` (a ``latency_s`` key, e.g. ``"0.99"``)
    across the foreground tenants' encode/decode cells — the latency
    the maint A/B gates on."""
    worst = None
    for row in report["tenants"]:
        if row["tenant"] not in tenants or row["op"] not in ("encode",
                                                            "decode"):
            continue
        val = (row.get("latency_s") or {}).get(q)
        if val is not None and (worst is None or val > worst):
            worst = val
    return worst


def _settle_writes() -> float:
    """Write back every dirty page (``sync(2)``), so that a timed window
    does not share the disk with the writeback of what came before it;
    returns the seconds that took."""
    t0 = time.perf_counter()
    if hasattr(os, "sync"):
        os.sync()
    return round(time.perf_counter() - t0, 3)


def run_maint_ab(*, archives: int, size_bytes: int, k: int, p: int,
                 w: int = 8, duration_s: float = 10.0, rate: float = 8.0,
                 p99_ratio_max: float = 1.25, workdir: str,
                 quiet: bool = False, device=None) -> list[dict]:
    """The maintenance-plane margin (docs/MAINT.md): identical damaged
    fleets + identical foreground traffic through two daemons — one
    with ``rs serve --maint`` on, one off.

    Each arm seeds ``archives`` archives with one bit-rotted chunk each
    (scanned into a private damage ledger), fires a sacrificial
    ``monkey`` tenant salvo of guaranteed-expiring decodes — a 1 ms
    ``X-RS-Deadline-Ms`` against the daemon's 5 ms batch window, so
    every one admits, expires with 504, and burns the deliberately
    fragile ``monkey:decode:avail=50`` objective over one short
    ``RS_SLO_WINDOWS`` window (pre-queue 404s never reach the SLO
    plane; expired admissions do) — making the burn-rate governor
    demonstrably PAUSE maintenance mid-run, then drives the alpha/beta
    open loop.
    The ON arm must converge — burn decays as the monkey samples age
    out, the governor resumes, every repair drains, and the rotted
    chunk bytes are byte-verified restored — while the OFF arm proves
    the damage does NOT self-heal (every repair still queued) and
    provides the foreground latency baseline: the ON arm's worst
    foreground encode/decode p99 must stay within ``p99_ratio_max`` of
    it, and the governor must have logged at least one pause event.
    Both arms' daemons, their maint jobs and the seeding run on
    ``device`` (None: CUDA, raising with no GPU present).  Both arms
    start from a settled disk: the off arm's archives are removed once
    its row is taken (its ledger stays), and pending writes are synced
    before each arm.
    """
    from .daemon import ServeDaemon
    from .. import api
    from ..obs import health as _health
    from ..utils.backend import resolve_device
    from ..utils.fileformat import chunk_file_name

    device = resolve_device(device)

    fg = {"alpha", "beta"}
    monkey_n = 12

    def run_arm(arm: str, maint_on: bool) -> dict:
        arm_dir = os.path.join(workdir, arm)
        root = os.path.join(arm_dir, "root")
        ledger = os.path.join(arm_dir, "ledger.jsonl")
        os.makedirs(os.path.join(root, "alpha"), exist_ok=True)
        saved = {kk: os.environ.get(kk)
                 for kk in ("RS_RUNLOG", "RS_RUNLOG_MAX_BYTES",
                            "RS_SLO_WINDOWS", "RS_MAINT_INTERVAL_S",
                            "RS_HEALTH_SCRUB_MAX_AGE_S")}
        daemon = None
        try:
            os.environ["RS_RUNLOG"] = ledger
            os.environ.pop("RS_RUNLOG_MAX_BYTES", None)
            os.environ.pop("RS_HEALTH_SCRUB_MAX_AGE_S", None)
            # One SHORT SLO window: the monkey burn must both fire the
            # pause AND age out mid-run so the resume half of the
            # hysteresis is exercised too (a long window would hold the
            # burn for the whole run and starve the ON arm's repairs).
            os.environ["RS_SLO_WINDOWS"] = "6"
            os.environ["RS_MAINT_INTERVAL_S"] = "0.2"

            # Seeded damage, identical per arm: encode, clean scan,
            # rot 16 bytes of chunk 1, damage scan.
            pristine: dict[str, bytes] = {}
            victims = []
            rng = random.Random(20260807)
            body = rng.randbytes(size_bytes)
            for a in range(archives):
                fname = os.path.join(root, "alpha", f"maintab_{a}.bin")
                with open(fname, "wb") as fp:
                    fp.write(body)
                api.encode_file(fname, k, p, checksums=True, w=w,
                                device=device)
                api.scan_file(fname, device=device)
                cf = chunk_file_name(fname, 1)
                pristine[fname] = open(cf, "rb").read()
                with open(cf, "r+b") as fp:
                    fp.seek(64)
                    fp.write(rng.randbytes(16))
                api.scan_file(fname, device=device)
                victims.append(fname)

            # The monkey's own (healthy, unscanned) archive: its decodes
            # must ADMIT to be observed, then expire on the deadline.
            os.makedirs(os.path.join(root, "monkey"), exist_ok=True)
            burn_f = os.path.join(root, "monkey", "burn.bin")
            with open(burn_f, "wb") as fp:
                fp.write(rng.randbytes(8192))
            api.encode_file(burn_f, k, p, checksums=True, w=w,
                            device=device)

            daemon = ServeDaemon(root, port=0,
                                 slo_spec="monkey:decode:avail=50",
                                 maint=maint_on, device=device)
            daemon.start()
            daemon.warm(k, p, w=w, file_bytes=size_bytes)
            base = f"http://127.0.0.1:{daemon.port}"

            # The sacrificial burn: a 1 ms deadline cannot survive the
            # 5 ms harvest window — every salvo member admits, expires
            # with 504, and burns avail=50 at 2x budget.
            for _ in range(monkey_n):
                mreq = urllib.request.Request(
                    f"{base}/decode?name=burn.bin", data=b"",
                    method="POST",
                    headers={"X-RS-Tenant": "monkey",
                             "X-RS-Deadline-Ms": "1"})
                try:
                    with urllib.request.urlopen(mreq, timeout=30) as rr:
                        rr.read()
                except urllib.error.HTTPError as e:
                    e.read()
                    e.close()

            report = run_open_loop(
                base, duration_s=duration_s, rate=rate,
                tenants=[("alpha", 3.0), ("beta", 1.0)],
                size_bytes=size_bytes, k=k, p=p, w=w,
                decode_frac=0.3, seed=20260807, quiet=quiet)

            # ON arm: wait for the queue to drain (the monkey window
            # must age out first — resume, then repairs).
            maint_doc: dict = {}
            converge_s = None
            if maint_on:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 120.0:
                    maint_doc = _scrape_json(base, "/maint")
                    q = maint_doc.get("queue") or {}
                    if (q.get("repair", 0) == 0 and q.get("scrub", 0) == 0
                            and q.get("compact", 0) == 0
                            and not maint_doc.get("paused")):
                        converge_s = round(time.monotonic() - t0, 3)
                        break
                    time.sleep(0.25)
            else:
                maint_doc = _scrape_json(base, "/maint")
        finally:
            if daemon is not None:
                daemon.close(drain=True, timeout=120)
            for kk, vv in saved.items():
                if vv is None:
                    os.environ.pop(kk, None)
                else:
                    os.environ[kk] = vv

        state = _health.load(ledger)
        repairs_left = len([it for it in _health.work_queue(state)
                            if it["action"] == "repair"])
        restored = all(
            open(chunk_file_name(f, 1), "rb").read() == pristine[f]
            for f in victims)
        return {
            "kind": "maint_ab", "arm": arm, "archives": archives,
            "size_bytes": size_bytes, "damaged": archives,
            "repairs_left": repairs_left, "chunks_restored": restored,
            "converge_wait_s": converge_s,
            "pause_events": maint_doc.get("pause_events"),
            "resume_events": maint_doc.get("resume_events"),
            "maint_enabled": bool(maint_doc.get("enabled")),
            "maint_jobs": maint_doc.get("jobs"),
            "fg_p50_s": _fg_latency(report, fg, "0.5"),
            "fg_p99_s": _fg_latency(report, fg, "0.99"),
            "summary": report["summary"],
            "tenants": report["tenants"],
            "config": {"k": k, "n": k + p, "w": w,
                       "duration_s": duration_s, "rate": rate,
                       "monkey_decodes": monkey_n,
                       "slo": "monkey:decode:avail=50", "windows_s": [6]},
        }

    # Each arm starts with no writes pending: the off arm's files (about
    # 5 GiB at 64 MiB) go once its row is taken, and what the page cache
    # still holds is written back before each arm.  Without this the on
    # arm, always second, served its first seconds beside the off arm's
    # writeback, and the gate compared that against a settled disk.
    settle_off = _settle_writes()
    row_off = run_arm("maint_off", False)
    shutil.rmtree(os.path.join(workdir, "maint_off", "root"))
    settle_on = _settle_writes()
    row_on = run_arm("maint_on", True)
    row_off["settle_s"], row_on["settle_s"] = settle_off, settle_on

    # The contract, checked loudly (a capture that silently records a
    # broken run would read as a blessing):
    if row_off["repairs_left"] != archives or row_off["chunks_restored"]:
        raise RuntimeError(
            f"off arm self-healed? {row_off['repairs_left']} of "
            f"{archives} repairs left, restored="
            f"{row_off['chunks_restored']}")
    if row_on["repairs_left"] != 0 or not row_on["chunks_restored"]:
        raise RuntimeError(
            f"maint arm did not converge: {row_on['repairs_left']} "
            f"repair(s) left, restored={row_on['chunks_restored']}")
    if not row_on["pause_events"]:
        raise RuntimeError(
            "burn-rate governor never paused — the monkey burn did not "
            "register")
    ratio = (row_on["fg_p99_s"] / row_off["fg_p99_s"]
             if row_on["fg_p99_s"] and row_off["fg_p99_s"] else None)
    margin = {
        "kind": "maint_ab_margin", "archives": archives,
        "size_bytes": size_bytes,
        "fg_p99_off_s": row_off["fg_p99_s"],
        "fg_p99_on_s": row_on["fg_p99_s"],
        "p99_ratio": round(ratio, 3) if ratio is not None else None,
        "p99_ratio_max": p99_ratio_max,
        "repairs_converged": True,
        "repairs_left_off": row_off["repairs_left"],
        "pause_events": row_on["pause_events"],
        "resume_events": row_on["resume_events"],
        "converge_wait_s": row_on["converge_wait_s"],
    }
    if ratio is not None and ratio > p99_ratio_max:
        raise RuntimeError(
            f"maint arm foreground p99 {row_on['fg_p99_s']}s is "
            f"{ratio:.2f}x the off arm's {row_off['fg_p99_s']}s "
            f"(max {p99_ratio_max}x)")
    if not quiet:
        print(f"loadgen maint A/B: {archives} repairs converged under "
              f"load (wait {row_on['converge_wait_s']}s, "
              f"{row_on['pause_events']} governor pause(s)); foreground "
              f"p99 {row_off['fg_p99_s']}s (off) vs "
              f"{row_on['fg_p99_s']}s (on) -> "
              f"{margin['p99_ratio']}x", file=sys.stderr)
    return [row_off, row_on, margin]


# -- CLI ----------------------------------------------------------------------

def main(argv=None) -> int:
    """The ``rs loadgen`` subcommand."""
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        prog="rs loadgen",
        description="Open-loop (Poisson) load generator for rs serve: "
        "per-tenant mixes, offered/achieved throughput, latency "
        "percentiles, bench_captures capture (docs/SERVE.md).",
    )
    ap.add_argument("--url", default=None,
                    help="daemon base URL (e.g. http://127.0.0.1:9470)")
    ap.add_argument("--spawn", action="store_true",
                    help="spawn an in-process daemon on an ephemeral "
                    "port for the run")
    ap.add_argument("--root", default=None,
                    help="--spawn daemon root (default: a temp dir)")
    ap.add_argument("--duration", type=float, default=15.0,
                    help="offered-load window in seconds (default 15)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrival rate, requests/s (default 8)")
    ap.add_argument("--tenants", default="alpha:3,beta:1",
                    help="weighted tenant mix, name:weight,... "
                    "(default alpha:3,beta:1)")
    ap.add_argument("--size-kb", type=int, default=64,
                    help="encode payload size (default 64)")
    ap.add_argument("--decode-frac", type=float, default=0.3,
                    help="fraction of arrivals that decode (default 0.3)")
    ap.add_argument("--update-frac", type=float, default=0.0,
                    help="fraction of arrivals that POST /update a small "
                    "byte range of an archive the tenant already encoded "
                    "(mixed read/write traffic; default 0)")
    ap.add_argument("--edit-burst", type=int, default=1,
                    help="small /update requests fired CONCURRENTLY per "
                    "update arrival against the same archive — lands the "
                    "salvo in one batch window so the daemon's write "
                    "combining groups it (default 1 = no burst)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--w", type=int, default=8, choices=(8, 16))
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-process seed (default 0)")
    ap.add_argument("--object-frac", type=float, default=0.0,
                    help="fraction of arrivals hitting the object "
                    "facade (PUT/GET /o/<bucket>/<key>, zipf-hot keys; "
                    "docs/STORE.md; default 0)")
    ap.add_argument("--object-bytes", type=int, default=4096,
                    help="object payload size (default 4096)")
    ap.add_argument("--object-keys", type=int, default=256,
                    help="object key-space size (default 256)")
    ap.add_argument("--object-zipf", type=float, default=1.1,
                    help="zipf skew of the key draw (default 1.1)")
    ap.add_argument("--object-burst", type=int, default=1,
                    help="object PUTs fired CONCURRENTLY per object-put "
                    "arrival (distinct keys, same bucket) — the salvo "
                    "lands in one batch window so the daemon commits it "
                    "as ONE grouped stripe append (default 1)")
    ap.add_argument("--ab", action="store_true",
                    help="A/B mode instead of open-loop: resident daemon "
                    "vs CLI subprocess per file on --files encodes")
    ap.add_argument("--object-ab", action="store_true",
                    help="A/B mode: --files small objects through the "
                    "store facade (PUT batches of --object-batch) vs "
                    "one archive per object — the per-object metadata "
                    "amortization margin (docs/STORE.md)")
    ap.add_argument("--object-batch", type=int, default=64,
                    help="--object-ab facade PUT batch size (default 64 "
                    "— the write-combining unit)")
    ap.add_argument("--object-trials", type=int, default=3,
                    help="--object-ab / --object-cache-ab paired trials "
                    "per arm, best wall wins (default 3)")
    ap.add_argument("--object-cache-ab", action="store_true",
                    help="A/B mode: the SAME seeded zipf GET stream "
                    "through a daemon with the hot-object cache on vs "
                    "off (RS_OBJ_CACHE_BYTES=0) — every GET "
                    "byte-verified, plus a small-cap eviction proof "
                    "(docs/SERVE.md)")
    ap.add_argument("--object-gets", type=int, default=600,
                    help="--object-cache-ab GETs per trial (default 600)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="--object-cache-ab cache-on arm capacity in "
                    "bytes (default: RS_OBJ_CACHE_BYTES or 64 MiB)")
    ap.add_argument("--maint-ab", action="store_true",
                    help="A/B mode: identical damaged fleets + identical "
                    "foreground traffic through a daemon with the "
                    "background-maintenance plane on vs off — repairs "
                    "must converge under load with the burn-rate "
                    "governor demonstrably pausing at least once, and "
                    "the foreground p99 must stay within "
                    "--maint-p99-max of the off arm (docs/MAINT.md)")
    ap.add_argument("--maint-archives", type=int, default=4,
                    help="--maint-ab damaged archives per arm (default 4)")
    ap.add_argument("--maint-p99-max", type=float, default=1.25,
                    help="--maint-ab foreground p99 ratio gate "
                    "(default 1.25)")
    ap.add_argument("--files", type=int, default=100,
                    help="--ab / --object-ab item count (default 100)")
    ap.add_argument("--faults", metavar="SPEC", default=None,
                    help="with --spawn: activate the fault plane in the "
                    "daemon for the run (bounded-error demonstration)")
    ap.add_argument("--device", default=None,
                    help="where the spawned daemon and the A/B arms run "
                    "(default: the CUDA device; without a GPU pass "
                    "--device cpu)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="SLO objectives (RS_SLO grammar, e.g. "
                    "'*:encode:p99=250ms,avail=99.9'): configures the "
                    "spawned daemon, scrapes GET /slo + /debug/requests "
                    "into the capture, and EXITS 4 when any window "
                    "misses its objective — open-loop runs double as "
                    "SLO gates")
    ap.add_argument("--capture", default=None,
                    help="capture JSONL path (default bench_captures/"
                    "serve_<mode>_<backend>_<ts>.jsonl; '-' disables)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary document as JSON on stdout")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.n <= args.k or args.k <= 0:
        print(f"rs loadgen: need n > k > 0 (got k={args.k} n={args.n})",
              file=sys.stderr)
        return 2
    ab_modes = sum((args.ab, args.object_ab, args.object_cache_ab,
                    args.maint_ab))
    if ab_modes > 1:
        print("rs loadgen: --ab, --object-ab, --object-cache-ab and "
              "--maint-ab conflict; pick one", file=sys.stderr)
        return 2
    if not ab_modes and not args.spawn and not args.url:
        print("rs loadgen: pass --url or --spawn", file=sys.stderr)
        return 2
    if args.slo and ab_modes:
        print("rs loadgen: --slo gates open-loop runs, not --ab/"
              "--object-ab/--object-cache-ab", file=sys.stderr)
        return 2
    if args.slo:
        from ..obs import slo as _slo

        try:  # fail before any daemon spawns, naming the bad token
            _slo.parse_slo(args.slo)
        except _slo.SLOSpecError as e:
            print(f"rs loadgen: bad --slo spec: {e}", file=sys.stderr)
            return 2

    p = args.n - args.k
    rows: list[dict] = []
    fault_ctx = contextlib.nullcontext()
    if args.faults:
        if not (args.spawn or args.ab):
            print("rs loadgen: --faults needs --spawn (the plane lives "
                  "in the daemon process)", file=sys.stderr)
            return 2
        from ..resilience import faults as _faults

        try:
            plan = _faults.parse_plan(args.faults,
                                      seed=_faults.env_seed())
        except ValueError as e:
            print(f"rs loadgen: bad --faults spec: {e}", file=sys.stderr)
            return 2
        fault_ctx = _faults.activate(plan)

    tmp = None
    daemon = None
    slo_report = None
    try:
        with fault_ctx, tempfile.TemporaryDirectory(
                prefix="rs_loadgen_") as tmp:
            if args.ab:
                rows = run_ab(
                    files=args.files, size_bytes=args.size_kb * 1024,
                    k=args.k, p=p, w=args.w, workdir=tmp,
                    quiet=args.json, device=args.device)
                mode = "ab"
            elif args.object_ab:
                rows = run_object_ab(
                    files=args.files, object_bytes=args.object_bytes,
                    k=args.k, p=p, w=args.w,
                    batch=max(1, args.object_batch),
                    trials=max(1, args.object_trials), workdir=tmp,
                    quiet=args.json, device=args.device)
                mode = "object_ab"
            elif args.maint_ab:
                rows = run_maint_ab(
                    archives=max(1, args.maint_archives),
                    size_bytes=args.size_kb * 1024,
                    k=args.k, p=p, w=args.w,
                    duration_s=args.duration, rate=args.rate,
                    p99_ratio_max=args.maint_p99_max, workdir=tmp,
                    quiet=args.json, device=args.device)
                mode = "maint_ab"
            elif args.object_cache_ab:
                rows = run_object_cache_ab(
                    objects=max(1, args.object_keys),
                    object_bytes=args.object_bytes,
                    gets=max(1, args.object_gets),
                    k=args.k, p=p, w=args.w, zipf=args.object_zipf,
                    trials=max(1, args.object_trials),
                    cache_bytes=args.cache_bytes, workdir=tmp,
                    quiet=args.json, device=args.device)
                mode = "object_cache_ab"
            else:
                url = args.url
                if args.spawn:
                    from .daemon import ServeDaemon

                    try:
                        daemon = ServeDaemon(
                            args.root or os.path.join(tmp, "serve_root"),
                            port=0, slo_spec=args.slo, device=args.device)
                    except RuntimeError as e:  # no device to run on
                        print(f"rs loadgen: {e}", file=sys.stderr)
                        return 2
                    daemon.start()
                    daemon.warm(args.k, p, w=args.w,
                                file_bytes=args.size_kb * 1024)
                    url = f"http://127.0.0.1:{daemon.port}"
                report = run_open_loop(
                    url.rstrip("/"), duration_s=args.duration,
                    rate=args.rate,
                    tenants=_parse_tenants(args.tenants),
                    size_bytes=args.size_kb * 1024, k=args.k, p=p,
                    w=args.w, decode_frac=args.decode_frac,
                    update_frac=args.update_frac,
                    edit_burst=max(1, args.edit_burst),
                    object_frac=args.object_frac,
                    object_bytes=args.object_bytes,
                    object_keys=max(1, args.object_keys),
                    object_zipf=args.object_zipf,
                    object_burst=max(1, args.object_burst),
                    seed=args.seed, quiet=args.json)
                if args.faults:
                    # Self-describing capture: a faulted run's error rows
                    # must not read as a regression.
                    report["summary"]["config"]["faults"] = args.faults
                if args.slo:
                    report["summary"]["config"]["slo"] = args.slo
                rows = [report["summary"], *report["tenants"],
                        *report["requests"]]
                if args.slo:
                    # Scrape the daemon's own lifecycle surfaces while it
                    # is still alive: the SLO report (attainment + burn
                    # rates) and its view of the recent requests — the
                    # capture carries both sides of the id join.
                    slo_report = _scrape_json(url, "/slo")
                    if not slo_report.get("configured"):
                        # A gate over zero objectives passes forever —
                        # refuse loudly instead (an external --url
                        # daemon must be started with --slo/RS_SLO;
                        # --spawn configures its own).
                        print("rs loadgen: --slo gate is vacuous: the "
                              "daemon reports no SLO objectives "
                              "configured (start it with rs serve "
                              "--slo or RS_SLO)", file=sys.stderr)
                        return 2
                    rows.append({**slo_report, "kind": "serve_slo"})
                    debug = _scrape_json(url, "/debug/requests?n=200")
                    rows.append({**debug, "kind": "serve_debug_requests"})
                if daemon is not None:
                    stats = daemon.stats()
                    rows.append({"kind": "serve_daemon_stats", **stats})
                    if args.object_frac > 0:
                        # Dedicated rs_obj_cache_* summary row: the zipf
                        # cache validator reads hit-rate from the capture
                        # alone, no /stats scrape of its own.
                        rows.append({"kind": "obj_cache_summary",
                                     **stats.get("objcache", {})})
                mode = ("faulted" if args.faults
                        else "object" if args.object_frac > 0
                        else "openloop")
    finally:
        if daemon is not None:
            daemon.close(drain=True, timeout=120)

    capture = args.capture
    if capture is None:
        os.makedirs("bench_captures", exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        capture = os.path.join(
            "bench_captures",
            f"serve_{mode}_{_runlog.backend_name() or 'cpu'}_"
            f"{stamp}.jsonl")
    if capture != "-":
        with open(capture, "w") as fp:
            fp.write(json.dumps(_runlog.capture_header("serve_loadgen"))
                     + "\n")
            for row in rows:
                fp.write(json.dumps(row) + "\n")
        print(f"rs loadgen: capture -> {capture}", file=sys.stderr)
    if args.json:
        print(json.dumps({"rows": rows, "capture": capture}))
    if args.slo:
        # The SLO gate (docs/SERVE.md "Request lifecycle"): the run
        # fails loudly when any rolling window missed its objective —
        # the capture above still records everything, so a gating CI
        # leg keeps its artifact.
        from ..obs import slo as _slo

        bad = _slo.breaches(slo_report or {})
        if bad:
            for b in bad:
                print(f"rs loadgen: SLO BREACH {b['tenant']}/{b['op']} "
                      f"{b['objective']} @{b['window']}s: attainment "
                      f"{b['attainment']}, burn {b['burn_rate']}",
                      file=sys.stderr)
            return 4
        print("rs loadgen: SLO attained across all windows",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
