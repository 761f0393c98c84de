"""The port's own copy of three parts of the JAX package's ``obs/runlog.py``.

* The identity header of a measurement tool's JSON-lines output
  (:func:`capture_header`, same keys).
* The store half of the run ledger: :func:`path` (``RS_RUNLOG``),
  :func:`store_path` (``RS_SCHEDULE_STORE``), the crash-safe
  :func:`append` with its size-capped rotation, and :func:`read_records`.
  The XOR and ring schedule stores (:mod:`..ops.xor_gemm`,
  :mod:`..ops.ring_gemm`) keep their records there.  The records are the
  same JSON lines with the same ``schema``, so a file written by either
  package reads in the other.
* The record envelope: :func:`record` (kind, run, ts, git sha, host,
  process index, backend, metrics digest) and :func:`tail` (the ``/runs``
  payload).  The damage plane (:mod:`.health`) and the request lifecycle
  plane (:mod:`.reqtrace`) write through it.

* The per-file-operation ``rs_run`` records: :func:`record_file_op` (op,
  ``{k, n, w, strategy}`` config, input bytes, wall, phases, outcome) with
  :func:`timer_phases` for a shared timer's entry snapshot, which
  ``api._observed_file_op`` calls around every file-level entry point.

The history surface (``filter_records``) is not ported yet.

Import cost: the standard library and :mod:`..utils.backend`.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import time
import uuid
import warnings

from ..utils.backend import backend_label

SCHEMA_VERSION = 1

# 8 MiB default cap on the ledger before it rotates (RS_RUNLOG_MAX_BYTES).
_DEFAULT_MAX_BYTES = 8 * 1024 * 1024

# One run id per process: every header of one invocation shares it.
_RUN_ID = uuid.uuid4().hex[:12]
_GIT_SHA: str | None | bool = False  # False = not yet resolved


def run_id() -> str:
    """This process's run id (12 hex chars)."""
    return _RUN_ID


def path() -> str | None:
    """The ledger path (``RS_RUNLOG``), or None when the ledger is off."""
    return os.environ.get("RS_RUNLOG") or None


def enabled() -> bool:
    return path() is not None


def store_path() -> str | None:
    """The persistent schedule store.  By default it rides the run ledger
    (one file, one rotation policy).  ``RS_SCHEDULE_STORE`` overrides it:
    ``0``/``off`` turns persistence off even with a ledger, a path gives
    the store its own file, ``1``/``on`` is the explicit default."""
    v = os.environ.get("RS_SCHEDULE_STORE")
    if v is None or not v.strip():
        return path()
    s = v.strip()
    if s.lower() in ("0", "off", "false", "no"):
        return None
    if s.lower() in ("1", "on", "true", "yes"):
        return path()
    return s


def intra_op_threads() -> int:
    """CPUs this process may run on (its affinity mask where the platform
    has one, else the host's CPU count)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def git_sha() -> str | None:
    """Short git sha of the checkout this package lies in, resolved once
    per process.  None when git fails or when the package's root is not the
    top of a git checkout (an unpacked archive inside another checkout
    would otherwise report that checkout's HEAD)."""
    global _GIT_SHA
    if _GIT_SHA is not False:
        return _GIT_SHA
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sha = None
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--show-toplevel", "--short", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=5,
        ).stdout.split()
        if len(out) == 2 and os.path.realpath(out[0]) == os.path.realpath(root):
            sha = out[1]
    except (OSError, subprocess.SubprocessError):
        pass
    _GIT_SHA = sha
    return sha


def backend_name() -> str:
    """Where this process computes: "cuda" when a CUDA device is present,
    else "cpu" (the JAX package records its JAX backend here)."""
    return backend_label()


def process_index() -> int:
    """This process's index in a multi-process job (0 single-process): the
    ``RANK`` that ``torch.distributed`` launchers set."""
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


def capture_header(tool: str) -> dict:
    """The first line a measurement tool prints: which host, source tree
    and backend produced the rows after it."""
    return {
        "kind": "capture_header",
        "schema": SCHEMA_VERSION,
        "tool": tool,
        "run": run_id(),
        "ts": time.time(),
        "git_sha": git_sha(),
        "host": socket.gethostname(),
        "backend": backend_label(),
        "host_cpus": os.cpu_count() or 1,
        "intra_op_threads": intra_op_threads(),
        "xla_flags": None,
    }


# Record kinds that rotation carries into the fresh ledger: calibration
# and schedule data that would otherwise be rebuilt from scratch after
# every rotation (the same list as the JAX package's, so both rotate a
# shared file alike).  Carried records are capped at half the rotation
# budget, so a store bigger than the cap cannot re-trigger rotation.
_PRESERVED_KINDS = ("rs_roofline", "rs_xor_schedule", "rs_autotune", "rs_health_snapshot", "rs_perf_baseline")


def _rotate(p: str, max_bytes: int) -> None:
    """Move a ledger of ``max_bytes`` or more to ``<p>.1`` and start the new
    file with the newest record of each preserved identity."""
    try:
        if os.path.getsize(p) < max_bytes:
            return
    except OSError:
        return  # no ledger yet
    try:
        os.replace(p, p + ".1")
    except OSError as e:
        warnings.warn(f"runlog rotation of {p!r} failed: {e}", stacklevel=3)
        return
    try:
        # One record per identity, the latest wins (as the loaders
        # resolve it); past the budget the newest are kept first.
        latest: dict[tuple, str] = {}
        with open(p + ".1") as fp:
            for line in fp:
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                kind = rec.get("kind")
                if kind not in _PRESERVED_KINDS:
                    continue
                if kind == "rs_autotune":
                    ident = (kind, rec.get("host"), rec.get("backend"), rec.get("k"), rec.get("p"), rec.get("w"))
                elif kind == "rs_xor_schedule":
                    ident = (kind, rec.get("digest"), rec.get("cse"))
                elif kind == "rs_health_snapshot":
                    ident = (kind,)
                elif kind == "rs_perf_baseline":
                    ident = (kind, rec.get("host"), rec.get("backend"))
                else:  # rs_roofline
                    ident = (kind, rec.get("host"))
                latest.pop(ident, None)  # re-insert: dict order = recency
                latest[ident] = stripped
        carried: list[str] = []
        budget = max_bytes // 2
        used = 0
        for line in reversed(list(latest.values())):  # newest first
            if used + len(line) + 1 > budget:
                continue
            carried.append(line)
            used += len(line) + 1
        if carried:
            carried.reverse()  # oldest-to-newest file order
            fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, ("\n".join(carried) + "\n").encode())
            finally:
                os.close(fd)
    except OSError as e:
        warnings.warn(f"runlog rotation could not carry calibration records: {e}", stacklevel=3)


def append(record: dict, ledger_path: str | None = None) -> None:
    """Append one record as one line with a single ``O_APPEND`` write (no-op
    when the ledger is off): concurrent writers interleave whole lines and
    a crash loses at most the record in flight.  Errors warn and drop the
    record; they never raise into the operation that records."""
    p = ledger_path or path()
    if not p:
        return
    try:
        max_bytes = int(os.environ.get("RS_RUNLOG_MAX_BYTES", _DEFAULT_MAX_BYTES))
    except ValueError:
        max_bytes = _DEFAULT_MAX_BYTES
    _rotate(p, max_bytes)
    line = json.dumps(record, default=str) + "\n"
    try:
        # O_RDWR: the torn-tail probe below reads through the same fd.
        fd = os.open(p, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            # A writer that died mid-line left no trailing newline; a
            # leading newline isolates that fragment (readers skip it).
            size = os.fstat(fd).st_size
            if size and os.pread(fd, 1, size - 1) != b"\n":
                line = "\n" + line
            os.write(fd, line.encode())
        finally:
            os.close(fd)
    except OSError as e:
        warnings.warn(f"runlog append to {p!r} failed: {e}", stacklevel=2)


def read_records(p: str, include_rotated: bool = True) -> list[dict]:
    """The records of ``p``, oldest first, the rotated ``<p>.1`` before the
    live file.  Unparseable and non-dict lines are skipped."""
    out: list[dict] = []
    paths = ([p + ".1"] if include_rotated else []) + [p]
    for part in paths:
        try:
            with open(part) as fp:
                for line in fp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            continue
    return out


def tail(p: str, n: int = 50) -> list[dict]:
    """The last ``n`` records (the ``/runs`` endpoint's payload)."""
    return read_records(p)[-n:]


def metrics_digest() -> str | None:
    """Short digest of the metrics registry's snapshot: two records with
    equal digests saw identical registries.  None with metrics off."""
    from . import metrics as _metrics

    if not _metrics.enabled():
        return None
    snap = _metrics.REGISTRY.snapshot_json()
    return hashlib.sha256(snap.encode()).hexdigest()[:12]


def timer_phases(sig, args: tuple, kwargs: dict) -> dict | None:
    """Best-effort snapshot of the bound ``timer`` argument's phases, taken
    at operation entry so the record carries the delta: nested fleet ops
    share one timer."""
    try:
        if sig is None:
            return None
        timer = sig.bind_partial(*args, **kwargs).arguments.get("timer")
        if timer is not None and getattr(timer, "enabled", False):
            return timer.phase_report()
    except Exception:  # noqa: BLE001 - the ledger never fails the operation it records
        pass
    return None


def record_file_op(op: str, sig, args: tuple, kwargs: dict, *, wall: float, error: BaseException | None,
                   phases_before: dict | None = None) -> None:
    """Build and append the ledger record of one file-level operation, the
    JAX package's record key for key.  Config fields are extracted by
    parameter NAME from the wrapped function's signature; a field that
    cannot be extracted is omitted, and recording never raises."""
    try:
        bound = {}
        if sig is not None:
            try:
                ba = sig.bind_partial(*args, **kwargs)
                ba.apply_defaults()  # strategy/w defaults are real config
                bound = ba.arguments
            except TypeError:
                pass  # the caller's own TypeError is already propagating
        files: list[str] = []
        primary = bound.get("file_name") or bound.get("in_file")
        if isinstance(primary, str):
            files = [primary]
        elif bound.get("files") is not None:
            files = [f for f in bound["files"] if isinstance(f, str)]
        config: dict = {}
        k = bound.get("native_num")
        if k is not None:
            config["k"] = int(k)
            p_num = bound.get("parity_num")
            if p_num is not None:
                config["n"] = int(k) + int(p_num)
        if bound.get("w") is not None:
            config["w"] = int(bound["w"])
        if bound.get("strategy") is not None:
            config["strategy"] = str(bound["strategy"])
        if bound.get("mesh") is not None:
            config["mesh"] = True
        nbytes = 0
        for f in files:
            try:
                nbytes += os.path.getsize(f)
            except OSError:
                pass  # decode/repair inputs are chunk sets, not the file
        phases = None
        timer = bound.get("timer")
        if timer is not None and getattr(timer, "enabled", False):
            phases = timer.phase_report()
            if phases_before:
                # THIS op's share of a shared (fleet) timer.
                phases = {k: round(v - phases_before.get(k, 0.0), 6) for k, v in phases.items()
                          if v - phases_before.get(k, 0.0) > 0}
        record({
            "op": op,
            "files": len(files),
            "file": files[0] if files else None,
            "config": config,
            "bytes": nbytes,
            "wall_s": round(wall, 6),
            "phases": phases,
            "outcome": "error" if error is not None else "ok",
            "error": type(error).__name__ if error is not None else None,
        })
    except Exception as e:  # noqa: BLE001 - the ledger must never fail the operation
        warnings.warn(f"runlog record for {op!r} failed: {type(e).__name__}: {e}", stacklevel=2)


def record(fields: dict, ledger_path: str | None = None) -> None:
    """Append a record, filling the shared identity envelope (kind, run,
    ts, git sha, host, process index, backend, metrics digest)."""
    rec = {
        "kind": "rs_run",
        "schema": SCHEMA_VERSION,
        "run": run_id(),
        "ts": time.time(),
        "git_sha": git_sha(),
        "host": socket.gethostname(),
        "proc": process_index(),
        "backend": backend_name(),
    }
    rec.update(fields)
    try:
        rec["metrics_digest"] = metrics_digest()
    except Exception:  # noqa: BLE001 - the ledger never fails the operation it records
        rec["metrics_digest"] = None
    append(rec, ledger_path)

