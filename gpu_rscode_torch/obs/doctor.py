"""`rs doctor`: a one-shot environment diagnostic, the port's counterpart
of the JAX package's ``obs/doctor.py``.

Every support thread starts with the same questions: which device is
serving, do the kernels and the native library build, which RS_* knobs
are set, is the ledger writable, is anything scraping the metrics
endpoint, and is the roofline calibration `rs analyze` depends on still
fresh?  This module answers them in one run, human-readable or ``--json``
(a schema-stable document: the section keys are the JAX package's, with
``torch`` in place of its ``jax`` section).

Sections:

* ``python`` / ``torch``: interpreter, torch and CUDA versions, the
  backend (``cuda`` or ``cpu``), the visible devices, the first card's
  name and compute capability, whether ``nvcc`` is found and the kernel
  build directory.
* ``native``: the native host library's presence, source digest, build
  error if any.
* ``mesh``: the CUDA device count, ``torch.distributed`` availability, the
  NCCL and gloo backends, whether this process joined a process group,
  and torchrun's variables when set.
* ``env``: every ``RS_*`` knob currently set.
* ``decoder`` / ``update`` / ``store`` / ``strategies``: capability
  matrices and the object store's read-only probe.
* ``ledger``: RS_RUNLOG presence, record count, writability.
* ``metrics_endpoint`` / ``serve`` / ``slo``: the live endpoints, probed
  once each on 127.0.0.1.
* ``roofline``: this host's newest calibration and its age against
  ``RS_ROOFLINE_MAX_AGE_S``.
* ``health`` / ``perf`` / ``maint``: the ledger replayed into the
  durability, perf-baseline and maintenance planes.

Import cost: the standard library and the port's own modules; torch is
imported inside :func:`collect`.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import socket
import sys
import time

from . import attrib as _attrib, runlog as _runlog

SCHEMA_VERSION = 1

# The --json document's stable surface (pinned by tests): these keys are
# always present, whatever the environment looks like.
SECTIONS = ("python", "torch", "native", "mesh", "env", "decoder", "update",
            "store", "strategies", "ledger", "metrics_endpoint", "serve",
            "slo", "roofline", "health", "perf", "maint")


def _torch_section() -> dict:
    out: dict = {"importable": False, "version": None, "cuda_version": None, "backend": None, "devices": [],
                 "device_count": 0, "device_name": None, "capability": None, "nvcc": None, "build_dir": None,
                 "error": None}
    try:
        import torch

        from ..ops import _build

        out["importable"] = True
        out["version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        cuda = torch.cuda.is_available() and torch.cuda.device_count() > 0
        out["backend"] = "cuda" if cuda else "cpu"
        out["device_count"] = torch.cuda.device_count() if cuda else 0
        out["devices"] = [torch.cuda.get_device_name(i) for i in range(out["device_count"])]
        if cuda:
            out["device_name"] = torch.cuda.get_device_name(0)
            out["capability"] = "sm_%d%d" % torch.cuda.get_device_capability(0)
        out["build_dir"] = str(_build.build_root())
        try:
            out["nvcc"] = _build.find_nvcc()
        except RuntimeError:
            out["nvcc"] = None  # the kernels build only where nvcc is
    except Exception as e:  # a broken install can fail any number of ways
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _native_section() -> dict:
    out: dict = {"available": False, "lib_path": None, "src_digest": None,
                 "error": None}
    try:
        from .. import native

        with open(native.SRC, "rb") as fp:
            out["src_digest"] = hashlib.sha256(fp.read()).hexdigest()[:12]
        out["available"] = native._native() is not None and native.available()
        if out["available"]:
            out["lib_path"] = str(native.library_path())
        else:
            out["error"] = "native toolchain unavailable (NumPy fallback)"
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _mesh_section(torch_info: dict) -> dict:
    out: dict = {
        "local_device_count": torch_info.get("device_count", 0),
        "distributed_available": False,
        "nccl_available": False,
        "gloo_available": False,
        "initialized": False,
        "distributed_env": {},
    }
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "RS_DISTRIBUTED"):
        if os.environ.get(var):
            out["distributed_env"][var] = os.environ[var]
    try:
        from ..parallel import _compat

        out["distributed_available"] = _compat.distributed_available()
        out["nccl_available"] = _compat.nccl_available()
        out["gloo_available"] = _compat.gloo_available()
        out["initialized"] = _compat.distributed_is_initialized()
    except Exception:
        pass
    return out


def _decoder_section() -> dict:
    """Decoder capability matrix (schema-stable): what this build can
    recover from.  ``erasure`` is the Vandermonde + Gauss-Jordan path the
    paper ships; ``locate`` is the gf_decode error-locating path (silent
    bitrot without CRCs — docs/RESILIENCE.md "Error location")."""
    out: dict = {
        "erasure": True,
        "locate": False,
        "supported_w": [8, 16],
        "syndrome_kernel": None,
        "locate_bound": "2*errors + erasures <= n - k per symbol column",
        "error": None,
    }
    try:
        from .. import gf_decode  # noqa: F401
        from ..codec import RSCodec

        out["locate"] = True
        out["syndrome_kernel"] = (
            "plan-cached GF-GEMM (codec.syndrome)"
            if hasattr(RSCodec, "syndrome") else None
        )
    except Exception as e:  # pragma: no cover - import-degraded env
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _update_section() -> dict:
    """Update/append capability matrix (schema-stable): whether this
    build can mutate archives in place (docs/UPDATE.md) and with which
    layouts/safety machinery."""
    out: dict = {
        "delta_update": False,
        "append": False,
        "layouts": [],
        "crash_safety": None,
        "crc_fixup": None,
        # Group-commit write combining (docs/UPDATE.md "Group commit"):
        # effective config + process-lifetime tallies, schema-stable.
        "group_commit": {
            "available": False,
            "window_max_edits": None,
            "groups": 0,
            "edits": 0,
            "bytes": 0,
            "max_group_seen": 0,
            "journal_fsyncs": 0,
            "metadata_commits": 0,
        },
        "error": None,
    }
    try:
        from ..update import apply_append, apply_update  # noqa: F401
        from ..update import group_stats as _group_stats

        out["delta_update"] = True
        out["append"] = True
        out["layouts"] = ["row", "interleaved"]
        out["crash_safety"] = (
            "undo journal + atomic generation-bumped .METADATA rewrite"
        )
        out["crc_fixup"] = "seekable crc32-combine (no full-chunk re-hash)"
        out["group_commit"].update(available=True, **_group_stats())
    except Exception as e:  # pragma: no cover - import-degraded env
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _store_section(root: str | None = None) -> dict:
    """Object-store façade health (docs/STORE.md): buckets probed
    read-only under ``root`` (``--root`` / ``RS_STORE_ROOT``) — objects,
    live/dead bytes, rolled-back index records pending a rewrite,
    pending compactions — plus the knob dump.  Schema-stable: every key
    present even with no root configured."""
    out: dict = {
        "root": None, "probed": False, "buckets": {},
        "objects": 0, "live_bytes": 0, "dead_bytes": 0,
        "pending_compactions": 0, "pending_drops": 0,
        "snapshots": 0, "segments": 0,
        "knobs": {}, "error": None,
    }
    try:
        from ..serve.objcache import cache_bytes_env
        from ..store import (compact_dead_frac, probe,
                             snapshot_keep_env, snapshot_records_env,
                             stripe_bytes_env)

        out["knobs"] = {
            "RS_STORE_STRIPE_BYTES": stripe_bytes_env(),
            "RS_STORE_COMPACT_DEAD_FRAC": compact_dead_frac(),
            "RS_STORE_SNAPSHOT_RECORDS": snapshot_records_env(),
            "RS_STORE_SNAPSHOT_KEEP": snapshot_keep_env(),
            "RS_OBJ_CACHE_BYTES": cache_bytes_env(),
            "RS_STORE_K": os.environ.get("RS_STORE_K"),
            "RS_STORE_P": os.environ.get("RS_STORE_P"),
        }
        root = root or os.environ.get("RS_STORE_ROOT")
        if not root:
            return out
        out["root"] = os.path.abspath(root)
        doc = probe(root)
        out["probed"] = True
        out["buckets"] = doc["buckets"]
        for b in doc["buckets"].values():
            if "error" in b:
                continue
            out["objects"] += b["objects"]
            out["live_bytes"] += b["live_bytes"]
            out["dead_bytes"] += b["dead_bytes"]
            out["pending_compactions"] += b["pending_compactions"]
            out["pending_drops"] += b["pending_drops"]
            out["snapshots"] += b.get("snapshots", 0)
            out["segments"] += b.get("segments", 0)
    except Exception as e:  # diagnostic must never crash
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _strategies_section() -> dict:
    """GEMM-strategy capability matrix (schema-stable): which strategies
    this build offers, what ``auto`` resolves to on this backend (the
    autotuner verdict — docs/XOR.md), the cached XOR-schedule stats
    (term counts before/after CSE) so plan-cache bloat is visible, the
    persistent schedule/autotune store facts, and the generation-keyed
    survivor-subset cache tallies."""
    out: dict = {
        "valid": [],
        "candidates": [],
        "auto": {"strategy": None, "mode": None, "source": None},
        "xor": {
            "supported_w": [8, 16],
            "cse_default": None,
            "schedules": [],
            "pipelines": 0,
            "opt": None,
        },
        "ring": {
            "supported_w": [8, 16],
            "schedules": [],
            "pipelines": 0,
            "store": {},
            "params": None,
        },
        "autotune_decisions": {},
        "store": {
            "path": None,
            "enabled": False,
            "entries": None,
            "hits": 0,
            "misses": 0,
            "stored": 0,
            "corrupt": 0,
            "built": 0,
            "ledger_autotune": 0,
        },
        "inverse_cache": {"entries": 0, "hits": 0, "misses": 0,
                          "stale": 0},
        "error": None,
    }
    try:
        from ..ops import xor_gemm as _xg
        from .. import tune as _tune

        device = "cuda" if _cuda_present() else "cpu"
        out["valid"] = list(_tune.VALID_STRATEGIES)
        out["candidates"] = list(_tune.candidate_strategies(8, device))
        mode = _tune.mode()
        decisions = _tune.decisions()
        # The verdict an auto codec gets today, mirroring resolve_auto:
        # `off` mode ignores the cache; measured/ledger decisions are per
        # (k, p, w) class, so a unanimous winner reports with its source
        # and split winners fall back to the prior label with the
        # per-class table below telling the full story.
        winners = sorted({d["strategy"] for d in decisions.values()})
        sources = sorted({
            d.get("source") or "measured" for d in decisions.values()
        })
        if mode == "off" or not winners:
            auto = {"strategy": _tune.static_choice(8, device), "source": "prior"}
        elif len(winners) == 1:
            auto = {
                "strategy": winners[0],
                "source": sources[0] if len(sources) == 1 else "mixed",
            }
        else:
            auto = {"strategy": _tune.static_choice(8, device), "source": "mixed"}
        out["auto"] = dict(auto, mode=mode)
        scheds = _xg.schedule_stats()
        out["xor"]["cse_default"] = _xg._cse_enabled()
        out["xor"]["schedules"] = scheds
        out["xor"]["pipelines"] = len(_xg.pipeline_stats())
        # Schedule-optimizer pass facts (ops/xor_opt.py): the resolved
        # knob state plus per-pipeline stats — what the pass actually
        # did (nodes moved, tile choice, unpack split) per compiled
        # pipeline, xor and ring alike.
        from ..ops import ring_gemm as _rg
        from ..ops import xor_opt as _xopt

        out["xor"]["opt"] = {
            "enabled": _xopt.opt_enabled(),
            "tile_override": _xopt.tile_override(),
            "tile_budget_bytes": _xopt.tile_budget_bytes(),
            "pipelines": [
                {"digest": p_["digest"], **p_["opt"]}
                for p_ in _xg.pipeline_stats() if p_.get("opt")
            ] + [
                {"digest": p_["digest"], **p_["opt"]}
                for p_ in _rg.ring_pipeline_stats() if p_.get("opt")
            ],
        }
        out["ring"]["schedules"] = _rg.ring_schedule_stats()
        out["ring"]["pipelines"] = len(_rg.ring_pipeline_stats())
        out["ring"]["store"] = _rg.ring_store_stats(load=True)
        out["ring"]["params"] = _rg.ring_params(8)
        out["autotune_decisions"] = decisions
        # Persistent-store facts (docs/XOR.md "The persistent store"):
        # resolved path, on-disk schedule entries (load=True forces one
        # index read — doctor is a diagnostic, the parse is the point),
        # this process's hit/miss/stored/corrupt tallies, and how many
        # cached autotune verdicts came from the ledger.
        out["store"].update(_xg.store_stats(load=True))
        out["store"]["ledger_autotune"] = sum(
            1 for d in decisions.values() if d.get("source") == "ledger"
        )
        from ..api import subset_cache_stats

        out["inverse_cache"] = subset_cache_stats()
    except Exception as e:  # pragma: no cover - import-degraded env
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _cuda_present() -> bool:
    from ..utils.backend import cuda_devices_present

    return cuda_devices_present()


def _ledger_section() -> tuple[dict, list[dict]]:
    """Ledger facts plus the parsed records — read ONCE and shared with
    the roofline section (a rotation-bound ledger is several MB; the
    one-shot diagnostic must not JSON-parse it twice)."""
    p = _runlog.path()
    records: list[dict] = []
    out: dict = {"path": p, "exists": False, "records": 0,
                 "damage_records": 0, "health_snapshots": 0,
                 "writable": None, "error": None}
    if not p:
        out["error"] = "RS_RUNLOG unset (no persistent run ledger)"
        return out, records
    out["exists"] = os.path.exists(p) or os.path.exists(p + ".1")
    if out["exists"]:
        try:
            records = _runlog.read_records(p)
            out["records"] = len(records)
            # Damage-plane volume (obs/health.py): how much of the
            # ledger is the durability event stream vs op history.
            out["damage_records"] = sum(
                1 for r in records if r.get("kind") == "rs_damage")
            out["health_snapshots"] = sum(
                1 for r in records
                if r.get("kind") == "rs_health_snapshot")
        except Exception as e:
            out["error"] = f"{type(e).__name__}: {e}"
    # Writability probe that MUTATES NOTHING: doctor diagnoses state, it
    # must not create the ledger file a later existence check would read
    # as "some operation wrote here".
    if os.path.exists(p):
        try:
            fd = os.open(p, os.O_RDWR | os.O_APPEND)
            os.close(fd)
            out["writable"] = True
        except OSError as e:
            out["writable"] = False
            out["error"] = f"{type(e).__name__}: {e}"
    else:
        parent = os.path.dirname(p) or "."
        out["writable"] = os.access(parent, os.W_OK | os.X_OK)
        if not out["writable"]:
            out["error"] = f"parent directory {parent!r} not writable"
    return out, records


def _health_section(ledger_records: list[dict]) -> dict:
    """Fleet durability-health facts (obs/health.py, docs/HEALTH.md):
    replay the shared ledger-record list — parsed once by
    :func:`_ledger_section` — into health state and report snapshot
    freshness, the at-risk count and the repair work-queue depth."""
    out: dict = {"enabled": _runlog.enabled(), "tracked": 0, "at_risk": 0,
                 "work_queue_depth": 0, "buckets": None, "events": 0,
                 "snapshots": 0, "snapshots_corrupt": 0,
                 "snapshot_age_s": None, "events_since_snapshot": 0,
                 "error": None}
    if not out["enabled"]:
        out["error"] = "RS_RUNLOG unset (no damage ledger)"
        return out
    try:
        from . import health as _health

        state = _health.replay(ledger_records)
        report = _health.fleet_report(state)
        out["tracked"] = report["total"]
        out["at_risk"] = report["at_risk"]
        out["work_queue_depth"] = report["work_queue_depth"]
        out["buckets"] = report["buckets"]
        out["events"] = report["events"]
        out["snapshots"] = report["snapshots"]
        out["snapshots_corrupt"] = report["snapshots_corrupt"]
        out["events_since_snapshot"] = report["events_since_snapshot"]
        if report["snapshot_ts"]:
            out["snapshot_age_s"] = round(
                max(0.0, time.time() - report["snapshot_ts"]), 3)
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _maint_section(ledger_records: list[dict]) -> dict:
    """Background-maintenance facts (maint/controller.py, docs/MAINT.md):
    is the daemon plane enabled, what would the controller work on right
    now (repair / scrub / compaction-eligible counts from the shared
    ledger replay), and the throttle knobs it would run under."""
    out: dict = {"enabled": False, "tenant": None, "repairs": 0,
                 "scrubs": 0, "claimed": 0,
                 "knobs": {k: os.environ.get(k) for k in
                           ("RS_MAINT", "RS_MAINT_TENANT",
                            "RS_MAINT_BYTES_PER_S", "RS_MAINT_BURN_PAUSE",
                            "RS_MAINT_RESUME", "RS_MAINT_LEASE_S",
                            "RS_MAINT_INTERVAL_S")},
                 "error": None}
    try:
        from ..maint import controller as _maint

        out["enabled"] = _maint.enabled()
        out["tenant"] = _maint.tenant_env()
        if not _runlog.enabled():
            out["error"] = "RS_RUNLOG unset (no damage ledger)"
            return out
        from . import health as _health

        state = _health.replay(ledger_records)
        now = time.time()
        for item in _health.work_queue(state, now=now):
            if item["action"] == "repair":
                out["repairs"] += 1
            else:
                out["scrubs"] += 1
            if item.get("claimed_by"):
                out["claimed"] += 1
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _perf_section(ledger_records: list[dict]) -> dict:
    """Perf-baseline facts (obs/perfbase.py, docs/OBSERVABILITY.md
    "Perf attribution & baselines"): replay the shared ledger-record
    list into the drift report — is a baseline blessed, how many cells
    have current evidence, and how far the worst cell has drifted."""
    out: dict = {"enabled": _runlog.enabled(), "baseline": False,
                 "baseline_cells": 0, "current_cells": 0, "samples": 0,
                 "worst_cell": None, "worst_ratio": None, "breach": False,
                 "drift_frac": None,
                 "knobs": {k: os.environ.get(k) for k in
                           ("RS_PROF", "RS_PROF_SAMPLE",
                            "RS_PERF_DRIFT_FRAC")},
                 "error": None}
    if not out["enabled"]:
        out["error"] = "RS_RUNLOG unset (no perf evidence stream)"
        return out
    try:
        from . import perfbase as _perfbase

        rep = _perfbase.report(ledger_records)
        out["baseline"] = rep["baseline"]
        out["baseline_cells"] = rep["baseline_cells"]
        out["current_cells"] = rep["current_cells"]
        out["samples"] = rep["samples"]
        out["drift_frac"] = rep["drift_frac"]
        out["breach"] = rep["breach"]
        if rep["worst"] is not None:
            out["worst_cell"] = rep["worst"]["cell"]
            out["worst_ratio"] = rep["worst"]["ratio"]
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _endpoint_section(probe: bool = True) -> dict:
    port = os.environ.get("RS_METRICS_PORT")
    out: dict = {"port": port, "reachable": None, "error": None}
    if not port:
        out["error"] = "RS_METRICS_PORT unset (no live /metrics endpoint)"
        return out
    if not probe:
        return out
    try:
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{int(port)}/healthz", timeout=2
        ) as resp:
            out["reachable"] = resp.status == 200
    except Exception as e:
        out["reachable"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _serve_section(probe: bool = True) -> dict:
    """Serve-daemon facts (docs/SERVE.md): the configured port and queue
    knobs (env-resolved, same precedence the daemon uses) plus one local
    ``/healthz`` probe of a running daemon when a port is configured."""
    from ..serve.batcher import DEFAULT_BATCH_MS, DEFAULT_MAX_BATCH
    from ..serve.daemon import DEFAULT_PORT
    from ..serve.queue import DEFAULT_DEPTH, DEFAULT_QUANTUM
    from ..utils.env import float_env, int_env

    port = os.environ.get("RS_SERVE_PORT")
    out: dict = {
        "port": port,
        "default_port": DEFAULT_PORT,
        "depth": int_env("RS_SERVE_DEPTH", DEFAULT_DEPTH),
        "quantum": int_env("RS_SERVE_QUANTUM", DEFAULT_QUANTUM),
        "batch_ms": float_env("RS_SERVE_BATCH_MS", DEFAULT_BATCH_MS),
        "max_batch": int_env("RS_SERVE_MAX_BATCH", DEFAULT_MAX_BATCH),
        "workers": int_env("RS_SERVE_WORKERS", 2),
        "reachable": None,
        "daemon": None,
        "error": None,
    }
    if not port:
        out["error"] = "RS_SERVE_PORT unset (no resident daemon configured)"
        return out
    if not probe:
        return out
    try:
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{int(port)}/healthz", timeout=2
        ) as resp:
            body = json.loads(resp.read())
            out["reachable"] = resp.status == 200
            # The live daemon's own answer (queue depth, draining,
            # inflight) — the facts a support thread asks for first.
            out["daemon"] = {
                key: body.get(key)
                for key in ("uptime_s", "draining", "queue_depth",
                            "inflight", "requests_done",
                            "requests_failed")
            }
    except Exception as e:
        out["reachable"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _slo_section(probe: bool = True) -> dict:
    """SLO-objective facts (docs/SERVE.md "Request lifecycle"): the
    parsed ``RS_SLO`` table and rolling-window config, plus one live
    ``GET /slo`` probe of a configured daemon summarizing current
    breaches.  A malformed spec surfaces here as the parse error the
    daemon would refuse to start with."""
    from . import slo as _slo

    out: dict = {
        "configured": False,
        "source": None,  # "env" | "daemon" (rs serve --slo)
        "spec": os.environ.get("RS_SLO") or None,
        "objectives": [],
        "windows_s": list(_slo.windows()),
        "reqtrace_ring": None,
        "attainment": None,
        "error": None,
    }
    try:
        from . import reqtrace as _reqtrace

        out["reqtrace_ring"] = _reqtrace.ring_capacity()
    except Exception:
        pass
    if out["spec"]:
        try:
            objectives = _slo.parse_slo(out["spec"])
        except _slo.SLOSpecError as e:
            out["error"] = f"SLOSpecError: {e}"
            return out
        out["configured"] = True
        out["source"] = "env"
        out["objectives"] = [o.describe() for o in objectives]
    port = os.environ.get("RS_SERVE_PORT")
    if probe and port:
        # Probe regardless of the env spec: a daemon started with
        # `rs serve --slo ...` is configured even when this shell's
        # RS_SLO is unset — its /slo report is the truth.
        try:
            import urllib.request

            with urllib.request.urlopen(
                f"http://127.0.0.1:{int(port)}/slo", timeout=2
            ) as resp:
                report = json.loads(resp.read())
            if report.get("configured") and not out["configured"]:
                out["configured"] = True
                out["source"] = "daemon"
                out["objectives"] = report.get("objectives", [])
            if report.get("configured"):
                out["attainment"] = {
                    "cells": len(report.get("cells", [])),
                    "breaches": _slo.breaches(report),
                }
        except Exception as e:
            if out["configured"]:
                out["error"] = f"{type(e).__name__}: {e}"
    if not out["configured"] and out["error"] is None:
        out["error"] = "RS_SLO unset (no SLO objectives)"
    return out


def _roofline_section(ledger_records: list[dict]) -> dict:
    out: dict = {"cached": False, "age_s": None, "fresh": None,
                 "triad_gbps": None, "gemm_gflops": None,
                 "max_age_s": _attrib.roofline_max_age_s()}
    host = socket.gethostname()
    rec = next(
        (r for r in reversed(ledger_records)
         if r.get("kind") == "rs_roofline" and r.get("host") == host),
        None,
    )
    if rec is None:
        return out
    out["cached"] = True
    out["triad_gbps"] = rec.get("triad_gbps")
    out["gemm_gflops"] = rec.get("gemm_gflops")
    age = time.time() - float(rec.get("ts") or 0)
    out["age_s"] = round(age, 1)
    out["fresh"] = 0 <= age < out["max_age_s"]
    return out


def collect(probe_endpoint: bool = True,
            store_root: str | None = None) -> dict:
    """The full diagnostic document (the ``--json`` payload)."""
    torch_info = _torch_section()
    ledger, ledger_records = _ledger_section()
    report = {
        "kind": "rs_doctor",
        "schema": SCHEMA_VERSION,
        "ts": time.time(),
        "host": socket.gethostname(),
        "python": {
            "version": platform.python_version(),
            "executable": sys.executable,
        },
        "torch": torch_info,
        "native": _native_section(),
        "mesh": _mesh_section(torch_info),
        "env": {
            k: v for k, v in sorted(os.environ.items())
            if k.startswith("RS_")
        },
        "decoder": _decoder_section(),
        "update": _update_section(),
        "store": _store_section(store_root),
        "strategies": _strategies_section(),
        "ledger": ledger,
        "metrics_endpoint": _endpoint_section(probe_endpoint),
        "serve": _serve_section(probe_endpoint),
        "slo": _slo_section(probe_endpoint),
        "roofline": _roofline_section(ledger_records),
        "health": _health_section(ledger_records),
        "perf": _perf_section(ledger_records),
        "maint": _maint_section(ledger_records),
    }
    warnings = []
    if not torch_info["importable"]:
        warnings.append(f"torch failed to import: {torch_info['error']}")
    if not report["native"]["available"]:
        warnings.append("native library unavailable — host paths run on "
                        "the NumPy fallback")
    if not report["mesh"]["distributed_available"]:
        warnings.append("torch.distributed missing — multi-process mesh "
                        "paths will fail")
    if report["ledger"]["path"] and report["ledger"]["writable"] is False:
        warnings.append(f"run ledger not writable: "
                        f"{report['ledger']['error']}")
    if report["roofline"]["cached"] and not report["roofline"]["fresh"]:
        warnings.append("roofline calibration is stale — rs analyze will "
                        "re-probe (or pass --refresh-roofline)")
    if report["health"]["at_risk"]:
        warnings.append(f"{report['health']['at_risk']} archive(s) at "
                        "risk — run `rs health` for the ranked fleet "
                        "table and repair the top entries")
    if report["perf"]["breach"]:
        warnings.append(f"perf drift: worst cell "
                        f"{report['perf']['worst_cell']} at "
                        f"{report['perf']['worst_ratio']}x of baseline "
                        "— run `rs perf` for the per-cell table")
    report["warnings"] = warnings
    return report


def render(report: dict) -> str:
    """Human-readable doctor output: one ok/!! line per fact."""

    def mark(ok) -> str:
        return "ok" if ok else "!!"

    j = report["torch"]
    n = report["native"]
    m = report["mesh"]
    led = report["ledger"]
    ep = report["metrics_endpoint"]
    sv = report["serve"]
    sl = report["slo"]
    rl = report["roofline"]
    if not sl["configured"]:
        slo_line = f"[--] slo: RS_SLO unset (ring {sl['reqtrace_ring']})"
        if sl["spec"]:  # set but unparseable — that IS a problem
            slo_line = f"[!!] slo: {sl['error']}"
    else:
        n_breach = (len(sl["attainment"]["breaches"])
                    if sl["attainment"] else None)
        spec = sl["spec"] if sl["source"] == "env" \
            else "from the live daemon"
        slo_line = (
            f"[{mark(not n_breach)}] slo: "
            f"{len(sl['objectives'])} objective(s) ({spec}), "
            f"windows {sl['windows_s']}"
            + (f"; live: {sl['attainment']['cells']} cell(s), "
               f"{n_breach} breach(es)" if sl["attainment"] is not None
               else "; not probed")
        )
    h = report["health"]
    if not h["enabled"] or h["error"]:
        health_line = ("[--] health: " + (h["error"] or "unavailable")
                       if not h["enabled"]
                       else f"[!!] health: {h['error']}")
    else:
        health_line = (
            f"[{mark(not h['at_risk'])}] health: {h['tracked']} archive(s) "
            f"tracked, {h['at_risk']} at risk, work queue "
            f"{h['work_queue_depth']}, {h['snapshots']} snapshot(s)"
            + (f" (last {h['snapshot_age_s']}s ago, "
               f"{h['events_since_snapshot']} delta(s) since)"
               if h["snapshot_age_s"] is not None else "")
            + (f", {h['snapshots_corrupt']} corrupt snapshot(s) skipped"
               if h["snapshots_corrupt"] else "")
        )
    mt = report["maint"]
    if mt["error"]:
        maint_line = f"[--] maint: {mt['error']}"
    else:
        mt_knobs = ", ".join(f"{k}={v}" for k, v in mt["knobs"].items()
                             if v is not None) or "knobs default"
        maint_line = (
            f"[{'ok' if mt['enabled'] else '--'}] maint: "
            + ("daemon tenant on" if mt["enabled"]
               else "daemon tenant off (RS_MAINT unset)")
            + f" — queue {mt['repairs']} repair(s), {mt['scrubs']} "
              f"scrub(s), {mt['claimed']} claimed; {mt_knobs}"
        )
    pf = report["perf"]
    if not pf["enabled"] or pf["error"]:
        perf_line = ("[--] perf: " + (pf["error"] or "unavailable")
                     if not pf["enabled"]
                     else f"[!!] perf: {pf['error']}")
    else:
        knobs = ", ".join(f"{k}={v}" for k, v in pf["knobs"].items()
                          if v is not None) or "knobs default"
        perf_line = (
            f"[{mark(not pf['breach'])}] perf: "
            + (f"baseline {pf['baseline_cells']} cell(s)"
               if pf["baseline"] else "no blessed baseline")
            + f", {pf['current_cells']} current, {pf['samples']} "
              f"sample(s)"
            + (f", worst {pf['worst_cell']} @ {pf['worst_ratio']}x "
               f"(gate {pf['drift_frac']}x)"
               if pf["worst_cell"] else "")
            + f"; {knobs}"
        )
    lines = [
        f"rs doctor @ {report['host']} "
        f"(python {report['python']['version']})",
        f"[{mark(j['importable'])}] torch {j['version'] or '-'} (CUDA "
        f"{j['cuda_version'] or '-'}): backend {j['backend'] or '-'}, "
        f"{j['device_count']} device(s)"
        + (f" {j['device_name']} {j['capability']}" if j["device_name"]
           else "")
        + f", nvcc {j['nvcc'] or 'not found'}, kernels in {j['build_dir']}"
        + (f" — {j['error']}" if j["error"] else ""),
        f"[{mark(n['available'])}] native lib: "
        + (f"{n['lib_path']} (src {n['src_digest']})"
           if n["available"] else str(n["error"])),
        f"[{mark(m['distributed_available'])}] mesh: "
        f"{m['local_device_count']} CUDA device(s), torch.distributed "
        f"{'present' if m['distributed_available'] else 'MISSING'} (nccl "
        f"{'yes' if m['nccl_available'] else 'no'}, gloo "
        f"{'yes' if m['gloo_available'] else 'no'}"
        f"{', initialized' if m['initialized'] else ''})"
        + (f", {m['distributed_env']}" if m["distributed_env"] else ""),
        "[--] RS_* knobs: "
        + (", ".join(f"{k}={v}" for k, v in report["env"].items())
           or "(none set)"),
        f"[{mark(report['decoder']['locate'])}] decoder: erasure"
        + ("+locate" if report["decoder"]["locate"] else " ONLY")
        + f", w {report['decoder']['supported_w']}, syndrome kernel "
        + (report["decoder"]["syndrome_kernel"] or "unavailable"),
        f"[{mark(report['update']['delta_update'])}] update: "
        + (
            f"delta update + append, layouts "
            f"{report['update']['layouts']}, "
            f"{report['update']['crash_safety']}; group commit "
            f"<={report['update']['group_commit']['window_max_edits']} "
            f"edits/group, {report['update']['group_commit']['groups']} "
            f"committed (max {report['update']['group_commit']['max_group_seen']})"
            if report["update"]["delta_update"]
            else f"unavailable ({report['update']['error']})"
        ),
        f"[{'--' if not report['store']['probed'] else mark(not report['store']['error'])}] "
        "store: "
        + (
            f"{len(report['store']['buckets'])} bucket(s), "
            f"{report['store']['objects']} objects, "
            f"{report['store']['live_bytes']} live / "
            f"{report['store']['dead_bytes']} dead bytes, "
            f"{report['store']['pending_compactions']} pending "
            f"compaction(s)"
            + (f", {report['store']['pending_drops']} rolled-back "
               "record(s) pending rewrite"
               if report["store"]["pending_drops"] else "")
            + (f", {report['store']['snapshots']} index snapshot(s) / "
               f"{report['store']['segments']} sealed segment(s)"
               if report["store"].get("snapshots")
               or report["store"].get("segments") else "")
            if report["store"]["probed"]
            else (report["store"]["error"]
                  or "no root (pass --root or set RS_STORE_ROOT)")
        )
        + f"; stripe {report['store']['knobs'].get('RS_STORE_STRIPE_BYTES')} B"
          f" seal, compact @"
          f"{report['store']['knobs'].get('RS_STORE_COMPACT_DEAD_FRAC')}"
          f", snapshot every "
          f"{report['store']['knobs'].get('RS_STORE_SNAPSHOT_RECORDS')}"
          f" records, obj cache "
          f"{report['store']['knobs'].get('RS_OBJ_CACHE_BYTES')} B",
        f"[{mark(not report['strategies']['error'])}] strategies: "
        + (
            f"{'/'.join(report['strategies']['candidates'])} compete for "
            f"auto -> {report['strategies']['auto']['strategy']} "
            f"({report['strategies']['auto']['source']}, mode "
            f"{report['strategies']['auto']['mode']}); xor schedules "
            f"{len(report['strategies']['xor']['schedules'])} cached, "
            "store "
            + (
                f"{report['strategies']['store']['entries'] or 0} "
                f"entries "
                f"({report['strategies']['store']['hits']} hits/"
                f"{report['strategies']['store']['misses']} misses)"
                if report["strategies"]["store"]["enabled"]
                else "disabled"
            )
            + (
                ", " + ", ".join(
                    f"{s['digest']}:{s['terms_naive']}->{s['xors']} xors"
                    for s in report["strategies"]["xor"]["schedules"][:3]
                )
                if report["strategies"]["xor"]["schedules"] else ""
            )
            if not report["strategies"]["error"]
            else f"unavailable ({report['strategies']['error']})"
        ),
        f"[{mark(led['writable'])}] ledger: "
        + (f"{led['path']} ({led['records']} records, "
           f"{led.get('damage_records', 0)} damage, "
           f"{led.get('health_snapshots', 0)} health snapshot(s))"
           if led["path"] else "RS_RUNLOG unset"),
        # reachable is None when the probe was skipped (--no-probe): an
        # untested endpoint must not render as an outage.
        f"[{'--' if ep['reachable'] is None and ep['port'] else mark(ep['reachable'])}] "
        "metrics endpoint: "
        + (f"port {ep['port']} "
           + ("not probed" if ep["reachable"] is None
              else "reachable" if ep["reachable"] else "UNREACHABLE")
           if ep["port"] else "RS_METRICS_PORT unset"),
        f"[{'--' if sv['reachable'] is None and sv['port'] else mark(sv['reachable'])}] "
        "serve daemon: "
        + (f"port {sv['port']} "
           + ("not probed" if sv["reachable"] is None
              else (f"reachable (queue {sv['daemon']['queue_depth']}, "
                    f"{'draining' if sv['daemon']['draining'] else 'live'})"
                    if sv["reachable"] and sv["daemon"] else "reachable")
              if sv["reachable"] else "UNREACHABLE")
           if sv["port"] else "RS_SERVE_PORT unset")
        + f"; knobs depth={sv['depth']} batch_ms={sv['batch_ms']} "
          f"max_batch={sv['max_batch']} workers={sv['workers']}",
        slo_line,
        f"[{mark(rl['cached'] and rl['fresh'])}] roofline: "
        + (f"{rl['triad_gbps']} GB/s triad / {rl['gemm_gflops']} GFLOP/s "
           f"gemm, age {rl['age_s']}s "
           f"({'fresh' if rl['fresh'] else 'STALE'})"
           if rl["cached"] else "not calibrated (run rs analyze)"),
        health_line,
        perf_line,
        maint_line,
    ]
    for w in report.get("warnings", []):
        lines.append(f"  warning: {w}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """The ``rs doctor`` subcommand."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs doctor",
        description="One-shot environment diagnostic: torch/CUDA devices, "
        "kernel toolchain, native lib, mesh and collectives, RS_* knobs, "
        "ledger and metrics-endpoint "
        "reachability, roofline calibration freshness.",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-stable JSON document")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the live /healthz endpoint probe")
    ap.add_argument("--root", default=None,
                    help="object-store root to probe for the store "
                    "section (default $RS_STORE_ROOT; read-only)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    report = collect(probe_endpoint=not args.no_probe,
                     store_root=args.root)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    # Exit 0 even with warnings: doctor diagnoses, CI gates elsewhere.
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
