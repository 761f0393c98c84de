"""The identity header of a measurement tool's JSON-lines output: the
port's own minimal copy of the JAX package's ``obs/runlog.py``
``capture_header`` (same keys; no run ledger).

Import cost: the standard library and :mod:`..utils.backend`.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
import uuid

from ..utils.backend import backend_label

SCHEMA_VERSION = 1

# One run id per process: every header of one invocation shares it.
_RUN_ID = uuid.uuid4().hex[:12]
_GIT_SHA: str | None | bool = False  # False = not yet resolved


def run_id() -> str:
    """This process's run id (12 hex chars)."""
    return _RUN_ID


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
