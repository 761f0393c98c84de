"""Deterministic, seedable fault-injection plane (``RS_FAULTS`` / ``--faults``):
the port's copy of the JAX package's ``resilience/faults.py``, draw for draw.

The reference's only fault model was a hand-written conf file naming which
chunks to pretend are lost (unit-test.sh); nothing could provoke the
failures the retry/degraded-decode machinery exists for.  This module is
the injection side of that story: a :class:`FaultPlan` parsed from a
compact spec string, consulted at the I/O boundaries ONLY and compiled
to a shared no-op when unset (``active()`` returns ``None`` after one
env read; nothing parses, nothing allocates — the same tier-1 overhead
contract as the disabled metrics registry).

The boundaries: ``api._open_chunk`` (decode opens + scrub CRC reads),
the segment-gather stages of the encode/decode/repair loops (which also
cover the fallback read pool one level down), and the write-behind drain
lanes of ``parallel.io_executor`` — each crossed exactly once per
logical I/O, uniformly across native and toolchain-less builds.

Spec grammar (specs separated by ``;``, params by ``,``)::

    <scope>:<kind>[@key=val[,key=val...]]

    scope: read | write | scrub | chunk<N>   (chunk<N> fires at read AND
           scrub boundaries, only for chunk index N; add scope=read or
           scope=scrub to pin it to one boundary)
    kind:  ioerror  params p= (probability, default 1), from= (first call
                    number that may fire, default 1), times= (max fires),
                    scope= (chunk<N> boundary pin)
           delay    params ms= (sleep), plus p=/from=/times=/scope=
           bitrot   params count= (bits to flip, default 1), p=, scope=
                    (fires at its spec's boundary only: read:bitrot at
                    decode reads, scrub:bitrot at scan CRC reads)
           torn     params after= (bytes; the write lane dies once its
                    cumulative attempted bytes cross this — persistent,
                    classified FATAL by retry)
    sizes: plain ints or KiB/MiB/GiB suffixes (1MiB, 512KiB)

Examples: ``read:ioerror@p=0.02``, ``chunk2:bitrot@count=8``,
``write:torn@after=1MiB``, ``read:delay@ms=50``.

Determinism: every probabilistic decision is a pure hash of
``(seed, kind, scope, target-basename, call-number)`` — no RNG state —
so the same seed and the same call sequence produce the same schedule
regardless of wall clock, and targets are keyed by BASENAME so a run in
a different temp dir replays identically.  ``RS_FAULTS_SEED`` (or the
``seed=`` argument) selects the schedule.

Injected faults raise :class:`InjectedReadError` /
:class:`InjectedWriteError` (``OSError`` subclasses carrying kind, scope,
target and chunk index) and count ``rs_faults_injected_total{kind,scope}``
plus a ``fault`` instant on the ``faults`` trace lane.

Import cost: stdlib only (numpy is imported lazily inside the bitrot
path, which only runs when a bitrot fault actually fires).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from contextlib import contextmanager

from ..obs import metrics as _metrics, tracing as _tracing

_READ_SCOPES = ("read", "scrub")
_SIZE_SUFFIXES = (
    ("kib", 1024), ("mib", 1024 ** 2), ("gib", 1024 ** 3),
    ("k", 1024), ("m", 1024 ** 2), ("g", 1024 ** 3), ("b", 1),
)


class InjectedFault(OSError):
    """A fault raised by the plane at an I/O boundary.

    ``transient`` steers retry classification (:mod:`.retry`): ``ioerror``
    models a device hiccup (retryable), ``torn`` a writer that died
    mid-stream (fatal — retrying a dead stream is lying to the caller).
    """

    def __init__(self, kind: str, scope: str, target: str,
                 index: int | None = None, transient: bool = True):
        self.kind = kind
        self.scope = scope
        self.target = target
        self.index = index
        self.transient = transient
        where = target + (f" (chunk {index})" if index is not None else "")
        super().__init__(
            f"injected {kind} fault at {scope} boundary: {where}"
        )


class InjectedReadError(InjectedFault):
    pass


class InjectedWriteError(InjectedFault):
    pass


def _parse_size(text: str) -> int:
    t = text.strip().lower()
    for suffix, mult in _SIZE_SUFFIXES:
        if t.endswith(suffix):
            return int(float(t[: -len(suffix)]) * mult)
    return int(t)


_ALLOWED_PARAMS = {
    "ioerror": {"p", "from", "times", "scope"},
    "delay": {"ms", "p", "from", "times", "scope"},
    "bitrot": {"count", "p", "scope"},
    "torn": {"after"},
}


class FaultSpec:
    """One parsed ``scope:kind@params`` spec."""

    __slots__ = ("scope", "kind", "params", "chunk", "text")

    def __init__(self, scope: str, kind: str, params: dict, text: str):
        self.scope = scope
        self.kind = kind
        self.params = params
        self.text = text
        self.chunk = (
            int(scope[len("chunk"):])
            if scope.startswith("chunk") else None
        )

    @classmethod
    def parse(cls, token: str) -> "FaultSpec":
        token = token.strip()
        head, _, tail = token.partition("@")
        scope, sep, kind = head.partition(":")
        if not sep or not scope or not kind:
            raise ValueError(
                f"bad fault spec {token!r}: want <scope>:<kind>[@k=v,...]"
            )
        scope, kind = scope.strip().lower(), kind.strip().lower()
        if scope.startswith("chunk"):
            if not scope[len("chunk"):].isdigit():
                raise ValueError(
                    f"bad fault scope {scope!r}: chunk scope is chunk<N>"
                )
        elif scope not in ("read", "write", "scrub"):
            raise ValueError(
                f"bad fault scope {scope!r}: "
                "want read|write|scrub|chunk<N>"
            )
        if kind not in _ALLOWED_PARAMS:
            raise ValueError(
                f"bad fault kind {kind!r}: want "
                f"{'|'.join(sorted(_ALLOWED_PARAMS))}"
            )
        if kind == "torn" and scope != "write":
            raise ValueError(f"torn faults are write-scope only: {token!r}")
        if kind == "bitrot" and scope == "write":
            raise ValueError(
                f"bitrot faults fire at read boundaries: {token!r}"
            )
        params: dict = {}
        if tail:
            for kv in tail.split(","):
                key, sep2, val = kv.partition("=")
                key = key.strip().lower()
                if not sep2 or key not in _ALLOWED_PARAMS[kind]:
                    raise ValueError(
                        f"bad fault param {kv!r} for kind {kind!r} "
                        f"(allowed: {sorted(_ALLOWED_PARAMS[kind])})"
                    )
                if key in ("after",):
                    params[key] = _parse_size(val)
                elif key in ("from", "times", "count"):
                    params[key] = int(val)
                elif key == "scope":
                    val = val.strip().lower()
                    if val not in _READ_SCOPES:
                        raise ValueError(
                            f"fault scope= pin must be read|scrub: {kv!r}"
                        )
                    params[key] = val
                else:  # p, ms
                    params[key] = float(val)
        if kind == "delay" and "ms" not in params:
            raise ValueError(f"delay fault needs ms=: {token!r}")
        if kind == "torn" and "after" not in params:
            raise ValueError(f"torn fault needs after=: {token!r}")
        p = params.get("p", 1.0)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability p={p} outside [0, 1]")
        return cls(scope, kind, params, token)

    def matches_read(self, scope: str, index: int | None) -> bool:
        if self.chunk is not None:
            if scope not in _READ_SCOPES or index != self.chunk:
                return False
            pin = self.params.get("scope")
            return pin is None or pin == scope
        return self.scope == scope


class FaultPlan:
    """A parsed fault schedule with deterministic per-boundary decisions.

    Thread-safe; all mutable state (per-target call counters, per-lane
    byte accumulators, per-spec fire counts) sits under one lock.  The
    ``injected`` dict mirrors the ``rs_faults_injected_total`` series so
    tests can assert without enabling the metrics registry.
    """

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._read_specs = [
            s for s in self.specs
            if s.kind in ("ioerror", "delay")
            and (s.chunk is not None or s.scope in _READ_SCOPES)
        ]
        self._bitrot_specs = [s for s in self.specs if s.kind == "bitrot"]
        self._write_specs = [
            s for s in self.specs if s.scope == "write"
        ]
        self._lock = threading.Lock()
        self._calls: dict[tuple, int] = {}
        self._lane_bytes: dict[str, int] = {}
        self._fires: dict[int, int] = {}
        self.injected: dict[tuple, int] = {}

    # -- deterministic decisions ---------------------------------------------

    def _draw(self, *key) -> float:
        h = zlib.crc32(repr((self.seed,) + key).encode())
        return h / 2 ** 32

    @staticmethod
    def _target(path) -> str:
        # Basename keying: a chaos run in a different temp dir must replay
        # the same schedule.
        return os.path.basename(path) if path else "<anon>"

    def _next_call(self, scope: str, name: str) -> int:
        with self._lock:
            key = (scope, name)
            n = self._calls.get(key, 0) + 1
            self._calls[key] = n
            return n

    def _take_fire(self, spec: FaultSpec) -> bool:
        """Respect the spec's ``times=`` cap (unlimited when absent)."""
        times = spec.params.get("times")
        with self._lock:
            fired = self._fires.get(id(spec), 0)
            if times is not None and fired >= times:
                return False
            self._fires[id(spec)] = fired + 1
            return True

    def _record(self, kind: str, scope: str, target: str,
                index: int | None) -> None:
        with self._lock:
            key = (kind, scope)
            self.injected[key] = self.injected.get(key, 0) + 1
        _metrics.counter(
            "rs_faults_injected_total", "faults fired by the injection plane"
        ).labels(kind=kind, scope=scope).inc()
        _tracing.instant(
            "fault", lane="faults", kind=kind, scope=scope,
            target=target, index=index,
        )

    # -- boundary hooks ------------------------------------------------------

    def on_read(self, path, index: int | None = None,
                scope: str = "read") -> None:
        """One read-boundary crossing; may sleep (delay) or raise
        :class:`InjectedReadError` (ioerror)."""
        name = self._target(path)
        n = self._next_call(scope, name)
        for spec in self._read_specs:
            if not spec.matches_read(scope, index):
                continue
            if n < spec.params.get("from", 1):
                continue
            if self._draw(spec.kind, scope, name, n) >= spec.params.get(
                "p", 1.0
            ):
                continue
            if not self._take_fire(spec):
                continue
            self._record(spec.kind, scope, name, index)
            if spec.kind == "delay":
                time.sleep(spec.params["ms"] / 1000.0)
            else:
                raise InjectedReadError("ioerror", scope, name, index)

    def corrupt_read(self, path, index: int | None, arr,
                     scope: str = "read"):
        """Apply matching bitrot specs to read bytes; returns ``arr``
        untouched when none fire, else a corrupted COPY (the on-disk file
        is not modified — this models rot between platter and host).
        ``scope`` distinguishes decode reads from scrub CRC reads, so
        ``read:bitrot`` and ``scrub:bitrot`` target their own boundary.

        Boundary note: bitrot fires at WHOLE-CHUNK reads through
        ``api._open_chunk`` — scrub/verify CRC passes, decode survivor
        opens, and the native-passthrough row copies that read those
        views.  The streaming segment gathers read through their own fds
        (native pread) and do not see this corruption — to exercise
        decode-INPUT rot end to end, corrupt the file on disk the way
        ``rs chaos`` does.  (On toolchain-less builds the fallback
        gather reads the opened views, so decode inputs may see the rot
        there too — a test-plane edge, not a contract.)"""
        if not self._bitrot_specs:
            return arr
        name = self._target(path)
        # Per-crossing draws on a dedicated counter family (the caller's
        # on_read already consumed this crossing's (scope, name) count),
        # so p= is a fresh coin per read like ioerror/delay, and read-
        # vs scrub-boundary specs draw independently.
        n = self._next_call(f"bitrot@{scope}", name)
        out = arr
        for spec in self._bitrot_specs:
            if not spec.matches_read(scope, index):
                continue
            if self._draw("bitrot", scope, name, n) >= spec.params.get(
                "p", 1.0
            ):
                continue
            nbits = len(out) * 8
            if nbits == 0:
                continue
            if not self._take_fire(spec):
                continue
            import numpy as np

            if out is arr:
                out = np.array(arr, dtype=np.uint8, copy=True)
            count = max(1, spec.params.get("count", 1))
            positions = set()
            salt = 0
            while len(positions) < min(count, nbits):
                bit = int(self._draw("bitrot_pos", scope, name, n,
                                     len(positions), salt) * nbits) % nbits
                salt += 1
                positions.add(bit)
            for bit in sorted(positions):
                out[bit // 8] ^= 1 << (bit % 8)
            self._record("bitrot", scope, name, index)
        return out

    def on_write(self, lane: str, nbytes: int = 0) -> None:
        """One write-lane crossing of ``nbytes`` attempted bytes; may
        sleep, raise a transient :class:`InjectedWriteError` (ioerror) or
        a fatal one (torn — the lane's cumulative attempted bytes crossed
        ``after=``, and stays dead)."""
        if not self._write_specs:
            return
        with self._lock:
            before = self._lane_bytes.get(lane, 0)
            self._lane_bytes[lane] = before + max(0, nbytes)
        n = self._next_call("write", lane)
        for spec in self._write_specs:
            if spec.kind == "torn":
                if before + max(0, nbytes) > spec.params["after"]:
                    self._record("torn", "write", lane, None)
                    raise InjectedWriteError(
                        "torn", "write", lane, transient=False
                    )
                continue
            if n < spec.params.get("from", 1):
                continue
            if self._draw(spec.kind, "write", lane, n) >= spec.params.get(
                "p", 1.0
            ):
                continue
            if not self._take_fire(spec):
                continue
            self._record(spec.kind, "write", lane, None)
            if spec.kind == "delay":
                time.sleep(spec.params["ms"] / 1000.0)
            else:
                raise InjectedWriteError("ioerror", "write", lane)

    def describe(self) -> str:
        return ";".join(s.text for s in self.specs)


def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """Parse a full ``RS_FAULTS`` spec string into a :class:`FaultPlan`.
    Raises ``ValueError`` on any malformed spec (fail loudly at parse
    time, not silently at the first boundary)."""
    specs = [
        FaultSpec.parse(tok)
        for tok in text.replace("\n", ";").split(";")
        if tok.strip()
    ]
    if not specs:
        raise ValueError(f"empty fault spec {text!r}")
    return FaultPlan(specs, seed=seed)


# -- module-level plane (the hook surface) -----------------------------------
#
# The disabled path is the contract: with RS_FAULTS unset and no activate()
# override, active() is one env read returning the shared None — nothing
# parses, nothing allocates, no per-call state.  Guarded by
# tests/test_resilience.py::test_disabled_fault_plane_is_noop.

_OVERRIDE: FaultPlan | None = None
_CACHE_KEY: tuple | None = None
_CACHE_PLAN: FaultPlan | None = None
_STATE_LOCK = threading.Lock()


def env_seed() -> int:
    """The ``RS_FAULTS_SEED`` env seed (0 when unset or malformed) — the
    one parse shared by :func:`active` and the CLI's ``--faults``."""
    try:
        return int(os.environ.get("RS_FAULTS_SEED", "0"))
    except ValueError:
        return 0


def active() -> FaultPlan | None:
    """The live plan: an :func:`activate` override, else the parsed (and
    cached) ``RS_FAULTS`` env plan, else None."""
    plan = _OVERRIDE
    if plan is not None:
        return plan
    text = os.environ.get("RS_FAULTS")
    if not text:
        return None
    seed = env_seed()
    global _CACHE_KEY, _CACHE_PLAN
    key = (text, seed)
    with _STATE_LOCK:
        if _CACHE_KEY != key:
            _CACHE_PLAN = parse_plan(text, seed=seed)
            _CACHE_KEY = key
        return _CACHE_PLAN


@contextmanager
def activate(plan: FaultPlan | None):
    """Install ``plan`` as the process's fault plane for the block (the
    chaos harness's per-iteration scoping; nests by restoring the prior
    override)."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = plan
    try:
        yield plan
    finally:
        _OVERRIDE = prev


def on_read(path, index: int | None = None, scope: str = "read") -> None:
    plan = active()
    if plan is not None:
        plan.on_read(path, index=index, scope=scope)


def on_reads(paths, indices, scope: str = "read") -> None:
    """Per-survivor read hook for the segment-gather stages (one boundary
    crossing per chunk per segment)."""
    plan = active()
    if plan is not None:
        for path, index in zip(paths, indices):
            plan.on_read(path, index=index, scope=scope)


def corrupt(path, index, arr, scope: str = "read"):
    plan = active()
    if plan is None:
        return arr
    return plan.corrupt_read(path, index, arr, scope=scope)


def on_write(lane: str, nbytes: int = 0) -> None:
    plan = active()
    if plan is not None:
        plan.on_write(lane, nbytes)
