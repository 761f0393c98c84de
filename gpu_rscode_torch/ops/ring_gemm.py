"""Polynomial-ring GF(2^w) GEMM, ``strategy="ring"``: the port of the JAX
package's ``ops/ring_gemm.py`` to plain PyTorch.

The ring lowering of arXiv 1701.07731 (Detchart & Lacan): each GF(2^w)
symbol is embedded into the cyclic ring ``R_p = F2[x]/(x^p+1)`` for a prime
``p`` with ``ord_p(2) = w`` (17 for w=8, 257 for w=16), where multiplying
by ``x^s`` is a cyclic shift of the coefficient vector: at the bit-plane
level a re-indexing of the planes, no operation at all.  A coefficient
multiply then costs the XOR of a few shifted copies (its lift weight).

The embedding keeps byte equivalence with the repo's fields: ``psi: R_p
-> GF(2^w), x -> g`` with ``g`` of order p; ``{g^0..g^(w-1)}`` is a basis,
so ``u = sum_j c_j g^j`` with ``c = M . bits(u)`` lifts each input; each
coefficient lifts to the minimum-weight preimage among the ``2^(p-w)``
solutions of ``Psi z = bits(a)`` (exhaustive for w=8, a greedy descent for
w=16).

One dispatch is three straight-line XOR programs between the packing and
unpacking of :mod:`.xor_gemm` (a :class:`.xor_gemm.PackedOperand` packed
for xor feeds ring unchanged):

1. **ring-in**: per input row, the w byte planes -> w coefficient planes;
2. **accumulate**: ring plane ``t`` of output row r XORs plane ``(t - s)
   mod p`` of every input i for every ``s`` in the lift support of ``A[r,
   i]``: the shifts are index arithmetic;
3. **ring-out**: ``psi`` maps the active ring planes back to w byte planes
   per output row.

The host half (the embedding, the three Paar-CSE'd stage programs, the
persistent store with ``kind: "rs_ring_schedule"``) is copied from the
JAX package so schedules and records are identical; the optimizer pass
(:mod:`.xor_opt`) reorders and groups each stage and the chain runs
whole-width on CUDA, tiled on the CPU, as for xor.  w=16 (p=257, a 16x
plane expansion) is a correctness rung only.
"""

from __future__ import annotations

import hashlib
import json
import socket
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import xor_gemm as _xg
from . import xor_opt as _xopt
from ..obs import metrics as _metrics, profiler as _prof, runlog as _runlog
from .gf import get_field
from .xor_gemm import _COL_ALIGN, PackedOperand, matrix_digest, paar_cse

__all__ = [
    "RingSchedule", "RingPipeline", "build_ring_schedule",
    "gf_matmul_ring", "get_ring_pipeline", "clear_ring_caches",
    "ring_schedule_stats", "ring_pipeline_stats", "ring_store_stats",
    "ring_params",
]

_SUPPORTED_W = (8, 16)

# p per width: the smallest prime with ord_p(2) = w, so x^p+1 has a
# degree-w irreducible factor and GF(2^w) holds an element of order p.
_RING_P = {8: 17, 16: 257}


# -- embedding context (NumPy, cached per w) ----------------------------------


def _gf2_solve_affine(Mx: np.ndarray, b: np.ndarray):
    """Particular solution and kernel basis of ``Mx z = b`` over GF(2)."""
    rows, cols = Mx.shape
    A = np.concatenate([Mx.copy(), b.reshape(-1, 1)], axis=1).astype(np.uint8)
    pivots, r = [], 0
    for c in range(cols):
        piv = next((i for i in range(r, rows) if A[i, c]), None)
        if piv is None:
            continue
        A[[r, piv]] = A[[piv, r]]
        for i in range(rows):
            if i != r and A[i, c]:
                A[i] ^= A[r]
        pivots.append(c)
        r += 1
        if r == rows:
            break
    if any(A[i, cols] for i in range(r, rows)):
        raise ValueError("inconsistent GF(2) system")
    z = np.zeros(cols, np.uint8)
    for i, c in enumerate(pivots):
        z[c] = A[i, cols]
    ker = []
    for f in (c for c in range(cols) if c not in pivots):
        v = np.zeros(cols, np.uint8)
        v[f] = 1
        for i, c in enumerate(pivots):
            v[c] = A[i, f]
        ker.append(v)
    return z, ker


def _gf2_inv(Mx: np.ndarray) -> np.ndarray:
    n = Mx.shape[0]
    A = np.concatenate([Mx.copy().astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    r = 0
    for c in range(n):
        piv = next((i for i in range(r, n) if A[i, c]), None)
        if piv is None:
            raise ValueError("singular GF(2) matrix")
        A[[r, piv]] = A[[piv, r]]
        for i in range(n):
            if i != r and A[i, c]:
                A[i] ^= A[r]
        r += 1
    return A[:, n:]


class _RingCtx:
    """Embedding data for one w: p, Psi (w x p), M (w x w), kernel."""

    __slots__ = ("w", "p", "g", "psi", "m", "kernel", "_lifts", "_gf")

    def __init__(self, w: int):
        gf = get_field(w)
        p = _RING_P[w]

        def fmul(a, b):
            return int(np.asarray(gf.mul(np.array([a], gf.dtype), np.array([b], gf.dtype)))[0])

        def fpow(a, e):
            r, base = 1, a
            while e:
                if e & 1:
                    r = fmul(r, base)
                base = fmul(base, base)
                e >>= 1
            return r

        g = fpow(2, (gf.size - 1) // p)  # alpha=2 is primitive for both
        psi = np.zeros((w, p), np.uint8)
        v = 1
        for t in range(p):
            for b in range(w):
                psi[b, t] = (v >> b) & 1
            v = fmul(v, g)
        self.w, self.p, self.g = w, p, g
        self.psi = psi
        self.m = _gf2_inv(psi[:, :w])  # c = M . bits(u)
        _, self.kernel = _gf2_solve_affine(psi, np.zeros(w, np.uint8))
        self._lifts: dict[int, np.ndarray] = {}
        self._gf = gf

    def lift(self, a: int) -> np.ndarray:
        """Minimum-weight (w=8: exact; w=16: greedy) preimage of ``a`` under
        psi, as a p-length 0/1 vector."""
        hit = self._lifts.get(a)
        if hit is not None:
            return hit
        bits = np.array([(a >> b) & 1 for b in range(self.w)], np.uint8)
        z, ker = _gf2_solve_affine(self.psi, bits)
        if self.w == 8:
            # 2^(17-8) = 512 coset elements: the exhaustive minimum.
            K = np.array(ker, np.uint8)
            best, bw = z, int(z.sum())
            for mask in range(1, 1 << len(ker)):
                v = z.copy()
                mm, i = mask, 0
                while mm:
                    if mm & 1:
                        v ^= K[i]
                    mm >>= 1
                    i += 1
                wt = int(v.sum())
                if wt < bw:
                    best, bw = v, wt
            z = best
        else:
            # Greedy steepest descent over the kernel basis (the 2^241
            # coset cannot be enumerated).  Deterministic.
            K = np.array(ker, np.uint8)
            while True:
                cand = z ^ K
                wts = cand.sum(axis=1)
                i = int(wts.argmin())
                if wts[i] >= z.sum():
                    break
                z = cand[i]
        self._lifts[a] = z
        return z


_CTX_CACHE: dict[int, _RingCtx] = {}
_CTX_LOCK = threading.Lock()


def _ctx(w: int) -> _RingCtx:
    with _CTX_LOCK:
        hit = _CTX_CACHE.get(w)
        if hit is None:
            hit = _CTX_CACHE[w] = _RingCtx(w)
        return hit


def ring_params(w: int) -> dict:
    """Embedding facts: p, the generator, the basis density."""
    c = _ctx(w)
    return {
        "w": w,
        "p": c.p,
        "g": c.g,
        "psi_density": round(float(c.psi.mean()), 4),
        "plane_expansion": round(c.p / w, 4),
    }


# -- schedule -----------------------------------------------------------------


@dataclass(frozen=True)
class RingSchedule:
    """Three Paar-CSE'd straight-line XOR programs (hashable, immutable).

    Stage s consumes the previous stage's output planes (stage 1: the
    ``k * w`` packed byte planes): ``sN_pairs[t] = (a, b)`` defines node
    ``n_inputs_N + t``; ``sN_rows`` lists each output plane's term nodes
    (an empty tuple is a zero plane).  ``s2_planes`` records which
    ``(out_row, ring_plane_t)`` each stage-2 output is; stage 3's term
    indices point into that list.
    """

    digest: str
    w: int
    p: int
    rows_out: int
    k: int
    n_inputs: int
    s1_pairs: tuple
    s1_rows: tuple
    s2_pairs: tuple
    s2_rows: tuple
    s2_planes: tuple
    s3_pairs: tuple
    s3_rows: tuple
    terms_naive: int
    terms_cse: int
    cse: bool
    build_seconds: float

    @property
    def xors(self) -> int:
        """XOR ops one dispatch evaluates (per packed word column)."""
        return sum(len(pairs) + sum(max(0, len(r) - 1) for r in rows) for pairs, rows in self.stage_payloads)

    @property
    def stage_payloads(self) -> tuple:
        return (
            (self.s1_pairs, self.s1_rows),
            (self.s2_pairs, self.s2_rows),
            (self.s3_pairs, self.s3_rows),
        )


_SCHEDULE_CACHE: dict[tuple, RingSchedule] = {}
_SCHEDULE_LOCK = threading.Lock()


# Paar's elimination argmaxes an O((n_inputs + pairs)^2) co-occurrence
# counter per extracted pair; ring stages can carry thousands of input
# planes, where that costs minutes for a few XORs.  Stages past this size
# run naive: the same bytes, no shared nodes.
_CSE_STAGE_BOUND = 2048


def _stage_program(row_sets, n_inputs: int, cse: bool):
    """(pair_ops, rows) for one stage, Paar-CSE'd when enabled."""
    sets = [set(s) for s in row_sets]
    if cse and 0 < max(n_inputs, len(sets)) <= _CSE_STAGE_BOUND and n_inputs > 0:
        pair_ops, sets = paar_cse(sets, n_inputs)
    else:
        pair_ops = []
    return tuple(pair_ops), tuple(tuple(int(t) for t in sorted(s)) for s in sets)


# -- persistent store (kind: rs_ring_schedule) --------------------------------
#
# The xor store's contract: pure data keyed by (digest, cse, algorithm
# version), every load validated, a corrupt record rebuilt.

_STORE_ALGO = 1

_STORE_LOCK = threading.Lock()
_STORE_INDEX: dict[tuple, dict] | None = None
_STORE_STATS = {"hits": 0, "misses": 0, "stored": 0, "corrupt": 0, "built": 0}


def _store_path() -> str | None:
    return _runlog.store_path()


def _count_store(outcome: str, tally: str) -> None:
    """One store lookup's outcome: the tally of :func:`ring_store_stats`
    and ``rs_ring_schedule_store_total``."""
    with _STORE_LOCK:
        _STORE_STATS[tally] += 1
    _metrics.counter("rs_ring_schedule_store_total", "persistent ring-schedule store lookups by outcome").labels(
        outcome=outcome).inc()


def _store_index() -> dict[tuple, dict]:
    global _STORE_INDEX
    with _STORE_LOCK:
        if _STORE_INDEX is not None:
            return _STORE_INDEX
    p = _store_path()
    idx: dict[tuple, dict] = {}
    if p:
        for rec in _runlog.read_records(p):
            if rec.get("kind") != "rs_ring_schedule":
                continue
            digest = rec.get("digest")
            if not isinstance(digest, str):
                continue
            key = (digest, bool(rec.get("cse")))
            cur = idx.get(key)
            if cur is None or _xg._rec_ts(rec) >= _xg._rec_ts(cur):
                idx[key] = rec
    with _STORE_LOCK:
        if _STORE_INDEX is None:
            _STORE_INDEX = idx
        return _STORE_INDEX


def _reset_store_index() -> None:
    global _STORE_INDEX
    with _STORE_LOCK:
        _STORE_INDEX = None


def _payload_digest(sched_fields: dict) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(json.dumps(sched_fields, separators=(",", ":")).encode())
    return h.hexdigest()


def _stage_fields(s1_pairs, s1_rows, s2_pairs, s2_rows, s2_planes, s3_pairs, s3_rows) -> dict:
    return {
        "s1_pairs": [list(x) for x in s1_pairs],
        "s1_rows": [list(r) for r in s1_rows],
        "s2_pairs": [list(x) for x in s2_pairs],
        "s2_rows": [list(r) for r in s2_rows],
        "s2_planes": [list(x) for x in s2_planes],
        "s3_pairs": [list(x) for x in s3_pairs],
        "s3_rows": [list(r) for r in s3_rows],
    }


def _validate_stage(pair_ops, rows, n_inputs: int, n_rows: int | None):
    for t, (a, b) in enumerate(pair_ops):
        if not (0 <= a < n_inputs + t and 0 <= b < n_inputs + t):
            raise ValueError("pair op references an undefined node")
    n_nodes = n_inputs + len(pair_ops)
    for r in rows:
        for t in r:
            if not 0 <= t < n_nodes:
                raise ValueError("row term references an undefined node")
    if n_rows is not None and len(rows) != n_rows:
        raise ValueError("stage row count inconsistent")


def _schedule_from_store(digest: str, cse: bool, A: np.ndarray, w: int) -> RingSchedule | None:
    if not _store_path():
        return None
    rec = _store_index().get((digest, cse))
    if rec is None:
        _count_store("miss", "misses")
        return None
    try:
        if rec.get("algo_version") != _STORE_ALGO:
            raise ValueError("algorithm version mismatch")
        rows_out, k = int(rec["rows_out"]), int(rec["k"])
        n_inputs, p = int(rec["n_inputs"]), int(rec["p"])
        if (int(rec["w"]), rows_out, k) != (w, A.shape[0], A.shape[1]):
            raise ValueError("shape fields disagree with the matrix")
        if n_inputs != k * w or p != _RING_P[w]:
            raise ValueError("ring parameters inconsistent with (k, w)")
        s1_pairs = tuple((int(a), int(b)) for a, b in rec["s1_pairs"])
        s1_rows = tuple(tuple(int(t) for t in r) for r in rec["s1_rows"])
        s2_pairs = tuple((int(a), int(b)) for a, b in rec["s2_pairs"])
        s2_rows = tuple(tuple(int(t) for t in r) for r in rec["s2_rows"])
        s2_planes = tuple((int(r_), int(t)) for r_, t in rec["s2_planes"])
        s3_pairs = tuple((int(a), int(b)) for a, b in rec["s3_pairs"])
        s3_rows = tuple(tuple(int(t) for t in r) for r in rec["s3_rows"])
        _validate_stage(s1_pairs, s1_rows, n_inputs, k * w)
        _validate_stage(s2_pairs, s2_rows, k * w, len(s2_planes))
        if len(s2_rows) != len(s2_planes):
            raise ValueError("stage-2 plane map inconsistent")
        for r_, t in s2_planes:
            if not (0 <= r_ < rows_out and 0 <= t < p):
                raise ValueError("stage-2 plane id out of range")
        _validate_stage(s3_pairs, s3_rows, len(s2_planes), rows_out * w)
        fields = _stage_fields(s1_pairs, s1_rows, s2_pairs, s2_rows, s2_planes, s3_pairs, s3_rows)
        if rec.get("payload_digest") != _payload_digest(fields):
            raise ValueError("payload checksum mismatch")
        sched = RingSchedule(
            digest=digest, w=w, p=p, rows_out=rows_out, k=k,
            n_inputs=n_inputs,
            s1_pairs=s1_pairs, s1_rows=s1_rows,
            s2_pairs=s2_pairs, s2_rows=s2_rows, s2_planes=s2_planes,
            s3_pairs=s3_pairs, s3_rows=s3_rows,
            terms_naive=int(rec["terms_naive"]),
            terms_cse=int(rec["terms_cse"]),
            cse=cse, build_seconds=0.0,
        )
    except Exception:
        # Any malformed field, whatever it raises: rebuild, never trust.
        with _STORE_LOCK:
            if _STORE_INDEX is not None:
                _STORE_INDEX.pop((digest, cse), None)
        _count_store("corrupt", "corrupt")
        return None
    _count_store("hit", "hits")
    return sched


def _schedule_to_store(sched: RingSchedule) -> None:
    p = _store_path()
    if not p:
        return
    key = (sched.digest, sched.cse)
    idx = _store_index()
    if key in idx:
        return
    fields = _stage_fields(sched.s1_pairs, sched.s1_rows, sched.s2_pairs, sched.s2_rows, sched.s2_planes,
                           sched.s3_pairs, sched.s3_rows)
    rec = {
        "kind": "rs_ring_schedule",
        "schema": _runlog.SCHEMA_VERSION,
        "algo_version": _STORE_ALGO,
        "digest": sched.digest,
        "cse": sched.cse,
        "w": sched.w,
        "p": sched.p,
        "rows_out": sched.rows_out,
        "k": sched.k,
        "n_inputs": sched.n_inputs,
        **fields,
        "payload_digest": _payload_digest(fields),
        "terms_naive": sched.terms_naive,
        "terms_cse": sched.terms_cse,
        "build_seconds": round(sched.build_seconds, 6),
        "ts": time.time(),
        "run": _runlog.run_id(),
        "host": socket.gethostname(),
    }
    _runlog.append(rec, p)
    with _STORE_LOCK:
        if _STORE_INDEX is not None:
            _STORE_INDEX[key] = rec
    _count_store("stored", "stored")


def ring_store_stats(load: bool = False) -> dict:
    """The ring store's facts (as :func:`.xor_gemm.store_stats`)."""
    p = _store_path()
    if load and p:
        _store_index()
    with _STORE_LOCK:
        entries = len(_STORE_INDEX) if _STORE_INDEX is not None else None
        out = dict(_STORE_STATS)
    out.update({"path": p, "enabled": p is not None, "entries": entries})
    return out


# -- schedule build -----------------------------------------------------------


def build_ring_schedule(A, w: int, cse: bool | None = None) -> RingSchedule:
    """Ring-lower ``A`` into the three stage programs: from the in-process
    cache, else from the persistent store, else built (and stored)."""
    if w not in _SUPPORTED_W:
        raise ValueError(f"strategy='ring' supports w in {_SUPPORTED_W}, got w={w}")
    if cse is None:
        cse = _xg._cse_enabled()
    A = np.asarray(A)
    digest = matrix_digest(A, w)
    key = (digest, bool(cse))
    with _SCHEDULE_LOCK:
        hit = _SCHEDULE_CACHE.get(key)
    if hit is not None:
        _prof.attr(schedule="memory")
        return hit
    loaded = _schedule_from_store(digest, bool(cse), A, w)
    if loaded is not None:
        _prof.attr(schedule="store")
        with _SCHEDULE_LOCK:
            return _SCHEDULE_CACHE.setdefault(key, loaded)
    _prof.attr(schedule="built")
    with _STORE_LOCK:
        _STORE_STATS["built"] += 1
    t0 = time.perf_counter()
    ctx = _ctx(w)
    p = ctx.p
    rows_out, k = A.shape
    n_inputs = k * w

    # Stage 1, ring-in: c_{i,j} = sum_b M[j,b] u_{i,b}.
    s1_sets = [{i * w + b for b in np.flatnonzero(ctx.m[j])} for i in range(k) for j in range(w)]

    # Stage 2, shift-accumulate: ring plane (r, t) is the parity-XOR of
    # c-planes (i, j) over every lift support s with (j+s) % p == t.
    terms: list[dict[int, set[int]]] = [dict() for _ in range(rows_out)]
    for r in range(rows_out):
        for i in range(k):
            a = int(A[r, i])
            if not a:
                continue
            lift = ctx.lift(a)
            for s in np.flatnonzero(lift):
                for j in range(w):
                    t = (j + int(s)) % p
                    bucket = terms[r].setdefault(t, set())
                    c_idx = i * w + j
                    if c_idx in bucket:
                        bucket.discard(c_idx)  # parity cancellation
                    else:
                        bucket.add(c_idx)
    s2_planes: list[tuple[int, int]] = []
    s2_sets: list[set[int]] = []
    for r in range(rows_out):
        for t in sorted(terms[r]):
            if terms[r][t]:
                s2_planes.append((r, t))
                s2_sets.append(terms[r][t])
    plane_index = {rt: i for i, rt in enumerate(s2_planes)}

    # Stage 3, ring-out: bits(out_r)[b] = sum_t Psi[b,t] S_r[t] (inactive
    # ring planes are zero and drop out).
    s3_sets = []
    for r in range(rows_out):
        for b in range(w):
            s3_sets.append({plane_index[(r, t)] for t in np.flatnonzero(ctx.psi[b]) if (r, int(t)) in plane_index})

    naive = sum(len(s) for s in s1_sets + s2_sets + s3_sets)
    limit = _xg._max_terms()
    if naive > limit:
        raise ValueError(
            f"ring schedule for {rows_out}x{k} w={w} needs {naive} XOR "
            f"terms, over RS_XOR_MAX_TERMS={limit}; use strategy='xor' "
            "(or raise the knob) for matrices this large"
        )
    s1_pairs, s1_rows = _stage_program(s1_sets, n_inputs, bool(cse))
    s2_pairs, s2_rows = _stage_program(s2_sets, n_inputs, bool(cse))
    s3_pairs, s3_rows = _stage_program(s3_sets, len(s2_planes), bool(cse))
    terms_cse = len(s1_pairs) + len(s2_pairs) + len(s3_pairs) + sum(len(r) for r in s1_rows + s2_rows + s3_rows)
    dt = time.perf_counter() - t0
    _metrics.quantile("rs_ring_schedule_build_seconds",
                      "ring-schedule lowering+CSE wall seconds (streaming quantiles)").observe(dt)
    sched = RingSchedule(
        digest=digest, w=w, p=p, rows_out=rows_out, k=k,
        n_inputs=n_inputs,
        s1_pairs=s1_pairs, s1_rows=s1_rows,
        s2_pairs=s2_pairs, s2_rows=s2_rows,
        s2_planes=tuple(s2_planes),
        s3_pairs=s3_pairs, s3_rows=s3_rows,
        terms_naive=naive, terms_cse=terms_cse,
        cse=bool(cse), build_seconds=dt,
    )
    _schedule_to_store(sched)
    with _SCHEDULE_LOCK:
        return _SCHEDULE_CACHE.setdefault(key, sched)


def ring_schedule_stats() -> list[dict]:
    """The ring schedules built in this process."""
    with _SCHEDULE_LOCK:
        scheds = list(_SCHEDULE_CACHE.values())
    return [
        {
            "digest": s.digest,
            "w": s.w,
            "p": s.p,
            "rows_out": s.rows_out,
            "k": s.k,
            "cse": s.cse,
            "ring_planes": len(s.s2_planes),
            "terms_naive": s.terms_naive,
            "terms_cse": s.terms_cse,
            "xors": s.xors,
            "build_seconds": round(s.build_seconds, 6),
        }
        for s in scheds
    ]


# -- the chain ----------------------------------------------------------------


def _emit_slp(inputs, pair_ops, rows, width: int, like: torch.Tensor) -> torch.Tensor:
    """One stage's straight-line XOR program over ``width``-word planes;
    returns its output planes as one (len(rows), width) tensor.  ``like``
    gives device and dtype: a stage fed by an all-zero coefficient row can
    have no inputs at all."""
    out = like.new_empty((len(rows), width))
    _xg._slp(inputs, pair_ops, rows, like.new_empty((len(pair_ops), width)), out)
    return out


def _ring_chain_stage(planes, sched: RingSchedule, out: torch.Tensor, tile: int = 0) -> None:
    """ring-in, shift-accumulate, ring-out from ``planes`` into ``out``,
    whole-width or over column tiles of ``tile`` words (each tile runs the
    whole three-stage program)."""
    nw = out.shape[1]
    for lo, hi in _xg._tiles(nw, tile):
        ins = planes if not tile else [p[lo:hi] for p in planes]
        c = _emit_slp(ins, sched.s1_pairs, sched.s1_rows, hi - lo, out)
        s2 = _emit_slp(c.unbind(0), sched.s2_pairs, sched.s2_rows, hi - lo, out)
        _xg._slp(s2.unbind(0), sched.s3_pairs, sched.s3_rows, out.new_empty((len(sched.s3_pairs), hi - lo)),
                 out[:, lo:hi])


# -- pipeline -----------------------------------------------------------------


class RingPipeline(_xg.XorPipeline):
    """pack, ring chain and unpack for one (schedule, k, cols, dtype) on one
    device type: :class:`.xor_gemm.XorPipeline` with its packing and
    unpacking (a :class:`PackedOperand` packed for xor feeds ring
    unchanged); only the chain differs.  The optimizer pass applies per
    stage program, and the tile covers the whole chain."""

    __slots__ = ()
    _name = "ring"

    @staticmethod
    def _n_planes(schedule) -> int:
        return schedule.n_inputs + sum(len(pairs) + len(rows) for pairs, rows in schedule.stage_payloads)

    @staticmethod
    def _optimized(schedule):
        moved = groups = 0
        fields = {}
        for name, n_in in (("s1", schedule.n_inputs), ("s2", schedule.n_inputs), ("s3", len(schedule.s2_planes))):
            pairs, rows, mv, gr = _xopt.optimize_program(getattr(schedule, f"{name}_pairs"),
                                                         getattr(schedule, f"{name}_rows"), n_in)
            fields[f"{name}_pairs"] = pairs
            fields[f"{name}_rows"] = rows
            moved += mv
            groups += gr
        return replace(schedule, **fields), moved, groups

    def _chain(self, planes, outs: torch.Tensor) -> None:
        _ring_chain_stage(planes, self._emit, outs, self.opt.tile_words)

    def _profiled_chain(self, planes, outs: torch.Tensor) -> None:
        """The three ring stages split and timed one by one, untiled (pure
        XOR, so the output is the tiled chain's).  A schedule with no ring
        plane is one ``chain`` stage."""
        s = self._emit
        if not s.s2_planes:
            super()._profiled_chain(planes, outs)
            return
        width = outs.shape[1]
        c = _prof.run_stage("ring_in", _emit_slp, planes, s.s1_pairs, s.s1_rows, width, outs)
        s2 = _prof.run_stage("shift_acc", _emit_slp, c.unbind(0), s.s2_pairs, s.s2_rows, width, outs)
        _prof.run_stage("ring_out", lambda: _xg._slp(s2.unbind(0), s.s3_pairs, s.s3_rows,
                                                    outs.new_empty((len(s.s3_pairs), width)), outs) or outs)

    def describe(self) -> dict:
        out = super().describe()
        out.update(p=self.schedule.p, ring_planes=len(self.schedule.s2_planes))
        return out


_PIPELINE_CACHE: dict[tuple, RingPipeline] = {}
_PIPELINE_LOCK = threading.Lock()


def get_ring_pipeline(A, B_shape, B_dtype, w: int, device_type: str = "cpu") -> RingPipeline:
    """Build or fetch the ring pipeline for concrete ``A`` and a (k, cols)
    operand class on ``device_type`` (cols 32-aligned)."""
    schedule = build_ring_schedule(A, w)
    k, cols = B_shape
    key = (schedule.digest, schedule.cse, k, cols, np.dtype(B_dtype).str, _xopt.env_fingerprint(), device_type)
    with _PIPELINE_LOCK:
        pipe = _PIPELINE_CACHE.get(key)
        if pipe is None:
            pipe = _PIPELINE_CACHE[key] = RingPipeline(schedule, k, cols, B_dtype, device_type)
        return pipe


def clear_ring_caches() -> None:
    """Drop ring pipelines and schedules and forget the store index (the
    store file stays).  Runs with :func:`.xor_gemm.clear_pipeline_cache`
    (a registered hook)."""
    with _PIPELINE_LOCK:
        _PIPELINE_CACHE.clear()
    with _SCHEDULE_LOCK:
        _SCHEDULE_CACHE.clear()
    _reset_store_index()


_xg.register_clear_hook(clear_ring_caches)


def ring_pipeline_stats() -> list[dict]:
    with _PIPELINE_LOCK:
        pipes = list(_PIPELINE_CACHE.values())
    return [p.describe() for p in pipes]


def gf_matmul_ring(A, B, w: int = 8) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through the ring pipeline; the contract of
    :func:`.xor_gemm.gf_matmul_xor` (concrete ``A``, a tensor or a
    :class:`PackedOperand` as ``B``, ragged widths padded and trimmed)."""
    return _xg._gf_matmul(get_ring_pipeline, A, B, w)
