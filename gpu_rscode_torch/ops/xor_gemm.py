"""XOR-lowered bit-sliced GF(2^w) GEMM, ``strategy="xor"``: the port of the
JAX package's ``ops/xor_gemm.py`` to plain PyTorch.

The coefficient matrix (rows, k) is lowered to its (rows*w, k*w) GF(2)
operator (each symbol becomes the w x w bit matrix of multiply-by-that-
constant) and the product is evaluated as XOR accumulation over packed bit
planes: Jerasure's bit-matrix coding, with the straight-line program shrunk
by Paar's greedy pair-frequency CSE.

**Host half** (NumPy, copied so that every output is identical to the JAX
package's for the same matrix): :func:`binary_matrix`,
:func:`matrix_digest`, :func:`paar_cse`, :class:`XorSchedule`,
:func:`build_schedule` and the persistent schedule store.  Paar's
tie-breaks follow ``np.argmax`` order and set iteration, so ``pair_ops``,
``rows`` and the term counts equal the JAX package's.

**Device half** (PyTorch on int32 words, the same ops on the CPU and on
CUDA):

* **pack**: each symbol row becomes w bit-plane vectors of packed words,
  one bit of 32 symbol columns a word.  An 8x8 bit transpose is three
  rounds of SWAR delta swaps plus a 4x4 byte transpose by shifts and
  masks, with contiguous half/quarter pairings, as in the JAX package.
  All k rows pack in one vectorised pass into one (k*w, cols/32) tensor.
  PyTorch has no right shift for ``uint32`` on the CPU, so the words are
  int32: a right shift is arithmetic there, and every one whose following
  mask does not clear the sign copies gets its own mask (``_t4x4``'s two
  16-bit shifts); the constants of 2^31 and above are written as their
  signed values.
* **chain**: one ``torch.bitwise_xor(..., out=)`` a pair node into a
  preallocated (pairs, nw) tensor, then each output plane as the XOR of
  its terms into the preallocated output planes; the chain allocates
  nothing else.  On the CPU it runs over the column tiles that the JAX
  package's tile choice gives (:func:`.xor_opt.choose_tile`); on CUDA it
  runs whole-width unless ``RS_XOR_TILE`` forces a tile, because each tile
  would cost one launch per XOR (at the 64 MiB encode segment, 103 tiles x
  352 XORs).  ``describe()["opt"]`` reports what ran.  The optimizer's
  unpack split has no effect here and is only recorded.
* **unpack**: the inverse transform on the ``rows_out * w`` output planes,
  then a view back to uint8 / uint16 symbols.

:class:`PackedOperand` carries a segment's planes between two GEMMs that
read the same rows (the locate decode's syndrome and recovery GEMMs), so
the second one skips the pack.  On CUDA both strategies run only these
PyTorch ops: no hand-written kernel and no other GEMM path is called.

Knobs: ``RS_XOR_CSE=0`` (no Paar CSE), ``RS_XOR_MAX_TERMS`` (refuse
schedules with more naive terms, default 32768), ``RS_SCHEDULE_STORE``
(see :func:`..obs.runlog.store_path`), ``RS_XOR_PACK_REUSE=0`` (no
packed-operand reuse), and the optimizer's ``RS_XOR_OPT``,
``RS_XOR_TILE``, ``RS_XOR_TILE_BUDGET`` (:mod:`.xor_opt`).  The metrics and
profiler hooks of the JAX package wait for ROADMAP item 5; the counts they
would read are :data:`PACK_REUSE` and the store's :func:`store_stats`.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import xor_opt as _xopt
from ..obs import metrics as _metrics, profiler as _prof, runlog as _runlog
from .gemm import to_tensor
from .gf import get_field

__all__ = [
    "XorSchedule", "XorPipeline", "PackedOperand", "build_schedule",
    "matrix_digest", "gf_matmul_xor", "get_pipeline",
    "clear_pipeline_cache", "schedule_stats", "pipeline_stats",
    "pack_operand", "pack_reuse_enabled", "store_stats",
]

_SUPPORTED_W = (8, 16)

# Symbol columns are padded up to a multiple of 32 so every row's byte
# stream splits into whole 8-byte SWAR blocks grouped in quads.
_COL_ALIGN = 32

# Pack executions and packed-operand reuses, by outcome: the tally behind
# ``rs_xor_pack_reuse_total{outcome}`` (a graph replay adds what it would
# have counted here, and not to the registry).
PACK_REUSE = {"packed": 0, "reused": 0}


def _max_terms() -> int:
    try:
        v = int(os.environ.get("RS_XOR_MAX_TERMS", "32768"))
        return v if v > 0 else 32768
    except ValueError:
        return 32768


def _cse_enabled() -> bool:
    return os.environ.get("RS_XOR_CSE", "1").lower() not in ("0", "false", "off", "no")


def pack_reuse_enabled() -> bool:
    """Whether chained GEMMs may share a :class:`PackedOperand`
    (``RS_XOR_PACK_REUSE``, default on; read per call)."""
    return os.environ.get("RS_XOR_PACK_REUSE", "1").lower() not in ("0", "false", "off", "no")


# -- binary-matrix lowering (host) -------------------------------------------


def binary_matrix(A: np.ndarray, w: int) -> np.ndarray:
    """(rows, k) GF(2^w) matrix -> (rows*w, k*w) uint8 0/1 operator.

    Block (ri, ki) is ``gf.bitmatrix(A[ri, ki])``, built per distinct value
    so w=16 never builds the whole table of operators.
    """
    gf = get_field(w)
    A = np.asarray(A)
    rows, k = A.shape
    mats = {int(v): gf.bitmatrix(int(v)) for v in np.unique(A)}
    blocks = np.empty((rows, k, w, w), dtype=np.uint8)
    for ri in range(rows):
        for ki in range(k):
            blocks[ri, ki] = mats[int(A[ri, ki])]
    return blocks.transpose(0, 2, 1, 3).reshape(rows * w, k * w)


def matrix_digest(A, w: int) -> str:
    """Stable identity of a coefficient matrix for schedule keying."""
    A = np.ascontiguousarray(np.asarray(A))
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{w}:{A.shape[0]}x{A.shape[1]}:{A.dtype.str}".encode())
    h.update(A.tobytes())
    return h.hexdigest()


# -- greedy pair-frequency CSE (Paar) ----------------------------------------


def paar_cse(rows: list[set[int]], n_inputs: int):
    """Greedy pair-frequency elimination over the binary-matrix rows.

    Repeatedly finds the column pair that co-occurs in the most rows and
    rewrites it into a fresh node (one shared XOR), until no pair occurs
    twice.  Incremental: the symmetric co-occurrence matrix grows
    geometrically and a step visits only the rows it rewrites.

    Returns ``(pair_ops, rows)``: ``pair_ops[t] = (a, b)`` defines node
    ``n_inputs + t``, and ``rows`` holds each output's remaining term sets.
    """
    cap = max(16, 2 * n_inputs)
    co = np.zeros((cap, cap), dtype=np.int32)
    rows_with: dict[int, set[int]] = {}
    for ri, s in enumerate(rows):
        idx = np.fromiter(s, dtype=np.int64, count=len(s))
        co[np.ix_(idx, idx)] += 1
        for c in s:
            rows_with.setdefault(c, set()).add(ri)
    n = n_inputs
    pair_ops: list[tuple[int, int]] = []
    while True:
        live = co[:n, :n]
        np.fill_diagonal(live, 0)  # self-pairs from the outer updates
        flat = int(np.argmax(live))
        a, b = flat // n, flat % n
        if live[a, b] < 2:
            break
        if a > b:
            a, b = b, a
        if n == cap:
            grown = np.zeros((2 * cap, 2 * cap), dtype=np.int32)
            grown[:cap, :cap] = co
            co, cap = grown, 2 * cap
        for ri in list(rows_with[a] & rows_with[b]):
            s = rows[ri]
            idx = np.fromiter(s, dtype=np.int64, count=len(s))
            co[np.ix_(idx, idx)] -= 1
            s.discard(a)
            s.discard(b)
            s.add(n)
            rows_with[a].discard(ri)
            rows_with[b].discard(ri)
            rows_with.setdefault(n, set()).add(ri)
            idx = np.fromiter(s, dtype=np.int64, count=len(s))
            co[np.ix_(idx, idx)] += 1
        pair_ops.append((int(a), int(b)))
        n += 1
    return pair_ops, rows


# -- schedule ----------------------------------------------------------------


@dataclass(frozen=True)
class XorSchedule:
    """One lowered and scheduled coefficient matrix (hashable, immutable).

    ``pair_ops`` are the CSE nodes (node ``n_inputs + t`` = XOR of the two
    referenced nodes); ``rows`` lists each output plane's term nodes (an
    empty tuple is a zero plane).
    """

    digest: str
    w: int
    rows_out: int
    k: int
    n_inputs: int
    pair_ops: tuple[tuple[int, int], ...]
    rows: tuple[tuple[int, ...], ...]
    terms_naive: int
    terms_cse: int
    cse: bool
    build_seconds: float

    @property
    def xors(self) -> int:
        """XOR ops one dispatch evaluates (per packed word column)."""
        return len(self.pair_ops) + sum(max(0, len(r) - 1) for r in self.rows)


_SCHEDULE_CACHE: dict[tuple, XorSchedule] = {}
_SCHEDULE_LOCK = threading.Lock()


# -- persistent schedule store -----------------------------------------------
#
# A schedule is pure data, a deterministic function of (matrix digest, cse
# flag, algorithm version), so it is safe to persist across processes and
# packages.  Every load re-validates the shape fields, the node-index
# bounds and the payload checksum: a torn line or a foreign record is
# rebuilt, never trusted.

# The algorithm version of the records, the JAX package's: v2 records
# carry an explicit ``algo_version``, checked first.
_STORE_ALGO = 2

_STORE_LOCK = threading.Lock()
_STORE_INDEX: dict[tuple, dict] | None = None  # (digest, cse) -> record
# ``built`` counts the Paar-CSE computations this process ran (store on or
# off): a process against a warm store builds zero.
_STORE_STATS = {"hits": 0, "misses": 0, "stored": 0, "corrupt": 0, "built": 0}


def _store_path() -> str | None:
    return _runlog.store_path()


def _count_store(outcome: str, tally: str) -> None:
    """One store lookup's outcome: the tally of :func:`store_stats` and
    ``rs_schedule_store_total``."""
    with _STORE_LOCK:
        _STORE_STATS[tally] += 1
    _metrics.counter("rs_schedule_store_total", "persistent XOR-schedule store lookups by outcome").labels(
        outcome=outcome).inc()


def _rec_ts(rec: dict) -> float:
    try:
        return float(rec.get("ts") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def _store_index() -> dict[tuple, dict]:
    """Lazily loaded (digest, cse) -> record index of the store file.  The
    newest timestamp wins, not file order: rotation carries old records
    forward past fresh appends."""
    global _STORE_INDEX
    with _STORE_LOCK:
        if _STORE_INDEX is not None:
            return _STORE_INDEX
    p = _store_path()
    idx: dict[tuple, dict] = {}
    if p:
        for rec in _runlog.read_records(p):
            if rec.get("kind") != "rs_xor_schedule":
                continue
            digest = rec.get("digest")
            if not isinstance(digest, str):
                continue
            key = (digest, bool(rec.get("cse")))
            cur = idx.get(key)
            if cur is None or _rec_ts(rec) >= _rec_ts(cur):
                idx[key] = rec
    with _STORE_LOCK:
        if _STORE_INDEX is None:
            _STORE_INDEX = idx
        return _STORE_INDEX


def _reset_store_index() -> None:
    """Forget the loaded index: the next lookup re-reads the store file."""
    global _STORE_INDEX
    with _STORE_LOCK:
        _STORE_INDEX = None


def _payload_digest(pair_ops, rows) -> str:
    h = hashlib.blake2b(digest_size=8)
    payload = [
        [[int(a), int(b)] for a, b in pair_ops],
        [[int(t) for t in r] for r in rows],
    ]
    h.update(json.dumps(payload, separators=(",", ":")).encode())
    return h.hexdigest()


def _schedule_from_store(digest: str, cse: bool, A: np.ndarray, w: int) -> XorSchedule | None:
    """Validated store load for one (digest, cse); None on a miss or on any
    corruption (counted ``corrupt``: the caller rebuilds)."""
    if not _store_path():
        return None
    rec = _store_index().get((digest, cse))
    if rec is None:
        _count_store("miss", "misses")
        return None
    try:
        # The version gate comes first: a digest proves a record intact,
        # not that it matches the current emission contract.
        if rec.get("algo_version") != _STORE_ALGO:
            raise ValueError("algorithm version mismatch")
        if rec.get("algo") != _STORE_ALGO:
            raise ValueError("legacy algo field disagrees")
        rows_out, k = int(rec["rows_out"]), int(rec["k"])
        n_inputs = int(rec["n_inputs"])
        if (int(rec["w"]), rows_out, k) != (w, A.shape[0], A.shape[1]):
            raise ValueError("shape fields disagree with the matrix")
        if n_inputs != k * w:
            raise ValueError("n_inputs inconsistent with (k, w)")
        pair_ops = tuple((int(a), int(b)) for a, b in rec["pair_ops"])
        rows = tuple(tuple(int(t) for t in r) for r in rec["rows"])
        if len(rows) != rows_out * w:
            raise ValueError("row count inconsistent with (rows_out, w)")
        for t, (a, b) in enumerate(pair_ops):
            if not (0 <= a < n_inputs + t and 0 <= b < n_inputs + t):
                raise ValueError("pair op references an undefined node")
        n_nodes = n_inputs + len(pair_ops)
        for r in rows:
            for t in r:
                if not 0 <= t < n_nodes:
                    raise ValueError("row term references an undefined node")
        if rec.get("payload_digest") != _payload_digest(pair_ops, rows):
            raise ValueError("payload checksum mismatch")
        sched = XorSchedule(
            digest=digest, w=w, rows_out=rows_out, k=k, n_inputs=n_inputs,
            pair_ops=pair_ops, rows=rows,
            terms_naive=int(rec["terms_naive"]),
            terms_cse=int(rec["terms_cse"]),
            cse=cse, build_seconds=0.0,
        )
    except Exception:
        # Torn line, foreign writer, stale algorithm: rebuild (and store
        # again, superseding the bad record).  Any malformed field lands
        # here, whatever the exception it raises.
        with _STORE_LOCK:
            if _STORE_INDEX is not None:
                # Forget the bad record so the rebuild's append is not
                # skipped as already present.
                _STORE_INDEX.pop((digest, cse), None)
        _count_store("corrupt", "corrupt")
        return None
    _count_store("hit", "hits")
    return sched


def _schedule_to_store(sched: XorSchedule) -> None:
    """Append a freshly built schedule (no-op when the store is off or the
    record is already present)."""
    p = _store_path()
    if not p:
        return
    key = (sched.digest, sched.cse)
    idx = _store_index()
    if key in idx:
        return
    rec = {
        "kind": "rs_xor_schedule",
        "schema": _runlog.SCHEMA_VERSION,
        "algo": _STORE_ALGO,
        "algo_version": _STORE_ALGO,
        "digest": sched.digest,
        "cse": sched.cse,
        "w": sched.w,
        "rows_out": sched.rows_out,
        "k": sched.k,
        "n_inputs": sched.n_inputs,
        "pair_ops": [list(p_) for p_ in sched.pair_ops],
        "rows": [list(r) for r in sched.rows],
        "payload_digest": _payload_digest(sched.pair_ops, sched.rows),
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


def store_stats(load: bool = False) -> dict:
    """The store's path, its entry count (``load=True`` reads the index
    first; otherwise only an index already loaded is counted) and this
    process's hit / miss / stored / corrupt / built tallies."""
    p = _store_path()
    if load and p:
        _store_index()
    with _STORE_LOCK:
        entries = len(_STORE_INDEX) if _STORE_INDEX is not None else None
        out = dict(_STORE_STATS)
    out.update({"path": p, "enabled": p is not None, "entries": entries})
    return out


def build_schedule(A, w: int, cse: bool | None = None) -> XorSchedule:
    """Lower ``A`` to GF(2) and CSE-schedule it: from the in-process cache,
    else from the persistent store, else built (and stored)."""
    if w not in _SUPPORTED_W:
        raise ValueError(f"strategy='xor' supports w in {_SUPPORTED_W}, got w={w}")
    if cse is None:
        cse = _cse_enabled()
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
    abin = binary_matrix(A, w)
    naive = int(abin.sum())
    limit = _max_terms()
    if naive > limit:
        raise ValueError(
            f"xor schedule for {A.shape[0]}x{A.shape[1]} w={w} needs "
            f"{naive} XOR terms, over RS_XOR_MAX_TERMS={limit}; use "
            "strategy='bitplane' (or raise the knob) for matrices this "
            "large"
        )
    row_sets = [set(np.nonzero(r)[0]) for r in abin]
    if cse:
        pair_ops, row_sets = paar_cse(row_sets, abin.shape[1])
    else:
        pair_ops = []
    sched = XorSchedule(
        digest=digest,
        w=w,
        rows_out=A.shape[0],
        k=A.shape[1],
        n_inputs=abin.shape[1],
        pair_ops=tuple(pair_ops),
        rows=tuple(tuple(int(t) for t in sorted(s)) for s in row_sets),
        terms_naive=naive,
        terms_cse=len(pair_ops) + sum(len(s) for s in row_sets),
        cse=bool(cse),
        build_seconds=time.perf_counter() - t0,
    )
    _schedule_to_store(sched)
    with _SCHEDULE_LOCK:
        return _SCHEDULE_CACHE.setdefault(key, sched)


def schedule_stats() -> list[dict]:
    """The schedules built in this process: digest, shape, term counts
    before and after CSE."""
    with _SCHEDULE_LOCK:
        scheds = list(_SCHEDULE_CACHE.values())
    return [
        {
            "digest": s.digest,
            "w": s.w,
            "rows_out": s.rows_out,
            "k": s.k,
            "cse": s.cse,
            "terms_naive": s.terms_naive,
            "terms_cse": s.terms_cse,
            "xors": s.xors,
            "build_seconds": round(s.build_seconds, 6),
        }
        for s in scheds
    ]


# -- packed bit-plane transforms (device) ------------------------------------
#
# The little-endian word formulation of the JAX package on int32 words: the
# SWAR pair transpose maps virtual-block bit (i, j) to lane (j+4) % 8, bit
# (i+4) % 8, an involution, so plane j is lane _PLANE_LANE[j].

_PLANE_LANE = tuple((j + 4) % 8 for j in range(8))


def _i32(v: int) -> int:
    """A 32-bit constant as the int32 value with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


_M1, _M2 = 0x00AA00AA, 0x0000CCCC
_HI4, _LO4 = _i32(0xF0F0F0F0), 0x0F0F0F0F
_LOW16, _HI16 = 0x0000FFFF, _i32(0xFFFF0000)
_EV, _OD = 0x00FF00FF, _i32(0xFF00FF00)
_LOBYTES = 0x00FF00FF


def _dswap(x, mask, shift):
    # The mask clears the sign copies of the arithmetic shift (bits
    # 32 - shift and up are zero in both masks used).
    t = (x ^ (x >> shift)) & mask
    return x ^ t ^ (t << shift)


def _swar_pair(x, y):
    """8x8 bit transpose of virtual blocks (x[t] bytes 0-3, y[t] 4-7)."""
    x = _dswap(x, _M1, 7)
    y = _dswap(y, _M1, 7)
    x = _dswap(x, _M2, 14)
    y = _dswap(y, _M2, 14)
    t = (x & _HI4) | ((y >> 4) & _LO4)
    y = ((x << 4) & _HI4) | (y & _LO4)
    return t, y


def _t4x4(x0, x1, x2, x3):
    """4x4 byte transpose across four word streams (shift/mask only)."""
    t0 = (x0 & _LOW16) | (x2 << 16)
    t1 = (x1 & _LOW16) | (x3 << 16)
    t2 = ((x0 >> 16) & _LOW16) | (x2 & _HI16)  # the mask: a logical shift
    t3 = ((x1 >> 16) & _LOW16) | (x3 & _HI16)
    u0 = (t0 & _EV) | ((t1 & _EV) << 8)
    u1 = ((t0 >> 8) & _EV) | (t1 & _OD)
    u2 = (t2 & _EV) | ((t3 & _EV) << 8)
    u3 = ((t2 >> 8) & _EV) | (t3 & _OD)
    return u0, u1, u2, u3


def _split(a, n):
    """``n`` contiguous equal pieces of the last axis."""
    step = a.shape[-1] // n
    return [a[..., i * step:(i + 1) * step] for i in range(n)]


def _pack_words(words):
    """(..., nw4) raw byte words -> 8 (..., nw4/8) plane words, indexed by
    the true bit number."""
    xh, yh = _split(words, 2)
    x, y = _swar_pair(xh, yh)
    lanes = list(_t4x4(*_split(x, 4))) + list(_t4x4(*_split(y, 4)))
    return [lanes[_PLANE_LANE[j]] for j in range(8)]


def _unpack_words(planes):
    """Inverse of :func:`_pack_words`, as 8 contiguous pieces (concatenated
    in order they are the raw byte words)."""
    lanes = [None] * 8
    for j in range(8):
        lanes[_PLANE_LANE[j]] = planes[j]
    xs = _t4x4(*lanes[:4])
    ys = _t4x4(*lanes[4:])
    xps, yps = [], []
    for s in range(4):
        a, b = _swar_pair(xs[s], ys[s])
        xps.append(a)
        yps.append(b)
    return xps + yps


def _pack(B: torch.Tensor, w: int) -> torch.Tensor:
    """(k, cols) uint8 / uint16 symbols -> (k*w, cols/32) int32 planes, row
    i's plane j at ``i*w + j``; all rows in one pass."""
    k = B.shape[0]
    words = B.contiguous().view(torch.int32)
    if w == 8:
        planes = _pack_words(words)
    else:
        # Little-endian symbols: split lo/hi byte streams by shift/mask
        # compaction (contiguous halves again), then the byte machinery per
        # stream; planes 0-7 from lo, 8-15 from hi.
        lo_sp, hi_sp = words & _LOBYTES, (words >> 8) & _LOBYTES
        lo_a, lo_b = _split(lo_sp, 2)
        hi_a, hi_b = _split(hi_sp, 2)
        planes = _pack_words(lo_a | (lo_b << 8)) + _pack_words(hi_a | (hi_b << 8))
    return torch.stack(planes, dim=1).reshape(k * w, -1)


def _unpack(outs: torch.Tensor, w: int, rows_out: int) -> torch.Tensor:
    """(rows_out*w, nw) output planes -> (rows_out, nw*32) symbols."""
    planes = outs.view(rows_out, w, -1).unbind(1)
    if w == 8:
        return torch.cat(_unpack_words(planes[:8]), dim=1).view(torch.uint8)
    lo_ps = _unpack_words(planes[:8])
    hi_ps = _unpack_words(planes[8:])
    first = [(lp & _LOBYTES) | ((hp & _LOBYTES) << 8) for lp, hp in zip(lo_ps, hi_ps)]
    second = [((lp >> 8) & _LOBYTES) | (hp & ~_LOBYTES) for lp, hp in zip(lo_ps, hi_ps)]
    return torch.cat(first + second, dim=1).view(torch.uint16)


# -- the chain ---------------------------------------------------------------


def _slp(inputs, pair_ops, rows, pairbuf: torch.Tensor, out: torch.Tensor) -> None:
    """One straight-line XOR program over 1-D planes: pair node t into
    ``pairbuf[t]``, output plane r (the XOR of its terms) into ``out[r]``."""
    nodes = list(inputs)
    n_in = len(nodes)
    nodes.extend(pairbuf.unbind(0))
    for dst, (a, b) in zip(nodes[n_in:], pair_ops):
        torch.bitwise_xor(nodes[a], nodes[b], out=dst)
    for dst, terms in zip(out.unbind(0), rows):
        if not terms:
            dst.zero_()
        elif len(terms) == 1:
            dst.copy_(nodes[terms[0]])
        else:
            torch.bitwise_xor(nodes[terms[0]], nodes[terms[1]], out=dst)
            for t in terms[2:]:
                dst.bitwise_xor_(nodes[t])


def _tiles(nw: int, tile: int):
    """(lo, hi) column ranges: one whole-width range when ``tile`` is 0."""
    if not tile:
        return [(0, nw)]
    return [(lo, min(lo + tile, nw)) for lo in range(0, nw, tile)]


def _chain_stage(planes, schedule: XorSchedule, out: torch.Tensor, tile: int = 0) -> None:
    """The schedule's XOR program from ``planes`` into ``out``, whole-width
    or over column tiles of ``tile`` words (the same program on each)."""
    nw = out.shape[1]
    pairbuf = out.new_empty((len(schedule.pair_ops), min(nw, tile) if tile else nw))
    for lo, hi in _tiles(nw, tile):
        ins = planes if not tile else [p[lo:hi] for p in planes]
        _slp(ins, schedule.pair_ops, schedule.rows, pairbuf[:, :hi - lo], out[:, lo:hi])


# -- packed operands ---------------------------------------------------------


def _count_pack_reuse(outcome: str) -> None:
    PACK_REUSE[outcome] += 1
    # A graph capture runs nothing: the plan layer takes its tallies back
    # and counts each replay (count_replayed_packs).
    if not _prof._capturing():
        _pack_reuse_metric(outcome, 1)
    if outcome == "reused":
        _prof.attr(pack="reused")


def _pack_reuse_metric(outcome: str, n: int) -> None:
    _metrics.counter("rs_xor_pack_reuse_total", "xor pack-stage executions vs packed-operand reuses").labels(
        outcome=outcome).inc(n)


def count_replayed_packs(packed: int, reused: int) -> None:
    """What one graph replay adds to the pack tallies and their counter."""
    PACK_REUSE["packed"] += packed
    PACK_REUSE["reused"] += reused
    for outcome, n in (("packed", packed), ("reused", reused)):
        if n:
            _pack_reuse_metric(outcome, n)


def pack_timing_enabled() -> bool:
    """Whether pack-stage walls are recorded (``RS_XOR_PACK_TIMING=1`` and
    metrics on): the timing synchronises on the planes, which costs every
    xor dispatch its overlap, so it is opted into on top of RS_METRICS."""
    return _metrics.enabled() and os.environ.get("RS_XOR_PACK_TIMING", "0").lower() in ("1", "true", "on", "yes")


def _observed_pack(B: torch.Tensor, w: int):
    """``_pack(B, w)``'s planes: a profiled dispatch's ``pack`` stage, or
    with pack timing on its wall into ``rs_xor_pack_seconds``.  Inside a
    CUDA graph capture nothing is timed (a synchronise is illegal there),
    so a graph replay records no pack wall: only eager dispatches do."""
    if _prof.active() is not None:
        _prof.attr(pack="packed")
        return _prof.run_stage("pack", _pack, B, w)
    if not pack_timing_enabled() or _prof._capturing():
        return _pack(B, w)
    t0 = time.perf_counter()
    planes = _prof.sync(_pack(B, w))
    _metrics.quantile("rs_xor_pack_seconds", "xor pack-stage wall seconds (streaming quantiles)").observe(
        time.perf_counter() - t0)
    return planes


class PackedOperand:
    """A ``B`` operand already in the packed bit-plane domain.

    Two GEMMs that read the same staged segment (the locate decode's
    syndrome GEMM, then its recovery GEMM) pack it once and pass this
    handle; the second one skips the pack.  ``planes`` is the row-major
    tuple of ``rows * w`` plane vectors (1-D int32 tensors); :meth:`select`
    restricts it to a row subset without a copy.  ``cols_true`` is the
    width before the padding (the 32-column one, and a staged segment's
    bucket pad); ``cap`` is the plan-ladder cap of a staged segment's
    bucket (None otherwise), so the plan layer finds the same bucket.
    """

    __slots__ = ("planes", "rows", "cols", "w", "dtype", "cols_true", "cap")

    def __init__(self, planes, rows: int, cols: int, w: int, dtype, cols_true: int | None = None,
                 cap: int | None = None):
        self.planes = tuple(planes)
        self.rows = int(rows)
        self.cols = int(cols)
        self.w = int(w)
        self.dtype = np.dtype(dtype)
        self.cols_true = int(cols_true) if cols_true is not None else cols
        self.cap = cap

    @property
    def device(self) -> torch.device:
        return self.planes[0].device

    def select(self, row_positions) -> "PackedOperand":
        """Packed view of a row subset, in the given order."""
        w = self.w
        planes: list = []
        for r in row_positions:
            r = int(r)
            if not 0 <= r < self.rows:
                raise ValueError(f"row {r} out of range for packed operand of {self.rows} rows")
            planes.extend(self.planes[r * w:(r + 1) * w])
        return PackedOperand(planes, len(planes) // w, self.cols, w, self.dtype, cols_true=self.cols_true,
                             cap=self.cap)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(np.uint16) if t.dtype == torch.uint16 else np.dtype(np.uint8)


def pack_operand(B: torch.Tensor, w: int, *, cols_true: int | None = None, cap: int | None = None) -> PackedOperand:
    """Pack a (rows, cols) symbol tensor once for reuse across chained
    GEMMs.  ``cols`` must already be 32-aligned (:func:`padded_cols`)."""
    rows, cols = B.shape
    if cols % _COL_ALIGN:
        raise ValueError(f"packed operand cols must be {_COL_ALIGN}-aligned, got {cols}")
    planes = _observed_pack(B, w).unbind(0)
    _count_pack_reuse("packed")
    return PackedOperand(planes, rows, cols, w, _np_dtype(B), cols_true=cols_true, cap=cap)


# -- pipeline ----------------------------------------------------------------


class XorPipeline:
    """pack, chain and unpack for one (schedule, k, padded cols, dtype) on
    one device type.

    Called with ``(A, B)``: ``A`` is ignored (its values are the
    schedule's); ``B`` is a (k, cols) symbol tensor or a
    :class:`PackedOperand` of the same class.  ``compile_seconds`` is the
    optimizer pass's setup time (there is nothing to compile).
    """

    __slots__ = ("schedule", "k", "cols", "dtype", "device_type", "compile_seconds", "calls", "opt", "_emit")
    _name = "xor"

    def __init__(self, schedule, k: int, cols: int, dtype, device_type: str = "cpu"):
        if cols % _COL_ALIGN:
            raise ValueError(f"{self._name} pipeline cols must be {_COL_ALIGN}-aligned, got {cols}")
        self.schedule = schedule
        self.k = k
        self.cols = cols
        self.dtype = np.dtype(dtype)
        self.device_type = device_type
        self.calls = 0
        t0 = time.perf_counter()
        # The optimizer rewrites the emitted program only: ``schedule``
        # stays the canonical stored form, ``_emit`` is what runs.
        self._emit = schedule
        nw = cols // _COL_ALIGN
        if _xopt.opt_enabled():
            self._emit, moved, groups = self._optimized(schedule)
            tile, n_tiles, ws = _xopt.device_tile(self._n_planes(schedule), nw, device_type)
            self.opt = _xopt.OptStats(enabled=True, nodes_moved=moved, term_groups=groups, tile_words=tile,
                                      n_tiles=n_tiles, est_working_set_bytes=ws,
                                      split_unpack=_xopt.split_unpack(nw))
        else:
            self.opt = _xopt.disabled_stats()
        self.compile_seconds = time.perf_counter() - t0

    @staticmethod
    def _n_planes(schedule) -> int:
        """Live planes of the whole program (the tile choice's input)."""
        return schedule.n_inputs + len(schedule.pair_ops) + len(schedule.rows)

    @staticmethod
    def _optimized(schedule):
        """(emitted schedule, nodes moved, term groups)."""
        pair_ops, rows, moved, groups = _xopt.optimize_program(schedule.pair_ops, schedule.rows, schedule.n_inputs)
        return replace(schedule, pair_ops=pair_ops, rows=rows), moved, groups

    def _chain(self, planes, outs: torch.Tensor) -> None:
        _chain_stage(planes, self._emit, outs, self.opt.tile_words)

    def planes_of(self, B):
        """The input planes of ``B``: a packed operand's own (checked
        against this pipeline's class), else ``B`` packed now."""
        w = self.schedule.w
        if isinstance(B, PackedOperand):
            if (B.rows, B.cols, B.w) != (self.k, self.cols, w) or B.dtype != self.dtype:
                raise ValueError(
                    f"packed operand ({B.rows}x{B.cols}, w={B.w}, {B.dtype}) does not match pipeline "
                    f"({self.k}x{self.cols}, w={w}, {self.dtype})"
                )
            _count_pack_reuse("reused")
            return B.planes, B.device
        if tuple(B.shape) != (self.k, self.cols) or _np_dtype(B) != self.dtype:
            raise ValueError(f"operand {B.dtype}{tuple(B.shape)} does not match pipeline "
                             f"({self.k}x{self.cols}, {self.dtype})")
        _count_pack_reuse("packed")
        return _observed_pack(B, w).unbind(0), B.device

    def _profiled_chain(self, planes, outs: torch.Tensor) -> None:
        """The chain as the stages of a profiled dispatch."""
        _prof.run_stage("chain", lambda: self._chain(planes, outs) or outs)

    def __call__(self, A, B):
        self.calls += 1
        planes, device = self.planes_of(B)
        s = self.schedule
        outs = torch.empty((s.rows_out * s.w, self.cols // _COL_ALIGN), dtype=torch.int32, device=device)
        if _prof.active() is None:
            self._chain(planes, outs)
            return _unpack(outs, s.w, s.rows_out)
        # A profiled dispatch: each stage synchronised and timed.
        self._profiled_chain(planes, outs)
        return _prof.run_stage("unpack", _unpack, outs, s.w, s.rows_out)

    def describe(self) -> dict:
        s = self.schedule
        return {
            "digest": s.digest,
            "w": s.w,
            "k": self.k,
            "rows_out": s.rows_out,
            "cols": self.cols,
            "cse": s.cse,
            "terms_naive": s.terms_naive,
            "terms_cse": s.terms_cse,
            "xors": s.xors,
            "calls": self.calls,
            "compile_seconds": round(self.compile_seconds, 6),
            "opt": self.opt.as_dict(),
        }


_PIPELINE_CACHE: dict[tuple, XorPipeline] = {}
_PIPELINE_LOCK = threading.Lock()


def get_pipeline(A, B_shape, B_dtype, w: int, device_type: str = "cpu") -> XorPipeline:
    """Build or fetch the pipeline for concrete coefficients ``A`` and a
    (k, cols) operand class on ``device_type``.  ``cols`` must be
    32-aligned (:func:`padded_cols`)."""
    schedule = build_schedule(A, w)
    k, cols = B_shape
    # The optimizer fingerprint keys the pipeline too: RS_XOR_OPT and its
    # tile knobs change what runs, so variants never share a slot.
    key = (schedule.digest, schedule.cse, k, cols, np.dtype(B_dtype).str, _xopt.env_fingerprint(), device_type)
    with _PIPELINE_LOCK:
        pipe = _PIPELINE_CACHE.get(key)
        if pipe is None:
            pipe = _PIPELINE_CACHE[key] = XorPipeline(schedule, k, cols, B_dtype, device_type)
        return pipe


def clear_pipeline_cache() -> None:
    """Drop pipelines and schedules, and forget the store's loaded index
    (not the store file: a later load re-reads and re-validates it).  The
    registered hooks (the ring caches) run too."""
    with _PIPELINE_LOCK:
        _PIPELINE_CACHE.clear()
    with _SCHEDULE_LOCK:
        _SCHEDULE_CACHE.clear()
    _reset_store_index()
    for hook in list(_CLEAR_HOOKS):
        hook()


_CLEAR_HOOKS: list = []


def register_clear_hook(fn) -> None:
    """Run ``fn`` on every :func:`clear_pipeline_cache` (the ring module
    registers its own cache clear here, so this module needs no import of
    it)."""
    if fn not in _CLEAR_HOOKS:
        _CLEAR_HOOKS.append(fn)


def pipeline_stats() -> list[dict]:
    with _PIPELINE_LOCK:
        pipes = list(_PIPELINE_CACHE.values())
    return [p.describe() for p in pipes]


def padded_cols(m: int) -> int:
    """Round a column count up to the pipeline's 32-symbol alignment."""
    return max(_COL_ALIGN, (m + _COL_ALIGN - 1) // _COL_ALIGN * _COL_ALIGN)


def pad_operand(B: torch.Tensor, cols: int) -> torch.Tensor:
    """``B`` with zero columns appended up to ``cols`` (GF linearity makes
    the padded output columns zero)."""
    padded = torch.zeros((B.shape[0], cols), dtype=B.dtype, device=B.device)
    padded[:, :B.shape[1]] = B
    return padded


def _gf_matmul(get, A, B, w: int) -> torch.Tensor:
    """C = A . B through the pipeline ``get(A, shape, dtype, w,
    device_type)`` returns: ragged widths padded to 32 columns and trimmed
    after; a :class:`PackedOperand` trimmed to its ``cols_true``."""
    A = np.asarray(A)
    dtype = np.dtype(get_field(w).dtype)
    rows_out, k = A.shape
    if isinstance(B, PackedOperand):
        pipe = get(A, (k, B.cols), dtype, w, B.device.type)
        out = pipe(A, B)
        return out[:, :B.cols_true].contiguous() if B.cols_true != B.cols else out
    B = to_tensor(B)
    if B.ndim != 2 or B.shape[0] != k:
        raise ValueError(f"shape mismatch {A.shape} @ {tuple(B.shape)}")
    m = B.shape[1]
    if m == 0:
        return torch.zeros((rows_out, 0), dtype=B.dtype, device=B.device)
    cols = padded_cols(m)
    if cols != m:
        B = pad_operand(B, cols)
    out = get(A, (k, cols), dtype, w, B.device.type)(A, B)
    return out[:, :m].contiguous() if cols != m else out


def gf_matmul_xor(A, B, w: int = 8) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through the XOR pipeline, on ``B``'s
    device.  ``A`` is concrete (its values select the schedule); ``B`` is a
    (k, m) uint8 (w=8) or uint16 (w=16) tensor or a :class:`PackedOperand`.
    Ragged widths are zero-padded to 32 columns and trimmed after."""
    return _gf_matmul(get_pipeline, A, B, w)
