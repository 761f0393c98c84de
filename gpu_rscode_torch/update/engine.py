"""The delta-parity patch engine behind ``update_file`` / ``append_file``.

One pipeline serves both entry points (they differ only in the byte range
and whether the archive grows):

1. resolve any pending journal (:mod:`.journal`: a torn earlier op rolls
   back before this one starts);
2. map the edited byte range to its touched column windows
   (:mod:`.layout`): only those columns move, never the cold stripes;
3. per column block: assemble the native delta ``Δ = new ⊕ old``
   (untouched rows stay zero), stage it from a pinned slot of a
   :class:`..parallel.pipeline.StreamLoop`, run ``E·Δ`` on the compute
   stream (``codec.update``: K1 on CUDA) and bring the parity delta back
   to the host (after the D2H event) before any old parity is read;
4. journal the old bytes (fsynced) BEFORE the block's patches, patch
   through an ordered pwrite lane (``DrainExecutor.submit_pwrite``), and
   fix each touched chunk's CRC incrementally (:mod:`.crc`: no full-chunk
   re-hash);
5. commit: fsync the chunk files, then one crash-safe .METADATA rewrite
   (total size for appends, refreshed CRC lines, generation bump), the
   atomic commit point, and discard the journal.

Any failure before the commit rolls back in-process (or, after a hard
crash, at the next open via :func:`.journal.recover`), so the archive is
always byte-identical to either its pre-op or its post-op state.

``RS_UPDATE_CRASH=<stage>`` (stages ``after_journal`` / ``mid_patch`` /
``before_commit``) raises :class:`SimulatedCrash` at the named point
WITHOUT the in-process rollback, leaving the disk as a real crash would.
"""

from __future__ import annotations

import bisect
import os
import time

import numpy as np

from ..codec import RSCodec, entry_device
from ..obs import metrics as _metrics, tracing as _tracing
from ..parallel.io_executor import DrainExecutor
from ..parallel.pipeline import StreamLoop
from ..utils.fileformat import (
    chunk_file_name,
    chunk_size_for_layout,
    metadata_file_name,
    read_archive_meta,
    rewrite_metadata_lines,
)
from ..utils.timing import PhaseTimer
from . import journal as _journal
from .crc import crc32_append, crc32_patch
from .layout import deinterleave, interleave, touched_rows, touched_windows


class UpdateError(ValueError):
    """The archive cannot take this update/append as asked (range outside
    the file, missing chunks, foreign metadata, row-layout append past the
    slack): actionable, never a half-applied mutation."""


class SimulatedCrash(RuntimeError):
    """RS_UPDATE_CRASH fired: the op stops dead WITHOUT rolling back,
    exactly like a power cut."""


def _crash_point(stage: str) -> None:
    if os.environ.get("RS_UPDATE_CRASH") == stage:
        raise SimulatedCrash(f"RS_UPDATE_CRASH={stage}")


def _load_payload(data, src) -> np.ndarray:
    """The edit/append bytes as a read-only uint8 array (a ``src`` path is
    memmapped, so a large delta streams through the block loop)."""
    if (data is None) == (src is None):
        raise ValueError("pass exactly one of data= or src=")
    if src is not None:
        if os.path.getsize(src) == 0:
            return np.zeros(0, dtype=np.uint8)
        return np.memmap(src, dtype=np.uint8, mode="r")
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _pread(fp, off: int, n: int) -> bytes:
    """n bytes at off, zero-filled past EOF (an append reads the region it
    is about to create as zeros, the archive's own pad contract)."""
    got = os.pread(fp.fileno(), n, off)
    if len(got) < n:
        got += b"\x00" * (n - len(got))
    return got


def _block_bytes(k: int, sym: int, segment_bytes: int) -> int:
    """Per-block chunk-byte width: the (k, block) working set bounded to
    about ``segment_bytes``, symbol-aligned."""
    return max(sym, (segment_bytes // max(1, k)) // sym * sym)


def _intersecting(spans, starts, flo, fhi):
    """The ascending, disjoint ``(at, payload)`` spans overlapping file
    range [flo, fhi), located by bisect (a group may hold thousands)."""
    i = bisect.bisect_right(starts, flo) - 1
    if i >= 0 and starts[i] + int(spans[i][1].shape[0]) <= flo:
        i += 1
    i = max(i, 0)
    while i < len(spans) and starts[i] < fhi:
        yield spans[i]
        i += 1


def _assemble_row_block(b0, b1, rows, fps, spans, chunk, k):
    """Row-layout Δ for chunk-byte window [b0, b1): per touched row, the
    intersection of its file range with each edit span, old bytes read and
    new bytes from the span; untouched rows stay zero.  ``spans``: an
    ascending list of disjoint ``(at, payload)`` file ranges."""
    delta = np.zeros((k, b1 - b0), dtype=np.uint8)
    starts = [at for at, _ in spans]
    writes = []
    for r in rows:
        for at, payload in _intersecting(spans, starts, r * chunk + b0, r * chunk + b1):
            lo = max(r * chunk + b0, at)
            hi = min(r * chunk + b1, at + int(payload.shape[0]))
            if lo >= hi:
                continue
            off = lo - r * chunk
            old = _pread(fps[r], off, hi - lo)
            new = np.ascontiguousarray(payload[lo - at : hi - at])
            delta[r, off - b0 : off - b0 + (hi - lo)] = np.frombuffer(old, dtype=np.uint8) ^ new
            writes.append((r, off, old, new.tobytes()))
    return delta, writes


def _assemble_interleaved_block(b0, b1, fps, spans, k, sym):
    """Interleaved Δ for chunk-byte window [b0, b1): gather the k old rows,
    de-interleave to file order, overlay every intersecting span,
    re-interleave.  Every row is a candidate; the caller drops rows whose
    Δ is zero and that gain no extension."""
    bw = b1 - b0
    old_rows = np.zeros((k, bw), dtype=np.uint8)
    for r in range(k):
        got = os.pread(fps[r].fileno(), bw, b0)
        if got:
            old_rows[r, : len(got)] = np.frombuffer(got, dtype=np.uint8)
    file_lo = (b0 // sym) * k * sym
    file_hi = file_lo + k * bw
    new_file = deinterleave(old_rows, sym).copy()
    starts = [at for at, _ in spans]
    for at, payload in _intersecting(spans, starts, file_lo, file_hi):
        lo = max(file_lo, at)
        hi = min(file_hi, at + int(payload.shape[0]))
        if lo < hi:
            new_file[lo - file_lo : hi - file_lo] = payload[lo - at : hi - at]
    new_rows = interleave(new_file, k, sym)
    delta = old_rows ^ new_rows
    writes = [(r, b0, old_rows[r].tobytes(), new_rows[r].tobytes()) for r in range(k)]
    return delta, writes


def apply_update(file_name: str, at: int, data=None, *, src: str | None = None, strategy: str = "auto", device=None,
                 segment_bytes: int = 64 * 1024 * 1024, timer: PhaseTimer | None = None) -> dict:
    """In-place edit of the archived file's bytes [at, at+len):
    ``parity' = parity ⊕ E·Δ``, only the touched columns move.  ``device``:
    where ``E·Δ`` runs; None means CUDA and raises with no GPU present."""
    return _apply(file_name, at, _load_payload(data, src), grow=False, strategy=strategy, device=device,
                  segment_bytes=segment_bytes, timer=timer)


def apply_append(file_name: str, data=None, *, src: str | None = None, strategy: str = "auto", device=None,
                 segment_bytes: int = 64 * 1024 * 1024, timer: PhaseTimer | None = None) -> dict:
    """Grow the archived file by the payload: interleaved archives extend
    every chunk's tail column block (cold columns untouched); row-layout
    archives take appends bounded by their tail-padding slack."""
    return _apply(file_name, None, _load_payload(data, src), grow=True, strategy=strategy, device=device,
                  segment_bytes=segment_bytes, timer=timer)


def _check_width(meta) -> None:
    """The w=8/16 gate shared by the single-op and group engines."""
    if meta.w not in (8, 16):
        raise ValueError(f"unsupported gfwidth {meta.w} in {meta.path!r} (this build handles w=8 and w=16 files)")


def _parity_coeffs(meta, gf):
    """The (p, k) parity coefficient block ``E`` of the archive's
    (systematic) total matrix, validated; shared by both engines."""
    from ..models.vandermonde import total_matrix as _regen_total

    k = meta.native_num
    mat = meta.total_mat
    if mat is None:
        mat = _regen_total(meta.parity_num, k, gf)
    mat = np.asarray(mat)
    if int(mat.max(initial=0)) >= (1 << meta.w):
        raise ValueError(
            f"metadata matrix entry {int(mat.max())} out of range for GF(2^{meta.w}) — corrupt or foreign .METADATA"
        )
    if not np.array_equal(mat[:k], np.eye(k, dtype=mat.dtype)):
        raise UpdateError(
            "delta update needs a systematic total matrix (identity native block); this archive's metadata is "
            "foreign — re-encode instead"
        )
    return mat[k:].astype(gf.dtype)


def _open_chunks(file_name, all_idx, chunk_old, fps) -> None:
    """Open every chunk in ``all_idx`` r+b into the caller's ``fps`` dict
    (the caller closes them, also on a partial failure here), refusing a
    missing or truncated chunk with the repair hint."""
    for idx in all_idx:
        path = chunk_file_name(file_name, idx)
        try:
            fps[idx] = open(path, "r+b")
        except FileNotFoundError:
            raise UpdateError(
                f"chunk {idx} ({path!r}) is missing — repair the archive (rs --repair -i) before updating it"
            ) from None
        size = os.fstat(fps[idx].fileno()).st_size
        if size < chunk_old:
            raise UpdateError(f"chunk {idx} ({path!r}) is truncated ({size} of {chunk_old} bytes) — repair the archive "
                              "first")


def _parity_delta(loop: StreamLoop, codec: RSCodec, E, delta: np.ndarray, sym: int, timer: PhaseTimer,
                  **span_args) -> np.ndarray:
    """``E·Δ`` for one staged (k, cols) delta: copied into a pinned slot,
    K1 on the compute stream (on CUDA), and the (p, cols) bytes back on the
    host after the D2H event, before any old parity is read.  The dispatch
    is one ``dispatch`` span with ``span_args`` (op, off, cols, and a
    group's tag)."""
    with timer.phase("update dispatch"), _tracing.span("dispatch", lane="dispatch", **span_args):
        out = loop.dispatch(lambda d: codec.update(E, d), loop.stage_copy(delta, sym))
    with timer.phase("update compute"):
        return loop.result(out)


def _apply(file_name, at, payload, *, grow, strategy, device, segment_bytes, timer):
    from ..ops.gf import get_field

    timer = timer or PhaseTimer(enabled=False)
    t_start = time.perf_counter()
    device = entry_device(device, strategy)
    op = "append" if grow else "update"
    recovered = _journal.recover(file_name)

    meta_path = metadata_file_name(file_name)
    meta = read_archive_meta(meta_path)
    k, p, w = meta.native_num, meta.parity_num, meta.w
    _check_width(meta)
    sym = meta.sym
    total = meta.total_size
    L = int(payload.shape[0])
    if grow:
        at = total
    summary_base = {"op": op, "at": int(at), "bytes": L, "layout": meta.layout, "recovered": recovered}
    if L == 0:
        return {**summary_base, "segments": 0, "chunks_touched": [], "total_size": total,
                "generation": meta.generation}
    if not grow and (at < 0 or at + L > total):
        raise UpdateError(
            f"update range [{at}, {at + L}) falls outside the archive's {total} bytes; use rs append to grow it"
        )

    gf = get_field(w)
    E = _parity_coeffs(meta, gf)

    chunk_old = meta.chunk
    new_total = total + L if grow else None
    if grow:
        chunk_new = chunk_size_for_layout(new_total, k, sym, meta.layout)
        if meta.layout == "row" and chunk_new != chunk_old:
            slack = k * chunk_old - total
            raise UpdateError(
                f"append of {L} bytes overflows the row-major archive's {slack} byte(s) of tail-padding slack "
                "(growing the chunk size would re-stripe every byte); re-encode, or encode with --layout "
                "interleaved for unbounded appends"
            )
    else:
        chunk_new = chunk_old
        if chunk_old == 0:
            raise UpdateError("zero-size archive has nothing to update")

    windows = touched_windows(meta.layout, at, L, k, sym, chunk_new)
    rows = touched_rows(meta.layout, at, L, k, chunk_new)
    all_idx = rows + [i for i in range(k, k + p) if i not in rows]

    fps: dict[int, object] = {}
    try:
        with timer.phase("update setup"):
            _open_chunks(file_name, all_idx, chunk_old, fps)
            codec = RSCodec(k, p, w=w, strategy=strategy, device=device)
            step = _block_bytes(k, sym, segment_bytes)
            loop = StreamLoop(codec.device, k, min(step, max(hi - lo for lo, hi in windows)), 1)
            jr = _journal.Journal(file_name, meta.generation, op, {i: chunk_old for i in all_idx})
        crcs = dict(meta.crcs) if meta.crcs else None
        touched: set[int] = set()
        blocks = 0
        committed = False
        try:
            spans = [(at, payload)]
            with DrainExecutor(ordered=True, name="rs-io-patch") as lane:
                for wlo, whi in windows:
                    for b0 in range(wlo, whi, step):
                        b1 = min(b0 + step, whi)
                        blocks += _patch_block(
                            b0, b1, rows, fps, spans, chunk_old, k, p, sym, meta.layout, codec, E, loop,
                            lane, jr, crcs, touched, timer, first=blocks == 0, op=op,
                        )
                with timer.phase("update patch (io)"):
                    lane.flush()
            with timer.phase("update fsync (io)"):
                for fp in fps.values():
                    os.fsync(fp.fileno())
            _crash_point("before_commit")
            with timer.phase("write metadata (io)"):
                new_gen = rewrite_metadata_lines(meta_path, total_size=new_total, crcs=crcs, bump_generation=True)
            jr.close(commit=True)
            committed = True
        except SimulatedCrash:
            jr.close(commit=False)  # the disk stays torn; recover() heals it
            raise
        except BaseException:
            if not committed:
                # In-process rollback from the DURABLE journal: its records
                # cover everything patched so far, and the metadata
                # generation still matches the journal's, so recover()
                # restores and discards it, as after a hard crash.
                jr.close(commit=False)
                _journal.recover(file_name)
            raise
    finally:
        for fp in fps.values():
            if not fp.closed:
                fp.close()

    _observe_commit(op, L, blocks, t_start)
    return {
        **summary_base,
        "segments": blocks,
        "chunks_touched": sorted(touched),
        "total_size": new_total if grow else total,
        "generation": new_gen,
    }


def _observe_commit(op: str, nbytes: int, blocks: int, t_start: float) -> None:
    """The ``rs_update_*`` series a committed update, append or group
    moves: payload bytes and wall by op, column blocks patched."""
    _metrics.counter(
        "rs_update_bytes_total",
        "payload bytes applied by delta update/append",
    ).labels(op=op).inc(nbytes)
    _metrics.counter(
        "rs_update_segments_touched_total",
        "column segment blocks patched by update/append",
    ).inc(blocks)
    _metrics.quantile(
        "rs_update_wall_seconds",
        "update/append wall seconds (streaming quantiles)",
    ).labels(op=op).observe(time.perf_counter() - t_start)


def _collect_block(b0, b1, delta, native_writes, pd_np, fps, chunk_old, k, p, layout, timer):
    """Finish one block's write set from its host parity delta ``pd_np``
    ((p, b1 - b0) bytes): XOR it into the old parity bytes, drop the
    untouched interleaved native rows.  Returns the ordered ``(idx, off,
    old, new)`` write list (natives first, then parity) and the native
    write count."""
    parity_writes = []
    ext = b1 > chunk_old  # this block extends the chunk files (append)
    with timer.phase("update stage (io)"):
        for j in range(p):
            if not ext and not pd_np[j].any():
                continue  # parity row provably unchanged in this block
            old = _pread(fps[k + j], b0, b1 - b0)
            new = (np.frombuffer(old, dtype=np.uint8) ^ pd_np[j]).tobytes()
            parity_writes.append((k + j, b0, old, new))
    if layout == "interleaved":
        # The assembler emits every row; rows the edit left untouched (zero
        # Δ, no extension) have nothing to write or re-checksum.
        native_writes = [wrt for r, wrt in enumerate(native_writes) if ext or delta[r].any()]
    return native_writes + parity_writes, len(native_writes)


def _stage_block(b0, b1, rows, fps, spans, chunk_old, k, p, sym, layout, codec, E, loop, timer, *, op):
    """One column block's write set: assemble its Δ from the edit spans,
    run ``E·Δ`` (:func:`_parity_delta`) and :func:`_collect_block` it."""
    with timer.phase("update stage (io)"):
        if layout == "interleaved":
            delta, native_writes = _assemble_interleaved_block(b0, b1, fps, spans, k, sym)
        else:
            delta, native_writes = _assemble_row_block(b0, b1, rows, fps, spans, chunk_old, k)
    pd_np = _parity_delta(loop, codec, E, delta, sym, timer, op=op, off=int(b0), cols=int(b1 - b0))
    return _collect_block(b0, b1, delta, native_writes, pd_np, fps, chunk_old, k, p, layout, timer)


def _patch_block(b0, b1, rows, fps, spans, chunk_old, k, p, sym, layout, codec, E, loop, lane, jr, crcs, touched,
                 timer, *, first, op) -> int:
    """One column block: assemble Δ, run E·Δ, journal, patch natives and
    parity, account CRCs.  Returns 1 (the caller counts blocks)."""
    writes, n_native = _stage_block(b0, b1, rows, fps, spans, chunk_old, k, p, sym, layout, codec, E, loop, timer,
                                    op=op)
    # Undo bytes FIRST, durably: only then may any region change (the
    # write-ahead order recovery depends on).
    with timer.phase("update journal (io)"):
        for idx, off, old, _new in writes:
            jr.record(idx, off, old[: max(0, chunk_old - off)])
        jr.sync()
    if first:
        _crash_point("after_journal")
    for pos, (idx, off, old, new) in enumerate(writes):
        if first and pos == n_native:
            # Natives patched, parity not yet: the torn state the journal
            # exists for.
            lane.flush()
            _crash_point("mid_patch")
        lane.submit_pwrite(fps[idx].fileno(), new, off)
        touched.add(idx)
        if crcs is not None:
            with timer.phase("update crc"):
                _account_crc(crcs, idx, off, old, new, chunk_old)
    return 1


def _account_crc(crcs, idx, off, old, new, chunk_old) -> None:
    """Incremental CRC for one written region: seekable patch math below
    the chunk's pre-op length, streaming append past it (regions arrive in
    ascending offset order per chunk, the block loop's invariant)."""
    cut = max(0, min(len(new), chunk_old - off))
    if cut:
        delta = (np.frombuffer(old[:cut], dtype=np.uint8) ^ np.frombuffer(new[:cut], dtype=np.uint8)).tobytes()
        crcs[idx] = crc32_patch(crcs.get(idx, 0), chunk_old, off, delta)
    if len(new) > cut:
        crcs[idx] = crc32_append(crcs.get(idx, 0), new[cut:])
