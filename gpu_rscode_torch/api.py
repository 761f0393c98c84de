"""File-level operations: the counterpart of the JAX package's
``api.encode_file``, ``api.decode_file`` and ``api.encode_fleet`` (one
device), of its resilience reads: ``scan_file``, ``auto_decode_file``,
``decode_fleet``, ``repair_file``, ``repair_fleet`` and
``locate_decode_file``, and of its in-place updates: ``update_file``,
``append_file``, ``update_file_many`` and ``recover_archive``
(:mod:`.update`), and of its object-store wrappers: ``put_object``,
``put_objects``, ``get_object``, ``delete_object``, ``list_objects``,
``list_objects_page``, ``stat_object`` and ``compact_bucket``
(:mod:`.store`).

* The file is striped into k contiguous ranges (``chunk_size =
  ceil(total/k)``), or under the interleaved layout symbol s goes to row
  ``s % k``, column ``s // k``, and streamed in column segments of about
  ``segment_bytes`` of natives, so any file size runs in bounded memory.
* The segments stream through the five-stage pipeline of
  :mod:`.parallel.pipeline`: a prefetch thread reads segment i+2 (native
  preads, into pinned memory on CUDA), the H2D stream copies segment i+1,
  the compute stream runs the GF-GEMM on segment i, the D2H stream copies
  its output, and the ordered write-behind lane
  (:mod:`.parallel.io_executor`) writes segment i-1.  ``pipeline_depth``
  (the ``-s`` flag) is the number of segments in flight; depth 1 with
  ``RS_IO_WRITERS=0`` runs the stages one after another.
* Tail padding is explicit zeros, so parity is deterministic.
* Natives are written straight from the source file, on the writer lane;
  only parity is computed on the device.
* Every output is written under a ``.rs_tmp`` name and promoted only when
  all of it has landed (.METADATA last), after the writer lane's barrier,
  so a failed encode leaves no partial archive; cleanup runs only after
  the lane's workers have joined.
* Decode trusts the .METADATA matrix, inverts the survivor submatrix on the
  host and runs the GEMM only for the missing natives.
* w=16 chunks hold little-endian uint16 symbols (``# gfwidth 16``).
* The resilience reads find the healthy chunks by size and CRC
  (:func:`scan_file`), choose k of them, natives first, whose submatrix
  inverts (cached per archive generation), decode without a hand-written
  conf (:func:`auto_decode_file`, which swaps a survivor that fails
  mid-stream and resumes), rebuild lost or corrupt chunks in place
  (:func:`repair_file`; :func:`repair_fleet` inverts a whole fleet's
  survivor matrices in one batched call on the device), and locate silent
  bitrot from the parity-check syndromes (:func:`locate_decode_file`).
  Every GEMM of these paths is a segment loop through :class:`StreamLoop`
  (K1 on the compute stream on CUDA).
* With ``RS_RUNLOG`` set, the damage-detection sites append the health
  plane's ``rs_damage`` records (:mod:`.obs.health`), as the JAX package's
  do: every scan (its full per-chunk verdict), a syndrome attribution, a
  survivor that fails after the scan, a rebuild, an unrecoverable repair
  and every update, append or group (a generation bump).
* The resilience boundaries (:mod:`.resilience`) sit where the JAX
  package's do: the fault plane's read hook and the retry policy around
  every chunk open (:func:`_open_chunk`) and segment gather, the write
  hook around every drain (:mod:`.parallel.io_executor`).  They wrap IO
  only: a GEMM on the device is never retried, and a kernel error raises.
* Every file-level entry point runs under :func:`_observed_file_op`: the
  retry budget rearmed, a ``trace_path=`` tracing session and span, the
  run ledger's ``rs_run`` record and ``rs_file_ops_total``.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import os
import threading
import time
from collections import OrderedDict
from contextlib import closing, contextmanager, nullcontext
from itertools import combinations

import numpy as np

from . import native
from . import plan as _plan
from .codec import RSCodec, entry_device
from .models.vandermonde import total_matrix
from .obs import health as _obs_health, metrics as _obs_metrics, runlog as _obs_runlog, tracing as _obs_tracing
from .ops.gf import get_field
from .ops.inverse import SingularMatrixError, invert_matrix
from .parallel.io_executor import DrainExecutor, FleetPipeline
from .parallel.pipeline import AsyncWindow, DeviceStagingRing, SegmentPrefetcher, StreamLoop
from .resilience import faults as _faults, retry as _retry
from .utils.backend import resolve_device
from .utils.fileformat import (
    append_checksums,
    chunk_crc32,
    chunk_file_name,
    chunk_size_for,
    chunk_size_for_layout,
    crc32_of,
    journal_path,
    metadata_file_name,
    parse_chunk_index,
    read_archive_meta,
    read_conf,
    rewrite_checksums,
    write_conf,
    write_metadata,
)
from .utils.timing import PhaseTimer

# Natives per segment: bounds the host and device working set per dispatch.
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024


class UndecidedSubsetError(ValueError):
    """The survivor-subset search hit its candidate cap without finding an
    invertible k-subset.  More combinations exist, so the archive is not
    proven unrecoverable (``scan_file`` reports ``decodable: "unknown"``)."""


class ChunkIntegrityError(ValueError):
    """A surviving chunk's bytes are unusable: CRC mismatch or truncated.
    ``bad_chunks`` maps chunk index -> file path."""

    def __init__(self, bad_chunks: dict[int, str], reason: str = "chunk checksum mismatch (corrupt survivors)"):
        self.bad_chunks = dict(bad_chunks)
        names = ", ".join(f"{i}:{p}" for i, p in sorted(bad_chunks.items()))
        super().__init__(f"{reason}: {names}; pick different survivors in the conf file")


def _observed_file_op(op: str):
    """Wrap a file-level entry point with the observability surface, as the
    JAX package does: a keyword-only ``trace_path=`` (like ``RS_TRACE``)
    opens a reentrant tracing session around a top-level span, the retry
    budget is rearmed (it bounds ONE operation's retry storm), every call,
    success or failure, appends an ``rs_run`` record to the run ledger
    (``RS_RUNLOG``), and a success counts in ``rs_file_ops_total`` and the
    ``rs_file_op_wall_seconds`` quantiles."""

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            trace_path = kwargs.pop("trace_path", None)
            _retry.reset_budget()
            t0 = time.perf_counter()
            # Entry snapshot of a caller's timer: nested fleet ops share
            # one, and the record carries THIS op's delta.
            phases0 = _obs_runlog.timer_phases(sig, args, kwargs) if _obs_runlog.enabled() else None
            error: BaseException | None = None
            try:
                # The JAX package's _profile_session(): its place, once the
                # profiler plane is ported.
                with _obs_tracing.session(trace_path), _obs_tracing.span(op, lane="op"):
                    out = fn(*args, **kwargs)
            except BaseException as e:
                error = e
                raise
            finally:
                if _obs_runlog.enabled():
                    _obs_runlog.record_file_op(op, sig, args, kwargs, wall=time.perf_counter() - t0, error=error,
                                               phases_before=phases0)
            _obs_metrics.counter("rs_file_ops_total", "file-level operations completed").labels(op=op).inc()
            _obs_metrics.quantile("rs_file_op_wall_seconds",
                                  "file-level operation wall seconds (streaming quantiles)").labels(
                op=op).observe(time.perf_counter() - t0)
            return out

        return wrapper

    return deco


def _segment_cols(chunk_size: int, native_num: int, segment_bytes: int) -> int:
    """Columns per segment: ``segment_bytes / k``, 128-aligned (so w=16
    segments hold whole symbols) unless the chunk itself is smaller."""
    cols = max(1, segment_bytes // max(1, native_num))
    if cols < chunk_size:
        cols = max(128, cols - cols % 128)
    return min(cols, chunk_size)


def _segment_spans(chunk_size: int, seg_cols: int) -> list[tuple[int, int]]:
    """(off, cols) spans covering [0, chunk_size) in seg_cols steps."""
    return [(off, min(seg_cols, chunk_size - off)) for off in range(0, chunk_size, seg_cols)]


def _check_gfwidth(w: int, meta_path: str) -> None:
    if w not in (8, 16):
        raise ValueError(f"unsupported gfwidth {w} in {meta_path!r} (this build handles w=8 and w=16 files)")


class _ArchiveCommit:
    """Crash atomicity for an encode: all n chunks and .METADATA are written
    to ``.rs_tmp`` names and promoted together, chunks first and .METADATA
    last.  ``discard`` removes temps and retracts chunks a failing promote
    already renamed, unless they existed before (a re-encode)."""

    def __init__(self, file_name: str, n: int):
        self.file_name = file_name
        self.written = [chunk_file_name(file_name, i) for i in range(n)] + [metadata_file_name(file_name)]
        self.tmps = {name: name + ".rs_tmp" for name in self.written}
        self._preexisting = {name for name in self.written if os.path.exists(name)}
        self._committed: list[str] = []

    @property
    def meta_tmp(self) -> str:
        return self.tmps[metadata_file_name(self.file_name)]

    def promote(self) -> None:
        for name in self.written[:-1]:
            os.replace(self.tmps[name], name)
            self._committed.append(name)
        os.replace(self.meta_tmp, metadata_file_name(self.file_name))

    def discard(self) -> None:
        for tmp in self.tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
        for name in self._committed:
            if name not in self._preexisting and os.path.exists(name):
                os.unlink(name)


@contextmanager
def _fleet_lane():
    """The scaffold of a multi-file operation: one ordered write-behind
    lane, archives committed behind their own writes, and ``abort`` (the
    cleanups still registered) only after the lane's workers joined, so no
    drain races a cleanup's closes and unlinks."""
    pipe = FleetPipeline(DrainExecutor(ordered=True))
    try:
        with pipe.executor:
            yield pipe
    except BaseException:
        pipe.abort()
        raise


def _drain_ctx(fleet: FleetPipeline | None):
    """The write-behind lane of one file loop: the fleet's shared lane, or
    a fresh ordered executor whose context exit is the write barrier
    (ordered: parity CRCs and shared-``fp`` writes advance segment by
    segment)."""
    if fleet is not None:
        return nullcontext(fleet.executor)
    return DrainExecutor(ordered=True)


def _staging(prefetch, loop: StreamLoop, sym: int, depth: int, timer: PhaseTimer) -> DeviceStagingRing:
    def stage(tag, segment):
        with timer.phase("h2d (transfer)"):
            return loop.stage(segment, sym)

    return DeviceStagingRing(prefetch, stage, depth=depth)


def warm_plan(native_num: int, parity_num: int, *, w: int = 8, generator: str = "vandermonde", strategy: str = "auto",
              segment_bytes: int = DEFAULT_SEGMENT_BYTES, file_bytes: int | None = None, device=None) -> dict:
    """Build the encode plan of one bucket before the first real request
    (a resident process pays the build, and on the card the graph capture,
    here).  Stages one zero segment of the bucket the workload will hit
    (``file_bytes`` sizes it as :func:`encode_file` would; default one
    full segment) into the first staging buffer of the pool
    (:func:`.plan.stage_segment`) and dispatches it; every later encode
    with the same (k, p, w, strategy) shape finds the plan in
    :data:`.plan.PLAN_CACHE`, and on the card the graph of that buffer
    captured.  Returns the resolved
    shape (``auto`` pinned to its choice), as the JAX package's
    ``warm_plan`` does.
    """
    if w not in (8, 16):
        raise ValueError(f"file-layer symbol width must be 8 or 16, got {w}")
    sym = w // 8
    codec = RSCodec(native_num, parity_num, w=w, generator=generator, strategy=strategy, device=device)
    chunk = chunk_size_for(file_bytes, native_num, sym) if file_bytes else max(sym, segment_bytes)
    seg_cols = _segment_cols(chunk, native_num, segment_bytes)
    seg = np.zeros((native_num, seg_cols // sym), dtype=codec.gf.dtype)
    staged = _plan.stage_segment(seg, seg_cols // sym, codec.device)
    codec.encode(staged).cpu()  # waits: the plan is built (and its graph captured)
    _plan.release(staged)
    return {"k": native_num, "p": parity_num, "w": w, "strategy": codec.strategy, "generator": generator,
            "cols": seg_cols}


def _write_native_chunks(src, file_name, tmps, k, chunk, total_size, copy_step, crcs, timer, executor) -> None:
    """The k native chunk temp files: straight copies of the k file ranges,
    tail zero-padded, in bounded slices, with optional CRC32.  Each chunk's
    copy is a drain on the writer lane ``executor`` (distinct files and
    ``crcs`` keys, a read-only ``src``), so the caller goes on to stream
    parity."""

    def write_one(i: int) -> None:
        with timer.phase("write natives (io)"):
            lo, hi = i * chunk, min((i + 1) * chunk, total_size)
            crc = 0
            with open(tmps[chunk_file_name(file_name, i)], "wb") as fp:
                for s in range(lo, hi, copy_step):
                    buf = src[s : min(s + copy_step, hi)]
                    fp.write(buf)
                    if crcs is not None:
                        crc = crc32_of(buf, crc)
                pad = chunk - max(0, hi - lo)
                zeros = b"\x00" * min(pad, copy_step)
                for s in range(0, pad, copy_step):
                    buf = zeros[: min(copy_step, pad - s)]
                    fp.write(buf)
                    if crcs is not None:
                        crc = crc32_of(buf, crc)
            if crcs is not None:
                crcs[i] = crc

    for i in range(k):
        executor.submit(lambda i=i: write_one(i), nbytes=chunk)


def _drain_parity(tag, out, loop: StreamLoop, parity_files, timer: PhaseTimer, crcs, k: int) -> None:
    """One segment's parity: wait for its D2H copy, write it, then advance
    the parity CRCs (only after the write landed)."""
    off, _cols = tag
    with timer.phase("encode compute"):
        parity = loop.result(out)
    new_crcs = None
    if crcs is not None:
        new_crcs = {k + j: crc32_of(parity[j], crcs.get(k + j, 0)) for j in range(parity.shape[0])}
    with timer.phase("write parity (io)"):
        native.scatter_write(parity_files, parity, off)
    if new_crcs is not None:
        crcs.update(new_crcs)


@_observed_file_op("encode")
def encode_file(
    file_name: str,
    native_num: int,
    parity_num: int,
    *,
    generator: str = "vandermonde",
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    checksums: bool = False,
    w: int = 8,
    layout: str = "row",
    timer: PhaseTimer | None = None,
    _fleet: FleetPipeline | None = None,
) -> list[str]:
    """Encode ``file_name`` into n = k + p chunk files plus .METADATA and
    return the paths written.

    ``device``: None runs on CUDA (and raises with no GPU present);
    ``"cpu"`` runs the plain PyTorch path.  ``pipeline_depth``: segments in
    flight (the ``-s`` flag).  ``checksums=True`` appends per-chunk CRC32
    lines to .METADATA.  ``w``: symbol width, 8 or 16.  ``layout``:
    ``"row"`` (the reference's) or ``"interleaved"`` (file symbol s in row
    ``s % k``, column ``s // k``; an append touches only the tail column
    block, ``# layout interleaved`` in .METADATA).
    """
    timer = timer or PhaseTimer(enabled=False)
    if w not in (8, 16):
        raise ValueError(f"file-layer symbol width must be 8 or 16, got {w}")
    sym = w // 8
    k, p = native_num, parity_num
    depth = max(1, pipeline_depth)
    codec = RSCodec(k, p, w=w, generator=generator, strategy=strategy, device=device)
    total_size = os.path.getsize(file_name)
    if total_size == 0:
        raise ValueError(f"refusing to encode empty file {file_name!r}")
    if layout not in ("row", "interleaved"):
        raise ValueError(f"unknown chunk layout {layout!r} (want row or interleaved)")
    if layout == "interleaved":
        return _encode_file_interleaved(file_name, codec, total_size, segment_bytes=segment_bytes, depth=depth,
                                        checksums=checksums, timer=timer, _fleet=_fleet)
    chunk = chunk_size_for(total_size, k, sym)
    seg_cols = _segment_cols(chunk, k, segment_bytes)
    src = np.memmap(file_name, dtype=np.uint8, mode="r")
    commit = _ArchiveCommit(file_name, k + p)
    crcs: dict[int, int] | None = {} if checksums else None
    loop = StreamLoop(codec.device, k, seg_cols, depth)

    def gather(off: int, cols: int):
        # On the prefetch thread: native preads into the loop's buffer.  A
        # resilience read boundary: the fault hook and a transient retry
        # (the read refills the same buffer, so a rerun is exact).
        with timer.phase("stage segment (io)"):
            slot, dst = loop.host_segment(cols)

            def attempt():
                _faults.on_read(file_name, scope="read")
                return native.stripe_read(file_name, chunk, k, off, cols, total_size, fallback_src=src, dst=dst)

            return slot, _retry.default_policy().call(attempt, op="encode_stage")

    parity_files: list = []

    def finalize() -> None:
        # After every parity write landed: on this thread standalone, on
        # the fleet's lane (behind this file's drains) in a fleet.
        for fp in parity_files:
            fp.close()
        with timer.phase("write metadata (io)"):
            write_metadata(commit.meta_tmp, total_size, p, k, codec.total_matrix, w=w)
            if crcs is not None:
                append_checksums(commit.meta_tmp, crcs)
        commit.promote()

    def cleanup() -> None:
        for fp in parity_files:
            if not fp.closed:
                fp.close()
        commit.discard()

    # In a fleet the cleanup runs from the fleet's abort, after its workers
    # joined; never here, where this file's drains may still be queued.
    key = _fleet.register(cleanup) if _fleet is not None else None
    try:
        with _drain_ctx(_fleet) as dex:
            _write_native_chunks(src, file_name, commit.tmps, k, chunk, total_size, max(1, segment_bytes), crcs,
                                 timer, dex)
            for j in range(p):
                parity_files.append(open(commit.tmps[chunk_file_name(file_name, k + j)], "wb"))
            with SegmentPrefetcher(_segment_spans(chunk, seg_cols), gather, depth=depth) as prefetch, AsyncWindow(
                depth, lambda tag, out: _drain_parity(tag, out, loop, parity_files, timer, crcs, k), executor=dex
            ) as window:
                for tag, staged in _staging(prefetch, loop, sym, depth, timer):
                    with timer.phase("encode dispatch"):
                        out = loop.dispatch(codec.encode, staged)
                    window.push(tag, out)
        if _fleet is not None:
            _fleet.commit(key, finalize)
        else:
            finalize()
    except BaseException:
        if _fleet is None:
            cleanup()
        raise
    return commit.written


def _encode_file_interleaved(file_name: str, codec: RSCodec, total_size: int, *, segment_bytes: int, depth: int,
                             checksums: bool, timer: PhaseTimer, _fleet: FleetPipeline | None) -> list[str]:
    """:func:`encode_file` under the interleaved layout: each segment is one
    contiguous read of the file (bytes ``[off*k, (off + cols)*k)``)
    transposed straight into a pinned slot of the loop
    (:func:`.native.interleave_read`); the slot stays held until the drain
    has written its natives and the parity.  The same ``.rs_tmp``
    atomicity, CRC lines, write-behind lane and fleet composition."""
    k, p, w = codec.native_num, codec.parity_num, codec.w
    sym = w // 8
    chunk = chunk_size_for_layout(total_size, k, sym, "interleaved")
    seg_cols = _segment_cols(chunk, k, segment_bytes)
    src = np.memmap(file_name, dtype=np.uint8, mode="r")
    commit = _ArchiveCommit(file_name, k + p)
    crcs: dict[int, int] | None = {} if checksums else None
    loop = StreamLoop(codec.device, k, seg_cols, depth, hold=True)
    files: list = []

    def gather(off: int, cols: int):
        # On the prefetch thread: one contiguous read, transposed into the
        # slot; the same read boundary as the row gather.
        with timer.phase("stage segment (io)"):
            slot, dst = loop.host_segment(cols)

            def attempt():
                _faults.on_read(file_name, scope="read")
                return native.interleave_read(file_name, k, sym, off, cols, total_size, fallback_src=src, dst=dst)

            return slot, _retry.default_policy().call(attempt, op="encode_stage")

    def drain(tag, payload) -> None:
        off, _cols = tag
        (slot, natives), out = payload
        with timer.phase("encode compute"):
            parity = loop.result(out)
        new_crcs = None
        if crcs is not None:
            new_crcs = {i: crc32_of(natives[i], crcs.get(i, 0)) for i in range(k)}
            new_crcs.update({k + j: crc32_of(parity[j], crcs.get(k + j, 0)) for j in range(p)})
        with timer.phase("write natives (io)"):
            native.scatter_write(files[:k], natives, off)
        with timer.phase("write parity (io)"):
            native.scatter_write(files[k:], parity, off)
        if new_crcs is not None:
            crcs.update(new_crcs)
        # Last: the write boundary reruns this whole drain after a
        # transient failure, and a rerun must read the same natives.
        loop.release(slot)

    def finalize() -> None:
        for fp in files:
            fp.close()
        with timer.phase("write metadata (io)"):
            write_metadata(commit.meta_tmp, total_size, p, k, codec.total_matrix, w=w, layout="interleaved")
            if crcs is not None:
                append_checksums(commit.meta_tmp, crcs)
        commit.promote()

    def cleanup() -> None:
        for fp in files:
            if not fp.closed:
                fp.close()
        commit.discard()

    def stage(tag, segment):
        with timer.phase("h2d (transfer)"):
            return segment, loop.stage(segment, sym)

    key = _fleet.register(cleanup) if _fleet is not None else None
    try:
        with _drain_ctx(_fleet) as dex:
            for name in commit.written[:-1]:
                files.append(open(commit.tmps[name], "wb"))
            # The loop closes before the prefetcher joins: a prefetch
            # waiting for a held slot must not outlive a failed stream.
            with SegmentPrefetcher(_segment_spans(chunk, seg_cols), gather, depth=depth) as prefetch, \
                    closing(loop), AsyncWindow(depth, drain, executor=dex) as window:
                for tag, (segment, staged) in DeviceStagingRing(prefetch, stage, depth=depth):
                    with timer.phase("encode dispatch"):
                        out = loop.dispatch(codec.encode, staged)
                    window.push(tag, (segment, out))
        if _fleet is not None:
            _fleet.commit(key, finalize)
        else:
            finalize()
    except BaseException:
        if _fleet is None:
            cleanup()
        raise
    return commit.written


@_observed_file_op("encode_fleet")
def encode_fleet(
    files,
    native_num: int,
    parity_num: int,
    *,
    generator: str = "vandermonde",
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    checksums: bool = False,
    w: int = 8,
    layout: str = "row",
    timer: PhaseTimer | None = None,
) -> dict[str, list[str]]:
    """Encode many files back to back through one shared write-behind lane:
    file j+1's native copies, reads and dispatches run while file j's
    parity drains, and each file's .METADATA and promote are committed
    behind its own writes.

    All or nothing per file (each keeps :func:`encode_file`'s atomicity),
    fail-fast across the fleet: the first failing file raises, later files
    are not tried, and every uncommitted file's temps are removed.  Returns
    ``{file: [paths written]}``.
    """
    timer = timer or PhaseTimer(enabled=False)
    results: dict[str, list[str]] = {}
    with _fleet_lane() as pipe:
        for f in list(files):
            results[f] = encode_file(
                f, native_num, parity_num, generator=generator, strategy=strategy, device=device,
                segment_bytes=segment_bytes, pipeline_depth=pipeline_depth, checksums=checksums, w=w,
                layout=layout, timer=timer, _fleet=pipe,
            )
    return results


def _checked_total_matrix(meta) -> np.ndarray:
    """The archive's total matrix: as .METADATA gives it (decode trusts the
    file), or regenerated for the sizes-only dialect; an entry past
    GF(2^w) raises."""
    total_mat = meta.total_mat
    if total_mat is None:
        # Sizes-only metadata: the canonical [I; Vandermonde] matrix.
        total_mat = total_matrix(meta.parity_num, meta.native_num, get_field(meta.w))
    if int(total_mat.max(initial=0)) >= (1 << meta.w):
        raise ValueError(
            f"metadata matrix entry {int(total_mat.max())} out of range for GF(2^{meta.w}) — corrupt or foreign "
            ".METADATA"
        )
    return total_mat


def _write_empty_atomic(out_path: str) -> str:
    """A zero-byte output (the decode of a totalSize=0 archive), written
    under a ``.rs_tmp`` name and renamed."""
    tmp_path = out_path + ".rs_tmp"
    open(tmp_path, "wb").close()
    os.replace(tmp_path, out_path)
    return out_path


def _open_chunk(path: str, chunk: int, index: int | None = None, scope: str = "read") -> np.ndarray:
    """Read-only byte view of a chunk file, checked against the chunk size
    (an empty view for a zero-size archive).

    A resilience boundary: the fault plane's read hook fires here
    (``scope`` tells decode reads from scrub CRC reads), bitrot specs
    corrupt the returned view (a copy; the file is untouched), and a
    transient open failure retries under the default policy.  A chunk that
    shrank below the chunk size raises :class:`ChunkIntegrityError` naming
    ``index`` (a ``ValueError`` when the caller gave none)."""

    def attempt() -> np.ndarray:
        _faults.on_read(path, index=index, scope=scope)
        mm = np.zeros(0, dtype=np.uint8) if chunk == 0 else np.memmap(path, dtype=np.uint8, mode="r")
        if mm.shape[0] < chunk:
            if index is not None:
                raise ChunkIntegrityError({index: path},
                                          reason=f"chunk truncated after scan ({mm.shape[0]} of {chunk} bytes)")
            raise ValueError(f"chunk {path!r} is {mm.shape[0]} bytes, expected {chunk}")
        return _faults.corrupt(path, index, mm, scope=scope)

    return _retry.default_policy().call(attempt, op="chunk_open")


@_observed_file_op("decode")
def decode_file(
    in_file: str,
    conf_file: str,
    output: str | None = None,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    verify_checksums: bool | None = None,
    timer: PhaseTimer | None = None,
    _fleet: FleetPipeline | None = None,
    _fallback_rows: list[int] | None = None,
) -> str:
    """Rebuild ``in_file`` from the k surviving chunks listed in
    ``conf_file`` and return the output path (``in_file`` by default).

    ``pipeline_depth``: segments in flight (the ``-s`` flag).
    ``verify_checksums``: None verifies survivors against the CRC32 lines
    when .METADATA has them, True requires them, False skips.  A corrupt
    survivor raises :class:`ChunkIntegrityError` naming it.

    ``_fallback_rows`` (private, from :func:`auto_decode_file`): healthy
    chunk indices beside ``in_file`` that the conf did not choose.  With
    such a pool, a survivor that fails mid-stream (a read error pinned on
    it by ``os.fstat``) is swapped for a pool chunk, the decode matrix is
    re-derived, and the stream resumes from the first uncommitted segment,
    at most ``RS_RETRY_RESELECT`` times (default 3).  When the pool cannot
    cover it, the failure raises :class:`ChunkIntegrityError` naming the
    survivor.  ``_fleet`` (private, from :func:`decode_fleet`): the shared
    write-behind lane; the output is committed behind its own writes.
    """
    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    meta_path = metadata_file_name(in_file)
    with timer.phase("read metadata (io)"):
        meta = read_archive_meta(meta_path)
    total_size, p, k = meta.total_size, meta.parity_num, meta.native_num
    total_mat, w, crcs = meta.total_mat, meta.w, meta.crcs
    _check_gfwidth(w, meta_path)
    layout = meta.layout
    total_mat = _checked_total_matrix(meta)
    sym = w // 8
    chunk = meta.chunk
    names = read_conf(conf_file)
    if len(names) != k:
        raise ValueError(f"conf file lists {len(names)} chunks, need k={k}")
    rows = [parse_chunk_index(nm) for nm in names]
    conf_dir = os.path.dirname(os.path.abspath(conf_file))
    in_dir = os.path.dirname(os.path.abspath(in_file))

    def resolve(nm: str) -> str:
        for cand in (nm, os.path.join(conf_dir, os.path.basename(nm)), os.path.join(in_dir, os.path.basename(nm))):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"surviving chunk {nm!r} not found")

    with timer.phase("open chunks (io)"):
        # Open every survivor before raising, so that one error names every
        # truncated or unreadable chunk.  A name never found still raises
        # FileNotFoundError from resolve().
        paths, maps, bad_open = [], [], {}
        for nm, row in zip(names, rows):
            path = resolve(nm)
            try:
                maps.append(_open_chunk(path, chunk, index=row))
            except ChunkIntegrityError as e:
                bad_open.update(e.bad_chunks)
                continue
            except OSError:
                bad_open[row] = path
                continue
            paths.append(path)
        if bad_open:
            raise ChunkIntegrityError(
                bad_open, reason="survivor chunks unreadable, truncated or vanished after selection"
            )

    if verify_checksums is not False:
        if verify_checksums and not crcs:
            raise ValueError(f"{meta_path!r} has no checksum lines but verify_checksums=True")
        if crcs:
            uncovered = [r for r in rows if r not in crcs]
            if verify_checksums and uncovered:
                raise ValueError(f"metadata has no CRC for survivor chunk(s) {uncovered} but verify_checksums=True")
            with timer.phase("verify checksums"):
                bad = {
                    row: path
                    for row, mm, path in zip(rows, maps, paths)
                    if row in crcs and chunk_crc32(mm, chunk, segment_bytes) != crcs[row]
                }
            if bad:
                raise ChunkIntegrityError(bad)

    out_path = output or in_file
    if total_size == 0:
        return _write_empty_atomic(out_path)
    tmp_path = out_path + ".rs_tmp"

    codec = RSCodec(k, p, w=w, strategy=strategy, device=device)
    total_mat = total_mat.astype(codec.gf.dtype)
    # Partial recovery: with a systematic matrix, surviving natives are
    # already the answer; only the missing native rows go through the GEMM
    # (their rows of the inverse; the dropped rows are unit vectors).
    systematic = np.array_equal(total_mat[:k], np.eye(k, dtype=total_mat.dtype))
    seg_cols = _segment_cols(chunk, k, segment_bytes)
    depth = max(1, pipeline_depth)
    segments = _segment_spans(chunk, seg_cols)

    # The survivor set and all that derives from it: a degraded decode
    # swaps a survivor that fails mid-stream for a pool chunk and resumes,
    # and _derive() rebuilds the rest.
    st: dict = {"rows": list(rows), "maps": list(maps), "paths": list(paths), "fps": []}

    def _derive() -> None:
        with timer.phase("invert matrix"):
            dec_mat = codec.decode_matrix_from(total_mat, st["rows"])
        native_pos = {r: idx for idx, r in enumerate(st["rows"]) if r < k} if systematic else {}
        missing = [i for i in range(k) if i not in native_pos]
        st["native_pos"] = native_pos
        st["rec_row"] = {i: j for j, i in enumerate(missing)}
        st["dec_missing"] = dec_mat[missing] if missing else None
        for fp in st["fps"]:
            fp.close()
        # Read fds and a stream loop for the native gather; only the
        # recovery path stages segments, the all-natives path copies from
        # the memmaps.  A resume gets a fresh loop: the prefetcher that
        # failed took its pinned buffers with it.
        recover = st["dec_missing"] is not None
        st["loop"] = StreamLoop(codec.device, k, seg_cols, depth) if recover else None
        st["fps"] = [open(path, "rb") for path in st["paths"]] if recover else []

    _derive()
    try:
        out_fp = open(tmp_path, "wb")
    except BaseException:
        for fp in st["fps"]:
            fp.close()
        raise

    def finalize() -> None:
        # After every output write landed: on this thread standalone, on
        # the fleet's lane (behind this file's drains) in a fleet.
        out_fp.truncate(total_size)
        out_fp.close()
        for fp in st["fps"]:
            fp.close()
        os.replace(tmp_path, out_path)

    def cleanup() -> None:
        for fp in [out_fp, *st["fps"]]:
            if not fp.closed:
                fp.close()
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)

    # Segments fully written.  Drains commit in dispatch order (the ordered
    # lane), and each attempt dispatches in ascending order from its resume
    # point, so this is the length of the committed prefix: where a
    # degraded decode resumes.
    committed = {"n": 0}

    def write_row(i: int, off: int, cols: int, row_bytes) -> None:
        lo = i * chunk + off
        if lo >= total_size:
            return
        hi = min(lo + cols, total_size)
        out_fp.seek(lo)
        out_fp.write(row_bytes[: hi - lo])

    def _stream(segs) -> None:
        # Bind this attempt's survivor state: drains a fleet lane already
        # queued keep the set their recovery GEMM used (any valid set
        # recovers the same bytes).
        native_pos, rec_row, dec_missing = st["native_pos"], st["rec_row"], st["dec_missing"]
        maps_l, fps_l, loop = st["maps"], st["fps"], st["loop"]
        paths_l, rows_l = st["paths"], st["rows"]

        def drain(tag, out) -> None:
            # On the ordered writer lane: segments land in column order
            # through the shared out_fp.
            off, cols = tag
            rec = None
            if out is not None:
                with timer.phase("decode compute"):
                    rec = loop.result(out)
            with timer.phase("write output (io)"):
                rows_out = [maps_l[native_pos[i]][off : off + cols] if i in native_pos else rec[rec_row[i]]
                            for i in range(k)]
                if layout == "interleaved":
                    # The window's k rows are one contiguous file range.
                    native.deinterleave_write(out_fp, rows_out, sym, off, total_size)
                else:
                    for i, row_bytes in enumerate(rows_out):
                        write_row(i, off, cols, row_bytes)
            committed["n"] = max(committed["n"], off // seg_cols + 1)

        def gather(off: int, cols: int):
            # On the prefetch thread: native preads of the k survivors.  A
            # resilience read boundary: one fault-hook crossing per survivor
            # and a transient retry into the same buffer.
            with timer.phase("stage segment (io)"):
                slot, dst = loop.host_segment(cols)

                def attempt():
                    _faults.on_reads(paths_l, rows_l)
                    return native.gather_rows(fps_l, off, cols, fallback_maps=maps_l, dst=dst)

                return slot, _retry.default_policy().call(attempt, op="decode_stage")

        # The lane's exit is the write barrier (standalone; in a fleet the
        # shared lane's); on an error it joins its workers first.
        with _drain_ctx(_fleet) as dex:
            if dec_missing is None:
                # Every native survived: a pure copy through the window.
                with AsyncWindow(depth, drain, executor=dex) as window:
                    for tag in segs:
                        window.push(tag, None)
                return
            with SegmentPrefetcher(segs, gather, depth=depth) as prefetch, AsyncWindow(
                depth, drain, executor=dex
            ) as window:
                for tag, staged in _staging(prefetch, loop, sym, depth, timer):
                    with timer.phase("decode dispatch"):
                        out = loop.dispatch(lambda seg: codec.decode(dec_missing, seg), staged)
                    window.push(tag, out)

    def _attribute(e: BaseException) -> list[int]:
        """Survivor rows a mid-stream read failure pins on: an injected
        fault carries its chunk index; a real one is probed with fstat (a
        chunk truncated or unlinked under the decode shows there)."""
        if isinstance(e, _faults.InjectedReadError):
            return [e.index] if e.index in st["rows"] else []
        bad = []
        for r, fp in zip(st["rows"], st["fps"]):
            try:
                if os.fstat(fp.fileno()).st_size < chunk:
                    bad.append(r)
            except OSError:
                bad.append(r)
        return bad

    pool = [r for r in (_fallback_rows or []) if r not in set(st["rows"])]
    # A swapped-in pool chunk is CRC-checked whenever the pre-pass above
    # checked the survivors.
    verify_swaps = verify_checksums is not False and bool(crcs)

    def _reselect(bad: list[int]) -> bool:
        """Swap the failed survivors for pool chunks and re-derive the
        decode state; False when the pool cannot cover them (or every
        replacement set is singular)."""
        keep = [(r, m, path) for r, m, path in zip(st["rows"], st["maps"], st["paths"]) if r not in bad]
        while True:
            fresh = []
            while pool and len(keep) + len(fresh) < k:
                r = pool.pop(0)
                path = chunk_file_name(in_file, r)
                try:
                    m = _open_chunk(path, chunk, index=r)
                    if verify_swaps and r in crcs and chunk_crc32(m, chunk, segment_bytes) != crcs[r]:
                        continue  # rotted after the scan; try the next
                except (ValueError, OSError):
                    continue  # this pool chunk is damaged too
                fresh.append((r, m, path))
            if len(keep) + len(fresh) < k:
                return False
            merged = keep + fresh
            st["rows"] = [r for r, _, _ in merged]
            st["maps"] = [m for _, m, _ in merged]
            st["paths"] = [path for _, _, path in merged]
            try:
                _derive()
            except SingularMatrixError:
                continue  # a non-MDS corner: try further pool chunks
            return True

    key = _fleet.register(cleanup) if _fleet is not None else None
    reselects = 0
    max_reselects = max(0, _retry.int_env("RS_RETRY_RESELECT", 3))
    try:
        while True:
            try:
                _stream(segments[committed["n"] :])
                break
            except OSError as e:
                bad = [r for r in _attribute(e) if r in st["rows"]]
                if not bad:
                    raise  # unattributable (e.g. a write-side error)
                # Name the failing rows' paths now: a failed _reselect
                # leaves st without them.
                bad_paths = {r: path for r, path in zip(st["rows"], st["paths"]) if r in bad}
                swapped = False
                if reselects < max_reselects:
                    if _fleet is not None:
                        # Let this archive's queued drains land, so that
                        # ``committed`` is final before the resume point.
                        _fleet.executor.flush()
                    swapped = _reselect(bad)
                if not swapped:
                    # The open-time contract: name the failing survivor, so
                    # that auto_decode_file can exclude it and reselect.
                    raise ChunkIntegrityError(bad_paths,
                                              reason="survivor chunk failed mid-stream reads past retries") from e
                reselects += 1
                _obs_tracing.instant("degraded_reselect", lane="retry", bad=",".join(map(str, bad)),
                                     resume_segment=committed["n"])
        if reselects:
            _obs_metrics.counter("rs_degraded_decodes_total",
                                 "decodes completed after mid-stream survivor reselection").labels(
                stage="midstream").inc()
        if _fleet is not None:
            _fleet.commit(key, finalize)
        else:
            finalize()
    except BaseException:
        if _fleet is None:
            cleanup()
        raise
    return out_path


# -- survivor discovery and selection -------------------------------------------


class _ChunkScan:
    """An archive's metadata fields plus which chunk indices are healthy,
    damaged (truncated, unreadable or CRC-failing) or missing."""

    def __init__(self, in_file, total_size, p, k, total_mat, w, crcs, chunk, healthy, bad, layout="row",
                 generation=0):
        self.in_file = in_file
        self.total_size = total_size
        self.p = p
        self.k = k
        self.total_mat = total_mat
        self.w = w
        self.crcs = crcs
        self.chunk = chunk
        self.healthy = healthy  # indices of full-size, CRC-clean files
        self.bad = bad  # {index: path} present but damaged
        self.layout = layout
        self.generation = generation  # the update commit counter
        self.missing = sorted(set(range(k + p)) - set(healthy) - set(bad))

    @property
    def unhealthy(self) -> list[int]:
        """Every chunk index that needs repair (damaged or absent)."""
        return sorted(set(self.bad) | set(self.missing))

    def excluding(self, bad: dict[int, str]) -> "_ChunkScan":
        """This scan with ``bad`` demoted from healthy: how auto-decode folds
        in failures found after the scan before it reselects."""
        return _ChunkScan(self.in_file, self.total_size, self.p, self.k, self.total_mat, self.w, self.crcs,
                          self.chunk, [i for i in self.healthy if i not in bad], {**self.bad, **bad},
                          layout=self.layout, generation=self.generation)


def _scan_chunks(in_file: str, segment_bytes: int) -> _ChunkScan:
    """Chunk health next to ``in_file``: a file shorter than the chunk is
    truncated, an unreadable one a read error, one whose CRC32 differs
    from its ``# crc32`` line a mismatch; all three are damage.  Files the
    metadata has no CRC for are healthy when full-size."""
    meta_path = metadata_file_name(in_file)
    meta = read_archive_meta(meta_path)
    k, p = meta.native_num, meta.parity_num
    _check_gfwidth(meta.w, meta_path)
    total_mat = _checked_total_matrix(meta)
    chunk, crcs = meta.chunk, meta.crcs
    healthy: list[int] = []
    bad: dict[int, str] = {}
    # The per-chunk verdicts of the health plane's "scan" event: the full
    # map, an empty one included (a clean scan clears earlier damage).
    states: dict[int, str] = {}
    chunk_states = _obs_metrics.counter("rs_scrub_chunks_total", "chunk verdicts from archive scans")
    for i in range(k + p):
        path = chunk_file_name(in_file, i)
        if not os.path.exists(path):
            states[i] = "missing"
        elif os.path.getsize(path) < chunk:
            bad[i], states[i] = path, "truncated"  # damage, not loss
        elif i in crcs:
            try:
                # The fault plane's scrub boundary.
                mm = _open_chunk(path, chunk, index=i, scope="scrub")
            except ChunkIntegrityError:
                bad[i], states[i] = path, "truncated"  # shrank since the size check
            except OSError:
                # Unreadable after retries: damage to record, the scan goes on.
                bad[i], states[i] = path, "read_error"
            else:
                if chunk_crc32(mm, chunk, segment_bytes) != crcs[i]:
                    bad[i], states[i] = path, "crc_mismatch"
        chunk_states.labels(state=states.get(i, "healthy")).inc()
        if i not in states:
            healthy.append(i)
    _obs_metrics.counter("rs_scrub_archives_scanned_total", "archive health scans").labels(
        outcome="damaged" if bad or len(healthy) < k + p else "clean").inc()
    _obs_health.record_damage("scan", in_file, states=states, k=k, p=p, w=meta.w, generation=meta.generation)
    return _ChunkScan(in_file, meta.total_size, p, k, total_mat, meta.w, crcs, chunk, healthy, bad,
                      layout=meta.layout, generation=meta.generation)


# The generation-keyed survivor-subset cache: one chosen subset and its
# verified inverse per (archive, generation).  Scans of the same archive
# generation resolve to the pinned subset while it stays healthy; an
# update bumps the generation and a re-encode with another matrix changes
# the digest, and either makes the entry stale.
_SUBSET_CACHE: "OrderedDict[str, dict]" = OrderedDict()
_SUBSET_LOCK = threading.Lock()
_SUBSET_CACHE_MAX = 128
_SUBSET_STATS = {"hits": 0, "misses": 0, "stale": 0}


def clear_subset_cache() -> None:
    """Drop the survivor-subset cache and reset its stats."""
    with _SUBSET_LOCK:
        _SUBSET_CACHE.clear()
        for key in _SUBSET_STATS:
            _SUBSET_STATS[key] = 0


def subset_cache_stats() -> dict:
    """Entries, and this process's hits, misses and stale entries."""
    with _SUBSET_LOCK:
        return {"entries": len(_SUBSET_CACHE), **_SUBSET_STATS}


def matrix_digest(A, w: int) -> str:
    """A stable identity of a coefficient matrix (blake2b, 8 bytes)."""
    A = np.ascontiguousarray(np.asarray(A))
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{w}:{A.shape[0]}x{A.shape[1]}:{A.dtype.str}".encode())
    h.update(A.tobytes())
    return h.hexdigest()


def _cached_subset(scan: _ChunkScan):
    """The pinned (chosen, inverse) of this archive generation, or None
    when absent, stale, of another matrix, or not fully healthy in this
    scan."""
    key = os.path.abspath(scan.in_file)
    with _SUBSET_LOCK:
        ent = _SUBSET_CACHE.get(key)
    if ent is None:
        return None
    if (ent["generation"] != scan.generation or ent["mat_digest"] != matrix_digest(scan.total_mat, scan.w)
            or len(ent["chosen"]) != scan.k):
        with _SUBSET_LOCK:
            if _SUBSET_CACHE.get(key) is ent:
                del _SUBSET_CACHE[key]
            _SUBSET_STATS["stale"] += 1
        return None
    if not set(ent["chosen"]) <= set(scan.healthy):
        # Not stale: unavailable under this scan's damage only.
        return None
    with _SUBSET_LOCK:
        if key in _SUBSET_CACHE:
            _SUBSET_CACHE.move_to_end(key)
        _SUBSET_STATS["hits"] += 1
    return list(ent["chosen"]), ent["inv"]


def _remember_subset(scan: _ChunkScan, chosen, inv) -> None:
    key = os.path.abspath(scan.in_file)
    ent = {"generation": scan.generation, "mat_digest": matrix_digest(scan.total_mat, scan.w),
           "chosen": tuple(int(c) for c in chosen), "inv": inv}
    with _SUBSET_LOCK:
        _SUBSET_CACHE[key] = ent
        _SUBSET_CACHE.move_to_end(key)
        while len(_SUBSET_CACHE) > _SUBSET_CACHE_MAX:
            _SUBSET_CACHE.popitem(last=False)
        _SUBSET_STATS["misses"] += 1


def _select_decodable_subset(scan: _ChunkScan, *, cap: int = 100, skip: int = 0):
    """k healthy chunk indices whose submatrix inverts, and the inverse.

    Candidates in natives-first order (surviving natives are copied, not
    computed), then with parity; a singular candidate moves on to the next.
    ``skip``/``cap`` window the candidate stream, so that a caller that
    caught :class:`UndecidedSubsetError` continues where the last batch
    stopped.  A search from the start consults the subset cache first.
    """
    k = scan.k
    if len(scan.healthy) < k:
        raise ValueError(
            f"only {len(scan.healthy)} healthy chunks of the k={k} needed "
            f"(corrupt: {sorted(scan.bad)}, missing: {scan.missing})"
        )
    if skip == 0:
        hit = _cached_subset(scan)
        if hit is not None:
            return hit
    gf = get_field(scan.w)
    mat = scan.total_mat.astype(gf.dtype)
    capped = False
    for attempt, subset in enumerate(combinations(scan.healthy, k)):
        if attempt < skip:
            continue
        if attempt >= skip + cap:
            capped = True
            break
        try:
            inv = invert_matrix(mat[list(subset)], gf)
        except SingularMatrixError:
            continue
        _remember_subset(scan, subset, inv)
        return list(subset), inv
    if capped:
        raise UndecidedSubsetError(
            f"no decodable k={k} subset within candidate subsets [{skip}, {skip + cap}) of healthy chunks "
            f"{scan.healthy}; more combinations exist — this archive is not proven unrecoverable"
        )
    raise ValueError(f"no decodable k={k} subset among healthy chunks {scan.healthy}")


def _select_subset_retrying(scan: _ChunkScan, attempts: int | None = None):
    """:func:`_select_decodable_subset`, going on into the next batch of
    100 candidates after an :class:`UndecidedSubsetError`, up to
    ``RS_RETRY_SUBSET_ATTEMPTS`` batches (default 3)."""
    cap = 100
    attempts = max(1, _retry.int_env("RS_RETRY_SUBSET_ATTEMPTS", 3)) if attempts is None else max(1, attempts)
    last: UndecidedSubsetError | None = None
    for batch in range(attempts):
        try:
            return _select_decodable_subset(scan, cap=cap, skip=batch * cap)
        except UndecidedSubsetError as e:
            last = e
    raise last


@_observed_file_op("scan")
def scan_file(in_file: str, *, segment_bytes: int = DEFAULT_SEGMENT_BYTES, syndrome: bool = False,
              device=None) -> dict:
    """Read-only health report of an archive (the scrubbing half of repair).

    Returns ``{"k", "p", "w", "checksummed", "layout", "generation",
    "pending_journal", "healthy", "corrupt", "missing", "decodable"}``:
    ``corrupt`` lists present but damaged chunks (truncated, unreadable or
    CRC-failing), ``missing`` absent ones; ``decodable`` is True when >= k
    healthy chunks hold an invertible subset (so every damaged chunk is
    repairable), False when not, and ``"unknown"`` when the subset search
    hit its cap.

    ``syndrome=True`` adds the parity-check sweep over every present chunk
    (through the device's GEMM), which attributes silent bitrot to its
    chunk without any CRC: located chunks move from ``healthy`` to
    ``corrupt`` and the report gains ``{"syndrome": {"verdict",
    "silent_bitrot", "symbol_errors", "complete"}}``.  A verdict of
    ``unlocatable`` (damage beyond t = floor((p - missing) / 2) in some
    column) makes a True ``decodable`` ``"unknown"``.

    ``device``: where the syndrome GEMM runs; None means CUDA and raises
    with no GPU present.
    """
    device = resolve_device(device)
    scan = _scan_chunks(in_file, segment_bytes)
    syn_report = None
    if syndrome:
        verdict, located, nerr, complete = _syndrome_sweep(in_file, scan, device=device, segment_bytes=segment_bytes)
        syn_report = {"verdict": verdict, "silent_bitrot": sorted(located), "symbol_errors": nerr,
                      "complete": complete}
        # Demote located chunks only on a complete sweep: an unlocatable
        # one stopped early, so its located set covers only a prefix.
        if located and verdict == "silent_bitrot":
            scan = scan.excluding({i: chunk_file_name(in_file, i) for i in located})
        if located or verdict == "unlocatable":
            # Each located chunk is a verified attribution, a partial
            # sweep's too (the verdict carries that caveat).
            _obs_health.record_damage("syndrome", in_file, chunks=sorted(located), k=scan.k, p=scan.p, w=scan.w,
                                      generation=scan.generation, verdict=verdict)
    try:
        _select_decodable_subset(scan)
        ok = True
    except UndecidedSubsetError:
        ok = "unknown"
    except ValueError:
        ok = False
    if syn_report is not None and syn_report["verdict"] == "unlocatable":
        ok = "unknown" if ok is True else ok  # erasure-decodable maybe, the bytes unproven
    report = {
        "k": scan.k,
        "p": scan.p,
        "w": scan.w,
        "checksummed": bool(scan.crcs),
        "layout": scan.layout,
        "generation": scan.generation,
        # A torn in-place update's undo journal; reported, never resolved
        # by a read-only scan.
        "pending_journal": os.path.exists(journal_path(in_file)),
        "healthy": scan.healthy,
        "corrupt": sorted(scan.bad),
        "missing": scan.missing,
        "decodable": ok,
    }
    if syn_report is not None:
        report["syndrome"] = syn_report
    return report


@_observed_file_op("auto_decode")
def auto_decode_file(in_file: str, output: str | None = None, *, conf_out: str | None = None,
                     **decode_kwargs) -> str:
    """Decode without a hand-written conf: scan the chunks beside
    ``in_file``, drop damaged ones, choose k survivors (natives first)
    whose submatrix inverts, write them as a conf (``conf_out``, default
    ``<in_file>.auto.conf``) and run :func:`decode_file` with it.
    ``decode_kwargs`` pass through (``verify_checksums`` defaults to False:
    the scan has CRC-checked the chunks it chose).

    The unselected healthy chunks go to :func:`decode_file` as its pool for
    a mid-stream survivor swap.  A survivor that fails after the scan
    (truncated or unlinked before its open, or mid-stream beyond what the
    pool covers) raises :class:`ChunkIntegrityError`; the named chunks are
    then excluded, and the archive rescanned and reselected, up to
    ``RS_RETRY_RESELECT`` more attempts.  On an archive without CRC lines
    (``RS_LOCATE=auto``, the default) or always (``RS_LOCATE=force``) the
    first attempt is :func:`locate_decode_file`, so silent bitrot cannot
    reach the output; when the reselections run out, one locate attempt
    comes last (not under ``RS_LOCATE=off``).

    Raises ValueError when fewer than k healthy chunks remain or no subset
    inverts.  ``device`` (in ``decode_kwargs``): None means CUDA and
    raises with no GPU present.
    """
    from .gf_decode import UnlocatableError

    decode_kwargs["device"] = entry_device(decode_kwargs.get("device"), decode_kwargs.get("strategy", "auto"))
    segment_bytes = decode_kwargs.get("segment_bytes", DEFAULT_SEGMENT_BYTES)
    conf_path = conf_out or (in_file + ".auto.conf")
    attempts = max(1, _retry.int_env("RS_RETRY_RESELECT", 3) + 1)
    excluded: dict[int, str] = {}
    locate_mode = _locate_mode()
    locate_kwargs = {key: decode_kwargs[key] for key in ("strategy", "device", "segment_bytes", "pipeline_depth",
                                                         "timer") if key in decode_kwargs}
    locate_kwargs["conf_out"] = conf_path

    for attempt in range(attempts):
        scan = _scan_chunks(in_file, segment_bytes)
        if excluded:
            scan = scan.excluding(excluded)
        # Locate first where no CRC protects this decode (with CRC lines the
        # scan has verified every chunk already).  A locate failure other
        # than UnlocatableError falls to the erasure ladder below, which
        # owns the reselection.
        locate_first = locate_mode == "force" or (locate_mode == "auto" and not scan.crcs)
        if attempt == 0 and scan.total_size > 0 and locate_first and _locate_context(scan) is not None:
            try:
                return locate_decode_file(in_file, output, _scan=scan, **locate_kwargs)
            except UnlocatableError:
                raise  # never fall back to a silently wrong erasure decode
            except (ValueError, OSError):
                pass
        chosen, _ = _select_subset_retrying(scan)
        write_conf(conf_path, [os.path.basename(chunk_file_name(in_file, i)) for i in chosen])
        kwargs = dict(decode_kwargs)
        if kwargs.get("verify_checksums") is None:
            kwargs["verify_checksums"] = False
        try:
            return decode_file(in_file, conf_path, output, _fallback_rows=[i for i in scan.healthy if i not in chosen],
                               **kwargs)
        except (ChunkIntegrityError, FileNotFoundError) as e:
            if isinstance(e, ChunkIntegrityError):
                excluded.update(e.bad_chunks)
                # Survivors that failed after the scan chose them: damage
                # the scan's map missed, recorded under its own event.
                _obs_health.record_damage("decode_failure", in_file, chunks=sorted(e.bad_chunks), k=scan.k, p=scan.p,
                                          w=scan.w, generation=scan.generation)
            if attempt + 1 >= attempts:
                # The last rung: one error-locating attempt over a fresh
                # scan; its own failure re-raises the ladder's error.
                if locate_mode != "off":
                    rescan = _scan_chunks(in_file, segment_bytes)
                    if _locate_context(rescan) is not None:
                        try:
                            return locate_decode_file(in_file, output, _scan=rescan, **locate_kwargs)
                        except (ValueError, OSError):
                            raise e from None
                raise
    raise AssertionError("unreachable: the last attempt returns or raises")


@_observed_file_op("decode_fleet")
def decode_fleet(
    files,
    outputs: dict[str, str] | None = None,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    verify_checksums: bool | None = None,
    timer: PhaseTimer | None = None,
) -> dict[str, str]:
    """:func:`auto_decode_file` of many archives through one shared
    write-behind lane: archive j+1's scan, reads and dispatches run while
    archive j's output writes drain, and each output is committed behind
    its own writes.  ``outputs`` maps an archive to its output path
    (default: in place).  Fail-fast: the first failing archive raises;
    outputs committed before stay, uncommitted temps are removed.  Returns
    ``{file: output path}``."""
    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    outputs = outputs or {}
    results: dict[str, str] = {}
    with _fleet_lane() as pipe:
        for f in list(files):
            results[f] = auto_decode_file(
                f, outputs.get(f), strategy=strategy, device=device, segment_bytes=segment_bytes,
                pipeline_depth=pipeline_depth, verify_checksums=verify_checksums, timer=timer, _fleet=pipe,
            )
    return results


# -- error-locating decode ---------------------------------------------------------
#
# Silent bitrot, a damaged chunk that no CRC catches, passes straight
# through an erasure decode.  The locate path reads every present chunk,
# computes each segment's parity-check syndromes on the device
# (RSCodec.syndrome), locates and corrects the errors on the host
# (gf_decode), and only then runs the recovery GEMM.  A column whose damage
# exceeds t = floor((p - erasures) / 2) raises UnlocatableError, never a
# wrong output.


def _locate_mode() -> str:
    """``RS_LOCATE``: ``auto`` (default: locate where no CRC protects a
    decode), ``off`` or ``force``."""
    v = os.environ.get("RS_LOCATE", "auto").strip().lower()
    if v in ("0", "off", "no", "false"):
        return "off"
    if v in ("1", "force", "always"):
        return "force"
    return "auto"


def _locate_context(scan: _ChunkScan):
    """A :class:`.gf_decode.LocateContext` for this scan, or None when
    locating does not apply (zero-size archive, fewer than k healthy
    chunks, more erasures than parity, a non-systematic matrix)."""
    from .gf_decode import LocateContext

    if scan.chunk == 0 or len(scan.healthy) < scan.k:
        return None
    try:
        return LocateContext(scan.total_mat, scan.k, scan.p, scan.w, scan.healthy)
    except ValueError:
        return None


def _locate_segment_fixes(ctx, codec: RSCodec, loop: StreamLoop, seg: np.ndarray, sym: int, timer: PhaseTimer,
                          want_packed: bool = False):
    """One segment's syndrome check: S = check . seg through the GEMM on
    the device, then the host locate.  Returns ``(fixes, packed)``: the
    verified corrections ({column: [(chunk, magnitude)]}) and, with
    ``want_packed`` under the xor or ring strategy, the segment's
    :class:`.ops.xor_gemm.PackedOperand`, so the caller's recovery GEMM
    reuses the pack this syndrome GEMM paid for (None otherwise).  The
    planes stay on ``loop``'s device, in its compute stream's order.
    Raises :class:`.gf_decode.UnlocatableError` past the t bound."""
    if ctx.r == 0:
        return {}, None
    packed = None

    def syndrome(d):
        nonlocal packed
        packed = codec.pack_operand(d) if want_packed else None
        return codec.syndrome(ctx.check, packed if packed is not None else d)

    with timer.phase("syndrome dispatch"):
        out = loop.dispatch(syndrome, loop.stage_copy(seg, sym))
    with timer.phase("syndrome locate"):
        S = loop.result(out)
        S = S.view(np.uint16) if sym == 2 else S
        return ctx.locate(S.astype(np.int64)), packed


def _survivor_reader(paths: list[str], indices: list[int], timer: PhaseTimer, *, op: str, scope: str = "read"):
    """(files, segment producer) for a locate loop over ``paths`` (chunk
    ``indices``): each segment is gathered into a fresh host buffer, which
    the caller corrects in place.  A resilience read boundary (``scope``
    ``scrub`` for the syndrome sweep): one fault-hook crossing per chunk and
    a transient retry under ``op``."""
    fps = [open(path, "rb") for path in paths]
    try:
        maps = [np.memmap(path, dtype=np.uint8, mode="r") for path in paths]
    except BaseException:
        for fp in fps:
            fp.close()
        raise

    def gather(off: int, cols: int) -> np.ndarray:
        def attempt() -> np.ndarray:
            _faults.on_reads(paths, indices, scope=scope)
            return native.gather_rows(fps, off, cols, fallback_maps=maps)

        with timer.phase("stage segment (io)"):
            return _retry.default_policy().call(attempt, op=op)

    return fps, gather


def _syndrome_sweep(in_file: str, scan: _ChunkScan, *, strategy: str = "auto", device=None,
                    segment_bytes: int = DEFAULT_SEGMENT_BYTES, timer: PhaseTimer | None = None):
    """Read-only syndrome check over an archive's present chunks; returns
    ``(verdict, located_chunks, symbol_errors, complete)``.  The verdict is
    ``clean``, ``silent_bitrot`` (with the rotten chunks attributed),
    ``unlocatable`` (damage beyond t somewhere: the sweep stops there, so
    ``complete`` is False and the located set is partial) or
    ``no_headroom`` (nothing checkable: erasures took the whole check, or
    the matrix is not systematic)."""
    from .gf_decode import UnlocatableError

    timer = timer or PhaseTimer(enabled=False)
    ctx = _locate_context(scan)
    if ctx is None or ctx.r == 0:
        return "no_headroom", set(), 0, True
    codec = RSCodec(scan.k, scan.p, w=scan.w, strategy=strategy, device=device)
    sym = scan.w // 8
    seg_cols = _segment_cols(scan.chunk, scan.k, segment_bytes)
    loop = StreamLoop(codec.device, len(ctx.survivors), seg_cols, 1)
    fps, gather = _survivor_reader([chunk_file_name(in_file, i) for i in ctx.survivors], ctx.survivors, timer,
                                   op="syndrome_stage", scope="scrub")
    located: set[int] = set()
    errors = 0
    try:
        with SegmentPrefetcher(_segment_spans(scan.chunk, seg_cols), gather, depth=2) as prefetch:
            for _tag, seg in prefetch:
                try:
                    fixes, _ = _locate_segment_fixes(ctx, codec, loop, seg, sym, timer)
                except UnlocatableError:
                    return "unlocatable", located, errors, False
                for col_fixes in fixes.values():
                    located.update(chunk_idx for chunk_idx, _mag in col_fixes)
                    errors += len(col_fixes)
    finally:
        for fp in fps:
            fp.close()
    return ("silent_bitrot" if located else "clean"), located, errors, True


@_observed_file_op("locate_decode")
def locate_decode_file(
    in_file: str,
    output: str | None = None,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    conf_out: str | None = None,
    timer: PhaseTimer | None = None,
    _scan: _ChunkScan | None = None,
) -> str:
    """Rebuild ``in_file`` with error-locating decode (CLI ``-d
    --locate``): no conf and no CRC needed.  Silent bitrot in up to t =
    floor((p - missing) / 2) chunks of a symbol column is found from the
    parity-check syndromes, attributed and corrected before the recovery
    GEMM runs.  Every present full-size chunk is read; missing or
    truncated ones are erasures (2 * errors + erasures <= p per column).
    Raises :class:`.gf_decode.UnlocatableError` when a column's damage
    exceeds the bound, and writes nothing then.  ``device``: None means
    CUDA and raises with no GPU present.
    """
    from .gf_decode import correct_segment, is_systematic

    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    if _scan is not None:
        scan = _scan  # auto_decode_file's fresh scan
    else:
        with timer.phase("scan chunks (io)"):
            scan = _scan_chunks(in_file, segment_bytes)
    if scan.total_size == 0:
        _select_decodable_subset(scan)
        return _write_empty_atomic(output or in_file)
    ctx = _locate_context(scan)
    if ctx is None:
        if not is_systematic(scan.total_mat, scan.k):
            raise ValueError(
                f"{in_file!r}: error-locating decode needs a systematic total matrix; this archive's metadata is "
                "foreign — use the erasure decoder (-d --auto)"
            )
        raise ValueError(
            f"only {len(scan.healthy)} healthy chunks of the k={scan.k} needed (corrupt: {sorted(scan.bad)}, "
            f"missing: {scan.missing}) — past erasure recovery, locate cannot help"
        )
    k, w = scan.k, scan.w
    sym = w // 8
    chunk = scan.chunk
    seg_cols = _segment_cols(chunk, k, segment_bytes)
    codec = RSCodec(k, scan.p, w=w, strategy=strategy, device=device)
    gf = get_field(w)

    # The recovery GEMM serves natives lost to erasure; located errors are
    # patched in place, so present natives pass straight through.  With no
    # native missing, the natives themselves are the survivor set.
    missing = [i for i in range(k) if i not in set(ctx.survivors)]
    if missing:
        with timer.phase("invert matrix"):
            chosen, inv = _select_decodable_subset(scan)
        dec_missing = np.asarray(inv).astype(gf.dtype)[missing]
    else:
        chosen, dec_missing = list(range(k)), None
    row_of = {c: i for i, c in enumerate(ctx.survivors)}
    chosen_rows = [row_of[c] for c in chosen]
    rec_row = {i: j for j, i in enumerate(missing)}
    if conf_out:
        write_conf(conf_out, [os.path.basename(chunk_file_name(in_file, i)) for i in chosen])

    out_path = output or in_file
    tmp_path = out_path + ".rs_tmp"
    check_loop = StreamLoop(codec.device, len(ctx.survivors), seg_cols, 1)
    rec_loop = StreamLoop(codec.device, k, seg_cols, 1) if dec_missing is not None else None
    fps, gather = _survivor_reader([chunk_file_name(in_file, i) for i in ctx.survivors], ctx.survivors, timer,
                                   op="locate_stage")
    try:
        out_fp = open(tmp_path, "wb")
    except BaseException:
        for fp in fps:
            fp.close()
        raise

    def write_row(i: int, off: int, cols: int, row_bytes) -> None:
        lo = i * chunk + off
        if lo >= scan.total_size:
            return
        hi = min(lo + cols, scan.total_size)
        out_fp.seek(lo)
        out_fp.write(np.ascontiguousarray(row_bytes[: hi - lo]))

    try:
        # One segment at a time (the prefetch overlaps the reads): the host
        # locate between the syndrome GEMM and the recovery GEMM is a
        # barrier.  A robustness path; the write-behind lane stays with
        # decode_file.
        with SegmentPrefetcher(_segment_spans(chunk, seg_cols), gather, depth=max(1, pipeline_depth)) as prefetch:
            for (off, cols), seg in prefetch:
                # Under xor and ring the syndrome GEMM packs the whole
                # survivor stack; the recovery GEMM reads a subset of the
                # same rows, so it selects their planes from that pack
                # instead of staging and packing them again.
                fixes, packed = _locate_segment_fixes(ctx, codec, check_loop, seg, sym, timer,
                                                      want_packed=dec_missing is not None)
                if fixes:
                    correct_segment(seg.view(np.uint16) if sym == 2 else seg, fixes, row_of)
                    # The planes predate the patch: the recovery GEMM
                    # re-stages the corrected bytes.
                    packed = None
                rec = None
                if dec_missing is not None:
                    with timer.phase("locate dispatch"):
                        if packed is not None:
                            # The planes are on check_loop's compute stream.
                            loop, chosen = check_loop, packed.select(chosen_rows)
                            out = loop.dispatch_resident(lambda: codec.decode(dec_missing, chosen))
                        else:
                            loop = rec_loop
                            out = loop.dispatch(lambda d: codec.decode(dec_missing, d),
                                                loop.stage_copy(seg, sym, chosen_rows))
                    with timer.phase("decode compute"):
                        rec = loop.result(out)
                with timer.phase("write output (io)"):
                    rows_out = [seg[row_of[i]] if i in row_of else rec[rec_row[i]] for i in range(k)]
                    if scan.layout == "interleaved":
                        native.deinterleave_write(out_fp, rows_out, sym, off, scan.total_size)
                    else:
                        for i, row_bytes in enumerate(rows_out):
                            write_row(i, off, cols, row_bytes)
        out_fp.truncate(scan.total_size)
        out_fp.close()
        os.replace(tmp_path, out_path)
    except BaseException:
        if not out_fp.closed:
            out_fp.close()
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise
    finally:
        for fp in fps:
            fp.close()
    return out_path


# -- repair ------------------------------------------------------------------------


@_observed_file_op("repair")
def repair_file(
    in_file: str,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    mesh=None,
    stripe_sharded: bool = False,
    timer: PhaseTimer | None = None,
) -> list[int]:
    """Regenerate every lost or damaged chunk of an archive, in place.

    Any chunk row t is a GF-linear function of a decodable survivor set:
    ``row_t = T[t] . inv(T[chosen])``, so all targets, natives and parity
    alike, rebuild in one streamed GEMM over the chosen survivors.  Each
    rebuilt chunk is written to a ``.rs_tmp`` name and renamed only when
    all of it landed; the CRC lines are refreshed when .METADATA has them.
    Returns the indices rebuilt ([] for a healthy archive).  Raises
    ValueError when fewer than k healthy chunks remain.  ``device``: None
    means CUDA and raises with no GPU present.  The ``mesh`` and
    ``stripe_sharded`` forms are not ported yet and raise
    NotImplementedError.
    """
    if mesh is not None or stripe_sharded:
        raise NotImplementedError("repair_file over a device mesh (mesh=, stripe_sharded=) is not ported yet")
    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    with timer.phase("scan chunks (io)"):
        scan = _scan_chunks(in_file, segment_bytes)
    targets = scan.unhealthy
    if not targets:
        return []
    if scan.chunk == 0:
        # Zero-size archive: every chunk is the empty file.  Still held to
        # the >= k healthy rule, as scan_file's decodable verdict is.
        _repair_select_or_fail(scan)
        for t in targets:
            _write_empty_atomic(chunk_file_name(in_file, t))
        if scan.crcs:
            rewrite_checksums(metadata_file_name(in_file), {**scan.crcs, **{t: 0 for t in targets}})  # crc32(b"") == 0
        return _record_repair(targets, scan)
    with timer.phase("invert matrix"):
        chosen, inv = _repair_select_or_fail(scan)
    return _record_repair(_repair_streamed(in_file, scan, chosen, inv, strategy=strategy, device=device,
                                           segment_bytes=segment_bytes, pipeline_depth=pipeline_depth, timer=timer),
                          scan)


def _record_repair(rebuilt: list[int], scan: _ChunkScan) -> list[int]:
    """The health plane's "repair" event for a non-empty rebuild (it
    clears the rebuilt chunks from the archive's damage map); identity on
    ``rebuilt``."""
    if rebuilt:
        _obs_health.record_damage("repair", scan.in_file, chunks=rebuilt, k=scan.k, p=scan.p, w=scan.w,
                                  generation=scan.generation)
    return rebuilt


def _repair_select_or_fail(scan: _ChunkScan):
    """:func:`_select_decodable_subset` for a single-archive repair, with
    the health plane's "repair_failed" event recorded before the failure
    propagates."""
    try:
        return _select_decodable_subset(scan)
    except ValueError as e:
        _obs_health.record_damage("repair_failed", scan.in_file, k=scan.k, p=scan.p, w=scan.w,
                                  generation=scan.generation,
                                  verdict="undecided" if isinstance(e, UndecidedSubsetError) else "unrecoverable")
        raise


def _repair_streamed(in_file: str, scan: _ChunkScan, chosen: list[int], inv, *, strategy: str, device,
                     segment_bytes: int, pipeline_depth: int, timer: PhaseTimer,
                     fleet: FleetPipeline | None = None) -> list[int]:
    """The streamed rebuild of :func:`repair_file`, given a scan and a
    chosen survivor subset with its inverse.  With ``fleet`` the archive's
    promote and CRC commit queue on the fleet's lane behind its writes,
    while the caller streams the next archive."""
    targets = scan.unhealthy
    with timer.phase("rebuild matrix"):
        gf = get_field(scan.w)
        mat = scan.total_mat.astype(gf.dtype)
        rebuild_mat = gf.matmul(mat[targets], np.asarray(inv).astype(gf.dtype))  # (targets, k)
    codec = RSCodec(scan.k, scan.p, w=scan.w, strategy=strategy, device=device)
    sym = scan.w // 8
    chunk = scan.chunk
    seg_cols = _segment_cols(chunk, scan.k, segment_bytes)
    depth = max(1, pipeline_depth)
    loop = StreamLoop(codec.device, scan.k, seg_cols, depth)
    surv_paths = [chunk_file_name(in_file, i) for i in chosen]
    surv_fps = [open(path, "rb") for path in surv_paths]
    surv_maps = [np.memmap(path, dtype=np.uint8, mode="r") for path in surv_paths]
    # A failed repair must not destroy a damaged-but-present chunk: rebuild
    # into temps, rename when every segment landed.
    tmp_paths = {t: chunk_file_name(in_file, t) + ".rs_tmp" for t in targets}
    out_fps = {t: open(tmp_paths[t], "wb") for t in targets}
    new_crcs: dict[int, int] = {}

    def drain(tag, out) -> None:
        off, _cols = tag
        with timer.phase("repair compute"):
            reb = loop.result(out)
        delta = {t: crc32_of(reb[j], new_crcs.get(t, 0)) for j, t in enumerate(targets)} if scan.crcs else None
        with timer.phase("write chunks (io)"):
            native.scatter_write([out_fps[t] for t in targets], reb, off)
        if delta is not None:
            new_crcs.update(delta)  # only after the write landed

    def gather(off: int, cols: int):
        # On the prefetch thread: survivor reads overlap the chunk writes.
        # The decode stage's read boundary: fault hook + transient retry.
        with timer.phase("stage segment (io)"):
            slot, dst = loop.host_segment(cols)

            def attempt():
                _faults.on_reads(surv_paths, chosen)
                return native.gather_rows(surv_fps, off, cols, fallback_maps=surv_maps, dst=dst)

            return slot, _retry.default_policy().call(attempt, op="repair_stage")

    def finalize() -> None:
        for t in targets:
            out_fps[t].close()
        for fp in surv_fps:
            fp.close()
        for t in targets:
            os.replace(tmp_paths[t], chunk_file_name(in_file, t))
        if scan.crcs:
            with timer.phase("write metadata (io)"):
                rewrite_checksums(metadata_file_name(in_file), {**scan.crcs, **new_crcs})

    def cleanup() -> None:
        for fp in surv_fps:
            if not fp.closed:
                fp.close()
        for t, fp in out_fps.items():
            if not fp.closed:
                fp.close()
            if os.path.exists(tmp_paths[t]):
                os.unlink(tmp_paths[t])

    key = fleet.register(cleanup) if fleet is not None else None
    try:
        with _drain_ctx(fleet) as dex:
            with SegmentPrefetcher(_segment_spans(chunk, seg_cols), gather, depth=depth) as prefetch, AsyncWindow(
                depth, drain, executor=dex
            ) as window:
                for tag, staged in _staging(prefetch, loop, sym, depth, timer):
                    with timer.phase("repair dispatch"):
                        out = loop.dispatch(lambda seg: codec.decode(rebuild_mat, seg), staged)
                    window.push(tag, out)
        if fleet is not None:
            fleet.commit(key, finalize)
        else:
            finalize()
    except BaseException:
        if fleet is None:
            cleanup()
        raise
    return targets


@_observed_file_op("repair_fleet")
def repair_fleet(
    files,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    pipeline_depth: int = 2,
    timer: PhaseTimer | None = None,
) -> dict[str, list[int]]:
    """Scan and repair many archives in one pass.

    Every archive is scanned and its survivor inverse solved before any
    rebuild is written: when one is unscannable or unrecoverable, raises
    ValueError naming each such archive and repairs nothing.  The damaged
    archives are grouped by (k, w); the subset cache is consulted first,
    and each group's first-choice survivor submatrices (in
    :func:`.ops.inverse.mds_nopivot_order`) are inverted in one batched
    call on the device without pivoting.  Each inverse is verified on the
    host with one GF product against the identity; a failure is re-solved
    by the host subset search.  The rebuilds then interleave through one
    shared write-behind lane.  Returns ``{file: [rebuilt indices]}``.
    ``device``: None means CUDA and raises with no GPU present.
    """
    from .ops import inverse

    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    files = list(files)
    errors: dict[str, str] = {}
    with timer.phase("scan chunks (io)"):
        scans: dict[str, _ChunkScan] = {}
        for f in files:
            try:
                scans[f] = _scan_chunks(f, segment_bytes)
            except Exception as e:  # noqa: BLE001 - every archive's error is reported together below
                errors[f] = f"{type(e).__name__}: {e}"
    # First-choice subsets grouped by (k, w): healthy is in index order, so
    # healthy[:k] is the natives-first candidate the search tries first.
    chosen_inv: dict[str, tuple[list[int], np.ndarray]] = {}
    groups: dict[tuple[int, int], list[str]] = {}
    for f, s in scans.items():
        if not s.unhealthy:
            continue
        if s.chunk == 0:
            # Zero-size archives skip the inversion, not the validation.
            try:
                _select_decodable_subset(s)
            except ValueError as e:
                errors[f] = str(e)
            continue
        if len(s.healthy) < s.k:
            errors[f] = f"only {len(s.healthy)} healthy chunks of the k={s.k} needed (corrupt: {sorted(s.bad)}, " \
                        f"missing: {s.missing})"
            continue
        hit = _cached_subset(s)
        if hit is not None:
            chosen_inv[f] = hit
            continue
        groups.setdefault((s.k, s.w), []).append(f)
    with timer.phase("invert matrices (batched)"):
        for (k, w), group in groups.items():
            gf = get_field(w)
            ordered = {f: inverse.mds_nopivot_order(scans[f].healthy[:k], k) for f in group}
            subs = [scans[f].total_mat[ordered[f]].astype(gf.dtype) for f in group]
            invs, oks = inverse.invert_matrix_torch_batch(np.stack(subs), w, pivot=False, device=device)
            invs = invs.cpu().numpy().astype(gf.dtype)
            oks = oks.cpu().numpy()
            eye = np.eye(k, dtype=gf.dtype)
            for j, f in enumerate(group):
                if bool(oks[j]) and np.array_equal(gf.matmul(subs[j], invs[j]), eye):
                    chosen_inv[f] = (ordered[f], invs[j])
                    _remember_subset(scans[f], ordered[f], invs[j])
                    continue
                # A zero pivot (or a wrong inverse, never written): the host
                # search tries the other subsets.
                try:
                    chosen_inv[f] = _select_decodable_subset(scans[f])
                except ValueError as e:
                    errors[f] = str(e)
    if errors:
        for f in sorted(errors):
            # An unscannable archive has no shape to record (the JAX
            # package's scans[f] raises KeyError there instead).
            s = scans.get(f)
            _obs_health.record_damage("repair_failed", f, k=s and s.k, p=s and s.p, w=s and s.w,
                                      generation=s and s.generation, verdict="unrecoverable")
        raise ValueError("unrecoverable archives (nothing repaired): "
                         + "; ".join(f"{f}: {msg}" for f, msg in sorted(errors.items())))
    results: dict[str, list[int]] = {}
    with _fleet_lane() as pipe:
        for f in files:
            s = scans[f]
            if not s.unhealthy:
                results[f] = []
            elif s.chunk == 0:
                results[f] = repair_file(f, strategy=strategy, device=device, segment_bytes=segment_bytes,
                                         pipeline_depth=pipeline_depth, timer=timer)
            else:
                chosen, inv = chosen_inv[f]
                results[f] = _record_repair(_repair_streamed(f, s, chosen, inv, strategy=strategy, device=device,
                                                             segment_bytes=segment_bytes,
                                                             pipeline_depth=pipeline_depth, timer=timer, fleet=pipe),
                                            s)
    return results


# -- in-place update and append (update/) -------------------------------------------
#
# RS is linear: parity' = parity ^ E.delta, so an edit moves only its touched
# column windows, and an append to an interleaved archive only the tail
# column block.  Both are crash-atomic: an undo journal before any in-place
# byte, then one generation-bumping .METADATA rewrite as the commit point,
# rolled back on failure or at the next open (recover_archive).


@_observed_file_op("update")
def update_file(file_name: str, at: int, data=None, *, src: str | None = None, strategy: str = "auto", device=None,
                segment_bytes: int = DEFAULT_SEGMENT_BYTES, timer: PhaseTimer | None = None) -> dict:
    """Overwrite bytes [at, at+len) of the archived file in place (``rs
    update ARCHIVE --at OFF --in DELTA``).

    Only the touched columns are read and rewritten: Δ = new ^ old per
    touched native column, ``E·Δ`` through K1 on the compute stream (on
    CUDA), the parity XOR-patched through an ordered pwrite lane, the CRC
    lines fixed by seekable CRC arithmetic, and the metadata committed
    atomically with a generation bump.  The new bytes come as ``data`` or
    a file path ``src``.  Works on both chunk layouts; the touched chunks
    must be healthy.  ``device``: None means CUDA and raises with no GPU
    present.  Returns the op summary (bytes, segments, chunks_touched,
    generation, ...)."""
    from .update import apply_update

    out = apply_update(file_name, at, data, src=src, strategy=strategy, device=device,
                      segment_bytes=segment_bytes, timer=timer)
    # The generation moved past the last verified scrub: the health plane
    # holds the archive scrub-stale until it is scanned again.
    _obs_health.record_damage("update", file_name, generation=out.get("generation"))
    return out


@_observed_file_op("append")
def append_file(file_name: str, data=None, *, src: str | None = None, strategy: str = "auto", device=None,
                segment_bytes: int = DEFAULT_SEGMENT_BYTES, timer: PhaseTimer | None = None) -> dict:
    """Grow the archived file by the payload bytes (``rs append ARCHIVE
    --in DATA``).  An interleaved archive grows every chunk by just the
    tail column block; a row-layout archive takes appends within its
    tail-padding slack (a larger chunk would re-stripe the whole file).
    ``device``: None means CUDA and raises with no GPU present.  Returns
    the op summary with the new ``total_size``."""
    from .update import apply_append

    out = apply_append(file_name, data, src=src, strategy=strategy, device=device, segment_bytes=segment_bytes,
                      timer=timer)
    # The generation moved past the last verified scrub: the health plane
    # holds the archive scrub-stale until it is scanned again.
    _obs_health.record_damage("update", file_name, generation=out.get("generation"))
    return out


@_observed_file_op("update_many")
def update_file_many(file_name: str, edits, *, strategy: str = "auto", device=None,
                     segment_bytes: int = DEFAULT_SEGMENT_BYTES, timer: PhaseTimer | None = None,
                     group_edits: int | None = None, group_tag: str | None = None, stage_hook=None) -> dict:
    """Apply an ORDERED batch of edits/appends to one archive under group
    commit (``rs update ARCHIVE --edits FILE``).

    ``edits``: dicts ``{"op": "update", "at": OFF, "data": bytes | "src":
    path}`` or ``{"op": "append", "data"/"src": ...}``.  Byte-identical to
    applying them one :func:`update_file` / :func:`append_file` at a time
    (later edits win overlapping bytes), but each window group of up to
    ``RS_UPDATE_GROUP_WINDOW`` edits (``group_edits`` overrides it) runs its
    adjacent column blocks as ONE stacked ``E·Δ`` GEMM and commits under
    ONE journal fsync chain, ONE .METADATA rewrite and ONE generation bump,
    all or nothing.  ``group_tag`` names the group in the summary
    (``group_id``); ``stage_hook("device_done")`` fires when every ``E·Δ``
    is back on the host.  ``device``: None means CUDA and raises with no
    GPU present.  Returns the aggregate summary."""
    from .update import apply_update_many

    out = apply_update_many(file_name, edits, strategy=strategy, device=device, segment_bytes=segment_bytes,
                           timer=timer, group_edits=group_edits, group_tag=group_tag, stage_hook=stage_hook)
    # The generation moved past the last verified scrub: the health plane
    # holds the archive scrub-stale until it is scanned again.
    _obs_health.record_damage("update", file_name, generation=out.get("generation"))
    return out


def recover_archive(file_name: str) -> str:
    """Resolve a pending update/append journal next to ``file_name`` (every
    update and append runs it first; ``rs update --recover`` runs it
    alone).  Returns ``none``, ``stale_discarded``, ``invalid_discarded``
    or ``rolled_back``."""
    from .update import recover

    return recover(file_name)


# -- the object store (store/) ---------------------------------------------------
#
# Many small objects share erasure-coded stripe archives instead of paying
# per-object metadata, chunks and journals (docs/STORE.md): a durable object
# index maps key -> (archive, byte range, CRC32), committed crash-atomically
# alongside the archive metadata it references.  PUT rides the group-commit
# append lane, GET decodes only the object's touched column windows, DELETE
# tombstones and zeroes through the delta-parity lane, and compaction
# retires dead-heavy archives all-or-nothing.  ``device``: where the
# bucket's GEMMs run; None means CUDA (K1) and raises with no GPU present.


@_observed_file_op("object_put")
def put_object(root: str, bucket: str, key: str, data=None, *, src: str | None = None, create: bool = True,
               k: int | None = None, p: int | None = None, w: int | None = None, stripe_bytes: int | None = None,
               device=None) -> dict:
    """Store one object under ``key`` in ``bucket`` (``rs object put``).

    The payload comes as ``data`` bytes or a ``src`` file path.  The bucket
    is created on first use (``create=False`` refuses instead); the shape
    knobs apply only at creation, an existing bucket's manifest wins.
    Returns the location dict (``arc``, ``at``, ``len``, ``crc``, ``gen``).
    For PUT bursts, :func:`put_objects` commits the whole batch under ONE
    group-committed stripe append and ONE index fsync."""
    if (data is None) == (src is None):
        raise ValueError("pass exactly one of data= or src=")
    if src is not None:
        with open(src, "rb") as fp:
            data = fp.read()
    return put_objects(root, bucket, [(key, data)], create=create, k=k, p=p, w=w, stripe_bytes=stripe_bytes,
                       device=device)[0]


def put_objects(root: str, bucket: str, items, *, create: bool = True, k: int | None = None, p: int | None = None,
                w: int | None = None, stripe_bytes: int | None = None, device=None) -> list[dict]:
    """Batch PUT: an ordered list of ``(key, bytes)`` committed as one group
    (one journal fsync chain, one metadata rewrite, one index fsync), all
    or nothing; later duplicates win."""
    from . import store as _store

    b = _store.open_bucket(root, bucket, create=create, k=k, p=p, w=w, stripe_bytes=stripe_bytes, device=device)
    return b.put_many(items)


@_observed_file_op("object_get")
def get_object(root: str, bucket: str, key: str, *, device=None) -> bytes:
    """Read one object's bytes (``rs object get``).  Reconstructs ONLY the
    object's byte range (touched column windows; a degraded decode when a
    native chunk is damaged), verified against the object's own CRC32 from
    the index, never silently wrong."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).get(key)


@_observed_file_op("object_delete")
def delete_object(root: str, bucket: str, key: str, *, device=None) -> dict:
    """Delete one object (``rs object rm``): durable tombstone first (the
    commit point), then the dead range is zeroed through the delta-parity
    patch lane; space returns at the next compaction."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).delete(key)


def list_objects(root: str, bucket: str, *, prefix: str = "", device=None) -> list[dict]:
    """Live objects in the bucket (tombstoned keys excluded), sorted by key
    (``rs object ls``).  ``prefix`` narrows to keys starting with it; for
    bounded pages over a huge bucket use :func:`list_objects_page`."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).list_objects(prefix=prefix)


def list_objects_page(root: str, bucket: str, *, prefix: str = "", limit: int = 0, cursor: str | None = None,
                      device=None) -> dict:
    """One bounded page of live objects (``rs object ls --limit``):
    ``{"objects", "truncated", "next"}`` where ``next`` is the opaque cursor
    resuming after the page's last key (None on the final page); ``limit
    <= 0`` means no bound."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).list_page(prefix=prefix, limit=limit, cursor=cursor)


def stat_object(root: str, bucket: str, key: str, *, device=None) -> dict:
    """One object's index entry (archive, range, CRC, generation pin), ``rs
    object stat``."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).stat(key)


@_observed_file_op("object_compact")
def compact_bucket(root: str, bucket: str, *, force: bool = False, device=None) -> dict:
    """Rewrite live objects out of dead-heavy sealed archives and retire
    them all-or-nothing (``rs object compact``; ``RS_STORE_COMPACT_DEAD_FRAC``
    sets the trigger, ``force=True`` compacts any sealed archive with dead
    bytes)."""
    from . import store as _store

    return _store.open_bucket(root, bucket, device=device).compact(force=force)
