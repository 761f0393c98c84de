"""File-level encode/decode: the counterpart of the JAX package's
``api.encode_file`` and ``api.decode_file`` (row layout, one device).

* The file is striped into k contiguous ranges (``chunk_size =
  ceil(total/k)``) and streamed in column segments of about
  ``segment_bytes`` of natives, so any file size runs in bounded memory.
  Each segment goes gather -> host-to-device copy -> GF-GEMM -> device-to-
  host copy -> write, one after the other.
* Tail padding is explicit zeros, so parity is deterministic.
* Natives are written straight from the source file; only parity is
  computed on the device.
* Every output is written under a ``.rs_tmp`` name and promoted only when
  all of it has landed (.METADATA last), so a failed encode leaves no
  partial archive.
* Decode trusts the .METADATA matrix, inverts the survivor submatrix on the
  host and runs the GEMM only for the missing natives.
* w=16 chunks hold little-endian uint16 symbols (``# gfwidth 16``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .codec import RSCodec
from .models.vandermonde import total_matrix
from .ops.gf import get_field
from .utils.backend import resolve_device
from .utils.fileformat import (
    append_checksums,
    chunk_crc32,
    chunk_file_name,
    chunk_size_for,
    crc32_of,
    metadata_file_name,
    parse_chunk_index,
    read_archive_meta,
    read_conf,
    write_metadata,
)
from .utils.timing import PhaseTimer

# Natives per segment: bounds the host and device working set per dispatch.
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024


class ChunkIntegrityError(ValueError):
    """A surviving chunk's bytes are unusable: CRC mismatch or truncated.
    ``bad_chunks`` maps chunk index -> file path."""

    def __init__(self, bad_chunks: dict[int, str], reason: str = "chunk checksum mismatch (corrupt survivors)"):
        self.bad_chunks = dict(bad_chunks)
        names = ", ".join(f"{i}:{p}" for i, p in sorted(bad_chunks.items()))
        super().__init__(f"{reason}: {names}; pick different survivors in the conf file")


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


def _to_device(seg: np.ndarray, sym: int, device: torch.device) -> torch.Tensor:
    """(rows, cols) host bytes -> (rows, cols/sym) symbols on ``device``."""
    t = torch.from_numpy(seg).to(device)
    return t.view(torch.uint16) if sym == 2 else t


def _to_host(t: torch.Tensor) -> np.ndarray:
    """(rows, m) symbols on any device -> (rows, m*itemsize) host bytes."""
    if t.dtype == torch.uint16:
        t = t.view(torch.uint8)
    return t.cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_gemm(codec: RSCodec, op: str, A, seg: np.ndarray, sym: int, timer: PhaseTimer) -> np.ndarray:
    """One segment through the device: H2D, GEMM, D2H (each timed)."""
    with timer.phase("h2d (transfer)"):
        data = _to_device(seg, sym, codec.device)
        _sync(codec.device)
    with timer.phase(f"{op} compute"):
        out = codec.decode(A, data) if op == "decode" else codec.encode(data)
        _sync(codec.device)
    with timer.phase("d2h (transfer)"):
        return _to_host(out)


def _write_native_chunks(src, file_name, tmps, k, chunk, total_size, copy_step, crcs, timer) -> None:
    """The k native chunk temp files: straight copies of the k file ranges,
    tail zero-padded, in bounded slices, with optional CRC32."""
    for i in range(k):
        with timer.phase("write natives (io)"):
            lo, hi = i * chunk, min((i + 1) * chunk, total_size)
            crc = 0
            with open(tmps[chunk_file_name(file_name, i)], "wb") as fp:
                for s in range(lo, hi, copy_step):
                    buf = src[s : min(s + copy_step, hi)].tobytes()
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


def encode_file(
    file_name: str,
    native_num: int,
    parity_num: int,
    *,
    generator: str = "vandermonde",
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    checksums: bool = False,
    w: int = 8,
    timer: PhaseTimer | None = None,
) -> list[str]:
    """Encode ``file_name`` into n = k + p chunk files plus .METADATA and
    return the paths written.

    ``device``: None runs on CUDA (and raises with no GPU present);
    ``"cpu"`` runs the plain PyTorch path.  ``checksums=True`` appends
    per-chunk CRC32 lines to .METADATA.  ``w``: symbol width, 8 or 16.
    """
    timer = timer or PhaseTimer(enabled=False)
    if w not in (8, 16):
        raise ValueError(f"file-layer symbol width must be 8 or 16, got {w}")
    sym = w // 8
    k, p = native_num, parity_num
    codec = RSCodec(k, p, w=w, generator=generator, strategy=strategy, device=device)
    total_size = os.path.getsize(file_name)
    if total_size == 0:
        raise ValueError(f"refusing to encode empty file {file_name!r}")
    chunk = chunk_size_for(total_size, k, sym)
    seg_cols = _segment_cols(chunk, k, segment_bytes)
    src = np.memmap(file_name, dtype=np.uint8, mode="r")
    commit = _ArchiveCommit(file_name, k + p)
    crcs: dict[int, int] | None = {} if checksums else None

    def gather(off: int, cols: int) -> np.ndarray:
        seg = np.zeros((k, cols), dtype=np.uint8)
        for i in range(k):
            lo = i * chunk + off
            hi = min(lo + cols, (i + 1) * chunk, total_size)
            if lo < hi:
                seg[i, : hi - lo] = src[lo:hi]
        return seg

    parity_files: list = []
    try:
        _write_native_chunks(src, file_name, commit.tmps, k, chunk, total_size, max(1, segment_bytes), crcs, timer)
        for j in range(p):
            parity_files.append(open(commit.tmps[chunk_file_name(file_name, k + j)], "wb"))
        for off, cols in _segment_spans(chunk, seg_cols):
            with timer.phase("stage segment (io)"):
                seg = gather(off, cols)
            parity = _run_gemm(codec, "encode", None, seg, sym, timer)
            with timer.phase("write parity (io)"):
                for j, fp in enumerate(parity_files):
                    fp.seek(off)
                    fp.write(parity[j].tobytes())
                    if crcs is not None:
                        crcs[k + j] = crc32_of(parity[j], crcs.get(k + j, 0))
        for fp in parity_files:
            fp.close()
        with timer.phase("write metadata (io)"):
            write_metadata(commit.meta_tmp, total_size, p, k, codec.total_matrix, w=w)
            if crcs is not None:
                append_checksums(commit.meta_tmp, crcs)
        commit.promote()
    except BaseException:
        for fp in parity_files:
            fp.close()
        commit.discard()
        raise
    return commit.written


def _open_chunk(path: str, chunk: int, index: int) -> np.ndarray:
    """Read-only byte view of a chunk file, checked against the chunk size."""
    mm = np.zeros(0, dtype=np.uint8) if chunk == 0 else np.memmap(path, dtype=np.uint8, mode="r")
    if mm.shape[0] < chunk:
        raise ChunkIntegrityError({index: path}, reason=f"chunk truncated ({mm.shape[0]} of {chunk} bytes)")
    return mm


def decode_file(
    in_file: str,
    conf_file: str,
    output: str | None = None,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    verify_checksums: bool | None = None,
    timer: PhaseTimer | None = None,
) -> str:
    """Rebuild ``in_file`` from the k surviving chunks listed in
    ``conf_file`` and return the output path (``in_file`` by default).

    ``verify_checksums``: None verifies survivors against the CRC32 lines
    when .METADATA has them, True requires them, False skips.  A corrupt
    survivor raises :class:`ChunkIntegrityError` naming it.
    """
    timer = timer or PhaseTimer(enabled=False)
    device = resolve_device(device)
    meta_path = metadata_file_name(in_file)
    with timer.phase("read metadata (io)"):
        meta = read_archive_meta(meta_path)
    total_size, p, k = meta.total_size, meta.parity_num, meta.native_num
    total_mat, w, crcs = meta.total_mat, meta.w, meta.crcs
    _check_gfwidth(w, meta_path)
    if meta.layout != "row":
        raise ValueError(f"chunk layout {meta.layout!r} in {meta_path!r} is not supported by this port (row only)")
    if total_mat is None:
        # Sizes-only metadata: the canonical [I; Vandermonde] matrix.
        total_mat = total_matrix(p, k, get_field(w))
    if int(total_mat.max(initial=0)) >= (1 << w):
        raise ValueError(
            f"metadata matrix entry {int(total_mat.max())} out of range for GF(2^{w}) — corrupt or foreign .METADATA"
        )
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
        paths = [resolve(nm) for nm in names]
        maps = [_open_chunk(path, chunk, row) for path, row in zip(paths, rows)]

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
    tmp_path = out_path + ".rs_tmp"
    if total_size == 0:
        open(tmp_path, "wb").close()
        os.replace(tmp_path, out_path)
        return out_path

    codec = RSCodec(k, p, w=w, strategy=strategy, device=device)
    total_mat = total_mat.astype(codec.gf.dtype)
    with timer.phase("invert matrix"):
        dec_mat = codec.decode_matrix_from(total_mat, rows)
    # Partial recovery: with a systematic matrix, surviving natives are
    # already the answer; only the missing native rows go through the GEMM
    # (their rows of the inverse; the dropped rows are unit vectors).
    systematic = np.array_equal(total_mat[:k], np.eye(k, dtype=total_mat.dtype))
    native_pos = {r: idx for idx, r in enumerate(rows) if r < k} if systematic else {}
    missing = [i for i in range(k) if i not in native_pos]
    rec_row = {i: j for j, i in enumerate(missing)}
    dec_missing = dec_mat[missing] if missing else None
    seg_cols = _segment_cols(chunk, k, segment_bytes)

    out_fp = open(tmp_path, "wb")
    try:

        def write_row(i: int, off: int, cols: int, row_bytes) -> None:
            lo = i * chunk + off
            if lo >= total_size:
                return
            hi = min(lo + cols, total_size)
            out_fp.seek(lo)
            out_fp.write(np.asarray(row_bytes[: hi - lo]).tobytes())

        for off, cols in _segment_spans(chunk, seg_cols):
            rec = None
            if dec_missing is not None:
                with timer.phase("stage segment (io)"):
                    seg = np.empty((k, cols), dtype=np.uint8)
                    for idx, mm in enumerate(maps):
                        seg[idx] = mm[off : off + cols]
                rec = _run_gemm(codec, "decode", dec_missing, seg, sym, timer)
            with timer.phase("write output (io)"):
                for i in range(k):
                    if i in native_pos:
                        write_row(i, off, cols, maps[native_pos[i]][off : off + cols])
                    else:
                        write_row(i, off, cols, rec[rec_row[i]])
        out_fp.truncate(total_size)
        out_fp.close()
        os.replace(tmp_path, out_path)
    except BaseException:
        out_fp.close()
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise
    return out_path
