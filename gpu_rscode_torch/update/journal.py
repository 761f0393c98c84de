"""Undo journal — crash atomicity for in-place archive mutation.

Update and append patch chunk files IN PLACE, the one thing the rest of
the stack never does (every other writer goes through ``.rs_tmp`` +
atomic rename).  The journal restores that safety: before any byte of
the archive is overwritten or extended, the OLD bytes of every region
about to change — plus each chunk file's pre-op length — are appended
to ``<archive>.rs_journal`` and fsynced.  The atomic .METADATA rewrite
(generation bump, :func:`..utils.fileformat.rewrite_metadata_lines`) is
the commit point; a successful commit unlinks the journal.

Recovery (:func:`recover`, run at the top of every update/append and on
demand via ``rs update --recover``):

* no journal → nothing pending;
* journal generation != the live metadata generation → the commit
  landed (or a later op superseded it): the journal is stale, discard;
* otherwise the op tore mid-patch: restore every journaled region,
  truncate each chunk back to its pre-op length (rolls back a torn
  APPEND's tail), fsync, discard — the archive is byte-identical to its
  pre-op state.

A torn JOURNAL (crash while writing it) is equally safe: regions are
length-prefixed and applied only when complete, and the engine never
patches a region before its journal record is on disk — an incomplete
tail record means its region was never touched.

On-disk format: line 1 is a JSON header
``{"kind": "rs_update_journal", "generation": G, "op": ..., "chunk_len":
{index: pre_bytes}}``; then per-region records — a 4-byte big-endian
length, a JSON record ``{"chunk": i, "off": o, "len": n}``, and ``n``
raw old bytes.
"""

from __future__ import annotations

import json
import os
import struct

from ..obs import metrics as _metrics
from ..utils.fileformat import (
    chunk_file_name,
    fsync_dir,
    journal_path,
    metadata_file_name,
    read_archive_meta,
)


class Journal:
    """Writer side: opened by the engine before the first patch."""

    def __init__(self, file_name: str, generation: int, op: str,
                 chunk_len: dict[int, int]):
        self.file_name = file_name
        self.path = journal_path(file_name)
        self.chunk_len = dict(chunk_len)
        self._fp = open(self.path, "wb")
        header = {
            "kind": "rs_update_journal",
            "generation": int(generation),
            "op": op,
            "chunk_len": {str(i): int(n) for i, n in chunk_len.items()},
        }
        self._fp.write((json.dumps(header) + "\n").encode())
        # The journal's DIRENT must be durable before any chunk byte
        # changes: a crash that persisted patches but lost the journal's
        # creation would be unrecoverable.  (Record contents sync per
        # block via sync(); this covers the name itself.)
        fsync_dir(self.path)
        self._dirty = True

    def record(self, chunk: int, off: int, old: bytes) -> None:
        """Queue one region's undo bytes (regions wholly past the chunk's
        pre-op length need no record — truncation undoes them)."""
        if not old:
            return
        rec = json.dumps(
            {"chunk": int(chunk), "off": int(off), "len": len(old)}
        ).encode()
        self._fp.write(struct.pack(">I", len(rec)))
        self._fp.write(rec)
        self._fp.write(old)
        self._dirty = True

    def sync(self) -> bool:
        """Barrier: every queued record is durable before the engine may
        patch the regions it covers.  Returns True when an fsync was
        actually issued (the group-commit fsync accounting reads this)."""
        if self._dirty:
            self._fp.flush()
            os.fsync(self._fp.fileno())
            self._dirty = False
            return True
        return False

    def close(self, *, commit: bool) -> None:
        """``commit=True`` (metadata rename landed) discards the journal;
        ``commit=False`` leaves it for :func:`recover` (a crash path that
        could not roll back in-process)."""
        if not self._fp.closed:
            self._fp.close()
        if commit and os.path.exists(self.path):
            os.unlink(self.path)


def _read_records(path: str):
    """(header, [(chunk, off, old_bytes)]) — complete records only; a
    torn tail record is dropped (its region was never patched)."""
    with open(path, "rb") as fp:
        head_line = fp.readline()
        try:
            header = json.loads(head_line)
        except ValueError:
            return None, []
        if header.get("kind") != "rs_update_journal":
            return None, []
        records = []
        while True:
            raw = fp.read(4)
            if len(raw) < 4:
                break
            (n,) = struct.unpack(">I", raw)
            rec_raw = fp.read(n)
            if len(rec_raw) < n:
                break
            try:
                rec = json.loads(rec_raw)
            except ValueError:
                break
            old = fp.read(rec["len"])
            if len(old) < rec["len"]:
                break
            records.append((int(rec["chunk"]), int(rec["off"]), old))
        return header, records


def recover(file_name: str) -> str:
    """Resolve any pending journal next to ``file_name``; returns one of
    ``none`` / ``stale_discarded`` / ``invalid_discarded`` /
    ``rolled_back``."""
    path = journal_path(file_name)
    if not os.path.exists(path):
        return "none"
    header, records = _read_records(path)
    if header is None:
        os.unlink(path)
        return "invalid_discarded"
    meta_gen = read_archive_meta(metadata_file_name(file_name)).generation
    if int(header.get("generation", -1)) != meta_gen:
        # The op committed (metadata generation moved past the journal's
        # pre-op value) — the journal is a leftover, not a torn write.
        os.unlink(path)
        verdict = "stale_discarded"
    else:
        rollback(file_name, header, records)
        os.unlink(path)
        verdict = "rolled_back"
    _metrics.counter(
        "rs_update_recoveries_total",
        "pending update/append journals resolved at open",
    ).labels(verdict=verdict).inc()
    return verdict


def rollback(file_name: str, header: dict, records) -> None:
    """Apply undo records + pre-op truncation (shared by on-disk recovery
    and the engine's in-process failure path)."""
    by_chunk: dict[int, list] = {}
    for chunk, off, old in records:
        by_chunk.setdefault(chunk, []).append((off, old))
    pre_len = {int(i): int(n) for i, n in header.get("chunk_len", {}).items()}
    for idx in sorted(set(by_chunk) | set(pre_len)):
        path = chunk_file_name(file_name, idx)
        if not os.path.exists(path):
            continue  # damaged independently of the torn op: best effort
        with open(path, "r+b") as fp:
            for off, old in by_chunk.get(idx, ()):
                os.pwrite(fp.fileno(), old, off)
            if idx in pre_len:
                fp.truncate(pre_len[idx])
            fp.flush()
            os.fsync(fp.fileno())
