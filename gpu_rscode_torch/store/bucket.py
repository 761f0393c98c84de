"""Bucket — millions of small objects packed into shared stripe archives.

The one-archive-per-file model pays per-object metadata, k+p chunk
files, a journal and a generation for EVERY object — ruinous at a
million 4 KiB objects.  A bucket amortizes all of it (docs/STORE.md):

* objects append back-to-back into the current **open stripe**, an
  ordinary interleaved-layout archive (``rs append`` semantics: only
  the tail column block moves).  A PUT batch lands as ONE group-
  committed append (one journal fsync chain, one ``.METADATA``
  rewrite, one generation bump — update/group.py), so a burst of
  same-bucket PUTs costs one durability chain, not N;
* the **object index** (store/index.py) records each object's
  (archive, byte range, CRC32) pinned to the generation its commit
  produced — appended BEFORE the stripe commit point, so the archive's
  own crash-atomic metadata rename (or journal rollback) decides the
  entry's validity.  The index never references bytes a rolled-back
  group wrote;
* a stripe **seals** once it crosses ``RS_STORE_STRIPE_BYTES``; the
  next batch opens a fresh stripe;
* GET reconstructs just the object's byte range (store/readpath.py —
  touched column windows only, degraded decode included), verified
  against the object's own CRC;
* DELETE commits a tombstone (fsynced before anything else moves),
  then zeroes the dead range through the delta-parity patch lane —
  dead bytes stay zero so stripe-level scrub/repair semantics are
  unchanged and the space is accountable;
* **compaction** rewrites a dead-heavy sealed archive's live objects
  into the current stripe as one grouped batch, re-points their index
  records, appends a retire record and unlinks the old archive — a
  crash at ANY stage leaves either the old archive fully live or the
  new locations fully live, never half.

Thread-safe per bucket (one RLock); cross-process mutation of one
bucket is NOT supported.

Every GEMM a bucket runs (a fresh stripe's encode, a PUT batch's stacked
E·Δ, a DELETE's zeroing, a degraded GET's window recovery, compaction's
rewrites) runs on the bucket's device: :func:`open_bucket`'s ``device``,
None meaning CUDA (K1) and raising with no GPU present, ``"cpu"`` only
when asked.  A build or launch error raises; nothing retries on the CPU.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import re
import threading
import time
import zlib

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..utils.backend import resolve_device
from ..utils.env import float_env as _float_env, int_env as _int_env
from ..utils.fileformat import (
    chunk_file_name,
    fsync_dir,
    metadata_file_name,
    read_archive_meta,
)
from . import index as _index
from . import snapshot as _snapshot
from .readpath import RangeReadError, read_range

MANIFEST_NAME = ".rs_bucket"
DEFAULT_STRIPE_BYTES = 64 * 1024 * 1024
DEFAULT_COMPACT_DEAD_FRAC = 0.5
DEFAULT_K, DEFAULT_P, DEFAULT_W = 4, 2, 8

_STRIPE_RE = re.compile(r"^stripe-(\d{8})\.METADATA$")
_KEY_MAX = 512


class ObjectStoreError(ValueError):
    """The bucket cannot take this operation as asked — actionable,
    never a half-applied mutation."""


class ObjectNotFound(ObjectStoreError):
    """No live object under that key (absent or tombstoned)."""


def stripe_bytes_env() -> int:
    """Stripe seal threshold (``RS_STORE_STRIPE_BYTES``, min 64 KiB):
    a stripe accepts whole PUT batches until its size crosses this,
    then the next batch opens a fresh stripe."""
    return max(64 * 1024,
               _int_env("RS_STORE_STRIPE_BYTES", DEFAULT_STRIPE_BYTES))


def compact_dead_frac() -> float:
    """Dead-byte fraction past which a sealed archive is a compaction
    candidate (``RS_STORE_COMPACT_DEAD_FRAC``, clamped to (0, 1])."""
    v = _float_env("RS_STORE_COMPACT_DEAD_FRAC", DEFAULT_COMPACT_DEAD_FRAC)
    return min(1.0, max(1e-6, v))


def encode_cursor(key: str) -> str:
    """Opaque pagination cursor naming the last key a page returned."""
    return base64.urlsafe_b64encode(key.encode()).decode().rstrip("=")


def decode_cursor(cursor: str) -> str:
    """The key a cursor points past; :class:`ObjectStoreError` on a
    cursor this store never minted."""
    try:
        pad = "=" * (-len(cursor) % 4)
        # validate=True: b64decode silently DISCARDS foreign characters
        # otherwise, turning garbage cursors into (wrong) empty ones.
        return base64.b64decode((cursor + pad).encode(),
                                altchars=b"-_", validate=True).decode()
    except (binascii.Error, UnicodeDecodeError, ValueError) as e:
        raise ObjectStoreError(f"bad list cursor {cursor!r}") from e


def _check_key(key) -> str:
    if (not isinstance(key, str) or not key or len(key) > _KEY_MAX
            or "\n" in key or "\r" in key):
        raise ObjectStoreError(
            f"bad object key {key!r}: want a non-empty single-line "
            f"string of at most {_KEY_MAX} chars"
        )
    return key


def _objects_counter():
    return _metrics.counter(
        "rs_store_objects_total", "object-store operations completed",
    )


class Bucket:
    """One bucket: packer-managed stripe archives + the durable object
    index.  Use :func:`open_bucket`, not the constructor."""

    def __init__(self, path: str, manifest: dict, device: torch.device):
        self.path = os.path.abspath(path)
        self.device = device
        self.name = os.path.basename(self.path)
        self.k = int(manifest["k"])
        self.p = int(manifest["p"])
        self.w = int(manifest["w"])
        self.stripe_bytes = int(manifest["stripe_bytes"])
        self.strategy = manifest.get("strategy", "auto")
        self._lock = threading.RLock()
        self._needs_reload = True
        self._state: _index.IndexState | None = None
        self._gens: dict[str, int] = {}
        self._totals: dict[str, int] = {}
        self._active_records = 0
        self._open_report: dict = {}

    # -- paths ---------------------------------------------------------------

    def _arc_path(self, arc: str) -> str:
        return os.path.join(self.path, arc)

    @property
    def index_file(self) -> str:
        return _index.index_path(self.path)

    # -- load / recovery -----------------------------------------------------

    def _load(self) -> None:
        """(Re)build the in-memory view from disk: resolve every
        archive's pending journal (the existing recovery path), read
        post-recovery generations, rebuild the index through the
        snapshot ladder (newest valid snapshot + tail replay —
        O(segments), not O(puts-ever); store/snapshot.py), finish any
        interrupted retirement, and checkpoint if replay had to skip
        records — a rolled-back record must not linger until later
        commits advance the generation past its pin."""
        from .. import api

        t0 = time.perf_counter()
        gens: dict[str, int] = {}
        totals: dict[str, int] = {}
        for fn in sorted(os.listdir(self.path)):
            m = _STRIPE_RE.match(fn)
            if not m:
                continue
            base = self._arc_path(fn[: -len(".METADATA")])
            api.recover_archive(base)
            meta = read_archive_meta(metadata_file_name(base))
            gens[os.path.basename(base)] = meta.generation
            totals[os.path.basename(base)] = meta.total_size
            # A crash between encode and seed unlink leaves the seed
            # file; the archive owns the bytes now.
            if os.path.exists(base):
                try:
                    os.unlink(base)
                except OSError:
                    pass
        state, report = _snapshot.load_ladder(self.path, gens)
        # Resume an interrupted retirement: the retire record is the
        # durable intent, the unlinks are idempotent.
        for arc in sorted(state.retired):
            if arc in gens:
                self._unlink_archive(arc)
                gens.pop(arc, None)
                totals.pop(arc, None)
            state.retired.discard(arc)
            state.dirty = True
        self._state = state
        self._gens = gens
        self._totals = totals
        self._active_records = report["active_records"]
        if state.dirty:
            # The ONE rewrite path: fold the scrubbed state into a
            # fresh snapshot + sealed (filtered) segment.
            self._checkpoint()
            report = dict(report, scrubbed=True)
        self._needs_reload = False
        report["open_seconds"] = time.perf_counter() - t0
        report["snapshots"] = len(_snapshot.list_snapshots(self.path))
        report["segments"] = len(_snapshot.list_segments(self.path))
        self._open_report = report
        _metrics.quantile(
            "rs_store_open_seconds",
            "bucket open wall (recovery + index ladder replay)",
        ).observe(report["open_seconds"])
        _metrics.counter(
            "rs_store_open_records_replayed_total",
            "index records replayed at bucket open",
        ).inc(report["records_replayed"])

    def _ensure_loaded(self) -> _index.IndexState:
        if self._needs_reload or self._state is None:
            self._load()
        return self._state

    # -- checkpointing (the ONE index rewrite path) --------------------------

    def _checkpoint(self) -> dict:
        """Fold the in-memory state into snapshot N + sealed segment N
        (store/snapshot.py) and start a fresh active log."""
        rep = _snapshot.checkpoint(self.path, self._state, self._gens)
        self._active_records = 0
        return rep

    def _maybe_checkpoint(self) -> None:
        if self._needs_reload:
            return  # never fold a view we no longer trust
        thresh = _snapshot.snapshot_records_env()
        if thresh > 0 and self._active_records >= thresh:
            self._checkpoint()

    @property
    def open_report(self) -> dict:
        """How the last (re)load rebuilt the index: ladder source,
        snapshots skipped, segments/records replayed, wall seconds."""
        with self._lock:
            self._ensure_loaded()
            return dict(self._open_report)

    def _unlink_archive(self, arc: str) -> None:
        base = self._arc_path(arc)
        from ..update.journal import journal_path

        doomed = [metadata_file_name(base), journal_path(base), base]
        doomed += [chunk_file_name(base, i)
                   for i in range(self.k + self.p)]
        for path in doomed:
            try:
                os.unlink(path)
            except OSError:
                pass
        fsync_dir(base)

    # -- stripe management ---------------------------------------------------

    def _current_archive(self) -> str | None:
        live = sorted(self._gens)
        return live[-1] if live else None

    def _next_archive(self) -> str:
        used = [int(m.group(1)) for m in
                (_STRIPE_RE.match(a + ".METADATA") for a in self._gens)
                if m]
        # Never reuse a number: a rolled-back create may have left index
        # garbage naming it (dropped+rewritten at load, but fresh ids
        # keep the invariant unconditional).
        for fn in os.listdir(self.path):
            m = _STRIPE_RE.match(fn)
            if m:
                used.append(int(m.group(1)))
        return f"stripe-{(max(used) + 1 if used else 1):08d}"

    # -- the append machinery (put + compaction share it) --------------------

    def _append_batch(self, items: list[tuple[str, bytes]]) -> list[dict]:
        """Append ``items`` into the current stripe (creating/rolling
        one as needed) and commit their index records — the put path's
        core.  Index records go down FIRST, pinned to the generation
        the stripe commit will produce; the archive's commit point
        (atomic .METADATA rename) then decides their validity, and the
        in-memory state is updated only on success.  Returns the new
        location dicts in item order."""
        from .. import api
        from ..update.engine import SimulatedCrash

        state = self._ensure_loaded()
        cur = self._current_archive()
        if cur is None or self._totals.get(cur, 0) >= self.stripe_bytes:
            return self._create_stripe(items)

        arcpath = self._arc_path(cur)
        meta = read_archive_meta(metadata_file_name(arcpath))
        gen_next = meta.generation + 1
        offset = meta.total_size
        records, locations = [], []
        for key, data in items:
            loc = {"arc": cur, "at": offset, "len": len(data),
                   "crc": zlib.crc32(data), "gen": gen_next}
            records.append({"t": "put", "key": key, **loc})
            locations.append(loc)
            offset += len(data)
        _index.append_records(self.index_file, records)
        self._active_records += len(records)
        edits = [{"op": "append", "data": data} for _, data in items]
        try:
            summary = api.update_file_many(
                arcpath, edits, strategy=self.strategy, device=self.device,
                group_edits=len(edits),
            )
        except SimulatedCrash:
            # Disk left torn on purpose; the next open recovers the
            # archive and drops the pre-written records via their pin.
            self._needs_reload = True
            raise
        except BaseException:
            # In-process failure: the group engine already rolled the
            # archive back; scrub the pre-written records out of the
            # log NOW (left in place they would validate once a later
            # commit reaches their pinned generation).  The checkpoint
            # seal filters them out against the rolled-back generation.
            self._checkpoint()
            raise
        if summary["generation"] != gen_next:
            # Never expected (group_edits forces one group); refuse to
            # trust the in-memory view if it ever happens.
            self._needs_reload = True
            raise ObjectStoreError(
                f"stripe commit produced generation "
                f"{summary['generation']}, index pinned {gen_next} — "
                "bucket reloading from disk"
            )
        self._gens[cur] = gen_next
        self._totals[cur] = summary["total_size"]
        for (key, _), loc in zip(items, locations):
            state.set_entry(key, dict(loc))
        return locations

    def _create_stripe(self, items: list[tuple[str, bytes]]) -> list[dict]:
        """First batch of a fresh stripe: seed file -> one interleaved
        encode (atomic via the encode path's .rs_tmp commit) -> index
        records.  Records follow the encode here — a torn encode leaves
        NO archive, so there is no generation to pin against; a crash
        between encode and records leaves an unreferenced stripe that
        the next compaction sweep can retire."""
        from .. import api

        state = self._ensure_loaded()
        arc = self._next_archive()
        arcpath = self._arc_path(arc)
        with open(arcpath, "wb") as fp:
            for _, data in items:
                fp.write(data)
        try:
            api.encode_file(
                arcpath, self.k, self.p, w=self.w, checksums=True,
                layout="interleaved", strategy=self.strategy,
                device=self.device,
            )
        finally:
            try:
                os.unlink(arcpath)
            except OSError:
                pass
        records, locations, offset = [], [], 0
        for key, data in items:
            loc = {"arc": arc, "at": offset, "len": len(data),
                   "crc": zlib.crc32(data), "gen": 0}
            records.append({"t": "put", "key": key, **loc})
            locations.append(loc)
            offset += len(data)
        _index.append_records(self.index_file, records)
        self._active_records += len(records)
        self._gens[arc] = 0
        self._totals[arc] = offset
        for (key, _), loc in zip(items, locations):
            state.set_entry(key, dict(loc))
        _metrics.counter(
            "rs_store_stripes_total", "stripe archives by lifecycle event",
        ).labels(event="created").inc()
        return locations

    # -- public surface ------------------------------------------------------

    def put_many(self, items) -> list[dict]:
        """Store an ordered batch of ``(key, bytes)`` objects as ONE
        group-committed stripe append + ONE index fsync (the write-
        combining unit).  Later
        duplicates win, like sequential puts.  All-or-nothing: a torn
        batch commits no object."""
        norm = []
        for key, data in items:
            data = bytes(data)
            if not data:
                raise ObjectStoreError(
                    f"refusing empty object {_check_key(key)!r} "
                    "(DELETE removes; zero-byte objects are not stored)"
                )
            norm.append((_check_key(key), data))
        if not norm:
            return []
        with self._lock:
            locations = self._append_batch(norm)
            self._maybe_checkpoint()
        nbytes = sum(len(d) for _, d in norm)
        _objects_counter().labels(op="put").inc(len(norm))
        _metrics.counter(
            "rs_store_bytes_total", "object payload bytes moved, by op",
        ).labels(op="put").inc(nbytes)
        self._export_gauges()
        return locations

    def put(self, key: str, data) -> dict:
        return self.put_many([(key, data)])[0]

    def entry_for(self, key: str) -> dict:
        """The live index entry (a copy) for ``key``: a read cache's
        validation handle, since a cached object may serve only while its
        full recorded location (arc, at, len, crc, gen) still equals
        this."""
        with self._lock:
            state = self._ensure_loaded()
            entry = state.entries.get(_check_key(key))
            if entry is None:
                raise ObjectNotFound(f"no object {key!r}")
            return dict(entry)

    def get(self, key: str, *, info: dict | None = None) -> bytes:
        """Read one object.  When ``info`` is given it gains ``path``
        (``fast``/``degraded`` — store/readpath.py) and ``entry`` (the
        exact index entry served)."""
        with self._lock:
            state = self._ensure_loaded()
            entry = state.entries.get(_check_key(key))
            if entry is None:
                raise ObjectNotFound(f"no object {key!r}")
            arcpath = self._arc_path(entry["arc"])
            data = read_range(
                arcpath, entry["at"], entry["len"], crc=entry["crc"],
                strategy=self.strategy, info=info, device=self.device,
            )
            if info is not None:
                info["entry"] = dict(entry)
        _objects_counter().labels(op="get").inc()
        _metrics.counter(
            "rs_store_bytes_total", "object payload bytes moved, by op",
        ).labels(op="get").inc(len(data))
        return data

    def delete(self, key: str) -> dict:
        """Tombstone ``key`` (durable BEFORE anything else moves — the
        delete's commit point), then zero the dead range through the
        delta-parity patch lane so dead bytes are inert on disk.  A torn
        zeroing changes nothing: the tombstone already committed, and
        the patch rolls back through the archive journal."""
        from .. import api
        from ..update.engine import SimulatedCrash, UpdateError

        with self._lock:
            state = self._ensure_loaded()
            entry = state.entries.get(_check_key(key))
            if entry is None:
                raise ObjectNotFound(f"no object {key!r}")
            _index.append_records(self.index_file, [
                {"t": "del", "key": key, "gen": self._gens.get(
                    entry["arc"], 0)},
            ])
            self._active_records += 1
            state.drop_key(key)
            _objects_counter().labels(op="delete").inc()
            arcpath = self._arc_path(entry["arc"])
            try:
                api.update_file(
                    arcpath, entry["at"],
                    np.zeros(entry["len"], dtype=np.uint8),
                    strategy=self.strategy, device=self.device,
                )
                self._gens[entry["arc"]] = self._gens.get(
                    entry["arc"], 0) + 1
            except SimulatedCrash:
                self._needs_reload = True
                raise
            except (UpdateError, OSError, ValueError):
                # Zeroing is hygiene, not correctness: the tombstone is
                # the commit.  Stale bytes stay until compaction.
                _metrics.counter(
                    "rs_store_zeroing_skipped_total",
                    "delete-as-update zeroing passes that failed",
                ).inc()
                self._needs_reload = True
            self._maybe_checkpoint()
        self._export_gauges()
        return {"key": key, "bytes": entry["len"], "arc": entry["arc"]}

    def list_objects(self, *, prefix: str = "") -> list[dict]:
        with self._lock:
            state = self._ensure_loaded()
            out = [
                {"key": key, "bytes": e["len"], "arc": e["arc"]}
                for key, e in sorted(state.entries.items())
                if not prefix or key.startswith(prefix)
            ]
        _objects_counter().labels(op="list").inc()
        return out

    def list_page(self, *, prefix: str = "", limit: int = 0,
                  cursor: str | None = None) -> dict:
        """One page of the listing: keys after ``cursor`` (exclusive,
        an opaque token a previous page's ``next`` minted) matching
        ``prefix``, at most ``limit`` of them (<= 0: unbounded).  A
        10⁷-key bucket never serializes whole into one response —
        ``next`` is set iff more keys follow."""
        start = decode_cursor(cursor) if cursor else None
        if limit < 0:
            limit = 0
        with self._lock:
            state = self._ensure_loaded()
            keys = sorted(
                k for k in state.entries
                if (not prefix or k.startswith(prefix))
                and (start is None or k > start)
            )
            truncated = bool(limit) and len(keys) > limit
            if truncated:
                keys = keys[:limit]
            objects = [
                {"key": k, "bytes": state.entries[k]["len"],
                 "arc": state.entries[k]["arc"]}
                for k in keys
            ]
        _objects_counter().labels(op="list").inc()
        return {
            "objects": objects,
            "truncated": truncated,
            "next": encode_cursor(keys[-1]) if truncated else None,
        }

    def stat(self, key: str) -> dict:
        with self._lock:
            state = self._ensure_loaded()
            entry = state.entries.get(_check_key(key))
            if entry is None:
                raise ObjectNotFound(f"no object {key!r}")
            return {
                "key": key, "bytes": entry["len"], "arc": entry["arc"],
                "at": entry["at"], "crc32": f"{entry['crc']:08x}",
                "pinned_generation": entry["gen"],
                "archive_generation": self._gens.get(entry["arc"]),
            }

    # -- space accounting / compaction ---------------------------------------

    def _dead_frac(self, arc: str) -> float:
        total = self._totals.get(arc, 0)
        if total <= 0:
            return 0.0
        return max(0.0, 1.0 - self._state.live_bytes(arc) / total)

    def stats(self) -> dict:
        """Schema-stable bucket report: ``rs object stat``'s
        bucket-level view."""
        with self._lock:
            state = self._ensure_loaded()
            cur = self._current_archive()
            archives = {}
            live_total = dead_total = 0
            pending = 0
            frac = compact_dead_frac()
            for arc in sorted(self._gens):
                live = state.live_bytes(arc)
                total = self._totals.get(arc, 0)
                dead = max(0, total - live)
                live_total += live
                dead_total += dead
                sealed = arc != cur or total >= self.stripe_bytes
                candidate = (sealed and total > 0
                             and dead / total >= frac)
                pending += bool(candidate)
                archives[arc] = {
                    "total_bytes": total, "live_bytes": live,
                    "dead_bytes": dead,
                    "generation": self._gens[arc],
                    "sealed": sealed, "compaction_candidate": candidate,
                }
            return {
                "bucket": self.name,
                "objects": len(state.entries),
                "live_bytes": live_total,
                "dead_bytes": dead_total,
                "index_records": state.records,
                "index_active_records": self._active_records,
                "open": dict(self._open_report),
                "archives": archives,
                "pending_compactions": pending,
                "config": {
                    "k": self.k, "p": self.p, "w": self.w,
                    "stripe_bytes": self.stripe_bytes,
                    "compact_dead_frac": frac,
                    "snapshot_records": _snapshot.snapshot_records_env(),
                },
            }

    def _export_gauges(self) -> None:
        with self._lock:
            state = self._ensure_loaded()
            live = sum(state.live_bytes(a) for a in self._gens)
            total = sum(self._totals.values())
        _metrics.gauge(
            "rs_store_live_bytes", "live object bytes per bucket",
        ).labels(bucket=self.name).set(live)
        _metrics.gauge(
            "rs_store_dead_bytes",
            "dead (tombstoned/superseded/unindexed) bytes per bucket",
        ).labels(bucket=self.name).set(max(0, total - live))

    def compact(self, *, force: bool = False) -> dict:
        """Rewrite live objects out of every dead-heavy sealed archive
        as one grouped batch each, then retire the old archive.
        All-or-nothing per archive: re-point records commit through the
        target stripe's generation pin; the retire record (and the
        unlinks it licenses) go down only after every re-point is
        durable — a crash at any stage leaves old-fully-live or
        new-fully-live.  ``force=True`` compacts any sealed archive
        with dead bytes, threshold regardless."""
        retired, moved_objects, moved_bytes = [], 0, 0
        with self._lock:
            state = self._ensure_loaded()
            frac = compact_dead_frac()
            cur = self._current_archive()
            for arc in sorted(self._gens):
                total = self._totals.get(arc, 0)
                if arc == cur and total < self.stripe_bytes:
                    continue  # the open stripe keeps taking appends
                if total <= 0:
                    continue
                dead = self._dead_frac(arc)
                if dead < (1e-9 if force else frac):
                    continue
                live = state.objects_in(arc)
                payloads = []
                for key, e in live:
                    payloads.append((key, read_range(
                        self._arc_path(arc), e["at"], e["len"],
                        crc=e["crc"], strategy=self.strategy,
                        device=self.device,
                    )))
                if payloads:
                    self._append_batch(payloads)
                    moved_objects += len(payloads)
                    moved_bytes += sum(len(d) for _, d in payloads)
                # Every re-point is durable (the batch fsynced its
                # records and committed) — NOW the old archive may die.
                _index.append_records(self.index_file,
                                      [{"t": "retire", "arc": arc}])
                self._active_records += 1
                self._unlink_archive(arc)
                self._gens.pop(arc, None)
                self._totals.pop(arc, None)
                retired.append(arc)
                _metrics.counter(
                    "rs_store_stripes_total",
                    "stripe archives by lifecycle event",
                ).labels(event="retired").inc()
            if retired:
                # Hygiene fold: drop the superseded/retired records so
                # the log does not grow monotonically (the unified
                # checkpoint path — store/snapshot.py).
                state.retired.clear()
                self._checkpoint()
        _metrics.counter(
            "rs_store_compactions_total", "bucket compaction passes",
        ).labels(outcome="committed" if retired else "noop").inc()
        if moved_objects:
            _objects_counter().labels(op="compact_rewrite").inc(
                moved_objects)
        self._export_gauges()
        return {
            "bucket": self.name, "archives_retired": retired,
            "objects_moved": moved_objects, "bytes_moved": moved_bytes,
        }


# -- bucket registry ----------------------------------------------------------

_BUCKETS: dict[str, Bucket] = {}
_BUCKETS_LOCK = threading.Lock()


def _manifest_path(path: str) -> str:
    return os.path.join(path, MANIFEST_NAME)


def _bucket_device(device) -> torch.device:
    """The device a bucket runs its GEMMs on: :func:`resolve_device`
    (None means the current CUDA device and raises with no GPU present),
    with a bare ``cuda`` pinned to the current index so that equal devices
    compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def open_bucket(root: str, name: str, *, create: bool = False,
                k: int | None = None, p: int | None = None,
                w: int | None = None,
                stripe_bytes: int | None = None, device=None) -> Bucket:
    """Open (and with ``create=True``, initialise) bucket ``name`` under
    ``root``.  Instances are cached per absolute path — the in-memory
    index view survives across calls in one process; the shape knobs
    only apply at creation (an existing manifest wins).  ``device``: where
    the bucket's GEMMs run (None: CUDA, raising with no GPU present);
    opening a cached bucket again with another device raises
    ``ValueError`` naming both."""
    dev = _bucket_device(device)
    path = os.path.abspath(os.path.join(root, name))
    with _BUCKETS_LOCK:
        bucket = _BUCKETS.get(path)
        if bucket is not None:
            if bucket.device != dev:
                raise ValueError(
                    f"bucket {path!r} is open on {bucket.device}, not "
                    f"{dev}: drop_cached() it before opening it on "
                    "another device"
                )
            return bucket
        mpath = _manifest_path(path)
        if os.path.exists(mpath):
            with open(mpath) as fp:
                manifest = json.load(fp)
        elif create:
            kk = k if k is not None else _int_env("RS_STORE_K", DEFAULT_K)
            pp = p if p is not None else _int_env("RS_STORE_P", DEFAULT_P)
            ww = w if w is not None else DEFAULT_W
            if kk <= 0 or pp <= 0 or ww not in (8, 16):
                raise ObjectStoreError(
                    f"bad bucket shape k={kk} p={pp} w={ww} "
                    "(k,p > 0; w in 8/16)"
                )
            manifest = {
                "version": 1, "k": kk, "p": pp, "w": ww,
                "layout": "interleaved",
                "stripe_bytes": (stripe_bytes if stripe_bytes is not None
                                 else stripe_bytes_env()),
            }
            os.makedirs(path, exist_ok=True)
            tmp = mpath + ".tmp"
            with open(tmp, "w") as fp:
                json.dump(manifest, fp, sort_keys=True)
                fp.write("\n")
                fp.flush()
                os.fsync(fp.fileno())
            os.replace(tmp, mpath)
            fsync_dir(mpath)
        else:
            raise ObjectNotFound(f"no bucket {name!r} under {root!r}")
        bucket = Bucket(path, manifest, dev)
        _BUCKETS[path] = bucket
        return bucket


def cached_bucket(root: str, name: str) -> Bucket | None:
    """The already-open :class:`Bucket` for ``root/name``, or None —
    lets introspection surfaces reuse the live in-memory view instead of
    re-replaying the on-disk log."""
    with _BUCKETS_LOCK:
        return _BUCKETS.get(os.path.abspath(os.path.join(root, name)))


def drop_cached(path: str | None = None) -> None:
    """Forget cached bucket instances (all, or one by absolute path) —
    the tests' "process restart" seam: the next
    :func:`open_bucket` reloads and re-validates from disk."""
    with _BUCKETS_LOCK:
        if path is None:
            _BUCKETS.clear()
        else:
            _BUCKETS.pop(os.path.abspath(path), None)


def list_buckets(root: str) -> list[str]:
    if not os.path.isdir(root):
        return []
    return sorted(
        name for name in os.listdir(root)
        if os.path.exists(_manifest_path(os.path.join(root, name)))
    )


def probe(root: str) -> dict:
    """Read-only store health view: replays each bucket's index WITHOUT
    running recovery or rewriting anything (a diagnostic must not
    mutate), so rolled-back records show up as ``pending_drops`` instead
    of silently vanishing."""
    from ..update.journal import journal_path

    buckets = {}
    for name in list_buckets(root):
        path = os.path.join(root, name)
        try:
            with open(_manifest_path(path)) as fp:
                manifest = json.load(fp)
            gens, totals, journals = {}, {}, 0
            for fn in sorted(os.listdir(path)):
                m = _STRIPE_RE.match(fn)
                if not m:
                    continue
                base = os.path.join(path, fn[: -len(".METADATA")])
                meta = read_archive_meta(metadata_file_name(base))
                gens[os.path.basename(base)] = meta.generation
                totals[os.path.basename(base)] = meta.total_size
                journals += os.path.exists(journal_path(base))
            state, open_report = _snapshot.load_ladder(path, gens)
            live = sum(state.live_bytes(a) for a in gens)
            total = sum(totals.values())
            frac = compact_dead_frac()
            stripe_cap = int(manifest.get("stripe_bytes")
                             or stripe_bytes_env())
            cur = max(gens) if gens else None  # the open stripe
            pending = sum(
                1 for a in gens if totals.get(a, 0) > 0
                and (a != cur or totals[a] >= stripe_cap)
                and 1.0 - state.live_bytes(a) / totals[a] >= frac
            )
            buckets[name] = {
                "objects": len(state.entries),
                "archives": len(gens),
                "live_bytes": live,
                "dead_bytes": max(0, total - live),
                "index_records": state.records,
                "pending_drops": (state.dropped_rolled_back
                                  + state.dropped_missing),
                "snapshots": len(_snapshot.list_snapshots(path)),
                "segments": len(_snapshot.list_segments(path)),
                "open": open_report,
                "pending_journals": journals,
                "pending_compactions": pending,
                "config": {"k": manifest.get("k"), "p": manifest.get("p"),
                           "w": manifest.get("w"),
                           "stripe_bytes": manifest.get("stripe_bytes")},
            }
        except (OSError, ValueError) as e:
            buckets[name] = {"error": f"{type(e).__name__}: {e}"}
    return {
        "root": os.path.abspath(root),
        "buckets": buckets,
        "knobs": {
            "RS_STORE_STRIPE_BYTES": stripe_bytes_env(),
            "RS_STORE_COMPACT_DEAD_FRAC": compact_dead_frac(),
            "RS_STORE_SNAPSHOT_RECORDS": _snapshot.snapshot_records_env(),
            "RS_STORE_SNAPSHOT_KEEP": _snapshot.snapshot_keep_env(),
        },
    }
