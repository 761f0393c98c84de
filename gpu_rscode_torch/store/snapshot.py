"""Index snapshots + sealed segments — O(segments) bucket opens.

The object index is one append-only JSONL log, so opening a bucket
replays every put/del/retire record EVER written: O(puts-ever), which
is quadratic pain on the way to the 10⁷-object target.  This module
folds the replayed last-writer-wins state into periodic **snapshot**
files and seals the replayed log as numbered **segments**, so an open
costs newest-valid-snapshot + tail replay — O(segments), not
O(puts-ever).

On-disk layout, per bucket directory:

* ``.rs_object_index`` — the ACTIVE log (unchanged name/format;
  store/index.py still owns appends and torn-tail healing);
* ``.rs_object_index.seg.NNNNNNNN`` — sealed segment N: the active
  log's records at checkpoint N, **filtered** of records that are
  invalid against the post-recovery generations (rolled back, or
  referencing a retired/missing archive).  Filtering at seal time is
  the resurrection guard: an invalid record can only ever live in the
  ACTIVE log, and any open that replays one checkpoints before the
  bucket accepts new writes — so no sealed segment can hold a record
  that would "resurrect" once later commits advance an archive's
  generation past its pin;
* ``.rs_object_snapshot.NNNNNNNN`` — snapshot N: one crash-atomic JSON
  document (algo_version checked BEFORE the blake2b payload digest —
  a foreign version is not corruption) folding ALL records
  through checkpoint N: snapshot N covers segments 1..N plus whatever
  was in the active log when it was written.

``checkpoint()`` is the ONE rewrite path (the skip-triggered atomic
rewrite, the in-process put-failure scrub, compaction hygiene, and the
periodic RS_STORE_SNAPSHOT_RECORDS fold all land here): write snapshot
N (tmp + fsync + rename + dir fsync), seal the active log as filtered
segment N, truncate the active log, prune history past
RS_STORE_SNAPSHOT_KEEP *verified* snapshots.

``load_ladder()`` is the open path: newest snapshot whose tail
segments are all present -> one snapshot older -> ... -> full log
replay (valid only while segments are still contiguous from 1, i.e.
before any pruning) -> loud :class:`~.bucket.ObjectStoreError`.
**Never wrong, only slower**: a torn/corrupt/foreign snapshot costs a
longer replay, never a different answer — replaying a contiguous
record suffix over a prefix-fold is exact because records are absolute
and replay is last-writer-wins (double-applying records a snapshot
already folded is idempotent).
"""

from __future__ import annotations

import hashlib
import json
import os
import re

from ..obs import metrics as _metrics
from ..utils.env import int_env as _int_env
from ..utils.fileformat import fsync_dir
from . import index as _index

SNAPSHOT_ALGO = 1
SNAP_RE = re.compile(r"^\.rs_object_snapshot\.(\d{8})$")
SEG_RE = re.compile(r"^\.rs_object_index\.seg\.(\d{8})$")

DEFAULT_SNAPSHOT_RECORDS = 8192
DEFAULT_SNAPSHOT_KEEP = 2


def snapshot_records_env() -> int:
    """Active-log record count that triggers a periodic checkpoint
    (``RS_STORE_SNAPSHOT_RECORDS``, default 8192; <= 0 disables the
    periodic trigger — dirty-replay scrubs still checkpoint)."""
    return _int_env("RS_STORE_SNAPSHOT_RECORDS", DEFAULT_SNAPSHOT_RECORDS)


def snapshot_keep_env() -> int:
    """Verified snapshots retained after a checkpoint
    (``RS_STORE_SNAPSHOT_KEEP``, default 2, min 1).  Segments covered
    by the oldest kept snapshot are pruned with it."""
    return max(1, _int_env("RS_STORE_SNAPSHOT_KEEP", DEFAULT_SNAPSHOT_KEEP))


def snapshots_disabled() -> bool:
    """``RS_STORE_SNAPSHOT_DISABLE=1`` makes :func:`load_ladder` ignore
    snapshot files (full-history replay) — the open-cost A/B seam."""
    return os.environ.get("RS_STORE_SNAPSHOT_DISABLE", "") == "1"


def snapshot_path(bucket_dir: str, n: int) -> str:
    return os.path.join(bucket_dir, f".rs_object_snapshot.{n:08d}")


def segment_path(bucket_dir: str, n: int) -> str:
    return os.path.join(bucket_dir, f".rs_object_index.seg.{n:08d}")


def list_snapshots(bucket_dir: str) -> list[int]:
    """Snapshot numbers present, ascending."""
    return _scan(bucket_dir, SNAP_RE)


def list_segments(bucket_dir: str) -> list[int]:
    """Sealed segment numbers present, ascending."""
    return _scan(bucket_dir, SEG_RE)


def _scan(bucket_dir: str, rx: re.Pattern) -> list[int]:
    out = []
    try:
        names = os.listdir(bucket_dir)
    except OSError:
        return []
    for fn in names:
        m = rx.match(fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _fallback_counter():
    return _metrics.counter(
        "rs_store_snapshot_fallbacks_total",
        "bucket opens that had to skip an unusable index snapshot",
    )


# -- snapshot document ---------------------------------------------------------


def payload_digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


def _payload_from_state(state: _index.IndexState) -> dict:
    return {
        "entries": {k: {"arc": e["arc"], "at": e["at"], "len": e["len"],
                        "crc": e["crc"], "gen": e["gen"]}
                    for k, e in state.entries.items()},
        "retired": sorted(state.retired),
    }


def _state_from_payload(payload: dict) -> _index.IndexState:
    st = _index.IndexState()
    for key in sorted(payload["entries"]):
        e = payload["entries"][key]
        st.set_entry(key, {"arc": e["arc"], "at": int(e["at"]),
                           "len": int(e["len"]),
                           "crc": int(e["crc"]) & 0xFFFFFFFF,
                           "gen": int(e["gen"])})
    st.retired = set(payload.get("retired", []))
    st.records = len(st.entries) + len(st.retired)
    return st


def write_snapshot(bucket_dir: str, n: int,
                   state: _index.IndexState) -> str:
    """Write snapshot ``n`` crash-atomically (tmp + fsync + rename +
    dir fsync) and return its path."""
    payload = _payload_from_state(state)
    doc = {
        "algo_version": SNAPSHOT_ALGO,
        "snap": int(n),
        "payload": payload,
        "payload_digest": payload_digest(payload),
    }
    path = snapshot_path(bucket_dir, n)
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, sort_keys=True)
        fp.write("\n")
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    fsync_dir(path)
    return path


def load_snapshot(bucket_dir: str, n: int) -> _index.IndexState | None:
    """Snapshot ``n`` as a fresh :class:`IndexState`, or None when the
    file is torn/corrupt/foreign — the caller falls back one rung.
    Discipline order matters: a FOREIGN algo_version is rejected BEFORE
    the digest (its digest may be valid for semantics this loader would
    misapply); only then is a digest mismatch corruption."""
    try:
        with open(snapshot_path(bucket_dir, n)) as fp:
            doc = json.load(fp)
        if not isinstance(doc, dict):
            raise ValueError("snapshot is not a JSON object")
        if doc.get("algo_version") != SNAPSHOT_ALGO:
            raise ValueError("snapshot algo_version mismatch")
        payload = doc.get("payload")
        if not isinstance(payload, dict) or not isinstance(
                payload.get("entries"), dict):
            raise ValueError("malformed snapshot payload")
        if doc.get("payload_digest") != payload_digest(payload):
            raise ValueError("snapshot digest mismatch")
        return _state_from_payload(payload)
    except (OSError, ValueError, KeyError, TypeError):
        return None


# -- checkpoint: the ONE rewrite path -----------------------------------------


def _record_valid_now(rec: dict, generations: dict[str, int],
                      retired: set[str]) -> bool:
    """Seal-time filter: del/retire records reference no bytes and are
    always durable; a put record survives iff its archive is live and
    its pinned generation committed (anything else is rolled back or
    unreachable and must not outlive the active log)."""
    kind = rec.get("t")
    if kind in ("del", "retire"):
        return True
    arc = rec.get("arc")
    if arc in retired or arc not in generations:
        return False
    try:
        return int(rec["gen"]) <= generations[arc]
    except (KeyError, TypeError, ValueError):
        return False


def checkpoint(bucket_dir: str, state: _index.IndexState,
               generations: dict[str, int], *,
               keep: int | None = None) -> dict:
    """Fold ``state`` into snapshot N, seal the active log as filtered
    segment N, start a fresh active log, prune old history.  Crash-safe
    at every boundary: records are absolute and replay is LWW, so a
    crash that leaves the active log alongside a covering snapshot just
    replays it idempotently on the next open."""
    active = _index.index_path(bucket_dir)
    snaps = list_snapshots(bucket_dir)
    segs = list_segments(bucket_dir)
    n = max(snaps + segs, default=0) + 1

    write_snapshot(bucket_dir, n, state)

    # Seal the replayed active log as segment N, dropping records that
    # are invalid against the post-recovery generations (the
    # resurrection guard: sealed segments hold only records that can
    # never be invalidated by a later generation advance).
    records = _index.read_records(active)
    retired = set(state.retired)
    kept = [r for r in records
            if _record_valid_now(r, generations, retired)]
    seg = segment_path(bucket_dir, n)
    tmp = seg + ".tmp"
    with open(tmp, "w") as fp:
        for rec in kept:
            fp.write(json.dumps(rec, sort_keys=True) + "\n")
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, seg)
    fsync_dir(seg)

    try:
        os.unlink(active)
    except OSError:
        pass
    fsync_dir(active)

    pruned = prune(bucket_dir, keep=keep)
    state.dirty = False
    state.dropped_rolled_back = 0
    state.dropped_missing = 0
    state.records = len(state.entries) + len(state.retired)
    state.tombstones = 0
    _metrics.counter(
        "rs_store_snapshots_total", "index checkpoints written",
    ).inc()
    return {"snap": n, "sealed_records": len(kept),
            "dropped_records": len(records) - len(kept), **pruned}


def prune(bucket_dir: str, *, keep: int | None = None) -> dict:
    """Drop snapshots beyond the newest ``keep`` that VERIFY on
    read-back, plus the segments only those dropped snapshots (or a
    from-genesis replay) still needed.  Never prunes past an unverified
    snapshot: history is only released once a newer snapshot has proven
    it can stand in for it.  Segment ``floor`` itself is RETAINED even
    though the floor snapshot covers it: once any segment is pruned, a
    later open that finds every snapshot damaged must see a
    non-contiguous chain and fail LOUDLY — an empty segment list would
    read as "no history" and silently serve only the active log."""
    keep = snapshot_keep_env() if keep is None else max(1, keep)
    snaps = sorted(list_snapshots(bucket_dir), reverse=True)
    verified: list[int] = []
    for n in snaps:
        if len(verified) >= keep:
            break
        if load_snapshot(bucket_dir, n) is not None:
            verified.append(n)
    if len(verified) < keep:
        return {"pruned_snapshots": 0, "pruned_segments": 0}
    floor = min(verified)
    dropped_snaps = [n for n in snaps if n < floor]
    dropped_segs = [m for m in list_segments(bucket_dir) if m < floor]
    for n in dropped_snaps:
        try:
            os.unlink(snapshot_path(bucket_dir, n))
        except OSError:
            pass
    for m in dropped_segs:
        try:
            os.unlink(segment_path(bucket_dir, m))
        except OSError:
            pass
    if dropped_snaps or dropped_segs:
        fsync_dir(os.path.join(bucket_dir, "x"))
    return {"pruned_snapshots": len(dropped_snaps),
            "pruned_segments": len(dropped_segs)}


# -- the open ladder -----------------------------------------------------------


def load_ladder(bucket_dir: str, generations: dict[str, int], *,
                use_snapshots: bool | None = None,
                ) -> tuple[_index.IndexState, dict]:
    """Rebuild the index state at open cost O(segments).

    Tries snapshots newest-first; a rung is usable when the snapshot
    verifies AND every segment in (snap, max_seg] is present (each such
    segment holds records the snapshot does not cover).  The final rung
    is full replay — valid only while segments are contiguous from 1.
    No usable rung raises :class:`~.bucket.ObjectStoreError` (loud,
    actionable — never silently wrong).

    Returns ``(state, report)``; the report feeds ``rs object stat``
    and :func:`~.bucket.probe`:
    ``{"source": "snapshot"|"log", "snapshot": N|None,
    "snapshots_skipped": j, "segments_replayed": s,
    "records_replayed": r, "active_records": a}``.
    """
    if use_snapshots is None:
        use_snapshots = not snapshots_disabled()
    segs = list_segments(bucket_dir)
    max_seg = max(segs, default=0)
    seg_set = set(segs)
    active = _index.read_records(_index.index_path(bucket_dir))
    skipped = 0

    if use_snapshots:
        for n in sorted(list_snapshots(bucket_dir), reverse=True):
            missing = [m for m in range(n + 1, max_seg + 1)
                       if m not in seg_set]
            if missing:
                skipped += 1
                _fallback_counter().labels(reason="missing_segment").inc()
                continue
            st = load_snapshot(bucket_dir, n)
            if st is None:
                skipped += 1
                _fallback_counter().labels(reason="invalid_snapshot").inc()
                continue
            replayed = 0
            tail_segs = [m for m in segs if m > n]
            for m in tail_segs:
                recs = _index.read_records(segment_path(bucket_dir, m))
                _index.replay_into(st, recs, generations)
                replayed += len(recs)
            _index.replay_into(st, active, generations)
            _revalidate(st, generations)
            return st, {
                "source": "snapshot", "snapshot": n,
                "snapshots_skipped": skipped,
                "segments_replayed": len(tail_segs),
                "records_replayed": replayed + len(active),
                "active_records": len(active),
            }

    # Full replay from genesis: only exact while no segment has been
    # pruned away (numbering is contiguous from 1, or there are none).
    if segs != list(range(1, len(segs) + 1)):
        from .bucket import ObjectStoreError

        raise ObjectStoreError(
            f"bucket index unrecoverable: no usable snapshot and sealed "
            f"segments {segs} are not contiguous from 1 (pruned history "
            "needs a valid snapshot) — restore a snapshot file or the "
            "missing segments"
        )
    st = _index.IndexState()
    replayed = 0
    for m in segs:
        recs = _index.read_records(segment_path(bucket_dir, m))
        _index.replay_into(st, recs, generations)
        replayed += len(recs)
    _index.replay_into(st, active, generations)
    return st, {
        "source": "log", "snapshot": None,
        "snapshots_skipped": skipped,
        "segments_replayed": len(segs),
        "records_replayed": replayed + len(active),
        "active_records": len(active),
    }


def _revalidate(st: _index.IndexState, generations: dict[str, int]) -> None:
    """Post-ladder sweep over the FINAL entries: a snapshot folded
    against an older world could in principle carry an entry whose
    archive has since vanished without a retire record (manual damage);
    drop it the way full replay would, never serve a dangling pointer.
    O(live objects) — the same cost as parsing the snapshot."""
    for key in [k for k, e in st.entries.items()
                if e["arc"] in st.retired
                or e["arc"] not in generations
                or e["gen"] > generations[e["arc"]]]:
        st.drop_key(key)
        st.dropped_missing += 1
        st.dirty = True
