"""The durable object index — one JSONL log per bucket.

Maps object keys onto byte ranges of shared erasure-coded stripe
archives (docs/STORE.md).  Three record kinds, one JSON object per
line, appended with single O_APPEND writes and fsynced at every
commit boundary:

* ``{"t": "put", "key": K, "arc": A, "at": O, "len": N, "crc": C,
  "gen": G}`` — object K lives in archive A at file-space bytes
  [O, O+N), CRC32 C, valid **iff** archive A's metadata generation
  reached G.  Put records are appended BEFORE the stripe append's
  commit point and pinned to the generation that commit will produce:
  the archive's own crash-atomic ``.METADATA`` rename (and, for a torn
  group, the journal rollback that undoes it) therefore decides the
  index entry's validity too — the index commits crash-atomically
  alongside the archive metadata it references, with no second
  journal.
* ``{"t": "del", "key": K, "gen": G}`` — tombstone.  Valid
  unconditionally (it references no bytes); appended and fsynced
  BEFORE the delete-as-update zeroing patch, so a torn zeroing never
  resurrects a deleted object.  ``gen`` is advisory (the generation
  observed at delete time).
* ``{"t": "retire", "arc": A}`` — archive A's live objects were all
  rewritten elsewhere (compaction); its files may be unlinked.
  Appended only after every re-point record is durable.

Replay is last-writer-wins in log order, **skipping invalid put
records** so an earlier valid record keeps winning over a rolled-back
overwrite.  A put record is invalid when its archive is missing /
retired, or when ``gen`` exceeds the archive's post-recovery metadata
generation (the referenced group was rolled back).  Any skip marks the
log dirty; the bucket rewrites it (atomic temp + fsync + rename)
before accepting new writes — a rolled-back record must not linger and
"resurrect" once later commits advance the generation past its pin.

A torn tail line (crash mid-append) is healed by ignoring it, exactly
like the run ledger's contract (obs/runlog.py).
"""

from __future__ import annotations

import json
import os

from ..obs import metrics as _metrics
from ..utils.fileformat import fsync_dir

INDEX_NAME = ".rs_object_index"


def index_path(bucket_dir: str) -> str:
    return os.path.join(bucket_dir, INDEX_NAME)


def _dropped_counter():
    return _metrics.counter(
        "rs_store_index_dropped_total",
        "object-index records dropped at load, by reason",
    )


def append_records(path: str, records: list[dict], *,
                   sync: bool = True) -> None:
    """Append ``records`` as JSONL with ONE write and (by default) one
    fsync — the index side of a commit boundary."""
    if not records:
        return
    blob = "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, blob.encode())
        if sync:
            os.fsync(fd)
    finally:
        os.close(fd)


def read_records(path: str) -> list[dict]:
    """Every parseable record in log order; a torn tail line (no
    trailing newline, or unparseable JSON at EOF) is dropped silently —
    its commit point never landed."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fp:
        raw = fp.read()
    out: list[dict] = []
    lines = raw.split(b"\n")
    complete = lines[:-1]  # raw ends with \n -> last element is b""
    for i, line in enumerate(complete):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(complete) - 1:
                break  # torn tail — healed by dropping
            continue  # interior garbage line: skip, keep reading
        if isinstance(rec, dict) and rec.get("t") in ("put", "del",
                                                      "retire"):
            out.append(rec)
    return out


class IndexState:
    """Replayed view of one bucket's log: live entries, retired archives,
    and whether the on-disk log holds records replay had to skip.
    Mutate ``entries`` only through :meth:`set_entry` / :meth:`drop_key`
    — they keep the per-archive live-byte tallies exact, so space
    accounting stays O(archives), not O(objects × archives), at the
    millions-of-objects scale the façade exists for."""

    def __init__(self):
        self.entries: dict[str, dict] = {}   # key -> put record
        self.retired: set[str] = set()
        self.dirty = False                   # log holds invalid records
        self.dropped_rolled_back = 0
        self.dropped_missing = 0
        self.records = 0                     # records replayed (valid+not)
        self.tombstones = 0                  # live tombstone records
        self._live_by_arc: dict[str, int] = {}

    def set_entry(self, key: str, entry: dict) -> None:
        self.drop_key(key)
        self.entries[key] = entry
        self._live_by_arc[entry["arc"]] = (
            self._live_by_arc.get(entry["arc"], 0) + entry["len"])

    def drop_key(self, key: str) -> dict | None:
        old = self.entries.pop(key, None)
        if old is not None:
            self._live_by_arc[old["arc"]] -= old["len"]
        return old

    def live_bytes(self, archive: str) -> int:
        return self._live_by_arc.get(archive, 0)

    def objects_in(self, archive: str) -> list[tuple[str, dict]]:
        """Live (key, entry) pairs in ``archive``, ascending offset —
        compaction's rewrite order."""
        out = [(k, e) for k, e in self.entries.items()
               if e["arc"] == archive]
        out.sort(key=lambda kv: kv[1]["at"])
        return out


def replay(records: list[dict], generations: dict[str, int]) -> IndexState:
    """Fold the log into an :class:`IndexState` against the
    POST-RECOVERY archive generations (``generations`` maps archive id
    -> metadata generation; absent id == archive files missing)."""
    st = IndexState()
    replay_into(st, records, generations)
    return st


def replay_into(st: IndexState, records: list[dict],
                generations: dict[str, int]) -> IndexState:
    """Fold ``records`` (log order) INTO an existing state — the shared
    core of full-log :func:`replay` and the snapshot+tail ladder
    (store/snapshot.py): replaying a contiguous record suffix over a
    prefix-fold is exact because records are absolute and replay is
    last-writer-wins."""
    for rec in records:
        st.records += 1
        kind = rec["t"]
        if kind == "retire":
            st.retired.add(rec["arc"])
            # Entries still pointing at the retired archive were either
            # re-pointed by records BEFORE this one (compaction orders
            # re-points first) or are unreachable data — drop them.
            for key in [k for k, e in st.entries.items()
                        if e["arc"] == rec["arc"]]:
                st.drop_key(key)
                st.dropped_missing += 1
                st.dirty = True
                _dropped_counter().labels(reason="missing_archive").inc()
            continue
        if kind == "del":
            st.tombstones += 1
            st.drop_key(rec["key"])
            continue
        arc = rec["arc"]
        if arc in st.retired or arc not in generations:
            st.dropped_missing += 1
            st.dirty = True
            _dropped_counter().labels(reason="missing_archive").inc()
            continue
        if int(rec["gen"]) > generations[arc]:
            # The group that wrote these bytes was rolled back through
            # the archive's journal: the bytes do not exist.
            st.dropped_rolled_back += 1
            st.dirty = True
            _dropped_counter().labels(reason="rolled_back").inc()
            continue
        st.set_entry(rec["key"], {
            "arc": arc, "at": int(rec["at"]), "len": int(rec["len"]),
            "crc": int(rec["crc"]) & 0xFFFFFFFF, "gen": int(rec["gen"]),
        })
    return st


def active_record_count(path: str) -> int:
    """Records currently in the active log — the periodic-checkpoint
    trigger's odometer at load time."""
    return len(read_records(path))


def rewrite(path: str, state: IndexState) -> None:
    """Atomically replace the log with a compacted snapshot of the
    current live state (put records only — tombstoned keys are simply
    absent, retire records for archives whose files are gone are no
    longer needed).  Crash-safe: temp + fsync + rename + dir fsync."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        for key in sorted(state.entries):
            e = state.entries[key]
            fp.write(json.dumps(
                {"t": "put", "key": key, "arc": e["arc"], "at": e["at"],
                 "len": e["len"], "crc": e["crc"], "gen": e["gen"]},
                sort_keys=True) + "\n")
        for arc in sorted(state.retired):
            fp.write(json.dumps({"t": "retire", "arc": arc},
                                sort_keys=True) + "\n")
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    fsync_dir(path)
    state.dirty = False
    state.dropped_rolled_back = 0
    state.dropped_missing = 0
    state.records = len(state.entries) + len(state.retired)
    state.tombstones = 0
