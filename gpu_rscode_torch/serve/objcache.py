"""Zipf-aware hot-object read cache for the daemon's GET /o/ lane.

The port's copy of the JAX package's ``serve/objcache.py``: the same names,
knobs, records and payloads.

Under a realistic skewed key distribution (``rs loadgen
--object-zipf``) the same few hot objects are read over and over, and
each windowed read pays k preads + de-interleave + CRC even when the
bytes were served milliseconds ago.  This LRU short-circuits that:
consulted BEFORE the windowed read lane, capped by
``RS_OBJ_CACHE_BYTES`` (default 64 MiB; 0 disables), one entry per
(tenant, bucket, key).

Staleness is impossible by construction, not by invalidation
discipline: a hit serves only when the cached object's FULL recorded
location — (arc, at, len, crc, gen), captured from the index entry the
fill actually read — still equals the bucket's CURRENT index entry
(``Bucket.entry_for``), and the cached bytes re-verify against that
entry's CRC32 (a hit is as checked as a miss).  Archive ids are never
reused and stripe offsets are append-only, so an equal location tuple
names the same committed bytes forever; any overwrite/delete/
compaction re-point changes the tuple and the stale entry simply stops
matching.  The explicit ``invalidate()`` calls on PUT-overwrite/
DELETE (under the daemon's per-name lock ordering) are hygiene — they
free the bytes immediately instead of waiting for LRU pressure.

Exported as ``rs_obj_cache_*`` metrics and the daemon ``/stats``
``objcache`` block; each GET's verdict rides the per-request wide
event (``cache: hit|miss|bypass``) and the ``X-RS-Cache`` header.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

from ..obs import metrics as _metrics
from ..utils.env import int_env as _int_env

DEFAULT_CACHE_BYTES = 64 * 1024 * 1024


def cache_bytes_env() -> int:
    """``RS_OBJ_CACHE_BYTES`` — cache capacity in bytes (default
    64 MiB; <= 0 disables the cache entirely)."""
    return _int_env("RS_OBJ_CACHE_BYTES", DEFAULT_CACHE_BYTES)


def _loc_tuple(entry: dict) -> tuple:
    return (entry["arc"], int(entry["at"]), int(entry["len"]),
            int(entry["crc"]) & 0xFFFFFFFF, int(entry["gen"]))


def _counter(name: str, help: str):
    return _metrics.counter(name, help)


class ObjectCache:
    """Byte-capped LRU of hot object payloads, location-validated."""

    def __init__(self, cap_bytes: int | None = None):
        self.cap = (cache_bytes_env() if cap_bytes is None
                    else int(cap_bytes))
        self._lock = threading.Lock()
        # (tenant, bucket, key) -> (loc_tuple, bytes); OrderedDict end
        # is most-recently-used.
        self._items: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def enabled(self) -> bool:
        return self.cap > 0

    def get(self, tenant: str, bucket: str, key: str,
            entry: dict) -> bytes | None:
        """The cached payload iff its recorded location equals the
        CURRENT index ``entry`` and the bytes re-verify against the
        entry's CRC32; None (a miss) otherwise."""
        if not self.enabled:
            return None
        ident = (tenant, bucket, key)
        want = _loc_tuple(entry)
        with self._lock:
            item = self._items.get(ident)
            if item is not None and item[0] == want \
                    and zlib.crc32(item[1]) == want[3]:
                self._items.move_to_end(ident)
                self.hits += 1
                _counter("rs_obj_cache_hits_total",
                         "daemon object-cache hits (read lane avoided)"
                         ).inc()
                return item[1]
            if item is not None:
                # Superseded (or, unthinkably, corrupt in memory):
                # drop — the caller refills from the read lane.
                self._drop(ident)
            self.misses += 1
            _counter("rs_obj_cache_misses_total",
                     "daemon object-cache misses").inc()
            return None

    def put(self, tenant: str, bucket: str, key: str, entry: dict,
            data: bytes) -> None:
        """Fill after a read-lane miss: ``entry`` must be the exact
        index entry the read served (``Bucket.get``'s ``info["entry"]``)
        — the validation identity of every future hit."""
        if not self.enabled or len(data) > self.cap:
            return
        ident = (tenant, bucket, key)
        with self._lock:
            self._drop(ident)
            self._items[ident] = (_loc_tuple(entry), bytes(data))
            self._bytes += len(data)
            while self._bytes > self.cap:
                old, (_, blob) = self._items.popitem(last=False)
                self._bytes -= len(blob)
                self.evictions += 1
                _counter("rs_obj_cache_evictions_total",
                         "daemon object-cache LRU evictions").inc()
            self._export()

    def invalidate(self, tenant: str, bucket: str,
                   key: str | None = None) -> None:
        """Hygiene drop on PUT-overwrite/DELETE (one key) or
        compaction/unknown churn (whole bucket, ``key=None``)."""
        if not self.enabled:
            return
        with self._lock:
            if key is not None:
                self.invalidations += self._drop((tenant, bucket, key))
            else:
                doomed = [i for i in self._items
                          if i[0] == tenant and i[1] == bucket]
                for ident in doomed:
                    self.invalidations += self._drop(ident)
            self._export()

    def _drop(self, ident: tuple) -> int:
        item = self._items.pop(ident, None)
        if item is None:
            return 0
        self._bytes -= len(item[1])
        return 1

    def _export(self) -> None:
        _metrics.gauge("rs_obj_cache_bytes",
                       "daemon object-cache resident payload bytes"
                       ).set(self._bytes)
        _metrics.gauge("rs_obj_cache_objects",
                       "daemon object-cache resident objects"
                       ).set(len(self._items))

    def stats(self) -> dict:
        """Schema-stable block for daemon ``/stats`` and rs doctor."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "cap_bytes": self.cap,
                "bytes": self._bytes,
                "objects": len(self._items),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
