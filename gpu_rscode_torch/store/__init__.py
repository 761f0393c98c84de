"""Object store: many small objects in shared erasure-coded stripes.

The packing layer over the archive model (docs/STORE.md): a **bucket**
maps many small objects into a handful of shared stripe archives, one
durable object index (key -> archive, byte range, CRC, generation pin)
instead of per-object metadata, chunks and journals.  PUT appends into
the open stripe through the group-commit lane, GET reconstructs just the
object's byte range (touched column windows only), DELETE is a tombstone
plus delete-as-update zeroing, and compaction retires dead-heavy archives
all-or-nothing.  Every GEMM of these paths runs on the bucket's device
(K1 on CUDA).

Surfaces: the ``api.put_object`` / ``get_object`` / ... wrappers and the
``rs object`` CLI (:mod:`.cli`).
"""

from .bucket import (  # noqa: F401
    Bucket,
    ObjectNotFound,
    ObjectStoreError,
    cached_bucket,
    compact_dead_frac,
    decode_cursor,
    drop_cached,
    encode_cursor,
    list_buckets,
    open_bucket,
    probe,
    stripe_bytes_env,
)
from .readpath import RangeReadError, read_range  # noqa: F401
from .snapshot import (  # noqa: F401
    checkpoint,
    list_segments,
    list_snapshots,
    load_ladder,
    snapshot_keep_env,
    snapshot_records_env,
)
