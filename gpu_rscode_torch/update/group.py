"""Group-commit write combining: one durability chain for many edits.

A burst of N small updates through :func:`.engine.apply_update` pays N
journal creates and fsyncs, N ``E·Δ`` GEMMs, N crash-safe .METADATA
rewrites and N generation bumps, even when the edits share column windows.
:func:`apply_update_many` takes an ORDERED batch of edits/appends against
one archive and

1. merges them last-writer-wins into a span overlay (sequential semantics:
   edit j sees the total left by appends 1..j-1, and a later edit of the
   same bytes wins: byte-identical to applying the batch one op at a
   time);
2. maps the merged spans to their touched column windows and assembles
   each window block's Δ; adjacent blocks' deltas are stacked into ONE
   staged segment and ONE ``E·Δ`` GEMM (K1 on CUDA) up to the block width;
3. journals the old bytes of EVERY region in the group, then commits the
   whole group under ONE journal fsync chain, ONE ordered patch drain,
   ONE .METADATA rewrite and ONE generation bump.

All-or-nothing: one journal covers the group, so a torn group (a crash at
any ``RS_UPDATE_CRASH`` stage) rolls back EVERY edit through
:func:`.journal.recover`, and no edit is acknowledged before its group is
durable.

``RS_UPDATE_GROUP_WINDOW`` caps the edits one commit group coalesces
(default 1024): a larger batch splits into consecutive groups, each
all-or-nothing with its own generation bump.  ``RS_UPDATE_GROUP_BYTES``
bounds the in-RAM staged write set of one group; past it the engine adds
journal-sync and patch-drain cycles (still one commit).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..codec import RSCodec, entry_device
from ..obs import metrics as _metrics
from ..parallel.io_executor import DrainExecutor
from ..parallel.pipeline import StreamLoop
from ..utils.fileformat import (
    chunk_size_for_layout,
    metadata_file_name,
    read_archive_meta,
    rewrite_metadata_lines,
)
from ..utils.env import int_env as _int_env
from ..utils.timing import PhaseTimer
from . import journal as _journal
from .engine import (
    SimulatedCrash,  # noqa: F401  (re-exported crash surface)
    UpdateError,
    _account_crc,
    _assemble_interleaved_block,
    _assemble_row_block,
    _block_bytes,
    _check_width,
    _collect_block,
    _crash_point,
    _load_payload,
    _observe_commit,
    _open_chunks,
    _parity_coeffs,
    _parity_delta,
)
from .layout import touched_rows, touched_windows

DEFAULT_GROUP_WINDOW = 1024
DEFAULT_GROUP_BYTES = 256 * 1024 * 1024


def group_window() -> int:
    """Max edits one commit group coalesces (``RS_UPDATE_GROUP_WINDOW``,
    >= 1; larger batches split into consecutive groups)."""
    return max(1, _int_env("RS_UPDATE_GROUP_WINDOW", DEFAULT_GROUP_WINDOW))


def _group_bytes_budget() -> int:
    return max(1 << 20, _int_env("RS_UPDATE_GROUP_BYTES", DEFAULT_GROUP_BYTES))


# Process-lifetime tallies of the committed groups.
_STATS_LOCK = threading.Lock()
_STATS = {
    "groups": 0,            # committed window groups
    "edits": 0,             # edits coalesced into those groups
    "bytes": 0,             # payload bytes through grouped commits
    "max_group_seen": 0,    # largest committed group
    "journal_fsyncs": 0,    # journal sync calls across all groups
    "metadata_commits": 0,  # .METADATA rewrites across all groups
}


def group_stats() -> dict:
    """The group-commit tallies plus the effective window."""
    with _STATS_LOCK:
        out = dict(_STATS)
    out["window_max_edits"] = group_window()
    return out


def _tally(edits: int, nbytes: int, journal_fsyncs: int) -> None:
    with _STATS_LOCK:
        _STATS["groups"] += 1
        _STATS["edits"] += edits
        _STATS["bytes"] += nbytes
        _STATS["max_group_seen"] = max(_STATS["max_group_seen"], edits)
        _STATS["journal_fsyncs"] += journal_fsyncs
        _STATS["metadata_commits"] += 1


def _fsync_counter():
    return _metrics.counter(
        "rs_update_group_fsyncs_total",
        "fsync calls in grouped update commits, by chain stage",
    )


class _Overlay:
    """Last-writer-wins byte-span overlay: ascending, disjoint ``(at,
    payload)`` ranges.  A later write splits or trims whatever it overlaps,
    leaving exactly the bytes a sequential application would."""

    def __init__(self):
        self.spans: list[tuple[int, np.ndarray]] = []

    def write(self, at: int, payload: np.ndarray) -> None:
        length = int(payload.shape[0])
        if length == 0:
            return
        end = at + length
        out = []
        for s_at, s_pl in self.spans:
            s_end = s_at + int(s_pl.shape[0])
            if s_end <= at or s_at >= end:
                out.append((s_at, s_pl))
                continue
            if s_at < at:
                out.append((s_at, s_pl[: at - s_at]))
            if s_end > end:
                out.append((end, s_pl[end - s_at :]))
        out.append((at, payload))
        out.sort(key=lambda t: t[0])
        self.spans = out


def _merge_windows(wins: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of column windows: sorted, overlapping or adjacent merged."""
    out: list[list[int]] = []
    for lo, hi in sorted(wins):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _parse_edits(edits) -> list[dict]:
    """Normalize the caller's edit list: each item a dict with ``op``
    ("update" | "append"), ``at`` (update only) and exactly one of
    ``data`` / ``src``.  Payloads load at once (``src`` is memmapped)."""
    parsed = []
    for i, e in enumerate(edits):
        if not isinstance(e, dict):
            raise ValueError(f"edit {i}: want a dict with op/at/data|src, got {type(e).__name__}")
        op = e.get("op", "update")
        if op not in ("update", "append"):
            raise ValueError(f"edit {i}: op must be 'update' or 'append', got {op!r}")
        try:
            payload = _load_payload(e.get("data"), e.get("src"))
        except ValueError as err:
            raise ValueError(f"edit {i}: {err}") from None
        if op == "update":
            if "at" not in e:
                raise ValueError(f"edit {i}: update needs an 'at' offset")
            at = int(e["at"])
            if at < 0:
                raise ValueError(f"edit {i}: negative offset {at}")
        else:
            at = None
        parsed.append({"op": op, "at": at, "payload": payload})
    return parsed


def apply_update_many(
    file_name: str,
    edits,
    *,
    strategy: str = "auto",
    device=None,
    segment_bytes: int = 64 * 1024 * 1024,
    timer: PhaseTimer | None = None,
    group_edits: int | None = None,
    group_tag: str | None = None,
    stage_hook=None,
) -> dict:
    """Apply an ordered batch of edits/appends as group-committed window
    groups: byte-identical to applying them one at a time (module doc).
    ``group_edits`` overrides ``RS_UPDATE_GROUP_WINDOW`` for this call
    (pass the batch's length for ONE all-or-nothing group).
    ``group_tag`` names the commit in the returned summary (``group_id``).
    ``stage_hook`` (``callable(stage_name)``) fires at ``"device_done"``,
    after the last ``E·Δ`` came back and before the journal fsync chain.
    ``device``: where ``E·Δ`` runs; None means CUDA and raises with no GPU
    present.  Returns the aggregate summary dict (``edits``, ``groups``,
    ``windows``, ``segments``, ``chunks_touched``, ``total_size``,
    ``generation``)."""
    timer = timer or PhaseTimer(enabled=False)
    device = entry_device(device, strategy)
    parsed = _parse_edits(edits)
    window = max(1, group_edits) if group_edits else group_window()
    summary: dict | None = None
    groups = 0
    for g0 in range(0, max(1, len(parsed)), window):
        part = _apply_group(
            file_name, parsed[g0 : g0 + window], base=g0, strategy=strategy, device=device,
            segment_bytes=segment_bytes, timer=timer, stage_hook=stage_hook, group_tag=group_tag,
        )
        groups += 1
        if summary is None:
            summary = part
        else:
            for key in ("edits", "bytes", "windows", "segments", "journal_fsyncs"):
                summary[key] += part[key]
            summary["chunks_touched"] = sorted(set(summary["chunks_touched"]) | set(part["chunks_touched"]))
            summary["total_size"] = part["total_size"]
            summary["generation"] = part["generation"]
    assert summary is not None
    summary["groups"] = groups
    if group_tag is not None:
        summary["group_id"] = group_tag
    return summary


def _apply_group(file_name, edits, *, base, strategy, device, segment_bytes, timer, stage_hook=None, group_tag=None):
    from ..ops.gf import get_field

    t_start = time.perf_counter()
    recovered = _journal.recover(file_name)
    meta_path = metadata_file_name(file_name)
    meta = read_archive_meta(meta_path)
    k, p, w = meta.native_num, meta.parity_num, meta.w
    _check_width(meta)
    sym = meta.sym
    total0 = meta.total_size

    # Sequential-semantics validation and the last-writer-wins merge: edit
    # j is validated against the running total its predecessors left.
    overlay = _Overlay()
    total = total0
    payload_bytes = 0
    for i, e in enumerate(edits):
        length = int(e["payload"].shape[0])
        if e["op"] == "update":
            at = e["at"]
            if length and at + length > total:
                raise UpdateError(
                    f"edit {base + i}: update range [{at}, {at + length}) falls outside the archive's {total} bytes "
                    "at that point in the batch; use an append edit to grow it"
                )
        else:
            at = total
            total += length
        payload_bytes += length
        overlay.write(at, e["payload"])
    grow = total > total0

    summary_base = {"op": "group", "edits": len(edits), "bytes": payload_bytes, "layout": meta.layout,
                    "recovered": recovered}
    if not overlay.spans:
        return {**summary_base, "windows": 0, "segments": 0, "chunks_touched": [], "journal_fsyncs": 0,
                "total_size": total0, "generation": meta.generation}

    gf = get_field(w)
    E = _parity_coeffs(meta, gf)
    chunk_old = meta.chunk
    if grow:
        chunk_new = chunk_size_for_layout(total, k, sym, meta.layout)
        if meta.layout == "row" and chunk_new != chunk_old:
            slack = k * chunk_old - total0
            raise UpdateError(
                f"group appends {total - total0} byte(s), overflowing the row-major archive's {slack} byte(s) of "
                "tail-padding slack (growing the chunk size would re-stripe every byte); re-encode, or encode with "
                "--layout interleaved for unbounded appends"
            )
    else:
        chunk_new = chunk_old
        if chunk_old == 0:
            raise UpdateError("zero-size archive has nothing to update")

    wins: list[tuple[int, int]] = []
    rows_set: set[int] = set()
    for at, pl in overlay.spans:
        length = int(pl.shape[0])
        wins += touched_windows(meta.layout, at, length, k, sym, chunk_new)
        rows_set |= set(touched_rows(meta.layout, at, length, k, chunk_new))
    windows = _merge_windows(wins)
    rows = sorted(rows_set)
    all_idx = rows + [i for i in range(k, k + p) if i not in rows]

    fps: dict[int, object] = {}
    try:
        with timer.phase("update setup"):
            _open_chunks(file_name, all_idx, chunk_old, fps)
            codec = RSCodec(k, p, w=w, strategy=strategy, device=device)
            step = _block_bytes(k, sym, segment_bytes)
            loop = StreamLoop(codec.device, k, min(step, sum(hi - lo for lo, hi in windows)), 1)
            jr = _journal.Journal(file_name, meta.generation, "group", {i: chunk_old for i in all_idx})
        crcs = dict(meta.crcs) if meta.crcs else None
        touched: set[int] = set()
        blocks = 0
        journal_fsyncs = 0
        committed = False
        try:
            budget = _group_bytes_budget()
            # Writes journaled but not yet submitted to the lane: the whole
            # group's set in the common case, so ONE journal sync covers
            # everything before the first chunk byte changes.
            pending: list[tuple[int, int, bytes]] = []
            pending_bytes = 0
            first_n_native = None

            with DrainExecutor(ordered=True, name="rs-io-patch") as lane:

                def drain_pending():
                    nonlocal pending, pending_bytes, journal_fsyncs
                    journal_fsyncs += jr.sync()
                    for idx, off, new in pending:
                        lane.submit_pwrite(fps[idx].fileno(), new, off)
                        touched.add(idx)
                    lane.flush()
                    pending = []
                    pending_bytes = 0

                # Small-window stacking: adjacent blocks' deltas go into
                # ONE staged segment and ONE E·Δ GEMM up to the block
                # width; a full-width block goes alone, as in the
                # single-op engine.
                batch: list[tuple] = []  # (b0, b1, delta, native_writes)
                batch_w = 0

                def flush_batch():
                    nonlocal batch, batch_w, blocks, pending_bytes, first_n_native
                    if not batch:
                        return
                    stacked = batch[0][2] if len(batch) == 1 else np.hstack([blk[2] for blk in batch])
                    span_args = {"op": "group", "off": int(batch[0][0]), "cols": int(stacked.shape[1])}
                    if group_tag is not None:
                        # The trace side of the group <-> request join.
                        span_args["group"] = group_tag
                    pd_np = _parity_delta(loop, codec, E, stacked, sym, timer, **span_args)
                    col = 0
                    for b0, b1, delta, nat in batch:
                        bw = b1 - b0
                        writes, n_native = _collect_block(b0, b1, delta, nat, pd_np[:, col : col + bw], fps,
                                                          chunk_old, k, p, meta.layout, timer)
                        col += bw
                        with timer.phase("update journal (io)"):
                            for idx, off, old, new in writes:
                                jr.record(idx, off, old[: max(0, chunk_old - off)])
                                pending.append((idx, off, new))
                                pending_bytes += len(new) + len(old)
                        if crcs is not None:
                            with timer.phase("update crc"):
                                for idx, off, old, new in writes:
                                    _account_crc(crcs, idx, off, old, new, chunk_old)
                        blocks += 1
                        if first_n_native is None:
                            first_n_native = n_native
                    batch = []
                    batch_w = 0
                    if pending_bytes > budget:
                        # RAM guard for huge groups: an extra sync and drain
                        # cycle, still one commit (journal before patch
                        # holds per cycle).
                        drain_pending()

                for wlo, whi in windows:
                    for b0 in range(wlo, whi, step):
                        b1 = min(b0 + step, whi)
                        if batch_w + (b1 - b0) > step:
                            flush_batch()
                        with timer.phase("update stage (io)"):
                            if meta.layout == "interleaved":
                                delta, nat = _assemble_interleaved_block(b0, b1, fps, overlay.spans, k, sym)
                            else:
                                delta, nat = _assemble_row_block(b0, b1, rows, fps, overlay.spans, chunk_old, k)
                        batch.append((b0, b1, delta, nat))
                        batch_w += b1 - b0
                flush_batch()
                if stage_hook is not None:
                    # Every E·Δ is back on the host; what follows is
                    # durability (journal sync, patch drain, chunk fsyncs,
                    # the metadata commit).
                    stage_hook("device_done")

                with timer.phase("update journal (io)"):
                    journal_fsyncs += jr.sync()
                _crash_point("after_journal")
                cut = min(first_n_native or 0, len(pending)) or None
                with timer.phase("update patch (io)"):
                    for pos, (idx, off, new) in enumerate(pending):
                        if pos == cut:
                            # The first block's natives patched, its parity
                            # and every later window not: the torn-group
                            # state recovery must undo in full.
                            lane.flush()
                            _crash_point("mid_patch")
                        lane.submit_pwrite(fps[idx].fileno(), new, off)
                        touched.add(idx)
                    pending = []
                    lane.flush()

            with timer.phase("update fsync (io)"):
                for fp in fps.values():
                    os.fsync(fp.fileno())
            _fsync_counter().labels(stage="chunks").inc(len(fps))
            _crash_point("before_commit")
            with timer.phase("write metadata (io)"):
                new_gen = rewrite_metadata_lines(meta_path, total_size=total if grow else None, crcs=crcs,
                                                 bump_generation=True)
            jr.close(commit=True)
            committed = True
        except SimulatedCrash:
            jr.close(commit=False)  # the disk stays torn; recover() heals it
            raise
        except BaseException:
            if not committed:
                # All-or-nothing: roll the WHOLE group back from the durable
                # journal (the machinery a hard crash uses).
                jr.close(commit=False)
                _journal.recover(file_name)
            raise
    finally:
        for fp in fps.values():
            if not fp.closed:
                fp.close()

    _fsync_counter().labels(stage="journal").inc(journal_fsyncs)
    _fsync_counter().labels(stage="metadata").inc()
    _metrics.histogram(
        "rs_update_group_size",
        "edits coalesced per committed update group",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    ).observe(len(edits))
    _metrics.counter(
        "rs_update_group_coalesced_bytes_total",
        "payload bytes applied through grouped update commits",
    ).inc(payload_bytes)
    _observe_commit("group", payload_bytes, blocks, t_start)
    _tally(len(edits), payload_bytes, journal_fsyncs)
    return {
        **summary_base,
        "windows": len(windows),
        "segments": blocks,
        "journal_fsyncs": journal_fsyncs,
        "chunks_touched": sorted(touched),
        "total_size": total,
        "generation": new_gen,
    }
