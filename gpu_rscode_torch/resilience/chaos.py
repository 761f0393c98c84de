"""Seeded chaos harness — ``rs chaos``: the port's copy of the JAX
package's ``resilience/chaos.py``, schedule for schedule.

The differential loop the whole resilience subsystem is verified by:

    seeded encode -> corrupt per schedule -> scrub / auto-decode / repair
    -> differential-check every output against the host GF oracle

Every iteration is a pure function of ``(seed, iteration)``: the config
(k, p, w, size), the file bytes, the corruption schedule (bitrot /
torn-write truncation / unlink) and the fault plan injected during the
recovery phase (read ioerror, delay, chunk-scoped mid-stream faults) all
derive from one ``random.Random`` stream, and the fault plane's own
decisions hash from the same derived seed — so ``rs chaos --seed S`` is
bit-reproducible: the same seed yields the same schedule and the same
pass/fail verdict every run, anywhere (targets are keyed by basename,
never by temp-dir path).

``--silent`` selects the SILENT corruption class instead
(:func:`plan_silent_iteration`): CRC-less bitrot proven recovered — or
refused — by the error-locating decode path (gf_decode/,
docs/RESILIENCE.md "Error location").  Its schedules derive from their
own seed stream, so the classic classes' digests are unchanged by its
existence.

Checks per iteration (any miss is a failure):

* encode differential: every chunk file byte-equals the host oracle's
  encode of the same data (the port's own :class:`..ops.gf.GaloisField`,
  both widths);
* scrub exactness: ``scan_file`` reports exactly the damaged chunks, and
  its ``decodable`` verdict matches the schedule's damage count vs p;
* recoverable archives: ``auto_decode_file`` output byte-equals the
  original AND an independent oracle decode of the conf it chose;
  ``repair_file`` rebuilds exactly the damaged set and leaves every
  chunk byte-equal to the oracle encode;
* unrecoverable archives (damage > p): decode and repair must raise
  (never fabricate bytes), and surviving chunks must be left untouched.

A failing iteration is shrunk greedily — drop one schedule event (or the
fault plan) at a time, keep what still fails — and reported as ONE line::

    REPRODUCE: {"seed": S, "iter": I, "k": .., "events": [..], ...}

which ``rs chaos --repro '<that json>'`` replays directly (``--seed S
--only I`` replays the unshrunk original).  Outcomes are recorded through
the run ledger (``RS_RUNLOG``, obs/runlog.py) as ``op="chaos_iter"``
records plus the ``rs_chaos_iterations_total{verdict}`` counter.

Every iteration runs on one device (``--device``, CUDA by default: every
encode, decode, repair, update and object GEMM of the schedule runs K1
there; with no GPU and no ``--device`` the harness refuses).  The verdict
rows hold only ints, strings and bools, so a seed's digests do not depend
on the device: the card must reproduce the JAX package's.
"""

from __future__ import annotations

import functools
import json
import os
import random
import shutil
import sys
import tempfile
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace

from ..obs import metrics as _metrics, runlog as _runlog
from . import faults as _faults, retry as _retry

# Small segments force multi-segment streaming even for the harness's
# small files, so the mid-stream (degraded decode) paths actually run.
_SEGMENT_BYTES = 4096

# The bit-reproducibility contract requires verdicts to be a function of
# the seed ALONE, so every knob the recovery path reads from the env is
# pinned for the iteration's duration: ambient RS_RETRY_* would change
# how many injected faults are absorbed (RS_RETRY_ATTEMPTS=0 fails seeds
# verified green; a high value silently skips the degraded-swap path the
# times= budgets are tuned to), and an ambient RS_FAULTS would stack a
# second schedule under iterations that planned none.
_PINNED_ENV = {
    "RS_FAULTS": None,          # the iteration's plan activates explicitly
    "RS_FAULTS_SEED": None,
    "RS_RETRY_ATTEMPTS": "3",   # the default the times= fire budgets match
    "RS_RETRY_BASE_MS": "1",
    "RS_RETRY_MAX_MS": "20",
    "RS_RETRY_SEED": "0",
    "RS_RETRY_BUDGET": "256",
    "RS_RETRY_RESELECT": "3",
    "RS_RETRY_SUBSET_ATTEMPTS": "3",
    # The silent class's verdicts hinge on the locate escalation rung:
    # an ambient RS_LOCATE=off would flip every recoverable silent
    # iteration to a failure.  Pin the default (auto).
    "RS_LOCATE": None,
    # The update class drives the crash knob itself, per scheduled op;
    # an ambient value would tear every un-scheduled update too.
    "RS_UPDATE_CRASH": None,
    # The grouped-update class's torn groups must tear as ONE window
    # group: an ambient small window would split a scheduled group into
    # several commits, so the "torn group rolls back ALL edits" check
    # would see the earlier sub-groups legitimately committed.
    "RS_UPDATE_GROUP_WINDOW": None,
    # The object class's schedules carry their own stripe/compaction
    # geometry in the config; ambient store knobs would change which
    # puts roll stripes and which archives compact — verdict drift.
    "RS_STORE_STRIPE_BYTES": None,
    "RS_STORE_COMPACT_DEAD_FRAC": None,
    "RS_STORE_K": None,
    "RS_STORE_P": None,
    # Index snapshots must FIRE under the object class's torn-op
    # schedules (a checkpoint every 32 records lands several per
    # iteration) without moving any verdict: the snapshot plane changes
    # how the index is reloaded, never what it says — the class digest
    # is the proof.  An ambient disable/keep would skip or prune that
    # coverage.
    "RS_STORE_SNAPSHOT_RECORDS": "32",
    "RS_STORE_SNAPSHOT_KEEP": None,
    "RS_STORE_SNAPSHOT_DISABLE": None,
    # The maint class drives the controller directly (and the crash
    # knob per schedule); ambient maint knobs would change job pacing,
    # lease lifetimes or inject crashes into every other class's
    # repairs — verdict drift.
    "RS_MAINT": None,
    "RS_MAINT_TENANT": None,
    "RS_MAINT_BYTES_PER_S": None,
    "RS_MAINT_BURN_PAUSE": None,
    "RS_MAINT_RESUME": None,
    "RS_MAINT_LEASE_S": None,
    "RS_MAINT_INTERVAL_S": None,
    "RS_MAINT_CRASH": None,
}


@contextmanager
def _pinned_env():
    saved = {k: os.environ.get(k) for k in _PINNED_ENV}
    try:
        for k, v in _PINNED_ENV.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _api_on(device) -> SimpleNamespace:
    """The api entry points an iteration calls, with ``device`` bound
    (``recover_archive`` computes nothing and takes none)."""
    from .. import api

    names = ("encode_file", "scan_file", "auto_decode_file", "locate_decode_file", "repair_file", "update_file",
             "append_file", "update_file_many")
    return SimpleNamespace(recover_archive=api.recover_archive,
                           **{name: functools.partial(getattr(api, name), device=device) for name in names})


class ChaosFailure(Exception):
    """One iteration's verdict went wrong; ``cfg`` is the iteration
    config that reproduces it."""

    def __init__(self, cfg: dict, what: str):
        self.cfg = cfg
        self.what = what
        super().__init__(f"iter {cfg.get('iter')}: {what}")


def _iter_rng(seed: int, i: int) -> random.Random:
    return random.Random(f"rs-chaos:{seed}:{i}")


def plan_silent_iteration(seed: int, i: int, max_bytes: int = 49152) -> dict:
    """The ``silent`` corruption class: bitrot with CRC verification
    DISABLED (archives encoded without checksum lines), recovered by the
    error-locating decode path (gf_decode/, ``rs decode --locate``).

    Schedule grammar: every event is ``{"kind": "silent", "chunk": c,
    ...}`` with either sparse distinct bit flips (``count``) or a dense
    random-byte window (``dense: [off, len]``).  Two flavors per seed
    stream:

    * recoverable — at most ``t = floor(p/2)`` damaged chunks, sparse
      flips: every symbol column carries <= t errors, so the locate
      decoder must recover BIT-IDENTICALLY and the syndrome scrub must
      attribute exactly the damaged chunk set (no CRCs involved);
    * unrecoverable (> t) — t+1.. chunks damaged over one SHARED dense
      window with nonzero random bytes: the window's columns all carry
      > t errors, so decode must FAIL LOUDLY (never fabricate bytes) and
      the scrub verdict must be ``unlocatable``.

    Deterministic from ``(seed, i)`` on its own derived stream
    (``rs-chaos-silent:*``) — the classic classes' schedules (seeded
    from ``rs-chaos:*``) are byte-identical with or without this class
    existing, so pinned CI seeds keep their verdict digests.
    """
    rng = random.Random(f"rs-chaos-silent:{seed}:{i}")
    k = rng.randint(2, 6)
    p = rng.randint(2, 4)          # p >= 2: t >= 1, location possible
    w = 16 if rng.random() < 0.2 else 8
    size = rng.randint(256, max_bytes)
    t = p // 2
    overkill = rng.random() < 0.3
    if overkill:
        n_damage = rng.randint(t + 1, min(k + p, p + 2))
    else:
        n_damage = rng.randint(0, t)
    targets = sorted(rng.sample(range(k + p), n_damage))
    events = []
    if overkill and targets:
        # One SHARED window across all victims: those columns all carry
        # n_damage > t errors — provably past the locate bound.
        from ..utils.fileformat import chunk_size_for

        chunk = chunk_size_for(size, k, w // 8)
        ln = max(w // 8, min(chunk, rng.randint(16, 512)))
        off = rng.randint(0, max(0, chunk - ln))
        for c in targets:
            events.append({"kind": "silent", "chunk": c,
                           "dense": [off, ln]})
    else:
        for c in targets:
            events.append({"kind": "silent", "chunk": c,
                           "count": rng.randint(1, 12)})
    return {
        "seed": seed,
        "iter": i,
        "mode": "silent",
        "k": k,
        "p": p,
        "w": w,
        "size": size,
        "events": events,
        "faults": "",
    }


def plan_update_iteration(seed: int, i: int, max_bytes: int = 49152) -> dict:
    """The ``update`` workload class (``rs chaos --update``): a random
    schedule of in-place edits, appends and TORN ops (RS_UPDATE_CRASH
    at a random stage) against one archive, on its own derived seed
    stream (``rs-chaos-update:*`` — classic/silent digests unchanged).

    Validation per the ROADMAP's stated contract: after the schedule,
    the delta-updated/appended archive must be byte-identical — every
    chunk file AND every CRC line — to a from-scratch full re-encode of
    the final logical bytes, scrub must report it fully healthy, and
    auto-decode must return exactly those bytes.  Every torn op must
    roll back to the byte-exact pre-op archive via the journal.
    """
    rng = random.Random(f"rs-chaos-update:{seed}:{i}")
    k = rng.randint(2, 6)
    p = rng.randint(1, 3)
    w = 16 if rng.random() < 0.2 else 8
    layout = "interleaved" if rng.random() < 0.6 else "row"
    size = rng.randint(64, max_bytes)
    sym = w // 8
    from ..utils.fileformat import chunk_size_for_layout

    chunk0 = chunk_size_for_layout(size, k, sym, layout)
    total = size
    ops = []
    for _ in range(rng.randint(1, 5)):
        kinds = ["update", "update", "crash_update"]
        if layout == "interleaved":
            kinds += ["append", "append", "crash_append"]
        else:
            # Row-major appends are slack-bounded: schedule one only
            # while it provably fits (chunk size unchanged).
            if k * chunk0 - total > 0:
                kinds.append("append")
        kind = rng.choice(kinds)
        if kind.endswith("update"):
            at = rng.randrange(0, total)
            ln = rng.randint(1, min(4096, total - at))
            op = {"op": "update", "at": at, "len": ln}
        else:
            ln = (
                rng.randint(1, 4096) if layout == "interleaved"
                else rng.randint(1, k * chunk0 - total)
            )
            op = {"op": "append", "len": ln}
        if kind.startswith("crash"):
            op["crash"] = rng.choice(
                ["after_journal", "mid_patch", "before_commit"]
            )
        elif op["op"] == "append":
            total += ln
        ops.append(op)
    faults = ""
    if rng.random() < 0.3:
        # Transient write hiccups on the patch lane: the bounded retry
        # plane must absorb them without changing any verdict.
        faults = "write:delay@ms=1,p=0.05"
    return {
        "seed": seed,
        "iter": i,
        "mode": "update",
        "k": k,
        "p": p,
        "w": w,
        "layout": layout,
        "size": size,
        "events": ops,
        "faults": faults,
    }


def plan_update_group_iteration(seed: int, i: int,
                                max_bytes: int = 49152) -> dict:
    """The GROUPED update workload class (``rs chaos --update --group``):
    random schedules of group-committed edit batches against one archive
    — each event is one ``api.update_file_many`` call of 1..6 mixed
    edits/appends, some torn (RS_UPDATE_CRASH at a random stage
    mid-group), on its OWN derived seed stream
    (``rs-chaos-update-group:*`` — the classic/silent/update classes'
    schedules and digests are untouched by this class existing).

    Validation per group: a torn group must roll back EVERY edit in the
    batch byte-exactly (one journal covers the whole window group); a
    committed group must leave the archive byte-identical to applying
    its edits sequentially (the tracked mirror), healthy under scrub,
    and — after the whole schedule — chunk- and CRC-identical to a
    from-scratch re-encode twin of the final logical bytes."""
    rng = random.Random(f"rs-chaos-update-group:{seed}:{i}")
    k = rng.randint(2, 6)
    p = rng.randint(1, 3)
    w = 16 if rng.random() < 0.2 else 8
    layout = "interleaved" if rng.random() < 0.6 else "row"
    size = rng.randint(256, max_bytes)
    from ..utils.fileformat import chunk_size_for_layout

    chunk0 = chunk_size_for_layout(size, k, w // 8, layout)
    total = size
    events = []
    for _ in range(rng.randint(1, 4)):
        gtotal = total
        edits = []
        for _ in range(rng.randint(1, 6)):
            kinds = ["update", "update"]
            if layout == "interleaved":
                kinds.append("append")
            elif k * chunk0 - gtotal > 0:
                kinds.append("append")
            kind = rng.choice(kinds)
            if kind == "update":
                at = rng.randrange(0, gtotal)
                ln = rng.randint(1, min(2048, gtotal - at))
                edits.append({"op": "update", "at": at, "len": ln})
            else:
                ln = (
                    rng.randint(1, 2048) if layout == "interleaved"
                    else rng.randint(1, k * chunk0 - gtotal)
                )
                edits.append({"op": "append", "len": ln})
                gtotal += ln
        ev = {"group": edits}
        if rng.random() < 0.35:
            ev["crash"] = rng.choice(
                ["after_journal", "mid_patch", "before_commit"]
            )
        else:
            total = gtotal  # only a committed group advances the size
        events.append(ev)
    faults = ""
    if rng.random() < 0.3:
        faults = "write:delay@ms=1,p=0.05"
    return {
        "seed": seed,
        "iter": i,
        "mode": "update_group",
        "k": k,
        "p": p,
        "w": w,
        "layout": layout,
        "size": size,
        "events": events,
        "faults": faults,
    }


def plan_object_iteration(seed: int, i: int,
                          max_bytes: int = 49152) -> dict:
    """The OBJECT-STORE workload class (``rs chaos --object``): seeded
    PUT/DELETE/compact schedules against one bucket, some ops torn at a
    random ``RS_UPDATE_CRASH`` stage, on its OWN derived seed stream
    (``rs-chaos-object:*`` — every other class's schedules and digests
    are untouched).

    Contract checked per event and at the end (store/bucket.py): the
    bucket's live contents stay byte-identical to a sequential mirror
    that applies exactly the COMMITTED ops — a torn PUT batch commits
    nothing (its index records are invalidated through the archive's
    journal rollback: the index never references bytes a rolled-back
    group wrote), a torn DELETE is committed (the tombstone fsyncs
    before the zeroing patch), and a torn compaction leaves either the
    old archive or the new locations fully live.  Every GET is
    byte-exact or a clean 404 — never silently wrong."""
    rng = random.Random(f"rs-chaos-object:{seed}:{i}")
    k = rng.randint(2, 5)
    p = rng.randint(1, 3)
    w = 16 if rng.random() < 0.2 else 8
    stripe_bytes = rng.choice([4096, 8192, 16384])
    keys = [f"obj{j}" for j in range(rng.randint(3, 8))]
    put_ever: set[str] = set()
    events = []
    for _ in range(rng.randint(5, 12)):
        roll = rng.random()
        if roll < 0.55 or not put_ever:
            batch = [
                {"key": rng.choice(keys),
                 "len": rng.randint(64, min(4096, max_bytes))}
                for _ in range(rng.randint(1, 4))
            ]
            ev = {"op": "put", "batch": batch}
            put_ever.update(b["key"] for b in batch)
        elif roll < 0.8:
            ev = {"op": "delete", "key": rng.choice(sorted(put_ever))}
        else:
            ev = {"op": "compact", "force": rng.random() < 0.5}
        if rng.random() < 0.3:
            ev["crash"] = rng.choice(
                ["after_journal", "mid_patch", "before_commit"]
            )
        events.append(ev)
    return {
        "seed": seed,
        "iter": i,
        "mode": "object",
        "k": k,
        "p": p,
        "w": w,
        "stripe_bytes": stripe_bytes,
        "keys": keys,
        "events": events,
        "faults": "",
    }


def plan_health_iteration(seed: int, i: int, max_bytes: int = 49152) -> dict:
    """The ``health`` convergence class: prove the fleet durability
    plane (obs/health.py, docs/HEALTH.md) tracks reality end to end —
    induced damage surfaces at the TOP of the risk ranking with the
    exact per-chunk damage map, repair clears it, and replaying the
    damage ledger is restart-stable (snapshot+delta replay byte-equal to
    pure-delta replay from genesis).

    Each iteration runs a small fleet (2-4 archives, one designated
    victim) against its own private ledger; damage is 1..p chunks of the
    victim — always within the repair bound, because the contract under
    test is CONVERGENCE (damage -> ranked -> repaired -> cleared), the
    unrecoverable verdicts belong to the classic/silent classes.

    Deterministic from ``(seed, i)`` on its own derived stream
    (``rs-chaos-health:*``); verdict rows carry only ints/bools (never
    risk floats or timestamps — risk depends on wall-clock scrub age),
    so the verdict digest stays a function of the seed alone.
    """
    rng = random.Random(f"rs-chaos-health:{seed}:{i}")
    k = rng.randint(2, 5)
    p = rng.randint(1, 3)
    w = 16 if rng.random() < 0.2 else 8
    n_archives = rng.randint(2, 4)
    sizes = [rng.randint(256, max_bytes) for _ in range(n_archives)]
    victim = rng.randrange(n_archives)
    n_damage = rng.randint(1, p)
    targets = sorted(rng.sample(range(k + p), n_damage))
    events = []
    for c in targets:
        kind = rng.choice(("bitrot", "torn", "unlink"))
        if kind == "bitrot":
            events.append({"kind": "bitrot", "chunk": c,
                           "count": rng.randint(1, 64)})
        elif kind == "torn":
            events.append({"kind": "torn", "chunk": c,
                           "keep_frac": rng.random() * 0.9})
        else:
            events.append({"kind": "unlink", "chunk": c})
    return {
        "seed": seed,
        "iter": i,
        "mode": "health",
        "k": k,
        "p": p,
        "w": w,
        "archives": n_archives,
        "sizes": sizes,
        "victim": victim,
        "events": events,
        "faults": "",
    }


def plan_maint_iteration(seed: int, i: int, max_bytes: int = 49152) -> dict:
    """The MAINT convergence class (``rs chaos --maint``): prove the
    background-maintenance plane (maint/controller.py, docs/MAINT.md)
    converges through crashes.  Each iteration builds a small fleet
    with one damaged victim plus a store bucket driven dead-heavy by a
    seeded put/delete schedule, then drains a :class:`MaintController`
    that may be killed (``RS_MAINT_CRASH``) at a random job stage —
    after claiming a repair, mid-repair before the clean rescan, after
    claiming a scrub, or before/after a compaction.  A second
    controller with the SAME owner (the restarted daemon) must then
    converge: empty work queue, zero pending compactions, the victim's
    chunks byte-identical to their pre-damage snapshot, the bucket's
    live objects byte-identical to a sequential mirror, and
    snapshot+delta ledger replay equal to pure-delta replay even with a
    live claim checkpointed mid-history.

    Deterministic from ``(seed, i)`` on its own derived stream
    (``rs-chaos-maint:*`` — the classic/silent/update/object/health
    schedules and digests are untouched by this class existing).
    """
    rng = random.Random(f"rs-chaos-maint:{seed}:{i}")
    k = rng.randint(2, 4)
    p = rng.randint(1, 2)
    w = 8
    n_archives = rng.randint(2, 3)
    sizes = [rng.randint(256, max_bytes) for _ in range(n_archives)]
    victim = rng.randrange(n_archives)
    n_damage = rng.randint(1, p)
    targets = sorted(rng.sample(range(k + p), n_damage))
    events = []
    for c in targets:
        kind = rng.choice(("bitrot", "torn", "unlink"))
        if kind == "bitrot":
            events.append({"kind": "bitrot", "chunk": c,
                           "count": rng.randint(1, 64)})
        elif kind == "torn":
            events.append({"kind": "torn", "chunk": c,
                           "keep_frac": rng.random() * 0.9})
        else:
            events.append({"kind": "unlink", "chunk": c})
    # Bucket schedule: small stripes + deleting most objects drives
    # sealed archives past RS_STORE_COMPACT_DEAD_FRAC deterministically.
    stripe_bytes = rng.choice([4096, 8192])
    n_objects = rng.randint(4, 7)
    puts = [{"key": f"o{j}", "len": rng.randint(64, 2048)}
            for j in range(n_objects)]
    keep = rng.randint(1, 2)
    kept = set(rng.sample([pt["key"] for pt in puts], keep))
    deletes = [pt["key"] for pt in puts if pt["key"] not in kept]
    crash = rng.choice([None, "repair:claimed", "repair:mid",
                        "scrub:claimed", "compact:claimed",
                        "compact:done"])
    return {
        "seed": seed,
        "iter": i,
        "mode": "maint",
        "k": k,
        "p": p,
        "w": w,
        "archives": n_archives,
        "sizes": sizes,
        "victim": victim,
        "events": events,
        "stripe_bytes": stripe_bytes,
        "puts": puts,
        "deletes": deletes,
        "crash": crash,
        "faults": "",
    }


def plan_iteration(seed: int, i: int, max_bytes: int = 49152) -> dict:
    """The deterministic schedule for iteration ``i`` of master ``seed``."""
    rng = _iter_rng(seed, i)
    k = rng.randint(2, 6)
    p = rng.randint(1, 3)
    w = 16 if rng.random() < 0.2 else 8
    size = rng.randint(1, max_bytes)
    # ~15% of iterations damage MORE than p chunks: the harness must also
    # prove the stack says "unrecoverable" instead of fabricating bytes.
    overkill = rng.random() < 0.15
    n_damage = (
        rng.randint(p + 1, min(k + p, p + 2)) if overkill
        else rng.randint(0, p)
    )
    targets = sorted(rng.sample(range(k + p), n_damage))
    events = []
    for t in targets:
        kind = rng.choice(["bitrot", "torn", "unlink"])
        if kind == "bitrot":
            events.append({"kind": "bitrot", "chunk": t,
                           "count": rng.randint(1, 16)})
        elif kind == "torn":
            # A torn write: only a prefix of the chunk landed.
            events.append({"kind": "torn", "chunk": t,
                           "keep_frac": round(rng.random() * 0.9, 3)})
        else:
            events.append({"kind": "unlink", "chunk": t})
    fault_bits = []
    if rng.random() < 0.5:
        fault_bits.append(
            f"read:ioerror@p={round(rng.uniform(0.005, 0.03), 4)}"
        )
    if rng.random() < 0.25:
        fault_bits.append("read:delay@ms=1,p=0.05")
    healthy_natives = [c for c in range(k) if c not in targets]
    if (
        rng.random() < 0.5
        and 0 < len(targets) < p          # spare healthy chunks exist
        and any(t < k for t in targets)   # recovery decode, not passthrough
        and healthy_natives
    ):
        # A healthy NATIVE that dies MID-STREAM (its open is fine, the
        # later segment gathers fail, bounded by times=): natives-first
        # selection guarantees it is a chosen survivor of a recovery
        # decode, so the fault really fires and exercises degraded
        # decode's in-place survivor swap + resume.  Pinned to the read
        # boundary so scrub CRC passes don't consume the fire budget.
        victim = rng.choice(healthy_natives)
        fault_bits.append(
            f"chunk{victim}:ioerror@from=2,times=4,scope=read"
        )
    return {
        "seed": seed,
        "iter": i,
        "k": k,
        "p": p,
        "w": w,
        "size": size,
        "events": events,
        "faults": ";".join(fault_bits),
    }


# -- oracle -------------------------------------------------------------------


def _oracle_chunks(data: bytes, k: int, p: int, w: int, total_mat):
    """Every chunk's bytes per the host oracle: natives are straight
    zero-padded stripes; parity is the GF host product."""
    import numpy as np

    from ..ops.gf import get_field
    from ..utils.fileformat import chunk_size_for

    sym = w // 8
    chunk = chunk_size_for(len(data), k, sym)
    padded = np.zeros(k * chunk, dtype=np.uint8)
    padded[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    natives = padded.reshape(k, chunk)
    gf = get_field(w)
    mat = np.asarray(total_mat, dtype=gf.dtype)[k:]
    parity = np.ascontiguousarray(
        gf.matmul(mat, natives.view(gf.dtype))
    ).view(np.uint8)
    return [natives[i].tobytes() for i in range(k)] + [
        parity[j].tobytes() for j in range(p)
    ]


def _oracle_decodable(total_mat, healthy, k: int, w: int) -> bool:
    """Ground-truth decodability: some k-subset of the healthy chunks
    inverts under the host oracle.  Exhaustive — the harness's chunk
    counts keep the combination space tiny — so scrub's verdict is
    checked against truth even for non-MDS Vandermonde corners where
    "damage <= p" over-promises."""
    from itertools import combinations

    import numpy as np

    from ..ops.gf import get_field
    from ..ops.inverse import SingularMatrixError, invert_matrix

    if len(healthy) < k:
        return False
    gf = get_field(w)
    mat = np.asarray(total_mat, dtype=gf.dtype)
    for subset in combinations(healthy, k):
        try:
            invert_matrix(mat[list(subset)], gf)
            return True
        except SingularMatrixError:
            continue
    return False


def _oracle_decode(in_file: str, conf_path: str, total_size: int, k: int,
                   w: int, total_mat) -> bytes:
    """Independent host reconstruction from the conf the decode under
    test actually used — the differential witness."""
    import numpy as np

    from ..ops.gf import get_field
    from ..ops.inverse import invert_matrix
    from ..utils.fileformat import (
        chunk_size_for, parse_chunk_index, read_conf,
    )

    sym = w // 8
    chunk = chunk_size_for(total_size, k, sym)
    names = read_conf(conf_path)
    rows = [parse_chunk_index(nm) for nm in names]
    base = os.path.dirname(os.path.abspath(in_file))
    stacked = np.stack([
        np.fromfile(os.path.join(base, os.path.basename(nm)),
                    dtype=np.uint8, count=chunk)
        for nm in names
    ])
    gf = get_field(w)
    sub = np.asarray(total_mat, dtype=gf.dtype)[rows]
    inv = invert_matrix(sub, gf)
    out = np.ascontiguousarray(
        gf.matmul(inv, stacked.view(gf.dtype))
    ).view(np.uint8)
    return out.reshape(-1).tobytes()[:total_size]


# -- one iteration ------------------------------------------------------------


def _apply_events(fname: str, events, chunk: int, rng: random.Random) -> None:
    from ..utils.fileformat import chunk_file_name

    for ev in events:
        path = chunk_file_name(fname, ev["chunk"])
        if ev["kind"] == "unlink":
            os.unlink(path)
        elif ev["kind"] == "torn":
            keep = int(chunk * ev["keep_frac"])
            if keep >= chunk:
                keep = max(0, chunk - 1)
            with open(path, "r+b") as fp:
                fp.truncate(keep)
        elif ev["kind"] == "silent":
            # The silent class (CRC-less bitrot): sparse distinct flips,
            # or a dense nonzero-random-byte window shared across the
            # iteration's victims (guarantees > t errors per column in
            # the unrecoverable flavor).
            with open(path, "r+b") as fp:
                buf = bytearray(fp.read())
                if "dense" in ev:
                    off, ln = ev["dense"]
                    for s in range(off, min(off + ln, len(buf))):
                        buf[s] ^= rng.randint(1, 255)
                else:
                    nbits = max(1, len(buf) * 8)
                    for bit in rng.sample(range(nbits),
                                          min(ev["count"], nbits)):
                        buf[bit // 8] ^= 1 << (bit % 8)
                fp.seek(0)
                fp.write(bytes(buf))
        else:  # bitrot
            # DISTINCT positions (capped at the chunk's bit count): with
            # replacement, an even number of hits on one bit nets to
            # zero corruption and the scrub-exactness check would fail
            # on a perfectly healthy stack.
            nbits = max(1, chunk * 8)
            with open(path, "r+b") as fp:
                buf = bytearray(fp.read())
                for bit in rng.sample(range(nbits),
                                      min(ev["count"], nbits)):
                    buf[bit // 8] ^= 1 << (bit % 8)
                fp.seek(0)
                fp.write(bytes(buf))


def _check(cond: bool, cfg: dict, what: str) -> None:
    if not cond:
        raise ChaosFailure(cfg, what)


def run_iteration(cfg: dict, workdir: str, *, keep: bool = False,
                  device=None) -> dict:
    """Execute one scheduled iteration under the pinned recovery env
    (verdicts are a function of the seed alone) on ``device`` (None:
    CUDA, raising with no GPU present); returns its outcome record or
    raises :class:`ChaosFailure` with the reproducing config."""
    from ..utils.backend import resolve_device

    device = resolve_device(device)
    with _pinned_env():
        if cfg.get("mode") == "silent":
            return _run_silent_iteration(cfg, workdir, keep=keep, device=device)
        if cfg.get("mode") == "update":
            return _run_update_iteration(cfg, workdir, keep=keep, device=device)
        if cfg.get("mode") == "update_group":
            return _run_update_group_iteration(cfg, workdir, keep=keep, device=device)
        if cfg.get("mode") == "object":
            return _run_object_iteration(cfg, workdir, keep=keep, device=device)
        if cfg.get("mode") == "health":
            return _run_health_iteration(cfg, workdir, keep=keep, device=device)
        if cfg.get("mode") == "maint":
            return _run_maint_iteration(cfg, workdir, keep=keep, device=device)
        return _run_iteration(cfg, workdir, keep=keep, device=device)


def _archive_snapshot(fname: str, n: int) -> list[bytes]:
    """Every chunk file's bytes plus .METADATA — the byte-exact rollback
    witness for torn update/append ops."""
    from ..utils.fileformat import chunk_file_name, metadata_file_name

    out = []
    for c in range(n):
        path = chunk_file_name(fname, c)
        out.append(open(path, "rb").read() if os.path.exists(path) else None)
    out.append(open(metadata_file_name(fname), "rb").read())
    return out


def _run_update_iteration(cfg: dict, workdir: str, *,
                          keep: bool = False, device=None) -> dict:
    """One ``update``-class iteration: encode, run the scheduled mix of
    edits / appends / torn ops, and prove the delta math against a
    from-scratch re-encode twin (chunk files AND CRC lines byte-equal),
    plus byte-exact journal rollback for every torn op."""
    from ..update import SimulatedCrash
    from ..update.journal import journal_path
    from ..utils.fileformat import (
        chunk_file_name, metadata_file_name, read_archive_meta,
    )

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w, size = cfg["k"], cfg["p"], cfg["w"], cfg["size"]
    layout = cfg["layout"]
    base = os.path.join(workdir, f"iter{i}")
    os.makedirs(base, exist_ok=True)
    fname = os.path.join(base, f"chaos_update_{i}.bin")
    data = random.Random(f"rs-chaos-data:{seed}:{i}").randbytes(size)
    ok = False
    try:
        with open(fname, "wb") as fp:
            fp.write(data)
        api.encode_file(
            fname, k, p, checksums=True, w=w, layout=layout,
            segment_bytes=_SEGMENT_BYTES,
        )
        mirror = bytearray(data)
        plan = (
            _faults.parse_plan(cfg["faults"], seed=(seed * 1_000_003 + i))
            if cfg["faults"] else None
        )
        _retry.reset_budget()
        with _faults.activate(plan) if plan else nullcontext():
            for j, op in enumerate(cfg["events"]):
                payload = random.Random(
                    f"rs-chaos-update-data:{seed}:{i}:{j}"
                ).randbytes(op["len"])
                crash = op.get("crash")
                if crash:
                    pre = _archive_snapshot(fname, k + p)
                    os.environ["RS_UPDATE_CRASH"] = crash
                    try:
                        if op["op"] == "update":
                            api.update_file(
                                fname, op["at"], payload,
                                segment_bytes=_SEGMENT_BYTES,
                            )
                        else:
                            api.append_file(
                                fname, payload,
                                segment_bytes=_SEGMENT_BYTES,
                            )
                        _check(False, cfg,
                               f"crash stage {crash} did not fire (op {j})")
                    except SimulatedCrash:
                        pass
                    finally:
                        os.environ.pop("RS_UPDATE_CRASH", None)
                    _check(os.path.exists(journal_path(fname)), cfg,
                           f"torn op {j} left no journal")
                    verdict = api.recover_archive(fname)
                    _check(verdict == "rolled_back", cfg,
                           f"recovery verdict {verdict!r} on torn op {j}")
                    _check(_archive_snapshot(fname, k + p) == pre, cfg,
                           f"torn op {j} did not roll back byte-exact")
                elif op["op"] == "update":
                    api.update_file(
                        fname, op["at"], payload,
                        segment_bytes=_SEGMENT_BYTES,
                    )
                    mirror[op["at"] : op["at"] + op["len"]] = payload
                else:
                    api.append_file(
                        fname, payload, segment_bytes=_SEGMENT_BYTES
                    )
                    mirror += payload
                report = api.scan_file(
                    fname, segment_bytes=_SEGMENT_BYTES
                )
                _check(
                    report["decodable"] is True
                    and not report["corrupt"] and not report["missing"]
                    and not report["pending_journal"],
                    cfg, f"archive unhealthy after op {j}: {report}",
                )
        # The ROADMAP's stated validation: the delta-updated archive is
        # differential-checked byte-identical against a from-scratch
        # full re-encode of the final logical bytes.
        twin = os.path.join(base, f"twin_{i}.bin")
        with open(twin, "wb") as fp:
            fp.write(bytes(mirror))
        api.encode_file(
            twin, k, p, checksums=True, w=w, layout=layout,
            segment_bytes=_SEGMENT_BYTES,
        )
        for c in range(k + p):
            got = open(chunk_file_name(fname, c), "rb").read()
            want = open(chunk_file_name(twin, c), "rb").read()
            _check(got == want, cfg,
                   f"delta-updated chunk {c} != full re-encode twin")
        ma = read_archive_meta(metadata_file_name(fname))
        mb = read_archive_meta(metadata_file_name(twin))
        _check(ma.crcs == mb.crcs and ma.total_size == mb.total_size, cfg,
               "metadata CRCs/size diverge from the re-encode twin")
        out = api.auto_decode_file(
            fname, fname + ".dec", segment_bytes=_SEGMENT_BYTES
        )
        _check(open(out, "rb").read() == bytes(mirror), cfg,
               "decode != tracked logical bytes after the schedule")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": size,
                "chaos": {
                    "seed": seed, "iter": i, "mode": "update",
                    "layout": layout, "events": cfg["events"],
                    "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "update", "layout": layout,
        "k": k, "p": p, "w": w, "size": size,
        "ops": [op["op"] + (":torn" if op.get("crash") else "")
                for op in cfg["events"]],
        "final_size": len(mirror),
        "faults": cfg["faults"], "verdict": "pass",
    }


def _run_update_group_iteration(cfg: dict, workdir: str, *,
                                keep: bool = False, device=None) -> dict:
    """One grouped-update iteration: encode, run the scheduled sequence
    of group-committed batches (torn groups included), and prove (a)
    every torn group rolls back ALL its edits byte-exactly, (b) every
    committed group equals sequential application (tracked mirror), and
    (c) the final archive is chunk- and CRC-identical to a from-scratch
    re-encode twin."""
    from ..update import SimulatedCrash
    from ..update.journal import journal_path
    from ..utils.fileformat import (
        chunk_file_name, metadata_file_name, read_archive_meta,
    )

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w, size = cfg["k"], cfg["p"], cfg["w"], cfg["size"]
    layout = cfg["layout"]
    base = os.path.join(workdir, f"iter{i}")
    os.makedirs(base, exist_ok=True)
    fname = os.path.join(base, f"chaos_group_{i}.bin")
    data = random.Random(f"rs-chaos-data:{seed}:{i}").randbytes(size)
    ok = False
    try:
        with open(fname, "wb") as fp:
            fp.write(data)
        api.encode_file(
            fname, k, p, checksums=True, w=w, layout=layout,
            segment_bytes=_SEGMENT_BYTES,
        )
        mirror = bytearray(data)
        plan = (
            _faults.parse_plan(cfg["faults"], seed=(seed * 1_000_003 + i))
            if cfg["faults"] else None
        )
        _retry.reset_budget()
        with _faults.activate(plan) if plan else nullcontext():
            for j, ev in enumerate(cfg["events"]):
                edits = []
                for e, op in enumerate(ev["group"]):
                    payload = random.Random(
                        f"rs-chaos-group-data:{seed}:{i}:{j}:{e}"
                    ).randbytes(op["len"])
                    if op["op"] == "update":
                        edits.append({"op": "update", "at": op["at"],
                                      "data": payload})
                    else:
                        edits.append({"op": "append", "data": payload})
                crash = ev.get("crash")
                if crash:
                    pre = _archive_snapshot(fname, k + p)
                    os.environ["RS_UPDATE_CRASH"] = crash
                    try:
                        api.update_file_many(
                            fname, edits, segment_bytes=_SEGMENT_BYTES
                        )
                        _check(False, cfg,
                               f"crash stage {crash} did not fire "
                               f"(group {j})")
                    except SimulatedCrash:
                        pass
                    finally:
                        os.environ.pop("RS_UPDATE_CRASH", None)
                    _check(os.path.exists(journal_path(fname)), cfg,
                           f"torn group {j} left no journal")
                    verdict = api.recover_archive(fname)
                    _check(verdict == "rolled_back", cfg,
                           f"recovery verdict {verdict!r} on torn "
                           f"group {j}")
                    _check(_archive_snapshot(fname, k + p) == pre, cfg,
                           f"torn group {j} did not roll back ALL "
                           "edits byte-exact")
                else:
                    summary = api.update_file_many(
                        fname, edits, segment_bytes=_SEGMENT_BYTES
                    )
                    _check(summary["groups"] == 1, cfg,
                           f"group {j} split into {summary['groups']} "
                           "commits under the pinned window")
                    # Sequential semantics on the tracked mirror.
                    for e in edits:
                        if e["op"] == "update":
                            at = e["at"]
                            mirror[at : at + len(e["data"])] = e["data"]
                        else:
                            mirror += e["data"]
                report = api.scan_file(fname, segment_bytes=_SEGMENT_BYTES)
                _check(
                    report["decodable"] is True
                    and not report["corrupt"] and not report["missing"]
                    and not report["pending_journal"],
                    cfg, f"archive unhealthy after group {j}: {report}",
                )
        twin = os.path.join(base, f"twin_{i}.bin")
        with open(twin, "wb") as fp:
            fp.write(bytes(mirror))
        api.encode_file(
            twin, k, p, checksums=True, w=w, layout=layout,
            segment_bytes=_SEGMENT_BYTES,
        )
        for c in range(k + p):
            got = open(chunk_file_name(fname, c), "rb").read()
            want = open(chunk_file_name(twin, c), "rb").read()
            _check(got == want, cfg,
                   f"group-updated chunk {c} != full re-encode twin")
        ma = read_archive_meta(metadata_file_name(fname))
        mb = read_archive_meta(metadata_file_name(twin))
        _check(ma.crcs == mb.crcs and ma.total_size == mb.total_size, cfg,
               "metadata CRCs/size diverge from the re-encode twin")
        out = api.auto_decode_file(
            fname, fname + ".dec", segment_bytes=_SEGMENT_BYTES
        )
        _check(open(out, "rb").read() == bytes(mirror), cfg,
               "decode != tracked logical bytes after the schedule")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": size,
                "chaos": {
                    "seed": seed, "iter": i, "mode": "update_group",
                    "layout": layout, "events": cfg["events"],
                    "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "update_group", "layout": layout,
        "k": k, "p": p, "w": w, "size": size,
        "groups": [
            f"{len(ev['group'])}" + (":torn" if ev.get("crash") else "")
            for ev in cfg["events"]
        ],
        "final_size": len(mirror),
        "faults": cfg["faults"], "verdict": "pass",
    }


def _run_object_iteration(cfg: dict, workdir: str, *,
                          keep: bool = False, device=None) -> dict:
    """One ``object``-class iteration: run the scheduled PUT/DELETE/
    compact sequence (torn ops included) against one bucket, holding a
    sequential mirror of the COMMITTED ops, and prove after every event
    that the bucket's live contents equal the mirror byte-for-byte —
    the index must never reference bytes a rolled-back group wrote, a
    GET is byte-exact or a clean 404, and compaction is all-or-nothing
    (:func:`plan_object_iteration` doc)."""
    from .. import store
    from ..update import SimulatedCrash

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w = cfg["k"], cfg["p"], cfg["w"]
    base = os.path.join(workdir, f"iter{i}")
    root = os.path.join(base, "root")
    os.makedirs(root, exist_ok=True)
    mirror: dict[str, bytes] = {}
    ok = False

    def check_state(bucket, what: str) -> None:
        listed = {o["key"] for o in bucket.list_objects()}
        _check(listed == set(mirror), cfg,
               f"{what}: live keys {sorted(listed)} != mirror "
               f"{sorted(mirror)}")
        for key, want in mirror.items():
            got = bucket.get(key)
            _check(got == want, cfg,
                   f"{what}: GET {key!r} returned {len(got)} bytes != "
                   "mirror (silently wrong read)")

    try:
        store.drop_cached()
        bucket = store.open_bucket(
            root, "bkt", create=True, k=k, p=p, w=w,
            stripe_bytes=cfg["stripe_bytes"], device=device,
        )
        for j, ev in enumerate(cfg["events"]):
            crash = ev.get("crash")
            payloads = {}
            if ev["op"] == "put":
                for e, b in enumerate(ev["batch"]):
                    payloads[e] = random.Random(
                        f"rs-chaos-object-data:{seed}:{i}:{j}:{e}"
                    ).randbytes(b["len"])
            if crash:
                os.environ["RS_UPDATE_CRASH"] = crash
            try:
                committed = True
                try:
                    if ev["op"] == "put":
                        bucket.put_many([
                            (b["key"], payloads[e])
                            for e, b in enumerate(ev["batch"])
                        ])
                    elif ev["op"] == "delete":
                        try:
                            bucket.delete(ev["key"])
                        except store.ObjectNotFound:
                            # Rolled-back earlier put (or double
                            # delete): legal iff the mirror agrees.
                            _check(ev["key"] not in mirror, cfg,
                                   f"event {j}: delete 404 for a key "
                                   "the mirror holds")
                            committed = False
                    else:
                        bucket.compact(force=ev.get("force", False))
                except SimulatedCrash:
                    # Torn op: simulate process death + restart, then
                    # prove the commit semantics.  A torn DELETE is
                    # COMMITTED (tombstone fsyncs before the zeroing);
                    # a torn put/compact commits nothing.
                    store.drop_cached()
                    bucket = store.open_bucket(root, "bkt", device=device)
                    if ev["op"] == "delete":
                        mirror.pop(ev["key"], None)
                    check_state(bucket, f"event {j} (torn {ev['op']} "
                                f"@{crash})")
                    continue
            finally:
                os.environ.pop("RS_UPDATE_CRASH", None)
            # The op completed (a scheduled crash stage may simply not
            # exist on this path, e.g. a stripe-creating put): committed.
            if committed and ev["op"] == "put":
                for e, b in enumerate(ev["batch"]):
                    mirror[b["key"]] = payloads[e]
            elif committed and ev["op"] == "delete":
                mirror.pop(ev["key"], None)
            check_state(bucket, f"event {j} ({ev['op']})")
        # Fresh-process differential: reload from disk and re-check,
        # then prove every surviving stripe archive is healthy.
        store.drop_cached()
        bucket = store.open_bucket(root, "bkt", device=device)
        check_state(bucket, "final reload")
        bdir = os.path.join(root, "bkt")
        for fn in sorted(os.listdir(bdir)):
            if fn.endswith(".METADATA"):
                report = api.scan_file(
                    os.path.join(bdir, fn[: -len(".METADATA")]),
                    segment_bytes=_SEGMENT_BYTES,
                )
                _check(
                    report["decodable"] is True and not report["corrupt"]
                    and not report["missing"]
                    and not report["pending_journal"],
                    cfg, f"stripe {fn} unhealthy after schedule: "
                    f"{report}",
                )
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        os.environ.pop("RS_UPDATE_CRASH", None)
        store.drop_cached()
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": sum(len(v) for v in mirror.values()),
                "chaos": {
                    "seed": seed, "iter": i, "mode": "object",
                    "stripe_bytes": cfg["stripe_bytes"],
                    "events": cfg["events"], "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "object", "k": k, "p": p, "w": w,
        "stripe_bytes": cfg["stripe_bytes"],
        "events": [
            ev["op"] + (":torn" if ev.get("crash") else "")
            for ev in cfg["events"]
        ],
        "final_objects": len(mirror),
        "final_bytes": sum(len(v) for v in mirror.values()),
        "verdict": "pass",
    }


def _run_silent_iteration(cfg: dict, workdir: str, *,
                          keep: bool = False, device=None) -> dict:
    """One ``silent``-class iteration: encode WITHOUT checksum lines,
    corrupt per schedule, then prove the error-locating plane's contract
    (docs/RESILIENCE.md "Error location"):

    * <= t damaged chunks: the syndrome scrub attributes EXACTLY the
      damaged set (no CRCs anywhere), and both the auto-decode escalation
      ladder and ``locate_decode_file`` recover bit-identical bytes;
    * > t: the scrub verdict is ``unlocatable``, ``decodable`` degrades
      to ``"unknown"``, and every decode path raises — never a silently
      wrong output.
    """
    from ..utils.fileformat import (
        chunk_file_name, chunk_size_for, metadata_file_name,
        read_archive_meta,
    )

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w, size = cfg["k"], cfg["p"], cfg["w"], cfg["size"]
    rng = random.Random(f"rs-chaos-silent-run:{seed}:{i}")
    base = os.path.join(workdir, f"iter{i}")
    os.makedirs(base, exist_ok=True)
    fname = os.path.join(base, f"chaos_silent_{i}.bin")
    data = random.Random(f"rs-chaos-data:{seed}:{i}").randbytes(size)
    ok = False
    try:
        with open(fname, "wb") as fp:
            fp.write(data)
        api.encode_file(
            fname, k, p, checksums=False, w=w, segment_bytes=_SEGMENT_BYTES
        )
        meta = read_archive_meta(metadata_file_name(fname))
        total_size, p_m, k_m, total_mat, w_m, crcs = (
            meta.total_size, meta.parity_num, meta.native_num,
            meta.total_mat, meta.w, meta.crcs)
        _check((k_m, p_m, w_m, total_size) == (k, p, w, size), cfg,
               "metadata disagrees with the encode config")
        _check(not crcs, cfg, "silent-class archive must carry no CRCs")
        oracle = _oracle_chunks(data, k, p, w, total_mat)
        for c in range(k + p):
            got = open(chunk_file_name(fname, c), "rb").read()
            _check(got == oracle[c], cfg,
                   f"encode differential mismatch on chunk {c}")

        chunk = chunk_size_for(size, k, w // 8)
        _apply_events(fname, cfg["events"], chunk, rng)
        damaged = sorted({ev["chunk"] for ev in cfg["events"]})
        t = p // 2
        recoverable = len(damaged) <= t

        _retry.reset_budget()
        report = api.scan_file(
            fname, syndrome=True, segment_bytes=_SEGMENT_BYTES
        )
        syn = report["syndrome"]
        if recoverable:
            _check(
                syn["verdict"] == ("silent_bitrot" if damaged else "clean"),
                cfg, f"scrub syndrome verdict {syn['verdict']!r} for "
                f"damage {damaged}",
            )
            # The attribution contract: chunk indices pinned WITHOUT CRCs
            # (the syndrome pre-check replacing subset-search oracling as
            # the first line of damage attribution).
            _check(syn["silent_bitrot"] == damaged, cfg,
                   f"syndrome attributed {syn['silent_bitrot']}, "
                   f"schedule damaged {damaged}")
            _check(report["decodable"] is True, cfg,
                   f"decodable {report['decodable']} on <=t silent damage")
            out = api.auto_decode_file(
                fname, fname + ".dec", segment_bytes=_SEGMENT_BYTES
            )
            _check(open(out, "rb").read() == data, cfg,
                   "auto-decode (locate rung) output != original bytes")
            out2 = api.locate_decode_file(
                fname, fname + ".dec2", segment_bytes=_SEGMENT_BYTES
            )
            _check(open(out2, "rb").read() == data, cfg,
                   "locate decode output != original bytes")
        else:
            _check(syn["verdict"] == "unlocatable", cfg,
                   f"scrub syndrome verdict {syn['verdict']!r} on >t "
                   "silent damage")
            _check(report["decodable"] == "unknown", cfg,
                   "decodable must degrade to 'unknown' past the t bound")
            for op_name, call in (
                ("auto_decode", lambda: api.auto_decode_file(
                    fname, fname + ".dec", segment_bytes=_SEGMENT_BYTES)),
                ("locate_decode", lambda: api.locate_decode_file(
                    fname, fname + ".dec2",
                    segment_bytes=_SEGMENT_BYTES)),
            ):
                try:
                    call()
                    _check(False, cfg,
                           f"{op_name} succeeded on >t silent damage")
                except ValueError:
                    pass  # UnlocatableError is the expected subclass
            # Never half-written: decode failures must leave no output.
            for leftover in (fname + ".dec", fname + ".dec2"):
                _check(not os.path.exists(leftover), cfg,
                       f"failed decode left {leftover}")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": size,
                "chaos": {
                    "seed": seed, "iter": i, "mode": "silent",
                    "events": cfg["events"], "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "silent", "k": k, "p": p, "w": w, "size": size,
        "damaged": sorted({ev["chunk"] for ev in cfg["events"]}),
        "faults": cfg["faults"], "verdict": "pass",
    }


def _run_health_iteration(cfg: dict, workdir: str, *,
                          keep: bool = False, device=None) -> dict:
    """One ``health``-class iteration: encode a small fleet against a
    private damage ledger, hurt the victim, and prove the durability
    plane converges (docs/HEALTH.md):

    * a clean fleet ranks nothing for repair;
    * induced damage puts the victim at rank 1 with the EXACT per-chunk
      state map the schedule predicts (unlink -> missing, torn ->
      truncated, bitrot -> crc_mismatch), margin ``p - lost``, and a
      ``repair`` work-queue head;
    * a checkpoint snapshot taken mid-history, then repair + rescan:
      the victim's damage map clears and no repair stays queued;
    * replay is restart-stable: two fresh replays agree byte-for-byte,
      and snapshot+delta replay equals pure-delta replay from genesis —
      the daemon kill/restart contract.
    """
    from ..obs import health as _health
    from ..utils.fileformat import chunk_size_for

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w = cfg["k"], cfg["p"], cfg["w"]
    rng = random.Random(f"rs-chaos-health-run:{seed}:{i}")
    base = os.path.join(workdir, f"iter{i}")
    os.makedirs(base, exist_ok=True)
    ledger = os.path.join(base, "health_ledger.jsonl")
    damaged = sorted({ev["chunk"] for ev in cfg["events"]})
    # Private ledger + pinned health knobs for the iteration: verdicts
    # must be a function of the seed alone, and the ambient ledger must
    # not absorb (or leak) this fleet's damage events.
    saved_env = {
        kk: os.environ.get(kk)
        for kk in ("RS_RUNLOG", "RS_RUNLOG_MAX_BYTES",
                   "RS_HEALTH_SCRUB_MAX_AGE_S", "RS_HEALTH_AT_RISK",
                   "RS_SCHEDULE_STORE")
    }
    ok = False
    try:
        os.environ["RS_RUNLOG"] = ledger
        os.environ.pop("RS_RUNLOG_MAX_BYTES", None)
        os.environ.pop("RS_HEALTH_SCRUB_MAX_AGE_S", None)
        os.environ.pop("RS_HEALTH_AT_RISK", None)
        os.environ["RS_SCHEDULE_STORE"] = "off"

        fnames = []
        for a, size in enumerate(cfg["sizes"]):
            fname = os.path.join(base, f"chaos_health_{i}_{a}.bin")
            data = random.Random(
                f"rs-chaos-data:{seed}:{i}:{a}").randbytes(size)
            with open(fname, "wb") as fp:
                fp.write(data)
            api.encode_file(fname, k, p, checksums=True, w=w,
                            segment_bytes=_SEGMENT_BYTES)
            fnames.append(fname)
        for f in fnames:
            api.scan_file(f, segment_bytes=_SEGMENT_BYTES)
        state = _health.load(ledger)
        _check(len(state["archives"]) == len(fnames), cfg,
               "clean scans did not track every archive")
        _check(
            not [q for q in _health.work_queue(state)
                 if q["action"] == "repair"],
            cfg, "clean fleet queued repairs",
        )

        victim = os.path.abspath(fnames[cfg["victim"]])
        chunk = chunk_size_for(cfg["sizes"][cfg["victim"]], k, w // 8)
        _apply_events(victim, cfg["events"], chunk, rng)
        for f in fnames:
            api.scan_file(f, segment_bytes=_SEGMENT_BYTES)
        state = _health.load(ledger)
        report = _health.fleet_report(state)
        top = report["archives"][0]
        _check(top["archive"] == victim, cfg,
               f"induced damage ranked {top['archive']!r} first, "
               f"not the victim")
        _check(top["lost"] == len(damaged), cfg,
               f"victim lost {top['lost']}, schedule damaged "
               f"{len(damaged)}")
        _check(top["margin"] == p - len(damaged), cfg,
               f"victim margin {top['margin']} != p - lost")
        expect = {
            str(ev["chunk"]): {"unlink": "missing", "torn": "truncated",
                               "bitrot": "crc_mismatch"}[ev["kind"]]
            for ev in cfg["events"]
        }
        _check(top["chunks"] == expect, cfg,
               f"damage map {top['chunks']} != schedule {expect}")
        wq = report["work_queue"]
        _check(
            bool(wq) and wq[0]["archive"] == victim
            and wq[0]["action"] == "repair",
            cfg, "victim is not the work queue's repair head",
        )

        # Checkpoint mid-history (the "daemon killed mid-scrub" state),
        # then keep appending deltas on top of it.
        _health.write_snapshot(state, ledger)

        rebuilt = api.repair_file(victim, segment_bytes=_SEGMENT_BYTES)
        _check(sorted(rebuilt) == damaged, cfg,
               f"repair rebuilt {sorted(rebuilt)}, schedule damaged "
               f"{damaged}")
        for f in fnames:
            api.scan_file(f, segment_bytes=_SEGMENT_BYTES)
        state = _health.load(ledger)
        report = _health.fleet_report(state)
        vrow = next(r for r in report["archives"]
                    if r["archive"] == victim)
        _check(vrow["lost"] == 0, cfg,
               "repair + rescan did not clear the victim's damage map")
        _check(
            not [q for q in report["work_queue"]
                 if q["action"] == "repair"],
            cfg, "repairs still queued after a clean rescan",
        )

        # Restart stability: replays of the same ledger agree
        # byte-for-byte, with and without the checkpoint.
        c_a = _health.canonical(_health.load(ledger))
        c_b = _health.canonical(_health.load(ledger))
        _check(c_a == c_b, cfg, "re-replay is not deterministic")
        c_pure = _health.canonical(
            _health.load(ledger, use_snapshots=False))
        _check(c_a == c_pure, cfg,
               "snapshot+delta replay != pure-delta replay")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        for kk, vv in saved_env.items():
            if vv is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = vv
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": sum(cfg["sizes"]),
                "chaos": {
                    "seed": seed, "iter": i, "mode": "health",
                    "events": cfg["events"], "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "health", "k": k, "p": p, "w": w,
        "archives": len(cfg["sizes"]), "damaged": damaged,
        "top_is_victim": True, "risk_cleared": True,
        "replay_identical": True, "verdict": "pass",
    }


def _run_maint_iteration(cfg: dict, workdir: str, *,
                         keep: bool = False, device=None) -> dict:
    """One ``maint``-class iteration: build the damaged fleet + the
    dead-heavy bucket, drain a controller that crashes at the scheduled
    job stage, then prove a same-owner restart converges
    (:func:`plan_maint_iteration` doc)."""
    from .. import store
    from ..maint import controller as _maint
    from ..obs import health as _health
    from ..utils.fileformat import chunk_size_for

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w = cfg["k"], cfg["p"], cfg["w"]
    rng = random.Random(f"rs-chaos-maint-run:{seed}:{i}")
    base = os.path.join(workdir, f"iter{i}")
    root = os.path.join(base, "store")
    os.makedirs(root, exist_ok=True)
    ledger = os.path.join(base, "maint_ledger.jsonl")
    damaged = sorted({ev["chunk"] for ev in cfg["events"]})
    # Private ledger + pinned knobs (the health-class discipline):
    # verdicts must be a function of the seed alone, and the ambient
    # ledger must not absorb this fleet's damage or claim events.
    saved_env = {
        kk: os.environ.get(kk)
        for kk in ("RS_RUNLOG", "RS_RUNLOG_MAX_BYTES",
                   "RS_HEALTH_SCRUB_MAX_AGE_S", "RS_HEALTH_AT_RISK",
                   "RS_SCHEDULE_STORE", "RS_MAINT_CRASH")
    }
    ok = False
    crashed = False
    try:
        os.environ["RS_RUNLOG"] = ledger
        os.environ.pop("RS_RUNLOG_MAX_BYTES", None)
        os.environ.pop("RS_HEALTH_SCRUB_MAX_AGE_S", None)
        os.environ.pop("RS_HEALTH_AT_RISK", None)
        os.environ["RS_SCHEDULE_STORE"] = "off"
        os.environ.pop("RS_MAINT_CRASH", None)

        fnames = []
        for a, size in enumerate(cfg["sizes"]):
            fname = os.path.join(base, f"chaos_maint_{i}_{a}.bin")
            data = random.Random(
                f"rs-chaos-data:{seed}:{i}:{a}").randbytes(size)
            with open(fname, "wb") as fp:
                fp.write(data)
            api.encode_file(fname, k, p, checksums=True, w=w)
            api.scan_file(fname)
            fnames.append(fname)
        victim = os.path.abspath(fnames[cfg["victim"]])
        # Chunk bytes BEFORE damage — repair must restore them exactly
        # (snapshot drops the trailing .METADATA entry: repair rewrites
        # identical chunk bytes, metadata line order is its own).
        pre_chunks = _archive_snapshot(victim, k + p)[:-1]
        chunk = chunk_size_for(cfg["sizes"][cfg["victim"]], k, w // 8)
        _apply_events(victim, cfg["events"], chunk, rng)
        api.scan_file(victim)

        store.drop_cached()
        bucket = store.open_bucket(
            root, "bkt", create=True, k=k, p=p, w=w,
            stripe_bytes=cfg["stripe_bytes"], device=device,
        )
        mirror: dict[str, bytes] = {}
        for j, pt in enumerate(cfg["puts"]):
            data = random.Random(
                f"rs-chaos-maint-obj:{seed}:{i}:{j}").randbytes(pt["len"])
            bucket.put(pt["key"], data)
            mirror[pt["key"]] = data
        for key in cfg["deletes"]:
            bucket.delete(key)
            mirror.pop(key, None)

        # Drain #1: the controller that may die mid-job.  Same-owner
        # restart is the daemon contract (docs/MAINT.md) — a restarted
        # process reclaims its own leases immediately.
        if cfg["crash"]:
            os.environ["RS_MAINT_CRASH"] = cfg["crash"]
        ctl = _maint.MaintController(
            ledger_path=ledger, store_roots=[root],
            owner="chaos:maint", bytes_per_s=float(1 << 30),
            interval_s=0.01, device=device)
        try:
            ctl.drain()
        except _maint.MaintCrash:
            crashed = True
        _check(bool(cfg["crash"]) or not crashed, cfg,
               "controller crashed with no crash scheduled")
        os.environ.pop("RS_MAINT_CRASH", None)

        # Checkpoint mid-history — a live claim (post-crash) must ride
        # the snapshot byte-exactly (the restart-stability check below
        # replays both ways).
        _health.write_snapshot(_health.load(ledger), ledger)

        # Drain #2: the "restarted" process — fresh store view, same
        # owner — must converge with nothing left actionable.
        store.drop_cached()
        ctl2 = _maint.MaintController(
            ledger_path=ledger, store_roots=[root],
            owner="chaos:maint", bytes_per_s=float(1 << 30),
            interval_s=0.01, device=device)
        out = ctl2.drain()
        _check(out["remaining"] == 0, cfg,
               f"restart drain left {out['remaining']} job(s) queued")
        _check(out["skipped_claimed"] == 0, cfg,
               "restart drain blocked on its own leases")

        state = _health.load(ledger)
        wq = _health.work_queue(state)
        _check(not wq, cfg,
               f"work queue not empty after convergence: {wq[:2]}")
        post_chunks = _archive_snapshot(victim, k + p)[:-1]
        _check(post_chunks == pre_chunks, cfg,
               "repair did not restore the victim's chunk bytes")

        bucket = store.open_bucket(root, "bkt", device=device)
        stats = bucket.stats()
        _check(stats["pending_compactions"] == 0, cfg,
               f"{stats['pending_compactions']} dead-heavy archive(s) "
               "still pending compaction")
        listed = {o["key"] for o in bucket.list_objects()}
        _check(listed == set(mirror), cfg,
               f"live keys {sorted(listed)} != mirror {sorted(mirror)}")
        for key, want in mirror.items():
            _check(bucket.get(key) == want, cfg,
                   f"GET {key!r} != mirror after maintenance")

        # Restart stability with claims in history: snapshot+delta
        # replay must equal pure-delta replay from genesis.
        c_a = _health.canonical(_health.load(ledger))
        c_pure = _health.canonical(
            _health.load(ledger, use_snapshots=False))
        _check(c_a == c_pure, cfg,
               "snapshot+delta replay != pure-delta replay")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        for kk, vv in saved_env.items():
            if vv is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = vv
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": sum(cfg["sizes"]),
                "chaos": {
                    "seed": seed, "iter": i, "mode": "maint",
                    "events": cfg["events"], "crash": cfg["crash"],
                    "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "mode": "maint", "k": k, "p": p, "w": w,
        "archives": len(cfg["sizes"]), "damaged": damaged,
        "objects": len(cfg["puts"]), "deleted": len(cfg["deletes"]),
        "crash": cfg["crash"] or "none", "crashed": crashed,
        "repaired": True, "pending_cleared": True,
        "mirror_match": True, "replay_identical": True,
        "verdict": "pass",
    }


def _run_iteration(cfg: dict, workdir: str, *, keep: bool = False,
                   device=None) -> dict:
    from ..utils.fileformat import (
        chunk_file_name, chunk_size_for, metadata_file_name,
        read_archive_meta,
    )

    seed, i = cfg["seed"], cfg["iter"]
    api = _api_on(device)
    k, p, w, size = cfg["k"], cfg["p"], cfg["w"], cfg["size"]
    rng = _iter_rng(seed, i)
    rng.random()  # decouple from plan_iteration's draws deterministically
    base = os.path.join(workdir, f"iter{i}")
    os.makedirs(base, exist_ok=True)
    fname = os.path.join(base, f"chaos_{i}.bin")
    data = random.Random(f"rs-chaos-data:{seed}:{i}").randbytes(size)
    ok = False
    try:
        with open(fname, "wb") as fp:
            fp.write(data)
        api.encode_file(
            fname, k, p, checksums=True, w=w, segment_bytes=_SEGMENT_BYTES
        )
        meta = read_archive_meta(metadata_file_name(fname))
        total_size, p_m, k_m, total_mat, w_m = (
            meta.total_size, meta.parity_num, meta.native_num,
            meta.total_mat, meta.w)
        _check((k_m, p_m, w_m, total_size) == (k, p, w, size), cfg,
               "metadata disagrees with the encode config")
        oracle = _oracle_chunks(data, k, p, w, total_mat)
        for c in range(k + p):
            got = open(chunk_file_name(fname, c), "rb").read()
            _check(got == oracle[c], cfg,
                   f"encode differential mismatch on chunk {c}")

        chunk = chunk_size_for(size, k, w // 8)
        _apply_events(fname, cfg["events"], chunk, rng)
        damaged = sorted({ev["chunk"] for ev in cfg["events"]})

        plan = (
            _faults.parse_plan(cfg["faults"], seed=(seed * 1_000_003 + i))
            if cfg["faults"] else None
        )
        _retry.reset_budget()
        with _faults.activate(plan) if plan else nullcontext():
            report = api.scan_file(fname, segment_bytes=_SEGMENT_BYTES)
            scan_damaged = sorted(
                set(report["corrupt"]) | set(report["missing"])
            )
            _check(scan_damaged == damaged, cfg,
                   f"scrub saw {scan_damaged}, schedule damaged {damaged}")
            recoverable = _oracle_decodable(
                total_mat, report["healthy"], k, w
            )
            _check(report["decodable"] is recoverable, cfg,
                   f"scrub verdict {report['decodable']} vs oracle "
                   f"decodable={recoverable}")
            _check(recoverable is (len(damaged) <= p) or not recoverable,
                   cfg, "oracle says decodable with more than p chunks "
                   "damaged (impossible)")
            if recoverable:
                out = api.auto_decode_file(
                    fname, fname + ".dec", segment_bytes=_SEGMENT_BYTES
                )
                _check(open(out, "rb").read() == data, cfg,
                       "auto-decode output != original bytes")
                _check(
                    _oracle_decode(fname, fname + ".auto.conf", size, k, w,
                                   total_mat) == data,
                    cfg, "oracle decode of the chosen conf != original",
                )
                rebuilt = api.repair_file(
                    fname, segment_bytes=_SEGMENT_BYTES
                )
                _check(sorted(rebuilt) == damaged, cfg,
                       f"repair rebuilt {sorted(rebuilt)}, expected "
                       f"{damaged}")
                for c in range(k + p):
                    got = open(chunk_file_name(fname, c), "rb").read()
                    _check(got == oracle[c], cfg,
                           f"post-repair differential mismatch on chunk {c}")
                post = api.scan_file(fname, segment_bytes=_SEGMENT_BYTES)
                _check(post["decodable"] is True and not post["corrupt"]
                       and not post["missing"], cfg,
                       "archive not fully healthy after repair")
            else:
                for op_name, call in (
                    ("auto_decode", lambda: api.auto_decode_file(
                        fname, fname + ".dec",
                        segment_bytes=_SEGMENT_BYTES)),
                    ("repair", lambda: api.repair_file(
                        fname, segment_bytes=_SEGMENT_BYTES)),
                ):
                    try:
                        call()
                        _check(False, cfg,
                               f"{op_name} succeeded on >p damage")
                    except ValueError:
                        pass  # includes UndecidedSubset/ChunkIntegrity
                # Nothing half-rebuilt: surviving chunks stay byte-exact.
                for c in range(k + p):
                    if c in damaged:
                        continue
                    got = open(chunk_file_name(fname, c), "rb").read()
                    _check(got == oracle[c], cfg,
                           f"survivor chunk {c} mutated by a failed repair")
        ok = True
    except ChaosFailure:
        raise
    except Exception as e:
        raise ChaosFailure(
            cfg, f"unexpected {type(e).__name__}: {e}"
        ) from e
    finally:
        verdict = "pass" if ok else "fail"
        _metrics.counter(
            "rs_chaos_iterations_total", "chaos-harness iteration verdicts"
        ).labels(verdict=verdict).inc()
        if _runlog.enabled():
            _runlog.record({
                "op": "chaos_iter",
                "config": {"k": k, "n": k + p, "w": w},
                "bytes": size,
                "chaos": {
                    "seed": seed, "iter": i, "events": cfg["events"],
                    "faults": cfg["faults"],
                },
                "outcome": "ok" if ok else "error",
            })
        if ok and not keep:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "iter": i, "k": k, "p": p, "w": w, "size": size,
        "damaged": sorted({ev["chunk"] for ev in cfg["events"]}),
        "faults": cfg["faults"], "verdict": "pass",
    }


# -- shrinking ----------------------------------------------------------------


def shrink(cfg: dict, workdir: str, run=run_iteration) -> dict:
    """Greedy one-line-reproducer shrink: drop the fault plan, then each
    schedule event, keeping any removal that still fails.  Bounded at
    one pass over the elements (len(events)+1 reruns)."""
    current = dict(cfg)
    if current.get("faults"):
        trial = {**current, "faults": ""}
        if _still_fails(trial, workdir, run):
            current = trial
    events = list(current["events"])
    idx = 0
    while idx < len(events):
        trial_events = events[:idx] + events[idx + 1:]
        trial = {**current, "events": trial_events}
        if _still_fails(trial, workdir, run):
            events = trial_events
        else:
            idx += 1
    current["events"] = events
    return current


def _still_fails(cfg: dict, workdir: str, run) -> bool:
    try:
        run(cfg, workdir)
        return False
    except ChaosFailure:
        return True


# -- CLI ----------------------------------------------------------------------


def _digest(obj) -> str:
    import hashlib

    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()
    ).hexdigest()[:16]


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs chaos",
        description="Seeded chaos harness: encode -> corrupt -> "
        "scrub/auto-decode/repair on the device, differential-checked "
        "against the host GF oracle.  Bit-reproducible per --seed.",
    )
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed (default 0)")
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations to run (default 10)")
    ap.add_argument("--only", type=int, default=None, metavar="I",
                    help="run just iteration I of the seed's schedule")
    ap.add_argument("--repro", metavar="JSON", default=None,
                    help="replay one REPRODUCE line's config verbatim")
    ap.add_argument("--dir", default=None,
                    help="work directory (default: a fresh temp dir)")
    ap.add_argument("--max-bytes", type=int, default=49152,
                    help="max file size per iteration (default 48 KiB)")
    ap.add_argument("--silent", action="store_true",
                    help="run the SILENT corruption class: CRC-less "
                    "bitrot recovered (or refused) by the error-locating "
                    "decode path — own seed stream, classic schedules "
                    "unchanged")
    ap.add_argument("--update", action="store_true",
                    help="run the UPDATE workload class: random edit/"
                    "append/torn-op schedules, every archive "
                    "differential-checked byte-identical against a "
                    "from-scratch re-encode and every torn op rolled "
                    "back via the journal — own seed stream "
                    "(docs/UPDATE.md)")
    ap.add_argument("--group", action="store_true",
                    help="with --update: the GROUPED update class "
                    "instead — group-committed edit batches "
                    "(update_file_many), torn groups must roll back ALL "
                    "their edits byte-exact — own seed stream, plain "
                    "--update digests unchanged (docs/UPDATE.md "
                    "\"Group commit\")")
    ap.add_argument("--object", action="store_true",
                    help="run the OBJECT-STORE workload class: seeded "
                    "PUT/DELETE/compact schedules against one bucket "
                    "with torn ops at every crash stage — the bucket's "
                    "live contents must stay byte-identical to a "
                    "sequential mirror of the committed ops, and the "
                    "index must never reference rolled-back bytes — "
                    "own seed stream (docs/STORE.md)")
    ap.add_argument("--health", action="store_true",
                    help="run the HEALTH convergence class: encode a "
                    "small fleet against a private damage ledger, hurt "
                    "one victim, and require the durability plane to "
                    "rank it first with the exact predicted chunk-state "
                    "map, clear it after repair, and replay snapshot+"
                    "delta byte-identically — own seed stream "
                    "(docs/HEALTH.md)")
    ap.add_argument("--maint", action="store_true",
                    help="run the MAINT convergence class: a damaged "
                    "fleet plus a dead-heavy bucket drained by the "
                    "maintenance controller, killed (RS_MAINT_CRASH) at "
                    "a scheduled job stage — a same-owner restart must "
                    "converge to an empty work queue, zero pending "
                    "compactions and byte-identical archive/object "
                    "state — own seed stream (docs/MAINT.md)")
    ap.add_argument("--device", default=None,
                    help="where every iteration's GEMMs run (default cuda; "
                    "cpu runs the plain PyTorch path; with no GPU and no "
                    "--device the harness refuses)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per iteration")
    ap.add_argument("--keep", action="store_true",
                    help="keep every iteration's files on disk")
    ap.add_argument("--no-shrink", action="store_true",
                    help="report the failing iteration without minimizing")
    ap.add_argument("--repro-out", metavar="PATH", default=None,
                    help="also write the REPRODUCE line to PATH on failure")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rs chaos: {e}", file=sys.stderr)
        return 1
    run = functools.partial(run_iteration, device=device)
    workdir = args.dir or tempfile.mkdtemp(prefix="rs_chaos_")
    os.makedirs(workdir, exist_ok=True)
    if args.repro:
        try:
            cfgs = [json.loads(args.repro)]
        except ValueError as e:
            print(f"rs chaos: bad --repro JSON: {e}", file=sys.stderr)
            return 2
    else:
        if sum((args.silent, args.update, args.object, args.health,
                args.maint)) > 1:
            print("rs chaos: --silent / --update / --object / --health "
                  "/ --maint conflict; pick one workload class",
                  file=sys.stderr)
            return 2
        if args.group and not args.update:
            print("rs chaos: --group modifies --update (the grouped "
                  "update class)", file=sys.stderr)
            return 2
        indices = [args.only] if args.only is not None else range(args.iters)
        plan = (
            plan_update_group_iteration if args.update and args.group
            else plan_update_iteration if args.update
            else plan_silent_iteration if args.silent
            else plan_object_iteration if args.object
            else plan_health_iteration if args.health
            else plan_maint_iteration if args.maint
            else plan_iteration
        )
        cfgs = [plan(args.seed, i, args.max_bytes) for i in indices]
    schedule_digest = _digest(cfgs)

    results = []
    for cfg in cfgs:
        try:
            rec = run(cfg, workdir, keep=args.keep)
        except ChaosFailure as e:
            shrunk = (
                e.cfg if args.no_shrink else shrink(e.cfg, workdir, run)
            )
            line = json.dumps(shrunk, sort_keys=True)
            print(f"rs chaos: FAILED — {e.what}", file=sys.stderr)
            silent_flag = {
                "silent": "--silent ", "update": "--update ",
                "update_group": "--update --group ",
                "object": "--object ", "health": "--health ",
                "maint": "--maint ",
            }.get(cfg.get("mode"), "")
            print(
                f"rs chaos: replay the original with: rs chaos "
                f"{silent_flag}--seed {cfg['seed']} --only {cfg['iter']}",
                file=sys.stderr,
            )
            print(f"REPRODUCE: {line}")
            if args.repro_out:
                with open(args.repro_out, "w") as fp:
                    fp.write(line + "\n")
            return 1
        results.append(rec)
        if args.json:
            print(json.dumps(rec, sort_keys=True))
    print(json.dumps({
        "seed": args.seed,
        "iters": len(results),
        "passed": len(results),
        "failed": 0,
        "schedule_digest": schedule_digest,
        "verdict_digest": _digest(results),
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
