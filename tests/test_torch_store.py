"""The port's object store (``gpu_rscode_torch.store`` and the object
wrappers of ``api``) against the JAX package's, on the CPU.

Every case runs the same seeded operations through both packages, each in
its own root (the JAX package under ``JAX_PLATFORMS=cpu``, the port with
``device="cpu"``), at the minimum stripe size (64 KiB) with objects of at
most 8 KiB.  After every step the two roots must hold the same files with
the same bytes (chunks, ``.METADATA``, ``.rs_bucket``, the object index,
snapshots and segments, journals), and every step must return the same
value or raise the same error class with the same message.  Timing fields
(``open_seconds``) are the only thing left out of the comparison.
Tolerance 0."""

import json
import os
import zlib

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch import store as t_store
from gpu_rscode_torch.store import snapshot as t_snap
from gpu_rscode_torch.update.engine import SimulatedCrash as TCrash
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu import store as j_store
from gpu_rscode_tpu.store import snapshot as j_snap
from gpu_rscode_tpu.update.engine import SimulatedCrash as JCrash
from gpu_rscode_tpu.utils import fileformat as j_ff

STRIPE = 64 * 1024
MAX_OBJECT = 8 * 1024
STAGES = ("after_journal", "mid_patch", "before_commit")
TIMING = {"open_seconds"}


class _Pkg:
    """One package's view of the scenario: its modules and its root."""

    def __init__(self, name, store, api, snap, ff, crash, root):
        self.name, self.store, self.api, self.snap, self.ff, self.crash = name, store, api, snap, ff, crash
        self.root = root
        os.makedirs(root, exist_ok=True)

    def open(self, name="bkt", **kw):
        if self.name == "t":
            kw.setdefault("device", "cpu")
        return self.store.open_bucket(self.root, name, **kw)

    def reopen(self, name="bkt"):
        self.store.drop_cached()
        return self.open(name)

    def path(self, *parts):
        return os.path.join(self.root, "bkt", *parts)


def _norm(x, roots):
    if isinstance(x, dict):
        return {k: _norm(v, roots) for k, v in x.items() if k not in TIMING}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, roots) for v in x)
    if isinstance(x, str):
        for r in roots:
            x = x.replace(r, "<root>")
    return x


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = fp.read()
    return out


class Twin:
    """The two packages side by side; :meth:`both` runs one step in each."""

    def __init__(self, tmp_path):
        self.j = _Pkg("j", j_store, j_api, j_snap, j_ff, JCrash, str(tmp_path / "j"))
        self.t = _Pkg("t", t_store, t_api, t_snap, t_ff, TCrash, str(tmp_path / "t"))
        self.roots = (self.j.root, self.t.root)

    def both(self, fn):
        """``fn(pkg)`` in each package; the returns (or the raised error's
        class and message) must be equal, and so must the two roots."""
        out = {}
        for pkg in (self.j, self.t):
            try:
                out[pkg.name] = ("ok", fn(pkg))
            except Exception as e:  # the comparison is the assertion
                out[pkg.name] = ("error", type(e).__name__, str(e))
        assert _norm(out["t"], self.roots) == _norm(out["j"], self.roots)
        self.same_disk()
        return out["t"]

    def same_disk(self):
        a, b = _tree(self.j.root), _tree(self.t.root)
        assert sorted(a) == sorted(b)
        assert [k for k in a if a[k] != b[k]] == []


@pytest.fixture(autouse=True)
def _fresh_buckets():
    j_store.drop_cached()
    t_store.drop_cached()
    yield
    j_store.drop_cached()
    t_store.drop_cached()


def _payload(rng, n=None):
    n = int(rng.integers(1, MAX_OBJECT + 1)) if n is None else n
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _create(tw, w=8, k=3, p=2):
    return tw.both(lambda m: m.open(create=True, k=k, p=p, w=w, stripe_bytes=STRIPE).stats())


# -- the seeded scenario ------------------------------------------------------


@pytest.mark.parametrize("w", [8, 16])
def test_scenario_byte_identical(tmp_path, monkeypatch, w):
    """put_many (duplicate keys in a batch), put with overwrite, GET of
    every object, list / list_page with prefix, limit and cursor, stat,
    stats, delete (and of a missing key), compact with and without force,
    stripe rolls at the seal, periodic checkpoints, reopen after
    drop_cached."""
    monkeypatch.setenv("RS_STORE_SNAPSHOT_RECORDS", "16")
    tw = Twin(tmp_path)
    rng = np.random.default_rng(100 + w)
    _create(tw, w=w)
    for _ in range(6):
        items = [(f"obj/{int(rng.integers(24)):02d}", _payload(rng)) for _ in range(7)]
        items.append((items[0][0], _payload(rng)))  # a duplicate: the later one wins
        tw.both(lambda m, items=items: m.open().put_many(items))
    tw.both(lambda m: m.open().put("obj/00", b"\x07" * 777))
    tw.both(lambda m: m.open().put("misc/z", _payload(np.random.default_rng(9), 1)))
    keys = [o["key"] for o in tw.both(lambda m: m.open().list_objects())[1]]
    for key in keys:
        tw.both(lambda m, key=key: m.open().get(key))
        tw.both(lambda m, key=key: m.open().stat(key))
    tw.both(lambda m: m.open().list_objects(prefix="obj/1"))
    cursor, seen = None, []
    while True:
        page = tw.both(lambda m, c=cursor: m.open().list_page(prefix="obj/", limit=3, cursor=c))[1]
        seen += [o["key"] for o in page["objects"]]
        if not page["truncated"]:
            break
        cursor = page["next"]
    assert seen == [k for k in keys if k.startswith("obj/")]
    tw.both(lambda m: m.open().list_page(cursor="%%%"))
    stats = tw.both(lambda m: m.open().stats())[1]
    assert len(stats["archives"]) >= 3  # the stripe rolled at the seal
    for key in keys[::3] + ["obj/99"]:
        tw.both(lambda m, key=key: m.open().delete(key))
    tw.both(lambda m: m.open().get(keys[0]))
    tw.both(lambda m: m.open().compact())
    tw.both(lambda m: m.open().compact(force=True))
    tw.both(lambda m: m.open().stats())
    report = tw.both(lambda m: m.reopen().open_report)[1]
    assert report["source"] == "snapshot"
    for key in keys:
        tw.both(lambda m, key=key: m.open().get(key))
    tw.both(lambda m: m.open().put_many([("after", _payload(np.random.default_rng(3)))]))
    tw.both(lambda m: m.store.probe(m.root))


# -- crash atomicity ------------------------------------------------------------


def _seed_objects(tw, n, size, prefix="k", batch=None):
    rng = np.random.default_rng(n * 7 + size)
    items = [(f"{prefix}{i}", _payload(rng, size)) for i in range(n)]
    step = batch or n
    for i in range(0, n, step):
        tw.both(lambda m, part=items[i : i + step]: m.open().put_many(part))
    return dict(items)


@pytest.mark.parametrize("stage", STAGES)
def test_torn_put_batch_identical(tmp_path, monkeypatch, stage):
    tw = Twin(tmp_path)
    _create(tw)
    objs = _seed_objects(tw, 3, 600)
    monkeypatch.setenv("RS_UPDATE_CRASH", stage)
    tw.both(lambda m: m.open().put_many([("new1", b"n" * 256), ("k0", b"CHANGED" * 64)]))
    monkeypatch.delenv("RS_UPDATE_CRASH")
    tw.both(lambda m: m.reopen().list_objects())  # recovery rolls the group back
    tw.both(lambda m: m.open().get("new1"))
    for key in objs:
        assert tw.both(lambda m, key=key: m.open().get(key))[1] == objs[key]
    tw.both(lambda m: m.open().put("fresh", b"f" * 300))  # advances past the pin
    tw.both(lambda m: m.reopen().get("new1"))


@pytest.mark.parametrize("stage", STAGES)
def test_torn_compaction_identical(tmp_path, monkeypatch, stage):
    tw = Twin(tmp_path)
    _create(tw)
    # Two sealed stripes of 9 x 8000 bytes and an open third: the
    # compaction's grouped append into the third is the crash surface.
    objs = _seed_objects(tw, 19, 8000, batch=9)
    for key in ("k0", "k1", "k2", "k3", "k4"):
        tw.both(lambda m, key=key: m.open().delete(key))
    monkeypatch.setenv("RS_UPDATE_CRASH", stage)
    tw.both(lambda m: m.open().compact())
    monkeypatch.delenv("RS_UPDATE_CRASH")
    live = tw.both(lambda m: [o["key"] for o in m.reopen().list_objects()])[1]
    assert live == sorted(set(objs) - {"k0", "k1", "k2", "k3", "k4"})
    for key in live:
        assert tw.both(lambda m, key=key: m.open().get(key))[1] == objs[key]
    tw.both(lambda m: m.open().compact())  # the redo retires
    tw.both(lambda m: m.reopen().stats())


def test_torn_delete_identical(tmp_path, monkeypatch):
    tw = Twin(tmp_path)
    _create(tw)
    _seed_objects(tw, 2, 512)
    monkeypatch.setenv("RS_UPDATE_CRASH", "mid_patch")
    tw.both(lambda m: m.open().delete("k1"))  # the tombstone is the commit
    monkeypatch.delenv("RS_UPDATE_CRASH")
    tw.both(lambda m: m.reopen().get("k1"))
    tw.both(lambda m: m.open().get("k0"))
    tw.both(lambda m: m.open().stats())


def test_inprocess_put_failure_scrubs_records_identically(tmp_path, monkeypatch):
    tw = Twin(tmp_path)
    _create(tw)
    _seed_objects(tw, 1, 128)

    def failing(*a, **kw):
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(j_api, "update_file_many", failing)
    monkeypatch.setattr(t_api, "update_file_many", failing)
    tw.both(lambda m: m.open().put_many([("x1", b"x" * 100), ("x2", b"y" * 100)]))
    monkeypatch.undo()
    tw.both(lambda m: m.open().get("x1"))
    tw.both(lambda m: m.open().put("after", b"z" * 100))
    tw.both(lambda m: m.reopen().list_objects())


def test_generation_mismatch_branch_reloads(tmp_path, monkeypatch):
    """``_append_batch`` trusts the group engine's ``generation`` and
    ``total_size``; a summary whose generation is not the pinned one makes
    the bucket refuse and reload from disk, alike in both packages."""
    tw = Twin(tmp_path)
    _create(tw)
    _seed_objects(tw, 2, 300)
    for api in (j_api, t_api):
        real = api.update_file_many

        def skewed(*a, _real=real, **kw):
            return {**_real(*a, **kw), "generation": -5}

        monkeypatch.setattr(api, "update_file_many", skewed)
    tw.both(lambda m: m.open().put("m", b"m" * 200))
    monkeypatch.undo()
    tw.both(lambda m: m.open().list_objects())  # reloaded: the commit itself landed
    tw.both(lambda m: m.open().get("m"))


def test_summary_keys_come_from_the_group_engine(tmp_path):
    """The port's ``update_file_many`` returns ``generation`` and
    ``total_size`` after the group commit (what a PUT batch pins to)."""
    tw = Twin(tmp_path)
    _create(tw)
    _seed_objects(tw, 1, 100)
    arc = tw.both(lambda m: m.open().stat("k0")["arc"])[1]
    got = tw.both(lambda m: m.api.update_file_many(
        m.path(arc), [{"op": "append", "data": b"q" * 50}], group_edits=1,
        **({"device": "cpu"} if m.name == "t" else {})))[1]
    assert got["generation"] == 1 and got["total_size"] == 150


# -- reads: degraded, bitrot, unrecoverable ---------------------------------------


def _chunk(m, arc, i):
    return m.ff.chunk_file_name(m.path(arc), i)


@pytest.mark.parametrize("w", [8, 16])
def test_degraded_get_after_native_loss(tmp_path, w):
    tw = Twin(tmp_path)
    _create(tw, w=w)
    objs = _seed_objects(tw, 8, 2048)
    arc = tw.both(lambda m: m.open().stat("k3")["arc"])[1]
    for m in (tw.j, tw.t):
        os.unlink(_chunk(m, arc, 1))

    def get(m, key):
        info = {}
        return m.open().get(key, info=info), info

    for key, want in objs.items():
        data, info = tw.both(lambda m, key=key: get(m, key))[1]
        assert data == want and info["path"] == "degraded"


def _flip_in_range(tw, key, *, fix_crc=False):
    """Flip the first byte of ``key``'s range in its native chunk (w=8,
    interleaved: file byte s lives in row s % k, column s // k); with
    ``fix_crc`` also rewrite that chunk's ``# crc32`` line so a scan takes
    the chunk as healthy."""
    st = tw.both(lambda m: m.open().stat(key))[1]
    k = tw.t.open().k
    row, col = st["at"] % k, st["at"] // k
    for m in (tw.j, tw.t):
        path = _chunk(m, st["arc"], row)
        with open(path, "r+b") as fp:
            fp.seek(col)
            byte = fp.read(1)
            fp.seek(col)
            fp.write(bytes([byte[0] ^ 0xFF]))
        if fix_crc:
            meta = m.ff.metadata_file_name(m.path(st["arc"]))
            crcs = dict(m.ff.read_archive_meta(meta).crcs)
            with open(path, "rb") as fp:
                crcs[row] = zlib.crc32(fp.read())
            m.ff.rewrite_checksums(meta, crcs)
    tw.same_disk()


def test_bitrot_caught_by_the_object_crc_and_repaired(tmp_path):
    tw = Twin(tmp_path)
    _create(tw)
    tw.both(lambda m: m.open().put("x", b"\x55" * 2048))
    _flip_in_range(tw, "x")
    assert tw.both(lambda m: m.open().get("x"))[1] == b"\x55" * 2048


def test_bitrot_past_the_parity_raises_the_same_error(tmp_path):
    """The rotted chunk's CRC line rewritten to match: the scan trusts it,
    the reconstruction reproduces the rot, and the object's own CRC
    refuses the bytes with a RangeReadError in both packages."""
    tw = Twin(tmp_path)
    _create(tw)
    tw.both(lambda m: m.open().put("x", b"\x55" * 2048))
    _flip_in_range(tw, "x", fix_crc=True)
    got = tw.both(lambda m: m.open().get("x"))
    assert got[0] == "error" and got[1] == "RangeReadError"
    assert "fails its CRC even after windowed reconstruction" in got[2]


def test_unrecoverable_range_raises_the_same_error(tmp_path):
    tw = Twin(tmp_path)
    _create(tw)
    tw.both(lambda m: m.open().put("x", b"\x33" * 3000))
    arc = tw.both(lambda m: m.open().stat("x")["arc"])[1]
    for m in (tw.j, tw.t):
        for i in (0, 1, 4):
            os.unlink(_chunk(m, arc, i))
    got = tw.both(lambda m: m.open().get("x"))
    assert got[0] == "error" and got[1] == "RangeReadError" and "unreadable" in got[2]
    tw.both(lambda m: m.store.read_range(m.path(arc), 0, 10, **({"device": "cpu"} if m.name == "t" else {})))
    tw.both(lambda m: m.store.read_range(m.path(arc), 2990, 20))  # out of bounds


# -- index snapshots ---------------------------------------------------------------


def _snap_corpus(tw, monkeypatch, records="3", keep="1000000", n=11):
    monkeypatch.setenv("RS_STORE_SNAPSHOT_RECORDS", records)
    monkeypatch.setenv("RS_STORE_SNAPSHOT_KEEP", keep)
    _create(tw)
    for i in range(n):
        tw.both(lambda m, i=i: m.open().put(f"k{i % 4}", bytes([97 + i]) * (60 + i)))


def test_snapshot_open_equals_full_replay(tmp_path, monkeypatch):
    tw = Twin(tmp_path)
    _snap_corpus(tw, monkeypatch)
    tw.both(lambda m: m.open().delete("k1"))
    monkeypatch.setenv("RS_UPDATE_CRASH", "before_commit")
    tw.both(lambda m: m.open().put("ghost", b"g" * 256))
    monkeypatch.delenv("RS_UPDATE_CRASH")
    tw.both(lambda m: m.reopen().compact(force=True))

    def state(m):
        b = m.reopen()
        return b.open_report, [(o["key"], b.get(o["key"])) for o in b.list_objects()]

    snap = tw.both(state)[1]
    monkeypatch.setenv("RS_STORE_SNAPSHOT_DISABLE", "1")
    full = tw.both(state)[1]
    assert snap[0]["source"] == "snapshot" and full[0]["source"] == "log"
    assert snap[1] == full[1]


def _damage(m, how):
    bdir = m.path()
    snaps = m.snap.list_snapshots(bdir)
    if how == "all_damaged":
        for n in snaps:
            with open(m.snap.snapshot_path(bdir, n), "w") as fp:
                fp.write("{garbage")
        return
    if how == "pruned":
        for n in snaps:
            os.unlink(m.snap.snapshot_path(bdir, n))
        return
    newest = m.snap.snapshot_path(bdir, snaps[-1])
    with open(newest) as fp:
        blob = fp.read()
    doc = json.loads(blob)
    if how == "torn":
        text = blob[: len(blob) // 2]
    elif how == "corrupt":
        doc["payload"]["entries"].popitem()  # the digest no longer matches
        text = json.dumps(doc)
    else:  # foreign_algo: rejected before the digest is checked
        doc["algo_version"] = 99
        doc["payload_digest"] = m.snap.payload_digest(doc["payload"])
        text = json.dumps(doc)
    with open(newest, "w") as fp:
        fp.write(text)


@pytest.mark.parametrize("damage", ["torn", "corrupt", "foreign_algo", "all_damaged", "pruned"])
def test_snapshot_fallback_matrix_identical(tmp_path, monkeypatch, damage):
    """Each damaged-snapshot case of the JAX package's fallback matrix, in
    both packages: one rung down (slower, never wrong), full replay when
    every snapshot is damaged, and a loud ObjectStoreError once pruned
    history has no snapshot left."""
    tw = Twin(tmp_path)
    _snap_corpus(tw, monkeypatch, keep="1" if damage == "pruned" else "1000000", n=14)
    for m in (tw.j, tw.t):
        _damage(m, damage)
    tw.same_disk()

    def reopen(m):
        b = m.reopen()
        return b.open_report, [(o["key"], b.get(o["key"])) for o in b.list_objects()]

    got = tw.both(reopen)
    if damage == "pruned":
        assert got[0] == "error" and got[1] == "ObjectStoreError" and "unrecoverable" in got[2]
    elif damage == "all_damaged":
        assert got[1][0]["source"] == "log"
    else:
        assert got[1][0]["snapshots_skipped"] >= 1


def test_rolled_back_records_never_reach_a_segment(tmp_path, monkeypatch):
    tw = Twin(tmp_path)
    monkeypatch.setenv("RS_STORE_SNAPSHOT_RECORDS", "2")
    monkeypatch.setenv("RS_STORE_SNAPSHOT_KEEP", "1000000")
    _create(tw)
    tw.both(lambda m: m.open().put("seed", b"s" * 128))
    monkeypatch.setenv("RS_UPDATE_CRASH", "before_commit")
    tw.both(lambda m: m.open().put("ghost", b"g" * 256))
    monkeypatch.delenv("RS_UPDATE_CRASH")
    tw.both(lambda m: m.reopen().list_objects())
    for i in range(5):
        tw.both(lambda m, i=i: m.open().put(f"fresh{i}", bytes([i + 1]) * 200))
    monkeypatch.setenv("RS_STORE_SNAPSHOT_DISABLE", "1")
    tw.both(lambda m: m.reopen().get("ghost"))


# -- the rs object CLI ----------------------------------------------------------------


def test_object_cli_identical(tmp_path, capsys):
    """``rs object`` through both CLIs: the same exit codes, the same stdout
    (JSON) and the same files."""
    tw = Twin(tmp_path)
    rng = np.random.default_rng(5)
    payloads = {}
    for name in ("a", "b", "c"):
        payloads[name] = str(tmp_path / f"{name}.bin")
        with open(payloads[name], "wb") as fp:
            fp.write(_payload(rng))

    def run(m, *argv):
        extra = ["--root", m.root] + (["--device", "cpu"] if m.name == "t" else [])
        main = t_cli.main if m.name == "t" else j_cli.main
        capsys.readouterr()
        rc = main(["object", *argv, *extra])
        out = capsys.readouterr().out
        return rc, out

    for name in ("a", "b", "c"):
        tw.both(lambda m, name=name: run(m, "put", "bkt", f"key/{name}", "--in", payloads[name], "--k", "3",
                                         "--p", "2", "--stripe-kb", "64", "--json"))
    for name in ("a", "b"):
        out = {m.name: str(tmp_path / f"out-{m.name}-{name}") for m in (tw.j, tw.t)}
        tw.both(lambda m, name=name: (run(m, "get", "bkt", f"key/{name}", "--out", out[m.name])[0],
                                      open(out[m.name], "rb").read()))
        for path in out.values():
            os.unlink(path)
    tw.both(lambda m: run(m, "ls", "bkt", "--json"))
    tw.both(lambda m: run(m, "ls", "bkt", "--limit", "2", "--json"))
    tw.both(lambda m: run(m, "ls", "bkt", "--prefix", "key/b"))
    tw.both(lambda m: run(m, "stat", "bkt", "key/c", "--json"))

    def bucket_stat(m):
        rc, out = run(m, "stat", "bkt", "--json")
        return rc, json.loads(out)

    tw.both(bucket_stat)
    tw.both(lambda m: run(m, "rm", "bkt", "key/a", "--json"))
    tw.both(lambda m: run(m, "get", "bkt", "key/a", "--out", str(tmp_path / f"gone-{m.name}")))
    tw.both(lambda m: run(m, "compact", "bkt", "--force", "--json"))
    tw.both(lambda m: run(m, "ls", "bkt", "--cursor", "%%%"))


def test_openbench_runs_through_the_port(tmp_path, capsys):
    """``rs object openbench`` on the CPU: the capture starts with the
    port's capture header, both arms verified, the same ladder counts as
    the JAX package's for the same build."""
    rows = {}
    for name, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        cap = str(tmp_path / f"{name}.jsonl")
        rc = main(["object", "openbench", "--puts", "60", "--keys", "12", "--batch", "6", "--snapshot-records", "16",
                   "--trials", "1", "--sample", "8", "--json", "--capture", cap, *extra])
        assert rc == 0
        with open(cap) as fp:
            rows[name] = [json.loads(line) for line in fp]
    capsys.readouterr()
    assert rows["t"][0]["kind"] == "capture_header" and rows["t"][0]["tool"] == "store_open_ab"
    keep = ("kind", "arm", "source", "snapshot", "segments_replayed", "records_replayed", "verified")
    for got, want in zip(rows["t"][1:3], rows["j"][1:3]):
        assert {k: got[k] for k in keep} == {k: want[k] for k in keep}
        assert got["verified"] is True
    assert rows["t"][3]["tail_bounded"] is True
    assert rows["t"][3]["tail_records"] == rows["j"][3]["tail_records"]


# -- the device convention ------------------------------------------------------------


def test_no_device_and_no_gpu_raises(tmp_path):
    root = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_store.open_bucket(root, "b", create=True)
    t_store.open_bucket(root, "b", create=True, device="cpu").put("x", b"x" * 10)
    t_store.drop_cached()
    calls = [
        lambda: t_api.put_object(root, "b", "y", b"y"),
        lambda: t_api.put_objects(root, "b", [("y", b"y")]),
        lambda: t_api.get_object(root, "b", "x"),
        lambda: t_api.delete_object(root, "b", "x"),
        lambda: t_api.list_objects(root, "b"),
        lambda: t_api.list_objects_page(root, "b", limit=1),
        lambda: t_api.stat_object(root, "b", "x"),
        lambda: t_api.compact_bucket(root, "b", force=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert t_api.get_object(root, "b", "x", device="cpu") == b"x" * 10


def test_cli_without_device_fails(tmp_path, capsys):
    src = tmp_path / "p.bin"
    src.write_bytes(b"p" * 10)
    rc = t_cli.main(["object", "put", "bkt", "k", "--in", str(src), "--root", str(tmp_path)])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_reopen_on_another_device_raises(tmp_path):
    root = str(tmp_path)
    t_store.open_bucket(root, "b", create=True, device="cpu")
    assert t_store.open_bucket(root, "b", device=t_store.open_bucket(root, "b", device="cpu").device)
    with pytest.raises(ValueError, match=r"open on cpu, not meta"):
        t_store.open_bucket(root, "b", device="meta")
    t_store.drop_cached()
    assert t_store.open_bucket(root, "b", device="meta").device.type == "meta"
