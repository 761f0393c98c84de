"""The port's serving daemon (``gpu_rscode_torch.serve``) against the JAX
package's, on the CPU.

The same seeded requests go to a JAX daemon (under ``JAX_PLATFORMS=cpu``)
and a port daemon (``device="cpu"``), each on port 0 with its own root.
Every response must carry the same status, the same headers that matter
(request id echo, cache verdict, read path, batch size, Retry-After) and
the same body, with the timings (``queue_wait_ms``, ``service_ms``,
``stages_ms``, a bucket's ``open_seconds``) and the random ids (minted request ids, write-group ids)
left out.  Where the request order is fixed (serial requests, or a group
whose members the batcher harvests in one window), both roots must hold
the same files with the same bytes.  Archives are at most 64 KiB and
object stripes 64 KiB.  Tolerance 0."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch import store as t_store
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.serve import batcher as t_batcher
from gpu_rscode_torch.serve import daemon as t_daemon
from gpu_rscode_torch.serve import objcache as t_objcache
from gpu_rscode_torch.serve import queue as t_queue
from gpu_rscode_torch.update import group as t_group
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu import store as j_store
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.serve import batcher as j_batcher
from gpu_rscode_tpu.serve import daemon as j_daemon
from gpu_rscode_tpu.serve import objcache as j_objcache
from gpu_rscode_tpu.serve import queue as j_queue
from gpu_rscode_tpu.update import group as j_group

TIMING = {"queue_wait_ms", "service_ms", "stages_ms", "open_seconds"}
HEADERS = ("X-RS-Request-Id", "X-RS-Cache", "X-RS-Read-Path", "X-RS-Batch", "Retry-After", "Content-Type")
_GROUP_ID = re.compile(r"^(wg|og)-[0-9a-f]{16}$")


@pytest.fixture(autouse=True)
def _clean_planes():
    j_store.drop_cached()
    t_store.drop_cached()
    yield
    j_store.drop_cached()
    t_store.drop_cached()
    for m in (j_metrics, t_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


# -- the queue, the batcher and the object cache -------------------------------


def _admissions(qmod, seed: int):
    """A seeded admission sequence through one package's queue: the pop
    order (tenant, name), the names refused with QueueFull, and the
    state snapshots along the way."""
    rng = np.random.default_rng(seed)
    q = qmod.AdmissionQueue(depth=6, quantum=64 * 1024)
    now = time.monotonic()
    log = []
    for i in range(40):
        if rng.random() < 0.7:
            tenant = ["alpha", "beta", "gamma"][int(rng.integers(0, 3))]
            deadline = None if rng.random() < 0.6 else now + float(rng.integers(1, 100))
            req = qmod.Request("encode", tenant, f"n{i}", f"/x/n{i}", k=4, p=2,
                               cost=int(rng.integers(1, 300_000)), deadline=deadline)
            try:
                q.submit(req)
                log.append(("admit", req.name, req.seq))
            except qmod.QueueFull as e:
                log.append(("429", req.name, str(e)))
        else:
            got = q.pop(timeout=0)
            log.append(("pop", None if got is None else (got.tenant, got.name)))
        snap = q.snapshot()
        log.append(("snap", snap["depth"], snap["admitted"], snap["rejected"], snap["tenants"], snap["deficits"]))
    q.drain()
    with pytest.raises(qmod.Draining):
        q.submit(qmod.Request("encode", "alpha", "late", "/x/late"))
    while (got := q.pop(timeout=0)) is not None:
        log.append(("pop", (got.tenant, got.name)))
    return log


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_queue_admissions_pop_order_and_429s_equal_jax(seed):
    t, j = _admissions(t_queue, seed), _admissions(j_queue, seed)
    assert t == j
    assert any(e[0] == "429" for e in t)


def _batches(qmod, bmod, seed: int):
    """A seeded burst of mixed requests, harvested by one package's batcher
    with a long window: the groups it forms, in order."""
    rng = np.random.default_rng(seed)
    q = qmod.AdmissionQueue(depth=64)
    ops = ["encode", "decode", "update", "append", "object_put", "object_get", "scrub"]
    for i in range(24):
        op = ops[int(rng.integers(0, len(ops)))]
        q.submit(qmod.Request(op, ["a", "b"][int(rng.integers(0, 2))], f"f{int(rng.integers(0, 3))}", "/x",
                              k=int(rng.integers(3, 5)), p=2, w=[8, 16][int(rng.integers(0, 2))],
                              cost=int(rng.integers(1, 10_000)), key=f"k{i}"))
    b = bmod.Batcher(q, batch_ms=60_000, max_batch=int(rng.integers(4, 9)))
    out = []
    while q.depth():
        out.append([[(r.op, r.tenant, r.name, r.seq, r.batch_id) for r in g] for g in b.next_batches(timeout=0)])
    return out, b.snapshot()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_batcher_groups_equal_jax(seed):
    assert _batches(t_queue, t_batcher, seed) == _batches(j_queue, j_batcher, seed)


def _cache_run(mod, seed: int):
    """A seeded GET / PUT / DELETE sequence through one package's object
    cache: every lookup's verdict and the stats after each step."""
    rng = np.random.default_rng(seed)
    cache = mod.ObjectCache(cap_bytes=20_000)
    entries: dict[str, dict] = {}
    blobs: dict[str, bytes] = {}
    log = []
    for step in range(200):
        key = f"k{int(rng.zipf(1.3)) % 12}"
        roll = rng.random()
        if roll < 0.25 or key not in entries:  # PUT (over)writes the key
            data = rng.integers(0, 256, size=int(rng.integers(1, 6000)), dtype=np.uint8).tobytes()
            entries[key] = {"arc": f"a{step}", "at": step, "len": len(data), "crc": zlib.crc32(data), "gen": 0}
            blobs[key] = data
            cache.invalidate("t", "b", key)
            log.append(("put", key))
        elif roll < 0.32:  # DELETE
            entries.pop(key)
            cache.invalidate("t", "b", key)
            log.append(("del", key))
        else:  # GET: a miss fills
            hit = cache.get("t", "b", key, entries[key])
            if hit is None:
                cache.put("t", "b", key, entries[key], blobs[key])
            else:
                assert hit == blobs[key]
            log.append(("get", key, hit is not None))
        log.append(cache.stats())
    cache.invalidate("t", "b")
    log.append(cache.stats())
    return log


@pytest.mark.parametrize("seed", [8, 9])
def test_object_cache_verdicts_and_stats_equal_jax(seed):
    t, j = _cache_run(t_objcache, seed), _cache_run(j_objcache, seed)
    assert t == j
    final = t[-2]
    assert final["hits"] and final["misses"] and final["evictions"] and final["invalidations"]


# -- the daemons, side by side ------------------------------------------------


def _call(port, method, path, body=b"", tenant="t", headers=None, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers={"X-RS-Tenant": tenant, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        payload, hdrs = e.read(), dict(e.headers or {})
        e.close()
        return e.code, payload, hdrs


def _norm(x, roots):
    if isinstance(x, dict):
        return {k: _norm(v, roots) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_norm(v, roots) for v in x]
    if isinstance(x, str):
        if _GROUP_ID.match(x):
            return x[:3] + "*"
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


class Twins:
    """A JAX daemon and a port daemon with the same knobs; :meth:`both`
    sends one request to each and compares the answers."""

    def __init__(self, tmp_path, **kw):
        self.j = j_daemon.ServeDaemon(str(tmp_path / "j"), port=0, **kw).start()
        self.t = t_daemon.ServeDaemon(str(tmp_path / "t"), port=0, device="cpu", **kw).start()
        self.roots = (self.j.root, self.t.root)
        self.n = 0

    def both(self, method, path, body=b"", tenant="t", headers=None, want=None, echo=True):
        self.n += 1
        rid = f"cid-{self.n}"
        hdrs = {"X-RS-Request-Id": rid, **(headers or {})}
        out = [_call(d.port, method, path, body, tenant, hdrs) for d in (self.j, self.t)]
        (js, jb, jh), (ts, tb, th) = out
        assert ts == js, (path, js, jb, ts, tb)
        if want is not None:
            assert ts == want, (path, tb)
        if echo:  # every answer to a request-bearing path echoes the id
            assert th.get("X-RS-Request-Id") == rid
        assert {h: th.get(h) for h in HEADERS} == {h: jh.get(h) for h in HEADERS}, path
        if th.get("Content-Type") == "application/json":
            jd, td = json.loads(jb), json.loads(tb)
            if "req_id" in td:
                assert td["req_id"] == rid
            assert _norm(td, self.roots) == _norm(jd, self.roots), path
            return ts, td
        assert tb == jb, path
        return ts, tb

    def same_disk(self):
        # Each daemon unlinks a decode's output after its last byte went
        # out, so the client can hold the whole answer first: let both
        # handlers finish before the trees are compared.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(".out." in name for root in self.roots for name in _tree(root)):
            time.sleep(0.01)
        a, b = _tree(self.j.root), _tree(self.t.root)
        assert sorted(a) == sorted(b)
        assert [k for k in a if a[k] != b[k]] == []

    def each_root(self, fn):
        for d in (self.j, self.t):
            fn(d.root)

    def close(self):
        for d in (self.j, self.t):
            d.close(drain=True, timeout=60)


@pytest.fixture
def twins(tmp_path, monkeypatch):
    # The group-commit tallies in /stats are process-wide: both packages
    # count from zero here, whatever other files ran in this worker first.
    for mod in (j_group, t_group):
        monkeypatch.setattr(mod, "_STATS", dict.fromkeys(mod._STATS, 0))
    tw = Twins(tmp_path, batch_ms=0)
    yield tw
    tw.close()


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def test_file_routes_answer_and_write_alike(twins):
    """Encode (row and interleaved, w=8 and w=16), decode after losses,
    scrub with and without syndrome=1, update and append, one write group:
    equal responses and byte-equal roots after every step."""
    src = {"a.bin": _bytes(1, 40_000), "b.bin": _bytes(2, 30_000), "c.bin": _bytes(3, 20_001),
           "d.bin": _bytes(4, 12_345)}
    _, enc = twins.both("POST", "/encode?name=a.bin&k=4&n=6&checksum=1", src["a.bin"], want=200)
    # The derived device/drain boundary needs the pipeline's write*(io)
    # phase names on every timed route.
    assert "device_done" in enc["stages_ms"]
    twins.both("POST", "/encode?name=b.bin&k=4&n=6&layout=interleaved", src["b.bin"], want=200)
    twins.both("POST", "/encode?name=c.bin&k=3&n=5&w=16", src["c.bin"], want=200)
    twins.both("POST", "/encode?name=d.bin&k=4&n=7&w=16&layout=interleaved&checksum=0", src["d.bin"], want=200)
    twins.same_disk()

    twins.each_root(lambda r: [os.unlink(chunk_file_name(os.path.join(r, "t", "a.bin"), i)) for i in (0, 1)])
    _, body = twins.both("POST", "/decode?name=a.bin", want=200)
    assert body == src["a.bin"]
    assert "device_done" in json.loads(_call(twins.t.port, "POST", "/decode?name=a.bin")[2]["X-RS-Stages"])
    twins.each_root(lambda r: os.unlink(chunk_file_name(os.path.join(r, "t", "c.bin"), 0)))
    _, body = twins.both("POST", "/decode?name=c.bin", want=200)
    assert body == src["c.bin"]
    twins.same_disk()

    def flip(root):
        with open(chunk_file_name(os.path.join(root, "t", "d.bin"), 5), "r+b") as fp:
            fp.seek(100)
            b = fp.read(1)
            fp.seek(100)
            fp.write(bytes([b[0] ^ 0x5A]))

    twins.each_root(flip)
    _, plain = twins.both("POST", "/scrub?name=d.bin", want=200)
    _, syn = twins.both("POST", "/scrub?name=d.bin&syndrome=1", want=200)
    assert plain["report"]["corrupt"] == [] and syn["report"]["syndrome"]["silent_bitrot"] == [5]

    edit, tail = _bytes(5, 500), _bytes(6, 3000)
    _, up = twins.both("POST", "/update?name=b.bin&at=1000", edit, want=200)
    _, ap = twins.both("POST", "/append?name=b.bin", tail, want=200)
    assert up["update"]["generation"] == 1 and ap["update"]["total_size"] == 33_000
    assert "device_done" in up["stages_ms"] and "device_done" in ap["stages_ms"]
    twins.same_disk()

    # A write group: three edits harvested in one window (the window
    # closes at max_batch), one group commit in each daemon.
    for d in (twins.j, twins.t):
        d.batcher.batch_ms, d.batcher.max_batch = 60_000, 3
    edits = [(200 * i, _bytes(10 + i, 64)) for i in range(3)]
    answers = {}

    def send(d, i):
        answers[(d.port, i)] = _call(d.port, "POST", f"/update?name=b.bin&at={edits[i][0]}", edits[i][1], "t",
                                     {"X-RS-Request-Id": f"g-{i}"})

    threads = [threading.Thread(target=send, args=(d, i)) for d in (twins.j, twins.t) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    docs = {key: json.loads(val[1]) for key, val in answers.items()}
    for d in (twins.j, twins.t):
        group = {docs[(d.port, i)]["update"]["group_id"] for i in range(3)}
        assert len(group) == 1 and all(docs[(d.port, i)]["update"]["grouped"] == 3 for i in range(3))
    for i in range(3):
        assert _norm(docs[(twins.t.port, i)], twins.roots) == _norm(docs[(twins.j.port, i)], twins.roots)
    twins.same_disk()
    for d in (twins.j, twins.t):
        d.batcher.batch_ms, d.batcher.max_batch = 0, 16
    mirror = bytearray(src["b.bin"])
    mirror[1000:1500] = edit
    mirror += tail
    for at, data in edits:
        mirror[at:at + len(data)] = data
    _, body = twins.both("POST", "/decode?name=b.bin", want=200)
    assert body == bytes(mirror)


def test_object_routes_answer_and_write_alike(twins):
    """PUT / GET / DELETE /o/ with ?list, ?prefix, ?limit and ?stats=1 on a
    64 KiB-stripe bucket, serially: equal answers (cache verdicts and read
    paths included) and byte-equal roots."""
    objs = {f"k{i}": _bytes(20 + i, 500 + 1700 * i) for i in range(6)}
    for i, (key, data) in enumerate(objs.items()):
        shape = "?k=4&n=6&stripe_kb=64" if i == 0 else ""
        twins.both("PUT", f"/o/bk/{key}{shape}", data, want=200)
    twins.same_disk()
    for key, data in objs.items():
        for _ in range(2):  # a miss, then a hit
            _, body = twins.both("GET", f"/o/bk/{key}", want=200)
            assert body == data
    twins.both("PUT", "/o/bk/k1", _bytes(40, 900), want=200)  # overwrite invalidates
    _, body = twins.both("GET", "/o/bk/k1", want=200)
    assert body == _bytes(40, 900)
    twins.both("GET", "/o/bk?list", want=200)
    twins.both("GET", "/o/bk?list&prefix=k&limit=2", want=200)
    twins.both("GET", "/o/bk?stats=1", want=200)
    twins.both("DELETE", "/o/bk/k2", want=200)
    twins.both("GET", "/o/bk/k2", want=404)
    twins.both("DELETE", "/o/bk/k2", want=404)
    twins.same_disk()
    stats = [_call(d.port, "GET", "/stats")[1] for d in (twins.j, twins.t)]
    j_stats, t_stats = (json.loads(s) for s in stats)
    for block in ("objcache", "queue", "batcher", "group_commit", "slo", "maint"):
        assert t_stats[block] == j_stats[block], block
    assert _norm(t_stats["store"], twins.roots) == _norm(j_stats["store"], twins.roots)


def test_error_paths_answer_alike_with_the_id_echoed(twins):
    """400, 404 and 504 answers, each with the request id echoed."""
    twins.both("POST", "/encode?name=a.bin&k=4&n=6", _bytes(1, 5000), want=200)
    for path in ("/encode?name=../x&k=4&n=6", "/encode?name=e.bin&k=4&n=3", "/encode?name=e.bin&k=4&n=6&w=12",
                 "/encode?name=e.bin&k=4&n=6&layout=bogus", "/update?name=a.bin&at=xx"):
        twins.both("POST", path, b"abc", want=400)
    twins.both("POST", "/encode?name=e.bin&k=4&n=6", b"", want=400)
    twins.both("PUT", "/o/bk/k9?k=4", b"abc", want=400)
    twins.both("PUT", "/o/bk/k9", b"", want=400)
    twins.both("POST", "/nope", want=404)
    twins.both("POST", "/decode?name=missing.bin", want=404)
    twins.both("POST", "/update?name=missing.bin&at=0", b"x", want=404)
    twins.both("GET", "/o/bk/nokey", want=404)
    twins.both("PUT", "/nope", b"x", want=404)
    twins.both("GET", "/nope", want=404, echo=False)  # introspection paths carry no id
    twins.both("POST", "/scrub?name=a.bin", headers={"X-RS-Deadline-Ms": "0"}, want=504)
    twins.same_disk()


def test_429_and_503_answer_alike_with_the_id_echoed(tmp_path):
    """Depth 1, one worker whose slot the test holds: the first request is
    popped and waits for the slot, the second fills the queue, the third
    answers 429 with Retry-After 1.  After a drain, 503 with Retry-After
    5.  The admitted two commit alike in both roots."""
    tw = Twins(tmp_path, batch_ms=0, depth=1, workers=1)
    try:
        for d in (tw.j, tw.t):
            d._slots.acquire()
        results = {}

        def send(d, i):
            results[(d.port, i)] = _call(d.port, "POST", f"/encode?name=q{i}.bin&k=4&n=6", _bytes(i, 3000), "t",
                                         {"X-RS-Request-Id": f"q-{i}"})

        def wait_until(pred):
            for _ in range(500):
                if pred():
                    return
                time.sleep(0.01)
            raise AssertionError("daemon state not reached")

        threads = []
        for i in range(2):
            for d in (tw.j, tw.t):
                th = threading.Thread(target=send, args=(d, i))
                th.start()
                threads.append(th)
                # The first is popped (the scheduler waits on the slot),
                # the second stays queued.
                wait_until(lambda d=d, i=i: d.queue.admitted == i + 1 and d.queue.depth() == i)
        tw.both("POST", "/encode?name=q9.bin&k=4&n=6", b"zz", want=429)
        for d in (tw.j, tw.t):
            d._slots.release()
        for th in threads:
            th.join(timeout=120)
        for i in range(2):
            assert results[(tw.j.port, i)][0] == results[(tw.t.port, i)][0] == 200
            assert results[(tw.t.port, i)][2]["X-RS-Request-Id"] == f"q-{i}"
        for d in (tw.j, tw.t):
            assert d.drain(timeout=60)
        tw.both("POST", "/encode?name=late.bin&k=4&n=6", b"zz", want=503)
        tw.same_disk()
    finally:
        tw.close()


# -- what the port refuses, and its device --------------------------------------


def test_maint_and_perf_are_refused(tmp_path, monkeypatch, capsys):
    """The maintenance and fault planes now run (maint=True, RS_MAINT=1,
    --maint, --faults start and answer); GET /perf is still refused with
    501 (obs/perfbase is not ported)."""
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", maint=True)
    assert d.maint is not None and d.maint.device == d.device and d.maint.tenant == "maint"
    d.close()
    monkeypatch.setenv("RS_MAINT", "1")
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu")
    assert d.maint is not None
    d.close()
    monkeypatch.delenv("RS_MAINT")
    # The CLI's flags pass validation (a bad spec is a usage error, exit 2);
    # a malformed --faults still exits 2 before the daemon binds.
    assert t_cli.main(["serve", "--root", str(tmp_path / "r"), "--port", "0", "--device", "cpu",
                       "--faults", "read:melt"]) == 2
    assert "bad --faults spec" in capsys.readouterr().err
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu").start()
    try:
        st, body, _ = _call(d.port, "GET", "/perf")
        assert st == 501 and b"obs/perfbase" in body
        st, body, _ = _call(d.port, "GET", "/maint")
        assert st == 200 and json.loads(body)["enabled"] is False
    finally:
        d.close()
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", maint=True).start()
    try:
        st, body, _ = _call(d.port, "GET", "/maint")
        doc = json.loads(body)
        assert st == 200 and doc["enabled"] is True and doc["running"] is True and "queue" in doc
        assert _call(d.port, "GET", "/stats")[0] == 200 and d.stats()["maint"]["enabled"] is True
        st, body, _ = _call(d.port, "GET", "/perf")
        assert st == 501
    finally:
        d.close()


def test_serve_cli_runs_with_maint_and_faults(tmp_path):
    """`rs serve --maint --faults SPEC` in a process of its own: it
    listens (maint on), answers, and drains on SIGTERM."""
    import signal
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "RS_MAINT")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "gpu_rscode_torch", "serve", "--root", str(tmp_path / "r"),
                             "--port", "0", "--device", "cpu", "--maint", "--faults", "read:delay@ms=1"],
                            env=env, cwd=env["PYTHONPATH"], stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "listening on" in line and "maint on" in line, line
        port = int(re.search(r":(\d+) ", line).group(1))
        st, body, _ = _call(port, "GET", "/maint")
        assert st == 200 and json.loads(body)["enabled"] is True
    finally:
        proc.send_signal(signal.SIGTERM)
        err = proc.communicate(timeout=60)[1]
    assert proc.returncode == 0 and "drained" in err


def test_without_a_device_on_a_gpu_less_box_the_daemon_raises(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_daemon.ServeDaemon(str(tmp_path / "r"), port=0)
    assert t_cli.main(["serve", "--root", str(tmp_path / "r"), "--port", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "r")  # refused before it made its root


def test_a_second_daemon_on_another_device_does_not_reuse_the_first_ones_bucket(tmp_path, monkeypatch):
    """The bucket cache is keyed by path; a daemon on another device must
    not serve from the first one's bucket silently (the port's
    ``open_bucket`` raises, and the route answers 400 naming both)."""
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", batch_ms=0).start()
    try:
        assert _call(d.port, "PUT", "/o/bk/k?k=4&n=6&stripe_kb=64", b"abc")[0] == 200
        d.device = t_daemon.resolve_device("meta")
        st, body, _ = _call(d.port, "GET", "/o/bk/k")
        assert st == 400 and b"is open on cpu, not meta" in body
    finally:
        d.device = t_daemon.resolve_device("cpu")
        d.close()


def test_two_workers_encode_distinct_archives_at_once(tmp_path, monkeypatch):
    """Two executor threads run two encodes concurrently (a barrier inside
    the api call proves the overlap); each archive equals the one a serial
    encode writes."""
    barrier = threading.Barrier(2, timeout=60)
    real = t_api.encode_file
    threads_seen = set()

    def overlapped(*a, **kw):
        threads_seen.add(threading.current_thread().name)
        barrier.wait()
        return real(*a, **kw)

    monkeypatch.setattr(t_api, "encode_file", overlapped)
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", batch_ms=0, workers=2).start()
    data = {i: _bytes(50 + i, 20_000 + 777 * i) for i in range(2)}
    results = {}
    try:
        ths = [threading.Thread(target=lambda i=i: results.update(
            {i: _call(d.port, "POST", f"/encode?name=c{i}.bin&k=4&n=6", data[i], "t")[0]})) for i in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        d.close()
    assert results == {0: 200, 1: 200}
    assert len(threads_seen) == 2
    monkeypatch.setattr(t_api, "encode_file", real)
    serial = tmp_path / "serial"
    serial.mkdir()
    for i in range(2):
        path = serial / f"c{i}.bin"
        path.write_bytes(data[i])
        t_api.encode_file(str(path), 4, 2, checksums=True, device="cpu")
        os.unlink(path)
    assert _tree(str(serial)) == _tree(os.path.join(str(tmp_path / "r"), "t"))


def test_stage_timeline_is_monotonic_and_sums_to_the_wall(tmp_path):
    """The wide event's stage offsets are non-decreasing, and their
    consecutive durations sum to the request wall (within 1e-9 s).  The
    event is emitted after the response is written, so the test waits for
    it in the ring instead of reading the ring once."""
    from gpu_rscode_torch.obs import reqtrace

    reqtrace.reset()
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", batch_ms=5).start()
    try:
        st, body, _ = _call(d.port, "POST", "/encode?name=tl.bin&k=4&n=6", _bytes(7, 50_000), "t",
                            {"X-RS-Request-Id": "cid-tl"})
        assert st == 200
        stages = json.loads(body)["stages_ms"]
        vals = [stages[s] for s in reqtrace.STAGES if s in stages]
        assert vals == sorted(vals)
        ev = None
        for _ in range(500):
            ev = next((e for e in reqtrace.recent(50) if e["req_id"] == "cid-tl"), None)
            if ev is not None:
                break
            time.sleep(0.01)
        assert ev is not None
        offs = [ev["stages"][s] for s in reqtrace.STAGES if s in ev["stages"]]
        assert offs == sorted(offs) and list(ev["stages"])[-1] == "ack"
        assert ev["wall_s"] == pytest.approx(offs[-1])
        assert sum(b - a for a, b in zip(offs, offs[1:])) == pytest.approx(ev["wall_s"], abs=1e-9)
    finally:
        d.close()


def test_fleet_fallback_counts_and_reruns_solo_on_the_same_device(tmp_path, monkeypatch):
    """A failing fleet is counted in rs_serve_batch_fallbacks_total and its
    members re-run solo (on the daemon's device); a member that fails
    there too answers 500 with its own error."""
    seen = []

    def broken_fleet(*a, **kw):
        raise RuntimeError("fleet down")

    real = t_api.encode_file

    def solo(path, *a, **kw):
        seen.append(kw.get("device"))
        if path.endswith("bad.bin"):
            raise ValueError("this one is poisoned")
        return real(path, *a, **kw)

    monkeypatch.setattr(t_api, "encode_fleet", broken_fleet)
    monkeypatch.setattr(t_api, "encode_file", solo)
    d = t_daemon.ServeDaemon(str(tmp_path / "r"), port=0, device="cpu", batch_ms=60_000, max_batch=2).start()
    out = {}
    try:
        ths = [threading.Thread(target=lambda n=n: out.update(
            {n: _call(d.port, "POST", f"/encode?name={n}&k=4&n=6", _bytes(8, 4000), "t")})) for n in ("ok.bin",
                                                                                                   "bad.bin")]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
        assert out["ok.bin"][0] == 200 and out["bad.bin"][0] == 500
        assert b"this one is poisoned" in out["bad.bin"][1]
        assert [str(s) for s in seen] == ["cpu", "cpu"]
        fallbacks = t_metrics.REGISTRY.snapshot()["rs_serve_batch_fallbacks_total"]["values"]
        assert sum(fallbacks.values()) == 1
    finally:
        d.close()
