"""The port's fault plane and retry policy against the JAX package's, on the
CPU: the spec grammar and its errors, the seeded draws, the fire caps, the
torn write lanes, the retry delays for a seed and the transient/fatal
classes; then the four verify flows of the fault plane through both
packages' api (the degraded decode under random faults, the torn encode,
the mid-stream swap and the scrub read error).  Tolerance 0: every byte,
error class and message (paths aside), and the plans' ``injected`` and
``_calls`` dicts must be equal."""

import errno
import os

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.resilience import faults as t_faults
from gpu_rscode_torch.resilience import retry as t_retry
from gpu_rscode_torch.utils.fileformat import chunk_file_name, metadata_file_name
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu.resilience import faults as j_faults
from gpu_rscode_tpu.resilience import retry as j_retry

CPU = {"device": "cpu"}
JAX = {"strategy": "bitplane"}
SEG = {"segment_bytes": 4096}


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    """Short backoffs, the default budget, no ambient plan."""
    for name in ("RS_FAULTS", "RS_FAULTS_SEED", "RS_RETRY_ATTEMPTS", "RS_RETRY_SEED", "RS_RETRY_BUDGET"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    monkeypatch.setenv("RS_RETRY_MAX_MS", "4")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class and message are the outcome
        return (type(e).__name__, str(e))


SPECS = [
    "read:ioerror@p=0.02",
    "chunk2:bitrot@count=8",
    "write:torn@after=1MiB",
    "read:delay@ms=50",
    "chunk1:ioerror@from=2,times=4,scope=read;scrub:bitrot@p=0.5",
    "write:delay@ms=1,p=0.05\nread:ioerror@from=3",
    "write:torn@after=1.5KiB",
    "readx:ioerror",
    "read",
    "chunkx:ioerror",
    "read:melt",
    "read:torn@after=1",
    "write:bitrot",
    "read:ioerror@q=1",
    "read:delay",
    "write:torn",
    "read:ioerror@p=1.5",
    "chunk1:ioerror@scope=write",
    "  ;  ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_and_its_errors_match_jax(spec):
    got = _outcome(lambda: t_faults.parse_plan(spec, seed=3))
    want = _outcome(lambda: j_faults.parse_plan(spec, seed=3))
    if got[0] == "ok":
        assert want[0] == "ok"
        assert [(s.scope, s.kind, s.params, s.chunk) for s in got[1].specs] == \
            [(s.scope, s.kind, s.params, s.chunk) for s in want[1].specs]
        assert got[1].describe() == want[1].describe()
    else:
        assert got == want


def _drive(mod, spec: str, seed: int) -> tuple:
    """A fixed sequence of boundary crossings through a plan of ``mod``;
    returns each crossing's outcome and the plan's counters."""
    plan = mod.parse_plan(spec, seed=seed)
    out = []
    buf = np.arange(64, dtype=np.uint8)
    for n in range(40):
        for path, idx, scope in (("/a/_0_f.bin", 0, "read"), ("/b/_1_f.bin", 1, "read"), ("/c/_1_f.bin", 1, "scrub"),
                                 ("/d/_2_f.bin", 2, "scrub")):
            out.append(_outcome(lambda: plan.on_read(path, index=idx, scope=scope)))
            got = plan.corrupt_read(path, idx, buf, scope=scope)
            out.append(got is buf or bytes(got))
        out.append(_outcome(lambda: plan.on_write("writer-0", 1000 * n)))
        out.append(_outcome(lambda: plan.on_write("drain-sync", 7)))
    return out, dict(plan.injected), dict(plan._calls), dict(plan._lane_bytes)


@pytest.mark.parametrize("spec", [
    "read:ioerror@p=0.3;scrub:ioerror@p=0.2,from=5",
    "chunk1:ioerror@from=2,times=4,scope=read;read:delay@ms=0,p=0.4,times=7",
    "chunk2:bitrot@count=8,p=0.5;read:bitrot@count=3,p=0.25;scrub:bitrot",
    "write:ioerror@p=0.3,from=4,times=5;write:delay@ms=0,p=0.2",
    "write:torn@after=100KiB",
    "write:torn@after=0;read:ioerror@p=0.1",
])
@pytest.mark.parametrize("seed", [0, 20260807])
def test_draws_fire_caps_and_torn_lanes_match_jax(spec, seed):
    assert _drive(t_faults, spec, seed) == _drive(j_faults, spec, seed)


def test_draw_is_crc32_of_the_seeded_key():
    plan = t_faults.parse_plan("read:ioerror", seed=11)
    key = ("ioerror", "read", "_3_x.bin", 7)
    assert plan._draw(*key) == j_faults.parse_plan("read:ioerror", seed=11)._draw(*key)
    assert plan._target("/deep/dir/_3_x.bin") == "_3_x.bin" and plan._target(None) == "<anon>"


def test_env_plane_and_activation_match_jax(monkeypatch):
    assert t_faults.active() is None and t_faults.env_seed() == 0
    monkeypatch.setenv("RS_FAULTS", "read:ioerror@p=0.5")
    monkeypatch.setenv("RS_FAULTS_SEED", "42")
    plan = t_faults.active()
    assert plan is t_faults.active() and plan.seed == 42 == j_faults.env_seed()
    assert plan.describe() == j_faults.active().describe()
    other = t_faults.parse_plan("write:torn@after=1", seed=1)
    with t_faults.activate(other):
        assert t_faults.active() is other
        with t_faults.activate(None):
            assert t_faults.active() is plan
    monkeypatch.setenv("RS_FAULTS_SEED", "junk")
    assert t_faults.env_seed() == 0 == j_faults.env_seed()


@pytest.mark.parametrize("seed", [0, 7, 20260807])
def test_retry_delays_for_a_seed_match_jax(seed):
    t_pol = t_retry.RetryPolicy(retries=5, base_ms=5, max_ms=250, seed=seed)
    j_pol = j_retry.RetryPolicy(retries=5, base_ms=5, max_ms=250, seed=seed)
    for op in ("chunk_open", "decode_stage", "write_drain"):
        for attempt in range(7):
            assert t_pol.backoff_s(op, attempt) == j_pol.backoff_s(op, attempt)


def test_retry_policy_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("RS_RETRY_ATTEMPTS", "2")
    monkeypatch.setenv("RS_RETRY_SEED", "9")
    t_pol, j_pol = t_retry.default_policy(), j_retry.default_policy()
    assert (t_pol.retries, t_pol.base_ms, t_pol.max_ms, t_pol.seed) == (j_pol.retries, j_pol.base_ms, j_pol.max_ms,
                                                                        j_pol.seed)
    assert t_retry.default_policy() is t_pol
    monkeypatch.setenv("RS_RETRY_ATTEMPTS", "4")
    assert t_retry.default_policy().retries == 4


@pytest.mark.parametrize("budget", [None, "2", "0"])
def test_retry_call_attempts_and_budget_match_jax(monkeypatch, budget):
    if budget is not None:
        monkeypatch.setenv("RS_RETRY_BUDGET", budget)

    def run(mod, fails):
        mod.reset_budget()
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError(errno.EIO, "flaky")
            return "done"

        return _outcome(lambda: mod.RetryPolicy(retries=3, base_ms=0.01, max_ms=0.02).call(fn, op="t")), \
            len(calls), mod.budget_left()

    for fails in (0, 1, 3, 4, 9):
        assert run(t_retry, fails) == run(j_retry, fails)


EXCEPTIONS = [
    OSError(errno.EIO, "io"), OSError(errno.EAGAIN, "again"), OSError(errno.EINTR, "intr"),
    OSError(errno.ETIMEDOUT, "timeout"), OSError(errno.EBUSY, "busy"), OSError(errno.ENOSPC, "full"),
    TimeoutError(), InterruptedError(), BlockingIOError(), FileNotFoundError(errno.ENOENT, "gone"),
    PermissionError(errno.EACCES, "no"), IsADirectoryError(), NotADirectoryError(), FileExistsError(),
    ValueError("v"), RuntimeError("CUDA error: an illegal memory access was encountered"),
]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: f"{type(e).__name__}-{getattr(e, 'errno', '')}")
def test_transient_classes_match_jax(exc):
    assert t_retry.is_transient(exc) == j_retry.is_transient(exc)
    t_inj = t_faults.InjectedWriteError("torn", "write", "writer-0", transient=False)
    j_inj = j_faults.InjectedWriteError("torn", "write", "writer-0", transient=False)
    assert t_retry.is_transient(t_inj) is j_retry.is_transient(j_inj) is False
    assert str(t_inj) == str(j_inj)


def test_a_kernel_error_is_never_retried(tmp_path, monkeypatch):
    """The retry policy wraps IO only: a GEMM failing on the device (a CUDA
    error is a RuntimeError) raises at once, with no retry taken."""
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as fp:
        fp.write(bytes(range(256)) * 64)
    calls = []

    def broken(self, *args, **kwargs):
        calls.append(1)
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(RSCodec, "_matmul", broken)
    before = t_retry.budget_left()
    with pytest.raises(RuntimeError, match="CUDA error"):
        t_api.encode_file(path, 4, 2, **SEG, **CPU)
    assert len(calls) == 1 and t_retry.budget_left() in (before, None)
    assert not [f for f in os.listdir(tmp_path) if f != "f.bin"]


@pytest.mark.parametrize("writers", ["1", "0"])
def test_a_transient_parity_write_reruns_the_interleaved_drain_cleanly(tmp_path, monkeypatch, writers):
    """The write boundary reruns a whole drain after a transient failure.
    The interleaved encode's drain holds its pinned slot until the parity
    and the CRCs landed, so a rerun writes the same natives, and each slot
    goes back to the loop once."""
    from gpu_rscode_torch.parallel import pipeline

    monkeypatch.setenv("RS_IO_WRITERS", writers)
    clean, data = _seeded(tmp_path / "clean", 300_001, 9)
    faulted, _ = _seeded(tmp_path / "faulted", 300_001, 9)
    opts = {"checksums": True, "layout": "interleaved", "segment_bytes": 40_000, **CPU}
    t_api.encode_file(clean, 4, 2, **opts)

    scatter, release = t_api.native.scatter_write, pipeline.StreamLoop.release
    failed, released = [], []

    def flaky_scatter(files, arr, off):
        if len(files) == 2 and not failed:  # the first parity write
            failed.append(off)
            raise OSError(errno.EIO, "transient parity write error")
        return scatter(files, arr, off)

    def counted_release(self, slot):
        released.append(slot)
        return release(self, slot)

    monkeypatch.setattr(t_api.native, "scatter_write", flaky_scatter)
    monkeypatch.setattr(pipeline.StreamLoop, "release", counted_release)
    t_api.encode_file(faulted, 4, 2, **opts)
    assert failed == [0]
    chunk = t_api.chunk_size_for_layout(300_001, 4, 1, "interleaved")
    assert len(released) == len(t_api._segment_spans(chunk, t_api._segment_cols(chunk, 4, 40_000))) > 1
    for i in range(6):
        assert open(chunk_file_name(faulted, i), "rb").read() == open(chunk_file_name(clean, i), "rb").read()
    assert open(metadata_file_name(faulted)).read() == open(metadata_file_name(clean)).read()


# -- the verify flows of the fault plane, through both packages ---------------


def _seeded(d, size, seed):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), "f.bin")
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return path, data


def _pair(tmp_path, size, seed, k, p, segment_bytes=4096):
    """The same seeded file encoded by each package in its own directory."""
    t_path, data = _seeded(tmp_path / "t", size, seed)
    j_path, _ = _seeded(tmp_path / "j", size, seed)
    t_api.encode_file(t_path, k, p, checksums=True, segment_bytes=segment_bytes, **CPU)
    j_api.encode_file(j_path, k, p, checksums=True, segment_bytes=segment_bytes, **JAX)
    return t_path, j_path, data


def _counters(plan) -> tuple:
    return dict(plan.injected), dict(plan._calls), dict(plan._lane_bytes)


def _norm(text: str, *dirs) -> str:
    for d in dirs:
        text = text.replace(os.path.dirname(d), "<dir>")
    return text


def test_degraded_decode_under_random_faults_matches_jax(tmp_path):
    t_path, j_path, data = _pair(tmp_path, 60_000, 5, k=4, p=2)
    for path in (t_path, j_path):
        os.unlink(chunk_file_name(path, 0))
        with open(chunk_file_name(path, 3), "r+b") as fp:
            fp.seek(100)
            fp.write(b"\xff\x00")
    spec = "read:ioerror@p=0.05;read:delay@ms=1,p=0.1"
    t_plan, j_plan = t_faults.parse_plan(spec, seed=17), j_faults.parse_plan(spec, seed=17)
    with t_faults.activate(t_plan):
        t_out = t_api.auto_decode_file(t_path, t_path + ".dec", **SEG, **CPU)
    with j_faults.activate(j_plan):
        j_out = j_api.auto_decode_file(j_path, j_path + ".dec", **SEG, **JAX)
    assert open(t_out, "rb").read() == open(j_out, "rb").read() == data
    assert open(t_path + ".auto.conf").read() == open(j_path + ".auto.conf").read()
    assert _counters(t_plan) == _counters(j_plan)
    assert t_plan.injected[("ioerror", "read")] > 0 and t_plan.injected[("delay", "read")] > 0


@pytest.mark.parametrize("writers", ["1", "0"])
def test_torn_encode_matches_jax_and_leaves_no_litter(tmp_path, monkeypatch, writers):
    monkeypatch.setenv("RS_IO_WRITERS", writers)
    t_path, _ = _seeded(tmp_path / "t", 400_000, 6)
    j_path, _ = _seeded(tmp_path / "j", 400_000, 6)
    spec = "write:torn@after=64KiB"
    t_plan, j_plan = t_faults.parse_plan(spec), j_faults.parse_plan(spec)
    with t_faults.activate(t_plan), pytest.raises(t_faults.InjectedWriteError) as t_err:
        t_api.encode_file(t_path, 4, 2, checksums=True, **CPU)
    with j_faults.activate(j_plan), pytest.raises(j_faults.InjectedWriteError) as j_err:
        j_api.encode_file(j_path, 4, 2, checksums=True, **JAX)
    assert str(t_err.value) == str(j_err.value)
    assert "injected torn fault" in str(t_err.value)
    assert str(t_err.value).endswith("writer-0" if writers == "1" else "drain-sync")
    assert _counters(t_plan) == _counters(j_plan)
    assert os.listdir(tmp_path / "t") == ["f.bin"] and os.listdir(tmp_path / "j") == ["f.bin"]


def test_torn_encode_through_the_cli_exits_1(tmp_path, capsys):
    path, _ = _seeded(tmp_path, 400_000, 7)
    rc = t_cli.main(["-k", "4", "-n", "6", "-e", path, "--device", "cpu", "--faults", "write:torn@after=64KiB"])
    assert rc == 1 and "injected torn fault" in capsys.readouterr().err
    assert os.listdir(tmp_path) == ["f.bin"]
    assert t_cli.main(["-k", "4", "-n", "6", "-e", path, "--device", "cpu", "--faults", "read:melt"]) == 2
    assert "bad --faults spec" in capsys.readouterr().err
    assert t_faults.active() is None


def test_midstream_swap_and_plain_decode_match_jax(tmp_path):
    t_path, j_path, data = _pair(tmp_path, 40_000, 8, k=3, p=2)
    for path in (t_path, j_path):
        os.unlink(chunk_file_name(path, 0))
    spec = "chunk1:ioerror@from=2,scope=read"
    t_plan, j_plan = t_faults.parse_plan(spec), j_faults.parse_plan(spec)
    with t_faults.activate(t_plan):
        t_out = t_api.auto_decode_file(t_path, t_path + ".dec", **SEG, **CPU)
    with j_faults.activate(j_plan):
        j_out = j_api.auto_decode_file(j_path, j_path + ".dec", **SEG, **JAX)
    assert open(t_out, "rb").read() == open(j_out, "rb").read() == data
    assert _counters(t_plan) == _counters(j_plan)

    errors = []
    for api_mod, faults_mod, path, kw in ((t_api, t_faults, t_path, CPU), (j_api, j_faults, j_path, JAX)):
        conf = path + ".conf"
        with open(conf, "w") as fp:
            fp.write("".join(os.path.basename(chunk_file_name(path, i)) + "\n" for i in (1, 2, 3)))
        plan = faults_mod.parse_plan(spec)
        with faults_mod.activate(plan), pytest.raises(api_mod.ChunkIntegrityError) as err:
            api_mod.decode_file(path, conf, path + ".dec2", **SEG, **kw)
        assert err.value.bad_chunks == {1: chunk_file_name(path, 1)}
        assert not os.path.exists(path + ".dec2")
        errors.append((_norm(str(err.value), path), _counters(plan)))
    assert errors[0] == errors[1]


def test_scrub_read_error_matches_jax(tmp_path):
    t_path, j_path, _ = _pair(tmp_path, 30_000, 9, k=3, p=2)
    spec = "chunk1:ioerror@scope=scrub"
    t_plan, j_plan = t_faults.parse_plan(spec), j_faults.parse_plan(spec)
    with t_faults.activate(t_plan):
        t_rep = t_api.scan_file(t_path, **SEG, **CPU)
    with j_faults.activate(j_plan):
        j_rep = j_api.scan_file(j_path, **SEG)
    assert t_rep == j_rep
    assert t_rep["corrupt"] == [1] and t_rep["decodable"] is True
    assert _counters(t_plan) == _counters(j_plan)
    # A decode-scoped pin does not fire at the scrub boundary.
    with t_faults.activate(t_faults.parse_plan("chunk1:ioerror@scope=read")):
        assert t_api.scan_file(t_path, **SEG, **CPU)["corrupt"] == []
