"""The port's copy of the error-locating decoder (``gf_decode``) against the
JAX package's on the same syndromes, and ``locate_decode_file``,
``scan_file(syndrome=True)`` and ``auto_decode_file``'s locate rungs
against the JAX package's on the same damaged archives, on the CPU.
Tolerance 0: the same corrections, verdicts, errors and output bytes."""

import os
import shutil

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import gf_decode as t_gd
from gpu_rscode_torch.models.vandermonde import generator_matrix, total_matrix
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import gf_decode as j_gd

CPU = {"device": "cpu"}
JAX = {"strategy": "bitplane"}


def cauchy_total_matrix(p, k, gf):
    return np.concatenate([np.eye(k, dtype=gf.dtype), generator_matrix("cauchy", p, k, gf)], axis=0)


def _codewords(rng, total, gf, m):
    k = total.shape[1]
    data = rng.integers(0, gf.size, size=(k, m)).astype(gf.dtype)
    return gf.matmul(total, data).astype(np.int64)


def _damage(rng, Y, gf, errors_per_col, rows=None):
    """Y with ``errors_per_col`` random nonzero errors in each column, at
    random rows (of ``rows`` when given)."""
    Y = Y.copy()
    n, m = Y.shape
    rows = list(range(n)) if rows is None else rows
    for col in range(m):
        for r in rng.choice(rows, size=errors_per_col, replace=False):
            Y[r, col] ^= int(rng.integers(1, gf.size))
    return Y


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("generator", ["vandermonde", "cauchy"])
def test_check_matrices_and_points_match_jax(w, generator):
    gf = get_field(w)
    k, p = 6, 4
    total = total_matrix(p, k, gf) if generator == "vandermonde" else cauchy_total_matrix(p, k, gf)
    assert t_gd.is_systematic(total, k) == j_gd.is_systematic(total, k) is True
    H = t_gd.parity_check_matrix(total, k, gf)
    np.testing.assert_array_equal(H, j_gd.parity_check_matrix(total, k, gf))
    assert not np.any(gf.matmul(H, total))
    t_pts, j_pts = t_gd.vandermonde_points(total, k, gf), j_gd.vandermonde_points(total, k, gf)
    assert (t_pts is None) == (j_pts is None) == (generator == "cauchy")
    if t_pts is not None:
        np.testing.assert_array_equal(t_pts, j_pts)
    for erasures in ([], [0], [2, 7], [1, 3, 8], [0, 1, 2, 3, 4]):
        t_red, j_red = t_gd.erasure_reduced_check(H, erasures, gf), j_gd.erasure_reduced_check(H, erasures, gf)
        assert (t_red is None) == (j_red is None)
        if t_red is not None:
            np.testing.assert_array_equal(t_red, j_red)


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("errors,erased", [(0, []), (1, []), (2, []), (1, [3]), (1, [0, 9]), (3, [])])
def test_locate_segment_matches_jax(w, errors, erased):
    """The port's LocateContext.locate against JAX's on the syndromes of the
    same damaged codewords: the same corrections, or UnlocatableError with
    the same columns past t."""
    gf = get_field(w)
    k, p, m = 6, 4, 40
    rng = np.random.default_rng(100 * w + 10 * errors + len(erased))
    total = total_matrix(p, k, gf)
    survivors = [i for i in range(k + p) if i not in erased]
    Y = _damage(rng, _codewords(rng, total, gf, m), gf, errors, rows=survivors)[survivors]
    t_ctx, j_ctx = t_gd.LocateContext(total, k, p, w, survivors), j_gd.LocateContext(total, k, p, w, survivors)
    np.testing.assert_array_equal(t_ctx.check, j_ctx.check)
    assert (t_ctx.r, t_ctx.t) == (j_ctx.r, j_ctx.t)
    S = gf.matmul(t_ctx.check, Y).astype(np.int64)
    if 2 * errors + len(erased) > p:
        with pytest.raises(t_gd.UnlocatableError) as t_e:
            t_ctx.locate(S)
        with pytest.raises(j_gd.UnlocatableError) as j_e:
            j_ctx.locate(S)
        assert (t_e.value.columns, t_e.value.t, t_e.value.total) == (j_e.value.columns, j_e.value.t, j_e.value.total)
        return
    fixes = t_ctx.locate(S)
    assert fixes == j_ctx.locate(S)
    assert len(fixes) == (m if errors else 0)
    seg = Y.astype(gf.dtype)
    row_of = {c: i for i, c in enumerate(survivors)}
    assert t_gd.correct_segment(seg, fixes, row_of) == errors * m
    assert not np.any(gf.matmul(t_ctx.check, seg))


def test_solver_tiers_match_jax():
    """Berlekamp-Massey, the GF solve and the per-column tiers on the same
    inputs (the general tier with a Cauchy check, BM with Vandermonde)."""
    gf = get_field(8)
    rng = np.random.default_rng(5)
    for gen in (total_matrix, cauchy_total_matrix):
        total = gen(4, 6, gf)
        H = t_gd.parity_check_matrix(total, 6, gf).astype(np.int64)
        points = t_gd.vandermonde_points(total, 6, gf)
        for _ in range(30):
            Y = _damage(rng, _codewords(rng, total, gf, 1), gf, int(rng.integers(0, 4)))
            S = gf.matmul(H, Y)[:, 0].astype(np.int64)
            assert t_gd.berlekamp_massey(S, gf) == j_gd.berlekamp_massey(S, gf)
            assert t_gd.locate_column(S, H, gf, 2, points=points) == j_gd.locate_column(S, H, gf, 2, points=points)
            A = H[:, :3]
            t_x, j_x = t_gd.gf_solve(A, S, gf), j_gd.gf_solve(A, S, gf)
            assert (t_x is None and j_x is None) or np.array_equal(t_x, j_x)


def _archive(d, size, seed, k=5, p=4, w=8, checksums=False):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), "f.bin")
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    t_api.encode_file(path, k, p, w=w, checksums=checksums, segment_bytes=4096, **CPU)
    return path, data


def _rot(path, offsets, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "r+b") as fp:
        for off in offsets:
            fp.seek(int(off))
            b = fp.read(1)[0]
            fp.seek(int(off))
            fp.write(bytes([b ^ int(rng.integers(1, 256))]))


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


CASES = {
    "clean": lambda path: None,
    "one_rotten_chunk": lambda path: _rot(chunk_file_name(path, 3), range(5, 6000, 97)),
    "rot_plus_erasure": lambda path: (os.unlink(chunk_file_name(path, 1)), _rot(chunk_file_name(path, 6), [9, 4000])),
    "two_rotten_chunks": lambda path: (_rot(chunk_file_name(path, 0), [10, 20]), _rot(chunk_file_name(path, 7), [30])),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("w", [8, 16])
def test_locate_decode_and_syndrome_scan_equal_jax(tmp_path, case, w):
    path, data = _archive(tmp_path, 30_000, seed=21 + w, w=w)
    CASES[case](path)
    t_rep = t_api.scan_file(path, syndrome=True, segment_bytes=4096, **CPU)
    assert t_rep == j_api.scan_file(path, syndrome=True, segment_bytes=4096)
    assert t_rep["syndrome"]["verdict"] == ("clean" if case == "clean" else "silent_bitrot")
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        out = pkg.locate_decode_file(path, str(tmp_path / f"{name}.out"), conf_out=str(tmp_path / f"{name}.conf"),
                                     segment_bytes=4096, **kw)
        outs[name] = (_read(out), _read(str(tmp_path / f"{name}.conf")))
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == data


def test_unlocatable_past_t_like_jax(tmp_path):
    """Three chunks rotten over one byte window with p=4 (t=2): both
    packages raise UnlocatableError, write no output, and report the
    sweep unlocatable with decodable "unknown"."""
    path, _ = _archive(tmp_path, 20_000, seed=31)
    rng = np.random.default_rng(3)
    for i in (0, 2, 6):
        with open(chunk_file_name(path, i), "r+b") as fp:
            fp.seek(100)
            fp.write(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    t_rep = t_api.scan_file(path, syndrome=True, **CPU)
    assert t_rep == j_api.scan_file(path, syndrome=True)
    assert t_rep["syndrome"]["verdict"] == "unlocatable" and t_rep["decodable"] == "unknown"
    for name, pkg, gd, kw in (("t", t_api, t_gd, CPU), ("j", j_api, j_gd, JAX)):
        out = str(tmp_path / f"{name}.out")
        with pytest.raises(gd.UnlocatableError):
            pkg.locate_decode_file(path, out, **kw)
        assert not os.path.exists(out) and not os.path.exists(out + ".rs_tmp")
        with pytest.raises(gd.UnlocatableError):
            pkg.auto_decode_file(path, out, **kw)  # no CRCs: locate first, never a silent erasure decode


@pytest.mark.parametrize("mode", ["auto", "off", "force"])
def test_auto_decode_locate_modes_like_jax(tmp_path, monkeypatch, mode):
    """RS_LOCATE: "auto" locates first on an archive without CRCs and so
    restores a rotten one; "off" decodes the erasures only (the rot passes
    through, as in the JAX package); "force" locates on a checksummed
    archive too.  The outputs and confs equal JAX's in each mode."""
    monkeypatch.setenv("RS_LOCATE", mode)
    base, data = _archive(tmp_path / "src", 25_000, seed=41, checksums=(mode == "force"))
    os.unlink(chunk_file_name(base, 0))
    _rot(chunk_file_name(base, 2), [50, 3000])
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        d = tmp_path / name
        d.mkdir()
        for f in os.listdir(tmp_path / "src"):
            shutil.copy(tmp_path / "src" / f, d / f)
        path = str(d / "f.bin")
        out = pkg.auto_decode_file(path, str(d / "out"), **kw)
        outs[name] = (_read(out), _read(path + ".auto.conf"))
    assert outs["t"] == outs["j"]
    if mode == "off":
        assert outs["t"][0] != data
    elif mode == "auto":
        assert outs["t"][0] == data


def test_auto_decode_final_rung_locates_after_reselects_run_out(tmp_path, monkeypatch):
    """With RS_RETRY_RESELECT=0 the one erasure attempt fails on a
    survivor truncated after the scan; the last rung's locate decode over
    a fresh scan then restores the file, in both packages."""
    monkeypatch.setenv("RS_RETRY_RESELECT", "0")
    base, data = _archive(tmp_path / "src", 20_000, seed=51, k=4, p=3, checksums=True)
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        d = tmp_path / name
        d.mkdir()
        for f in os.listdir(tmp_path / "src"):
            shutil.copy(tmp_path / "src" / f, d / f)
        path = str(d / "f.bin")
        real = pkg._scan_chunks
        state = {"n": 0}

        def scan_then_truncate(in_file, segment_bytes, real=real, state=state, path=path):
            scan = real(in_file, segment_bytes)
            state["n"] += 1
            if state["n"] == 1:
                os.truncate(chunk_file_name(path, 1), 5)
            return scan

        monkeypatch.setattr(pkg, "_scan_chunks", scan_then_truncate)
        out = pkg.auto_decode_file(path, str(d / "out"), **kw)
        outs[name] = (_read(out), _read(path + ".auto.conf"), state["n"])
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == data and outs["t"][2] == 2


def test_locate_refuses_foreign_matrix_and_past_erasure(tmp_path):
    path, _ = _archive(tmp_path, 8_000, seed=61, k=4, p=2)
    for i in (0, 1, 2):
        os.unlink(chunk_file_name(path, i))
    for pkg, kw in ((t_api, CPU), (j_api, JAX)):
        with pytest.raises(ValueError, match="past erasure recovery"):
            pkg.locate_decode_file(path, str(tmp_path / "o"), **kw)
