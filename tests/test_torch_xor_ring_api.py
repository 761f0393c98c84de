"""The file entry points under ``strategy="xor"`` and ``"ring"`` on the CPU:
``encode_file``, ``decode_file``, ``locate_decode_file`` and
``update_file`` of the port against the JAX package's under the same
strategy, on copies of one seeded file.  Chunk files, .METADATA and decoded
bytes must be identical (tolerance 0).  The locate decode with a native
lost reuses each segment's packed operand for its recovery GEMM, except in
a segment it corrected, which it stages again."""

import os
import shutil

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch.ops import xor_gemm as tx
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api

SIZE = 30_011
SEG = 4096
K, P = 4, 3


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("RS_RUNLOG", "RS_SCHEDULE_STORE", "RS_XOR_CSE", "RS_XOR_OPT", "RS_XOR_TILE", "RS_XOR_PACK_REUSE",
                 "RS_LOCATE"):
        monkeypatch.delenv(knob, raising=False)


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _archive(path, n=K + P):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): _read(f) for f in names if os.path.exists(f)}


def _conf(path, survivors):
    conf = path + ".conf"
    with open(conf, "w") as fp:
        fp.write("".join(os.path.basename(t_ff.chunk_file_name(path, i)) + "\n" for i in survivors))
    return conf


def _encode_both(tmp_path, strategy, w, checksums=True):
    """The same seeded file encoded by each package; returns ({pkg: path},
    data) after checking the archives are identical."""
    data = np.random.default_rng(w).integers(0, 256, size=SIZE, dtype=np.uint8).tobytes()
    paths = {}
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "f.bin")
        with open(path, "wb") as fp:
            fp.write(data)
        api.encode_file(path, K, P, w=w, strategy=strategy, segment_bytes=SEG, checksums=checksums, **kw)
        paths[name] = path
    assert _archive(paths["t"]) == _archive(paths["j"])
    return paths, data


@pytest.mark.parametrize("strategy", ["xor", "ring"])
@pytest.mark.parametrize("w", [8, 16])
def test_encode_and_decode_like_jax(tmp_path, strategy, w):
    paths, data = _encode_both(tmp_path, strategy, w)
    outs = {}
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        path = paths[name]
        for i in (0, 1, 5):
            os.unlink(t_ff.chunk_file_name(path, i))
        outs[name] = _read(api.decode_file(path, _conf(path, [2, 3, 4, 6]), path + ".out", strategy=strategy,
                                           segment_bytes=SEG, **kw))
    assert outs["t"] == outs["j"] == data


@pytest.mark.parametrize("strategy", ["xor", "ring"])
def test_locate_decode_like_jax_with_packed_reuse(tmp_path, strategy):
    """No CRC lines; native 0 lost; bitrot in chunk 2 inside the first
    segment only.  The first segment is corrected and re-staged, every
    other one feeds its recovery GEMM from the syndrome GEMM's pack."""
    paths, data = _encode_both(tmp_path, strategy, 8, checksums=False)
    chunk = -(-SIZE // K)
    seg_cols = t_api._segment_cols(chunk, K, SEG)
    segments = -(-chunk // seg_cols)
    outs = {}
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        path = paths[name]
        os.unlink(t_ff.chunk_file_name(path, 0))
        rot = t_ff.chunk_file_name(path, 2)
        buf = bytearray(_read(rot))
        for col in (5, seg_cols // 2, seg_cols - 1):
            buf[col] ^= 0x5A
        with open(rot, "wb") as fp:
            fp.write(buf)
        before = dict(tx.PACK_REUSE)
        outs[name] = _read(api.locate_decode_file(path, path + ".loc", strategy=strategy, segment_bytes=SEG, **kw))
        if name == "t":
            counts = {key: tx.PACK_REUSE[key] - before[key] for key in before}
            # One pack a segment for the syndrome GEMM, one more for the
            # re-staged corrected segment; reuse by every syndrome GEMM and
            # by every recovery GEMM but the corrected segment's.
            assert segments > 2
            assert counts == {"packed": segments + 1, "reused": 2 * segments - 1}
    assert outs["t"] == outs["j"] == data


@pytest.mark.parametrize("strategy", ["xor", "ring"])
def test_update_file_like_jax(tmp_path, strategy):
    paths, data = _encode_both(tmp_path, strategy, 8)
    delta = np.random.default_rng(9).integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    summaries = {}
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        summaries[name] = api.update_file(paths[name], 1234, delta, strategy=strategy, segment_bytes=SEG, **kw)
    assert _archive(paths["t"]) == _archive(paths["j"])
    assert summaries["t"] == summaries["j"]
    want = bytearray(data)
    want[1234:1234 + len(delta)] = delta
    path = paths["t"]
    for i in range(3):
        os.unlink(t_ff.chunk_file_name(path, i))
    out = t_api.decode_file(path, _conf(path, [3, 4, 5, 6]), path + ".out", strategy=strategy, segment_bytes=SEG,
                            device="cpu")
    assert _read(out) == bytes(want)
    shutil.rmtree(tmp_path / "j")
