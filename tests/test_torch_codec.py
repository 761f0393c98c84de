"""RSCodec of the PyTorch port against the JAX package's codec: parity,
erasure decoding, inversion and the device rule.  Bit-exact throughout."""

import itertools

import numpy as np
import pytest

from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.ops import inverse as t_inv
from gpu_rscode_torch.ops.gemm import to_numpy
from gpu_rscode_torch.utils import backend
from gpu_rscode_tpu.codec import RSCodec as JaxCodec
from gpu_rscode_tpu.ops import inverse as j_inv
from gpu_rscode_tpu.ops.gf import get_field


def _data(k, m, w, seed):
    dt = np.uint8 if w == 8 else np.uint16
    return np.random.default_rng(seed).integers(0, 1 << w, size=(k, m)).astype(dt)


@pytest.mark.parametrize("generator", ["vandermonde", "cauchy"])
@pytest.mark.parametrize("k,p,w", [(4, 2, 8), (10, 4, 8), (10, 4, 16)])
def test_parity_matches_jax_codec(k, p, w, generator):
    data = _data(k, 1000, w, k * p * w)
    ref = JaxCodec(k, p, w=w, generator=generator, strategy="bitplane")
    want = np.asarray(ref.encode(data))
    for strategy in ("auto", "bitplane", "table", "cuda"):
        codec = RSCodec(k, p, w=w, generator=generator, strategy=strategy, device="cpu")
        np.testing.assert_array_equal(codec.total_matrix, ref.total_matrix)
        got = to_numpy(codec.encode(data))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [8, 16])
def test_every_erasure_pattern_decodes(w):
    k, n = 4, 6
    codec = RSCodec(k, n - k, w=w, device="cpu")
    data = _data(k, 333, w, w)
    chunks = np.concatenate([data, to_numpy(codec.encode(data))])
    for rows in itertools.combinations(range(n), k):
        dec = codec.decode_matrix(rows)
        np.testing.assert_array_equal(dec, JaxCodec(k, n - k, w=w).decode_matrix(rows))
        np.testing.assert_array_equal(to_numpy(codec.decode(dec, chunks[list(rows)])), data)


@pytest.mark.parametrize("w", [8, 16])
def test_from_total_matrix_carries_the_jax_matrix(w):
    ref = JaxCodec(10, 4, w=w, generator="cauchy", strategy="bitplane")
    codec = RSCodec.from_total_matrix(ref.total_matrix, w=w, device="cpu")
    assert (codec.native_num, codec.parity_num) == (10, 4)
    np.testing.assert_array_equal(codec.total_matrix, ref.total_matrix)
    data = _data(10, 500, w, 3)
    np.testing.assert_array_equal(to_numpy(codec.encode(data)), np.asarray(ref.encode(data)))
    rows = [0, 2, 4, 6, 8, 10, 11, 12, 13, 9]
    np.testing.assert_array_equal(codec.decode_matrix(rows), ref.decode_matrix(rows))
    with pytest.raises(ValueError, match="n > k"):
        RSCodec.from_total_matrix(np.eye(4), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        RSCodec.from_total_matrix(np.full((6, 4), 300), w=8, device="cpu")


def test_invert_zero_pivot_and_singular():
    gf = get_field(8)
    M = np.array([[0, 1, 2], [1, 2, 3], [4, 5, 6]], dtype=np.uint8)
    inv = t_inv.invert_matrix(M)
    np.testing.assert_array_equal(inv, j_inv.invert_matrix(M))
    np.testing.assert_array_equal(gf.matmul(M, inv), np.eye(3, dtype=np.uint8))
    with pytest.raises(t_inv.SingularMatrixError):
        t_inv.invert_matrix(np.array([[1, 2], [1, 2]]))
    with pytest.raises(ValueError, match="square"):
        t_inv.invert_matrix(np.ones((2, 3)))


def test_inverse_matches_reference_on_random_matrices():
    rng = np.random.default_rng(5)
    for w, k in ((8, 10), (8, 32), (16, 12)):
        gf = get_field(w)
        codec = RSCodec(k, k, w=w, generator="cauchy", device="cpu")
        rows = sorted(rng.choice(2 * k, size=k, replace=False).tolist())
        sub = codec.total_matrix[rows]
        np.testing.assert_array_equal(t_inv.invert_matrix(sub, codec.gf), j_inv.invert_matrix(sub, gf))


def test_device_rule(monkeypatch):
    """No device and no GPU raises; device='cpu' resolves auto to bitplane;
    codec arguments are validated."""
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RSCodec(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RSCodec(4, 2, device="cuda")
    assert RSCodec(4, 2, device="cpu").strategy == "bitplane"
    with pytest.raises(ValueError, match="unknown strategy"):
        RSCodec(4, 2, strategy="pallas", device="cpu")
    with pytest.raises(ValueError, match="bad"):
        RSCodec(0, 2, device="cpu")
    with pytest.raises(ValueError, match="exactly k"):
        RSCodec(4, 2, device="cpu").decode_matrix([0, 1, 2])
