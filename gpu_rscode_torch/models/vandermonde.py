"""Coding matrices: the port's own copy of the JAX package's
``models/vandermonde.py``.

The coefficient matrices are this system's "weights": tiny host NumPy
arrays, written to .METADATA and carried across from the JAX package by
``RSCodec.from_total_matrix``.
"""

from __future__ import annotations

import numpy as np

from ..ops.gf import GaloisField, get_field


def vandermonde_matrix(parity_num: int, native_num: int, gf: GaloisField | None = None) -> np.ndarray:
    """(parity_num, native_num) block ``V[i, j] = (j+1)^i``, with the
    reference encoder's ``(j+1) % size`` wrap."""
    gf = gf or get_field(8)
    j = (np.arange(native_num, dtype=np.int64) + 1) % gf.size
    i = np.arange(parity_num, dtype=np.int64)
    return gf.pow(j[None, :], i[:, None]).astype(gf.dtype)


def total_matrix(parity_num: int, native_num: int, gf: GaloisField | None = None) -> np.ndarray:
    """(native_num + parity_num, native_num) total matrix ``[I; V]``, the row
    order .METADATA stores."""
    gf = gf or get_field(8)
    eye = np.eye(native_num, dtype=gf.dtype)
    return np.concatenate([eye, vandermonde_matrix(parity_num, native_num, gf)], axis=0)


def cauchy_matrix(parity_num: int, native_num: int, gf: GaloisField | None = None) -> np.ndarray:
    """(parity_num, native_num) block ``C[i, j] = 1 / (x_i ^ y_j)`` with
    ``x_i = native_num + i`` and ``y_j = j``: every square submatrix of
    ``[I; C]`` is invertible.  Requires ``n <= 2^w``."""
    gf = gf or get_field(8)
    if native_num + parity_num > gf.size:
        raise ValueError(f"n = {native_num + parity_num} exceeds field size {gf.size}")
    x = np.arange(native_num, native_num + parity_num, dtype=np.int64)
    y = np.arange(native_num, dtype=np.int64)
    return gf.inv(x[:, None] ^ y[None, :]).astype(gf.dtype)


GENERATORS = {
    "vandermonde": vandermonde_matrix,
    "cauchy": cauchy_matrix,
}


def generator_matrix(kind: str, parity_num: int, native_num: int, gf: GaloisField | None = None) -> np.ndarray:
    try:
        fn = GENERATORS[kind]
    except KeyError:
        raise ValueError(f"unknown generator {kind!r}; choose from {sorted(GENERATORS)}") from None
    return fn(parity_num, native_num, gf)
