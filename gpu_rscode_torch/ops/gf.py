"""GF(2^w) arithmetic core: tables, scalar ops and bit-plane linear maps.

The port's own copy of the JAX package's ``ops/gf.py`` (host NumPy; it
imports nothing of that package).  The table layout is the branchless one:
``log[0]`` holds the sentinel ``2*order`` and the exp table is zero-padded,
so ``exp[log[a] + log[b]]`` is correct for every pair, zeros included.

Multiplication by a constant is a GF(2)-linear map on the bits of the
operand, so a whole RS stripe product is one binary matrix product:
``bits(C) = expand_bitmatrix(A) @ bits(B) mod 2``.  The GEMM module and the
CUDA kernel consume those operators.
"""

from __future__ import annotations

import functools

import numpy as np

# One primitive polynomial per supported width.  w=8 is 0x11D
# (x^8+x^4+x^3+x^2+1), the polynomial of the reference encoder.
PRIMITIVE_POLY = {
    4: 0x13,  # x^4 + x + 1
    8: 0x11D,  # x^8 + x^4 + x^3 + x^2 + 1
    16: 0x1100B,  # x^16 + x^12 + x^3 + x + 1
}


def _carryless_mul_mod(a: int, b: int, w: int, poly: int) -> int:
    """Bitwise shift-add GF multiply: the table-free oracle the tests use to
    validate the tables."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> w:
            a ^= poly
    return r


class GaloisField:
    """Tables and vectorised host ops for GF(2^w), w in {4, 8, 16}.

    ``log``: ``(2^w,) int32`` with the ``log[0] = 2*order`` sentinel.
    ``exp``: ``(4*order + 1,)`` of the element dtype, zero from index
    ``2*order`` on.  ``mul_table``: the full ``(2^w, 2^w)`` product table for
    w <= 8 (None for w=16, where it would take 8 GB).
    """

    def __init__(self, w: int = 8):
        if w not in PRIMITIVE_POLY:
            raise ValueError(f"unsupported field width {w}; choose from {sorted(PRIMITIVE_POLY)}")
        self.w = w
        self.poly = PRIMITIVE_POLY[w]
        self.size = 1 << w
        self.order = self.size - 1
        self.dtype = np.uint8 if w <= 8 else np.uint16

        sentinel = 2 * self.order
        log = np.zeros(self.size, dtype=np.int32)
        exp_core = np.zeros(self.order, dtype=np.int64)
        x = 1
        for i in range(self.order):
            exp_core[i] = x
            log[x] = i
            x <<= 1
            if x & self.size:
                x ^= self.poly
        log[0] = sentinel

        # mul indexes up to 2*sentinel: pad to 2*sentinel + 1 and keep
        # everything >= sentinel zero, so a zero operand reads 0.
        exp = np.zeros(2 * sentinel + 1, dtype=self.dtype)
        idx = np.arange(sentinel) % self.order
        exp[:sentinel] = exp_core[idx].astype(self.dtype)
        self.log = log
        self.exp = exp
        self.sentinel = sentinel

        if w <= 8:
            a = np.arange(self.size, dtype=np.int64)
            self.mul_table = self.exp[self.log[a][:, None] + self.log[a][None, :]]
        else:
            self.mul_table = None
        self._bitmats: np.ndarray | None = None
        self._nibble_mats: np.ndarray | None = None

    def mul(self, a, b):
        """Elementwise GF multiply (branchless log/exp)."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        return self.exp[self.log[a] + self.log[b]]

    def div(self, a, b):
        """Elementwise GF divide; division by zero raises."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if np.any(b == 0):
            raise ZeroDivisionError("GF division by zero")
        return self.exp[self.log[a] + self.order - self.log[b]]

    def pow(self, a, e):
        """GF power with 0**0 == 1 and 0**e == 0 for e > 0."""
        a = np.asarray(a, dtype=np.int64)
        e = np.asarray(e, dtype=np.int64)
        idx = (self.log[a] * e) % self.order
        out = np.where((a == 0) & (e > 0), 0, self.exp[idx])
        return out.astype(self.dtype) if out.ndim else self.dtype(out)

    def inv(self, a):
        """Multiplicative inverse; the inverse of zero raises."""
        a = np.asarray(a, dtype=np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("GF inverse of zero")
        return self.exp[self.order - self.log[a]]

    def matmul(self, A, B):
        """GF matrix product with XOR accumulation: the host oracle every
        GEMM path is held against."""
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        out = np.zeros((A.shape[0], B.shape[1]), dtype=self.dtype)
        for t in range(A.shape[1]):
            out ^= self.mul(A[:, t][:, None], B[t][None, :])
        return out

    def bitmatrix(self, v: int) -> np.ndarray:
        """(w, w) uint8 GF(2) operator of multiply-by-v: ``M[i, j]`` is bit i
        of ``v * 2^j``, so ``bits(v*b) = M @ bits(b) mod 2``."""
        cols = self.mul(int(v), 1 << np.arange(self.w, dtype=np.int64))
        shifts = np.arange(self.w, dtype=np.int64)
        return ((cols[None, :].astype(np.int64) >> shifts[:, None]) & 1).astype(np.uint8)

    @property
    def bitmats(self) -> np.ndarray:
        """(2^w, w, w) uint8 GF(2) multiply operators: ``bitmats[v][i, j]``
        is bit i of ``v * 2^j`` (bit 0 is the LSB), so
        ``bits(v*b) = bitmats[v] @ bits(b) mod 2``."""
        if self._bitmats is None:
            v = np.arange(self.size, dtype=np.int64)
            prods = self.mul(v[:, None], 1 << np.arange(self.w, dtype=np.int64)[None, :])
            shifts = np.arange(self.w, dtype=np.int64)
            self._bitmats = (
                (prods[:, None, :].astype(np.int64) >> shifts[None, :, None]) & 1
            ).astype(np.uint8)
        return self._bitmats

    @property
    def nibble_mats(self) -> np.ndarray:
        """(256, 8, 32) uint8 one-hot-nibble multiply operators (w=8 only).

        ``nibble_mats[c][s, v]`` is bit s of ``c * val(v)``, with
        ``val(v) = v << 4`` for v < 16 (high nibble) and ``val(v) = v - 16``
        for v >= 16 (low nibble).  Since ``b = (hi << 4) ^ lo``, stacking
        ``one_hot(hi)`` over ``one_hot(lo)`` gives
        ``bits(c*b) = nibble_mats[c] @ stack mod 2``.
        """
        if self.w != 8:
            raise ValueError("nibble operator is defined for w=8 only")
        if self._nibble_mats is None:
            vals = np.concatenate([np.arange(16, dtype=np.int64) << 4, np.arange(16, dtype=np.int64)])
            prods = self.mul(np.arange(256, dtype=np.int64)[:, None], vals[None, :])
            shifts = np.arange(8, dtype=np.int64)
            self._nibble_mats = ((prods[:, None, :].astype(np.int64) >> shifts[None, :, None]) & 1).astype(np.uint8)
        return self._nibble_mats

    def expand_bitmatrix(self, A: np.ndarray) -> np.ndarray:
        """(p, k) GF matrix -> (p*w, k*w) GF(2) operator; block (i, j) is
        ``bitmats[A[i, j]]``."""
        A = np.asarray(A)
        p, k = A.shape
        blocks = self.bitmats[A.astype(np.int64)]  # (p, k, w, w)
        return blocks.transpose(0, 2, 1, 3).reshape(p * self.w, k * self.w)


@functools.lru_cache(maxsize=None)
def get_field(w: int = 8) -> GaloisField:
    """One field instance per width."""
    return GaloisField(w)
