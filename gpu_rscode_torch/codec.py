"""RSCodec: the stripe-level coding engine (compute only, no file IO).

The counterpart of the JAX package's ``codec.py``: a small object holding
the host NumPy total matrix ``[I; G]`` whose ``encode``/``decode`` run one
GF-GEMM over a (rows, m) stripe on the codec's device.  The k x k decode
inverse is computed on the host (:mod:`.ops.inverse`).

Strategies: ``cuda`` (the hand-written kernel, :mod:`.ops.cuda_gemm`),
``bitplane`` and ``table`` (plain PyTorch, :mod:`.ops.gemm`).  ``auto``
resolves to ``cuda`` on a CUDA device and to ``bitplane`` on the CPU.  A
kernel failure raises; nothing demotes to another strategy.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.vandermonde import generator_matrix
from .ops.gemm import gf_matmul_bitplane, gf_matmul_table, to_tensor
from .ops.gf import get_field
from .ops.inverse import invert_matrix
from .utils.backend import resolve_device

VALID_STRATEGIES = ("auto", "cuda", "bitplane", "table")


class RSCodec:
    """(n, k) Reed-Solomon codec over GF(2^w) on one device.

    ``native_num`` = k data chunks, ``parity_num`` = n - k parity chunks.
    ``generator``: "vandermonde" (the reference encoder's matrix) or
    "cauchy" (every k-subset decodable).  ``device``: where the stripes are
    computed; None means CUDA and raises when no GPU is present.
    """

    def __init__(
        self,
        native_num: int,
        parity_num: int,
        w: int = 8,
        generator: str = "vandermonde",
        strategy: str = "auto",
        device=None,
    ):
        if native_num < 1 or parity_num < 0:
            raise ValueError(f"bad (k={native_num}, p={parity_num})")
        if strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}: valid strategies are {', '.join(VALID_STRATEGIES)}"
            )
        self.device = resolve_device(device)
        if strategy == "auto":
            strategy = "cuda" if self.device.type == "cuda" else "bitplane"
        self.gf = get_field(w)
        self.w = w
        self.native_num = native_num
        self.parity_num = parity_num
        self.strategy = strategy
        self.generator = generator
        gen = generator_matrix(generator, parity_num, native_num, self.gf)
        eye = np.eye(native_num, dtype=self.gf.dtype)
        self.total_matrix = np.concatenate([eye, gen], axis=0)  # (n, k)

    @classmethod
    def from_total_matrix(cls, total_mat: np.ndarray, w: int = 8, strategy: str = "auto", device=None) -> "RSCodec":
        """A codec over an existing (n, k) total matrix, e.g. the one the
        JAX package's codec or a .METADATA file carries."""
        total_mat = np.asarray(total_mat)
        if total_mat.ndim != 2 or total_mat.shape[0] <= total_mat.shape[1]:
            raise ValueError(f"total matrix must be (n, k) with n > k, got {total_mat.shape}")
        n, k = total_mat.shape
        if int(total_mat.max(initial=0)) >= 1 << w or int(total_mat.min(initial=0)) < 0:
            raise ValueError(f"total matrix entry out of range for GF(2^{w})")
        codec = cls(k, n - k, w=w, strategy=strategy, device=device)
        codec.generator = "external"
        codec.total_matrix = total_mat.astype(codec.gf.dtype)
        return codec

    @property
    def n(self) -> int:
        return self.native_num + self.parity_num

    @property
    def parity_block(self) -> np.ndarray:
        return self.total_matrix[self.native_num :]

    def encode(self, data) -> torch.Tensor:
        """(k, m) natives -> (p, m) parity on the codec's device."""
        return self._matmul(self.parity_block, data)

    def decode(self, decode_mat, chunks) -> torch.Tensor:
        """(r, k) recovery rows x (k, m) surviving chunks -> (r, m) natives."""
        return self._matmul(decode_mat, chunks)

    def syndrome(self, check_mat, chunks) -> torch.Tensor:
        """(r, s) parity-check rows x (s, m) stacked chunk rows -> (r, m)
        syndromes; a zero column is a consistent codeword column.  The depth
        s is the number of chunks present (up to n), not k."""
        return self._matmul(check_mat, chunks)

    def _matmul(self, A, B) -> torch.Tensor:
        B = to_tensor(B, self.device)
        if self.strategy == "cuda":
            from .ops.cuda_gemm import gf_matmul_cuda

            return gf_matmul_cuda(A, B.contiguous(), self.w)
        if self.strategy == "table":
            return gf_matmul_table(A, B, self.w)
        return gf_matmul_bitplane(A, B, self.w)

    def decode_matrix(self, survivor_rows) -> np.ndarray:
        """Inverse of the k x k submatrix of the total matrix selected by
        ``survivor_rows`` (chunk indices, in stacking order).  Raises
        SingularMatrixError when the survivor set is not decodable."""
        rows = list(survivor_rows)
        if len(rows) != self.native_num:
            raise ValueError(f"need exactly k={self.native_num} survivors, got {len(rows)}")
        if any(r < 0 or r >= self.n for r in rows):
            raise ValueError(f"survivor index out of range in {rows}")
        return invert_matrix(self.total_matrix[rows], self.gf)

    def decode_matrix_from(self, total_mat: np.ndarray, survivor_rows) -> np.ndarray:
        """Same, against an externally supplied total matrix (the one parsed
        from .METADATA, which decode trusts over regeneration)."""
        rows = list(survivor_rows)
        total_mat = np.asarray(total_mat)
        if any(r < 0 or r >= total_mat.shape[0] for r in rows):
            raise ValueError(f"survivor chunk index out of range for n={total_mat.shape[0]}: {rows}")
        return invert_matrix(total_mat[rows], self.gf)
