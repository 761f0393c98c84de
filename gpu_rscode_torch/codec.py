"""RSCodec: the stripe-level coding engine (compute only, no file IO).

The counterpart of the JAX package's ``codec.py``: a small object holding
the host NumPy total matrix ``[I; G]`` whose ``encode``/``decode`` run one
GF-GEMM over a (rows, m) stripe on the codec's device (``update`` is the
in-place update's parity delta, the same GEMM).  The k x k decode
inverse is computed on the host (:mod:`.ops.inverse`).

Strategies: ``cuda`` (the hand-written kernel, :mod:`.ops.cuda_gemm`),
``bitplane`` and ``table`` (plain PyTorch, :mod:`.ops.gemm`), ``xor`` and
``ring`` (XOR chains over packed bit planes, :mod:`.ops.xor_gemm` and
:mod:`.ops.ring_gemm`, w=8 and w=16 only), ``cpu`` (the native host codec,
:func:`.native.gemm`, w=8 only: it computes on the host, needs no GPU, and
is refused when its library does not build).  ``auto`` resolves through
:func:`.tune.resolve_auto`: ``cuda`` on a CUDA device and ``bitplane`` on
the CPU unless a measured or persisted decision says otherwise.  Every GEMM
goes through the plan layer (:func:`.plan.dispatch`) while it is on, and
through the strategy's function (:func:`.plan.eager`) with ``RS_PLAN=0``.
A kernel, capture or replay failure raises; nothing demotes to another
strategy.

With a ``mesh`` (:mod:`.parallel.mesh`) every GEMM is sharded over it
(:func:`.parallel.sharded.sharded_gf_matmul`, counted in
:data:`.plan.MESH_PLAN_CACHE`): column blocks in cols mode, the k axis too
with ``stripe_sharded``.  ``auto`` then takes the static prior, and
``xor``, ``ring`` and ``cpu`` are refused, as the JAX package refuses its
single-device strategies on a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plan as _plan
from .models.vandermonde import generator_matrix
from .ops.gemm import to_tensor
from .ops.gf import get_field
from .obs import metrics as _obs_metrics, profiler as _prof
from .ops.inverse import invert_matrix
from .tune import VALID_STRATEGIES, resolve_auto, static_choice
from .utils.backend import resolve_device


def entry_device(device, strategy: str) -> torch.device:
    """The device a file operation under ``strategy`` runs on: the host for
    ``cpu`` (an explicit request for the host, which needs no GPU), else
    :func:`.utils.backend.resolve_device`."""
    if strategy == "cpu":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"strategy='cpu' computes on the host; it cannot run on {device!r}")
        return torch.device("cpu")
    return resolve_device(device)


def _mesh_device(mesh, device, strategy: str) -> torch.device:
    """A mesh codec's device, the mesh's home device: refuses the
    single-device strategies (their schedules or host library do not shard)
    and a ``device`` of another type than the mesh's."""
    if strategy in ("xor", "ring"):
        raise ValueError(f"strategy={strategy!r} is single-device (its schedule is built per coefficient matrix for "
                         "one device); use cuda/bitplane/table on a mesh")
    if strategy == "cpu":
        raise ValueError("strategy='cpu' is host-only; it cannot run on a device mesh")
    home = mesh.home
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(f"device {str(device)!r} does not match the mesh's devices ({home.type})")
    return resolve_device(home)


class RSCodec:
    """(n, k) Reed-Solomon codec over GF(2^w) on one device.

    ``native_num`` = k data chunks, ``parity_num`` = n - k parity chunks.
    ``generator``: "vandermonde" (the reference encoder's matrix) or
    "cauchy" (every k-subset decodable).  ``device``: where the stripes are
    computed; None means CUDA and raises when no GPU is present.  ``mesh``:
    shard every GEMM over it (the device is then the mesh's home device);
    ``stripe_sharded`` shards the k axis too (k must divide by the stripe
    axis).
    """

    def __init__(
        self,
        native_num: int,
        parity_num: int,
        w: int = 8,
        generator: str = "vandermonde",
        strategy: str = "auto",
        device=None,
        mesh=None,
        stripe_sharded: bool = False,
    ):
        if native_num < 1 or parity_num < 0:
            raise ValueError(f"bad (k={native_num}, p={parity_num})")
        if strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}: valid strategies are {', '.join(VALID_STRATEGIES)}"
            )
        if strategy in ("xor", "ring") and w not in (8, 16):
            raise ValueError(f"strategy={strategy!r} supports GF(2^8) and GF(2^16) only")
        self.mesh = mesh
        self.stripe_sharded = bool(stripe_sharded) and mesh is not None
        if mesh is not None:
            self.device = _mesh_device(mesh, device, strategy)
            if strategy == "auto":
                strategy = static_choice(w, self.device)
        else:
            self.device = entry_device(device, strategy)
        if strategy == "auto":
            strategy = resolve_auto(native_num, parity_num, w, device=self.device, generator=generator)
        if strategy == "cpu":
            # Validated up front: failing mid-stream would leave partial
            # output files behind.
            from . import native

            if w != 8:
                raise ValueError("strategy='cpu' supports GF(2^8) only")
            if not native.available():
                raise RuntimeError("strategy='cpu' needs the native GEMM library, which did not build here")
            self.device = torch.device("cpu")
        if mesh is not None:
            from .parallel.mesh import COLS, STRIPE

            self._cols_size = mesh.shape[COLS]
            if self.stripe_sharded and native_num % mesh.shape[STRIPE]:
                raise ValueError(f"k={native_num} not divisible by stripe axis ({mesh.shape[STRIPE]} devices)")
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

    def _count_segment(self, op: str, data) -> None:
        """Registry accounting for one stripe dispatch, as the JAX package
        counts it: ``segments_dispatched`` and ``rs_codec_bytes_total`` on
        the true (pre-pad) columns, and the op named for the profiler."""
        from .ops.xor_gemm import PackedOperand

        _prof.note_op(op)
        _obs_metrics.counter("segments_dispatched", "stripe GEMM dispatches by operation and strategy").labels(
            op=op, strategy=self.strategy, w=self.w).inc()
        if isinstance(data, PackedOperand):
            nbytes = data.rows * data.cols_true * data.dtype.itemsize
        elif isinstance(data, _plan.StagedSegment):
            nbytes = data.array.shape[0] * data.cols * data.array.element_size()
        else:
            nbytes = getattr(data, "nbytes", 0)
        if nbytes:
            _obs_metrics.counter("rs_codec_bytes_total", "payload bytes entering stripe GEMM dispatches").labels(
                op=op, strategy=self.strategy, w=self.w).inc(int(nbytes))

    def encode(self, data) -> torch.Tensor:
        """(k, m) natives -> (p, m) parity on the codec's device."""
        self._count_segment("encode", data)
        return self._matmul(self.parity_block, data)

    def decode(self, decode_mat, chunks) -> torch.Tensor:
        """(r, k) recovery rows x (k, m) surviving chunks -> (r, m) natives."""
        self._count_segment("decode", chunks)
        return self._matmul(decode_mat, chunks)

    def update(self, parity_mat, delta) -> torch.Tensor:
        """(p, k) parity coefficient block E x (k, m) native-symbol delta ->
        (p, m) parity delta: RS is linear, so ``parity' = parity ^ E.delta``
        over just the columns an edit touched."""
        self._count_segment("update", delta)
        return self._matmul(parity_mat, delta)

    def syndrome(self, check_mat, chunks) -> torch.Tensor:
        """(r, s) parity-check rows x (s, m) stacked chunk rows -> (r, m)
        syndromes; a zero column is a consistent codeword column.  The depth
        s is the number of chunks present (up to n), not k."""
        self._count_segment("syndrome", chunks)
        return self._matmul(check_mat, chunks)

    def pack_operand(self, data):
        """Pack a staged (rows, m) segment's bit planes once, for the chained
        xor / ring GEMMs that read the same rows: the returned
        :class:`.ops.xor_gemm.PackedOperand` goes to :meth:`syndrome` /
        :meth:`decode` in place of the segment, and its ``select`` hands a
        row subset to the next GEMM with no second pack.  A
        :class:`.plan.StagedSegment` is packed at its bucket width (its
        ``cap`` travels with the planes).  None when the reuse does not
        apply (another strategy, ``RS_XOR_PACK_REUSE=0``), so a caller falls
        back with one ``is None`` check."""
        from .ops import xor_gemm

        if self.strategy not in ("xor", "ring") or self.mesh is not None or not xor_gemm.pack_reuse_enabled():
            return None
        if isinstance(data, _plan.StagedSegment):
            arr, cols_true, cap = data.array, data.cols, data.cap
        else:
            arr = to_tensor(data, self.device)
            cols_true, cap = arr.shape[1], None
        cols = xor_gemm.padded_cols(arr.shape[1])
        if cols != arr.shape[1]:
            arr = xor_gemm.pad_operand(arr, cols)
        return xor_gemm.pack_operand(arr, self.w, cols_true=cols_true, cap=cap)

    def _matmul(self, A, B) -> torch.Tensor:
        from .ops.xor_gemm import PackedOperand

        if self.mesh is not None:
            if isinstance(B, PackedOperand):
                raise ValueError("packed operands require strategy='xor' or 'ring' on a single-device codec")
            return self._matmul_mesh(A, B)
        if isinstance(B, PackedOperand):
            if self.strategy not in ("xor", "ring"):
                raise ValueError("packed operands require strategy='xor' or 'ring' on a single-device codec")
        elif not isinstance(B, _plan.StagedSegment):
            B = to_tensor(B, self.device)
        # A staged segment is bucket-padded: it goes through the plan layer,
        # which trims, even if RS_PLAN was switched off since it was staged.
        if _plan.enabled() or isinstance(B, _plan.StagedSegment):
            return _plan.dispatch(A, B, w=self.w, strategy=self.strategy)
        return _plan.eager(self.strategy, A, B, self.w)

    def _matmul_mesh(self, A, B) -> torch.Tensor:
        """The sharded GEMM: the columns padded with zeros to a multiple of
        the cols axis (:func:`.parallel.sharded.padded_width`; their output
        is trimmed again), placed on the mesh and dispatched
        (:meth:`_dispatch_mesh`)."""
        from .parallel.sharded import padded_width, put_sharded

        B = to_tensor(B, self.device)
        m = B.shape[1]
        width = padded_width(m, self._cols_size)
        if width != m:
            padded = torch.zeros((B.shape[0], width), dtype=B.dtype, device=B.device)
            padded[:, :m] = B
            B = padded
        out = self._dispatch_mesh(A, put_sharded(B, self.mesh, self.stripe_sharded))
        return out[:, :m] if width != m else out

    def _dispatch_mesh(self, A, Bd) -> torch.Tensor:
        """One mesh GEMM of ``A`` by a placed ``Bd`` (a
        :class:`.parallel.sharded.Sharded`), through :func:`.plan.dispatch_mesh`
        so that it counts in ``MESH_PLAN_CACHE``: the single-process path
        above and the multi-process collectives' segment loop both come
        here."""
        from .parallel.sharded import sharded_gf_matmul

        def run(a, b):
            return sharded_gf_matmul(a, b, mesh=self.mesh, w=self.w, strategy=self.strategy,
                                     stripe_sharded=self.stripe_sharded)

        A = np.asarray(A)
        if _plan.enabled():
            return _plan.dispatch_mesh(A, Bd, w=self.w, strategy=self.strategy, mesh=self.mesh,
                                       stripe_sharded=self.stripe_sharded, fn=run)
        return run(A, Bd)

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
