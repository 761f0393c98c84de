"""Sharded GF-GEMM over a device mesh: the scale-out compute path, the
counterpart of the JAX package's ``parallel/sharded.py``.

Capability parity with the reference's multi-GPU fan-out (one pthread per
device over disjoint byte ranges, encode.cu:240-292,357-408), on a
``(stripe, cols)`` :class:`.mesh.Mesh`:

* **cols mode**: each shard runs the codec's strategy on its column slice
  on its own device (``cuda``: K1's folded form, ``gf_bitslice_kernel``,
  or under the RS_PALLAS_* knobs K2 / K3 with the refold
  :func:`..ops.cuda_gemm.static_refold` gives, which never calibrates or
  warns for ``autotune``; ``bitplane`` / ``table``: the plain versions).
  No communication.
* **stripe mode** (the wide stripe, BASELINE config 4, k=128): the
  contraction axis k is sharded.  A GF XOR across devices is not a sum,
  but its bit-plane form is: each shard computes the integer pre-parity
  sums of its k-slice (``cuda``: K1's ``gf_popcount_kernel``,
  ``gf_matmul_cuda(..., fold_parity=False)``, or under RS_PALLAS_EXPAND
  K3's pre-parity form; ``bitplane``: the plain version), narrowed to
  int8 on its device (the mod-256 wrap is even, so each sum keeps its
  parity; K3's signed sums wrap the same way), summed over the stripe
  shards this process holds, then ``all_reduce(SUM)`` across processes,
  and folded with
  :func:`..ops.gemm.from_bitplanes` (XOR = sum mod 2, taken after the
  reduction).  The logical reduce volume is ``p * w * m`` int8 bytes a
  segment (``rs_mesh_collective_bytes_total{op="psum_stripe"}``).

Shards are placed by :func:`put_sharded`: a position's shard is its own
tensor (a contiguous copy where the slice is not contiguous), and each
position's GEMM writes its own output, so positions that share one card
never alias.  Everything runs on the current stream of each shard's
device: a :class:`..parallel.pipeline.StreamLoop` compute stream for the
home device.  On CUDA a ``cuda`` dispatch launches K1 or raises.

In a multi-process job (the mesh's positions held by several ranks) the
arguments and the result are this process's block: :func:`put_sharded`
takes the local block of the global (k, W) array (:func:`local_block`)
and :func:`sharded_gf_matmul` returns the local column block of the
result.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..obs import metrics as _metrics, tracing as _tracing
from ..ops import gemm as _gemm

# The strategies with a pre-parity form (the stripe mode needs one).
PREPARITY_STRATEGIES = ("bitplane", "cuda")


def padded_width(m: int, cols_size: int) -> int:
    """``m`` columns padded up to a multiple of the cols axis: the width a
    segment is placed at, so that every cols shard is equal.  GF linearity
    makes the pad's output columns zeros; the callers trim them again."""
    return -(-m // cols_size) * cols_size


def local_block(mesh, shape, stripe_sharded: bool, rank: int | None = None) -> tuple[int, int, int, int]:
    """``(r0, r1, c0, c1)``: the contiguous block of a global (k, W) array
    that process ``rank`` (default this one) holds.  Rows are all k unless
    ``stripe_sharded``.  Each axis must tile contiguously and, in stripe
    mode, the positions must form the full cartesian block (a mesh built by
    :func:`.mesh.make_mesh` in process order does)."""
    k, W = shape
    S, C = mesh.devices.shape
    pos = mesh.local_positions(rank)
    if not pos:
        raise ValueError("this process holds no position of the mesh")
    cs = sorted({c for _, c in pos})
    if cs != list(range(cs[0], cs[-1] + 1)):
        raise ValueError("the mesh's cols axis gives this process a non-contiguous column range; build the mesh "
                         "in process order (make_mesh)")
    c0, c1 = cs[0] * (W // C), (cs[-1] + 1) * (W // C)
    if not stripe_sharded:
        return 0, k, c0, c1
    ss = sorted({s for s, _ in pos})
    if ss != list(range(ss[0], ss[-1] + 1)) or set(pos) != {(s, c) for s in ss for c in cs}:
        raise ValueError("the mesh gives this process a non-contiguous (stripe, cols) block; build the mesh in "
                         "process order (make_mesh)")
    return ss[0] * (k // S), (ss[-1] + 1) * (k // S), c0, c1


class Sharded:
    """A (k, W) array placed on a mesh: ``shards`` maps each mesh position
    this process computes to its tensor on the position's device.  In cols
    mode one position a column block (the first this process holds).
    ``shape`` is the global shape, ``block`` this process's
    ``(r0, r1, c0, c1)``, ``nbytes`` the bytes this process placed."""

    def __init__(self, shards: dict, shape: tuple, dtype, block: tuple, stripe_sharded: bool, nbytes: int):
        self.shards = shards
        self.shape = shape
        self.dtype = dtype
        self.block = block
        self.stripe_sharded = stripe_sharded
        self.nbytes = nbytes


def _place(B, mesh, stripe_sharded: bool) -> Sharded:
    B = _gemm.to_tensor(B)
    S, C = mesh.devices.shape
    pos = mesh.local_positions()
    if not pos:
        raise ValueError("this process holds no position of the mesh")
    n_c = len({c for _, c in pos})
    n_s = len({s for s, _ in pos}) if stripe_sharded else 1
    rows, cols = B.shape
    if cols % n_c or rows % n_s:
        raise ValueError(f"a ({rows}, {cols}) block does not split over this process's {n_s} x {n_c} mesh "
                         "positions; pad the columns to a multiple of the cols axis")
    shape = (rows // n_s * (S if stripe_sharded else 1), cols // n_c * C)
    if stripe_sharded and shape[0] % S:
        raise ValueError(f"k={shape[0]} not divisible by the stripe axis ({S} devices)")
    r0, r1, c0, c1 = block = local_block(mesh, shape, stripe_sharded)
    kb, mb = (shape[0] // S if stripe_sharded else shape[0]), shape[1] // C
    shards = {}
    for s, c in pos:
        if not stripe_sharded:
            if any(c == c2 for (_, c2) in shards):
                continue  # a replica along the stripe axis: computed once
            s_rows = slice(None)
        else:
            s_rows = slice(s * kb - r0, (s + 1) * kb - r0)
        x = B[s_rows, c * mb - c0:(c + 1) * mb - c0]
        shards[(s, c)] = x.to(mesh.devices[s, c]).contiguous()
    return Sharded(shards, shape, B.dtype, block, stripe_sharded, int(B.nbytes))


def put_sharded(B, mesh, stripe_sharded: bool = False) -> Sharded:
    """Place a (k, m) array on the mesh with the encode sharding.

    Single-process: ``B`` is the global array.  Multi-process: ``B`` is
    this process's block (:func:`local_block`), which is all it stages
    from the file.  Counts ``rs_mesh_segments_staged_total{stripe,procs}``
    and the process-local ``rs_mesh_staged_bytes_total{stripe}`` under a
    ``mesh_stage`` span, as the JAX package does.
    """
    from .distributed import world_size

    _metrics.counter("rs_mesh_segments_staged_total", "segments placed onto a device mesh (put_sharded)").labels(
        stripe=stripe_sharded, procs=world_size()).inc()
    _metrics.counter("rs_mesh_staged_bytes_total", "bytes placed onto a device mesh (process-local portion)").labels(
        stripe=stripe_sharded).inc(int(B.nbytes))
    with _tracing.span("mesh_stage", lane="stage", cols=int(B.shape[1]), stripe=bool(stripe_sharded)):
        return _place(B, mesh, stripe_sharded)


def sharded_gf_matmul(A, B, *, mesh, w: int = 8, strategy: str = "bitplane", stripe_sharded: bool = False):
    """``C = A . B`` over GF(2^w), B sharded over the mesh.

    ``A``: (p, k) coefficients (each stripe shard takes its k-slice in
    stripe mode).  ``B``: a :class:`Sharded` from :func:`put_sharded`, or
    an array placed here (uncounted, as the JAX package's implicit
    placement is).  Returns the (p, m) result on the mesh's home device
    (this process's column block in a multi-process job).  Each call
    records a ``mesh_dispatch`` span and, in stripe mode, the ``p * w * m``
    logical bytes of the reduction.
    """
    if not isinstance(B, Sharded):
        B = _place(B, mesh, stripe_sharded)
    A = np.asarray(A)
    m = int(B.shape[1])
    if stripe_sharded:
        _metrics.counter("rs_mesh_collective_bytes_total", "logical bytes through mesh collectives per dispatch").labels(
            op="psum_stripe").inc(int(A.shape[0]) * w * m)
    with _tracing.span("mesh_dispatch", lane="dispatch", strategy=str(strategy), stripe=bool(stripe_sharded), cols=m):
        outs = _stripe(A, B, mesh, w, strategy) if stripe_sharded else _cols(A, B, w, strategy)
    home = mesh.home
    outs.sort(key=lambda item: item[0])
    if len(outs) == 1:
        return outs[0][1].to(home)
    return torch.cat([out.to(home) for _, out in outs], dim=1)


def _folded(A, b: torch.Tensor, w: int, strategy: str) -> torch.Tensor:
    if strategy == "cuda":
        from ..ops.cuda_gemm import gf_matmul_cuda, static_refold

        return gf_matmul_cuda(A, b, w, refold=static_refold(w))
    if strategy == "bitplane":
        return _gemm.gf_matmul_bitplane(A, b, w)
    if strategy == "table":
        return _gemm.gf_matmul_table(A, b, w)
    raise ValueError(f"strategy {strategy!r} has no mesh form; use cuda, bitplane or table on a mesh")


def _cols(A, B: Sharded, w: int, strategy: str) -> list:
    return [(c, _folded(A, b, w, strategy)) for (_, c), b in sorted(B.shards.items())]


def _stripe(A, B: Sharded, mesh, w: int, strategy: str) -> list:
    if strategy not in PREPARITY_STRATEGIES:
        warnings.warn(f"stripe-sharded GEMM needs a pre-parity form (bitplane/cuda); ignoring strategy={strategy!r}",
                      stacklevel=3)
        strategy = "bitplane"
    S = mesh.devices.shape[0]
    kb = A.shape[1] // S
    sums: dict[int, torch.Tensor] = {}
    for (s, c), b in sorted(B.shards.items()):
        a_loc = np.ascontiguousarray(A[:, s * kb:(s + 1) * kb])
        if strategy == "cuda":
            from ..ops.cuda_gemm import gf_matmul_cuda

            acc = gf_matmul_cuda(a_loc, b, w, fold_parity=False)
        else:
            acc = _gemm.gf_matmul_bitplane(a_loc, b, w, fold_parity=False)
        # int32 -> int8 through uint8, whose narrowing wraps mod 256 by
        # definition: an even modulus, so every sum keeps its parity, and
        # the reduction moves a quarter of the int32 bytes.
        part = acc.to(torch.uint8).view(torch.int8)
        if c in sums:
            sums[c].add_(part.to(sums[c].device))
        else:
            sums[c] = part
    group = _reduce_group(mesh)
    if group is not False:
        for c in sorted(sums):
            torch.distributed.all_reduce(sums[c], group=group)
    return [(c, _gemm.from_bitplanes(acc, w)) for c, acc in sums.items()]


def _reduce_group(mesh):
    """The process group this process's stripe sums reduce over: the
    processes that hold the same column blocks (None: the whole group),
    or False when no other process holds them.  Every process creates
    every group, in the same order, at its first stripe dispatch."""
    from .distributed import rank, world_size

    world = world_size()
    if world == 1:
        return False
    if mesh._groups is None:
        ranks = sorted({int(p) for p in mesh.processes.flat})
        if ranks != list(range(world)):
            raise ValueError("a multi-process mesh must hold positions on every process of the group")
        spans: dict = {}
        for r in ranks:
            spans.setdefault(tuple(sorted({c for _, c in mesh.local_positions(r)})), []).append(r)
        groups = {}
        for span, members in sorted(spans.items()):
            if len(members) == world:
                groups[span] = None
            elif len(members) > 1:
                groups[span] = torch.distributed.new_group(members)
            else:
                groups[span] = False
        mesh._groups = groups
    return mesh._groups[tuple(sorted({c for _, c in mesh.local_positions(rank())}))]

