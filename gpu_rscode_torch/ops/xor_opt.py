"""The XOR and ring schedule optimizer, ``RS_XOR_OPT``: the port's own copy
of the JAX package's ``ops/xor_opt.py``.

Paar's CSE minimises the XOR count of a schedule; this pass rewrites the
order in which the straight-line program spends it.  Every transform is
semantics-preserving (XOR is associative and commutative), so outputs are
byte-identical with the pass on or off:

* **Topological reordering**: CSE pair nodes are emitted demand-driven,
  each right before its first consumer (dependencies first), instead of in
  Paar's discovery order.  ``nodes_moved`` counts repositioned nodes.
* **Term grouping**: within each output row, CSE nodes come first (newest
  first), then raw input planes in ascending order.
* **Region tiling**: the chain walks the packed planes in contiguous
  column blocks sized so the live set of one block (input planes, CSE
  nodes, outputs) fits a cache budget.  :func:`choose_tile` is the JAX
  package's choice, word for word.  The pipelines run it on the CPU; on
  CUDA a tile would turn every XOR into one launch per tile, so the chain
  runs whole-width there unless ``RS_XOR_TILE`` forces a tile
  (:func:`device_tile`).
* **Unpack splitting**: the JAX package emits a large unpack as two
  executables to dodge an XLA fusion pathology.  PyTorch has no such
  fusion, so :func:`split_unpack` is only recorded in :class:`OptStats`,
  as the JAX package records it.

Knobs (read when a pipeline is built; the pipeline caches key on
:func:`env_fingerprint`):

* ``RS_XOR_OPT=0``: turn the whole pass off.
* ``RS_XOR_TILE``: force the chain tile width in packed words (``0``
  turns tiling off; unset = automatic).
* ``RS_XOR_TILE_BUDGET``: the cache budget in bytes of the automatic
  tile choice (default 2 MiB).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..obs import profiler as _prof

__all__ = [
    "OptStats", "opt_enabled", "tile_override", "tile_budget_bytes",
    "reorder_pairs", "group_row_terms", "choose_tile", "device_tile",
    "optimize_program", "split_unpack", "env_fingerprint",
    "UNPACK_SPLIT_MIN_PLANE_BYTES",
]

# Tile bounds in packed int32 words: 256 words = 1 KiB a plane slice.
_MIN_TILE = 256
_MAX_TILE = 1 << 20

# Planes of at least 64 KiB count as a split unpack (see the docstring).
UNPACK_SPLIT_MIN_PLANE_BYTES = 65536


def opt_enabled() -> bool:
    """Whether the optimizer pass runs (``RS_XOR_OPT``, default on)."""
    return os.environ.get("RS_XOR_OPT", "1").lower() not in ("0", "false", "off", "no")


def tile_override() -> int | None:
    """``RS_XOR_TILE`` as words; ``0`` = force tiling off; None = auto."""
    v = os.environ.get("RS_XOR_TILE")
    if not v:
        return None
    try:
        n = int(v)
    except ValueError:
        return None
    return max(0, n)


def tile_budget_bytes() -> int:
    """Cache budget for the auto tile choice (``RS_XOR_TILE_BUDGET``)."""
    try:
        v = int(os.environ.get("RS_XOR_TILE_BUDGET", str(2 << 20)))
        return v if v > 0 else (2 << 20)
    except ValueError:
        return 2 << 20


def env_fingerprint() -> tuple:
    """Resolved knob state, for pipeline cache keys: two pipelines built
    under different optimizer settings never share a cache slot."""
    return (opt_enabled(), tile_override(), tile_budget_bytes())


@dataclass(frozen=True)
class OptStats:
    """What the pass did to one pipeline."""

    enabled: bool
    nodes_moved: int
    term_groups: int
    tile_words: int     # 0 = chain not tiled
    n_tiles: int        # 1 = single whole-width pass
    est_working_set_bytes: int
    split_unpack: bool

    def as_dict(self) -> dict:
        return {
            "enabled": self.enabled,
            "nodes_moved": self.nodes_moved,
            "term_groups": self.term_groups,
            "tile_words": self.tile_words,
            "n_tiles": self.n_tiles,
            "est_working_set_bytes": self.est_working_set_bytes,
            "split_unpack": self.split_unpack,
        }


_DISABLED = OptStats(
    enabled=False, nodes_moved=0, term_groups=0, tile_words=0,
    n_tiles=1, est_working_set_bytes=0, split_unpack=False,
)


def reorder_pairs(pair_ops, rows, n_inputs: int):
    """Demand-driven topological reordering of the CSE pair nodes.

    Walks the output rows in order; before a row is emitted, every
    not-yet-emitted pair node it (transitively) needs is emitted,
    dependencies first.  A permutation and an index remap: the node DAG
    and every XOR term set are kept exactly.

    Returns ``(pair_ops, rows, nodes_moved)`` with node indices remapped to
    the new order.
    """
    n_pairs = len(pair_ops)
    if not n_pairs:
        return tuple(pair_ops), tuple(tuple(r) for r in rows), 0
    emitted: dict[int, int] = {}  # old node idx -> new node idx
    new_pairs: list[tuple[int, int]] = []

    def emit(old: int) -> int:
        if old < n_inputs:
            return old
        hit = emitted.get(old)
        if hit is not None:
            return hit
        a, b = pair_ops[old - n_inputs]
        na, nb = emit(a), emit(b)
        new = n_inputs + len(new_pairs)
        new_pairs.append((na, nb))
        emitted[old] = new
        return new

    new_rows = tuple(tuple(emit(t) for t in r) for r in rows)
    # A pair no row reaches (Paar never builds one, a stored schedule
    # could) is appended, so the node count stays the same.
    for old in range(n_inputs, n_inputs + n_pairs):
        emit(old)
    moved = sum(
        1 for old, new in emitted.items()
        if pair_ops[old - n_inputs] != new_pairs[new - n_inputs] or old != new
    )
    return tuple(new_pairs), new_rows, moved


def group_row_terms(pair_ops, rows, n_inputs: int):
    """Group each row's terms by access pattern: CSE nodes first (newest
    first), then input planes ascending.

    Returns ``(rows, term_groups)``; term_groups counts the contiguous
    access groups across all rows (at most 2 a row).
    """
    groups = 0
    out = []
    for r in rows:
        nodes = sorted((t for t in r if t >= n_inputs), reverse=True)
        inputs = sorted(t for t in r if t < n_inputs)
        groups += (1 if nodes else 0) + (1 if inputs else 0)
        out.append(tuple(nodes + inputs))
    return tuple(out), groups


def choose_tile(n_planes: int, nw: int, *, itemsize: int = 4):
    """The chain tile width for ``n_planes`` live plane vectors of ``nw``
    packed words each.

    The largest power-of-two ``T`` whose live set ``n_planes * T *
    itemsize`` fits the budget, clamped to ``[_MIN_TILE, _MAX_TILE]``;
    tiling needs at least two full tiles.  Returns ``(tile_words, n_tiles,
    est_working_set_bytes)``; ``(0, 1, ws)`` runs the chain whole (ws is
    then the full-width live set).
    """
    ov = tile_override()
    if ov == 0:
        return 0, 1, n_planes * nw * itemsize
    if ov:
        t = min(ov, nw)
        if nw // t < 2:
            return 0, 1, n_planes * nw * itemsize
        return t, -(-nw // t), n_planes * t * itemsize
    budget = tile_budget_bytes()
    t = _MIN_TILE
    while t * 2 <= _MAX_TILE and n_planes * (t * 2) * itemsize <= budget:
        t *= 2
    if n_planes * t * itemsize > budget or nw // t < 2:
        # The budget is out of reach even at the floor, or the operand is
        # too narrow to cut twice: run whole.
        return 0, 1, n_planes * nw * itemsize
    return t, -(-nw // t), n_planes * t * itemsize


def device_tile(n_planes: int, nw: int, device_type: str):
    """The tile a pipeline on ``device_type`` runs: :func:`choose_tile` on
    the CPU; on CUDA whole-width unless ``RS_XOR_TILE`` forces a tile (each
    tile costs one launch per XOR, and the card's caches are not what the
    automatic budget models)."""
    if device_type == "cuda" and tile_override() is None:
        return 0, 1, n_planes * nw * 4
    return choose_tile(n_planes, nw)


def optimize_program(pair_ops, rows, n_inputs: int):
    """Reorder and group one (pair_ops, rows) straight-line XOR program.
    Returns ``(pair_ops, rows, nodes_moved, term_groups)``."""
    t0 = time.perf_counter()
    pair_ops, rows, moved = reorder_pairs(pair_ops, rows, n_inputs)
    rows, groups = group_row_terms(pair_ops, rows, n_inputs)
    # A profiled dispatch building this program attributes the pass's wall
    # and its two counters in its cache block.
    _prof.note_opt(time.perf_counter() - t0, opt_moved=moved, opt_groups=groups)
    return pair_ops, rows, moved, groups


def split_unpack(plane_words: int, *, itemsize: int = 4) -> bool:
    """Whether the JAX package would split this unpack into two executables
    (recorded only; see the module docstring)."""
    return plane_words * itemsize >= UNPACK_SPLIT_MIN_PLANE_BYTES


def disabled_stats() -> OptStats:
    return _DISABLED
