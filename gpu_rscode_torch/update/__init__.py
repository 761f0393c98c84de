"""Delta-parity partial-stripe updates and append-mode encoding: the
counterpart of the JAX package's ``update/``.

RS over GF(2^w) is linear, so a byte-range edit of the original file moves
only the touched symbol columns: with ``E`` the parity coefficient block
of the archive's total matrix and ``Δ = new ⊕ old`` the native-symbol
delta, ``parity' = parity ⊕ E·Δ``.

* :func:`~.engine.apply_update` / :func:`~.engine.apply_append`: the patch
  engine behind ``api.update_file`` / ``api.append_file``: byte range to
  touched column windows (both chunk layouts), Δ assembly, ``E·Δ`` through
  a :class:`..parallel.pipeline.StreamLoop` (K1 on the compute stream on
  CUDA, from pinned staging), in-place patches through an ordered pwrite
  lane, and incremental per-chunk CRC fix-up (:mod:`.crc`).
* :func:`~.group.apply_update_many`: many edits under one journal fsync
  chain and one metadata commit, small windows stacked into one GEMM.
* :mod:`.journal`: the undo journal that makes the in-place mutation
  crash-atomic; byte-compatible with the JAX package's.
* :mod:`.layout`: the ``interleaved`` chunk layout (file symbol s in row
  ``s % k``, column ``s // k``), under which an append touches only the
  tail column block.
"""

from __future__ import annotations

from .crc import crc32_append, crc32_combine, crc32_patch, crc32_zeros
from .engine import (
    SimulatedCrash,
    UpdateError,
    apply_append,
    apply_update,
)
from .group import apply_update_many, group_stats, group_window
from .journal import journal_path, recover
from .layout import deinterleave, interleave

__all__ = [
    "SimulatedCrash",
    "UpdateError",
    "apply_append",
    "apply_update",
    "apply_update_many",
    "crc32_append",
    "crc32_combine",
    "crc32_patch",
    "crc32_zeros",
    "deinterleave",
    "group_stats",
    "group_window",
    "interleave",
    "journal_path",
    "recover",
]
