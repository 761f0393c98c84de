"""The measurement tools' check of a timed call's output against a
reference, on columns spread over the whole output: the first and last
column of every block the kernel launched (the last, ragged block too) and
random columns between them.  A wrong result ends the tool; it is never
printed as a rate.
"""

from __future__ import annotations

import numpy as np
import torch

RANDOM_COLS = 65536


def sample_columns(m: int, blocks, seed: int = 0) -> np.ndarray:
    """Sorted distinct columns of an ``m``-column output: the first and last
    column of every block, for each block width in ``blocks``, and
    ``RANDOM_COLS`` columns drawn at random."""
    cols = [np.random.default_rng(seed).integers(0, m, size=min(RANDOM_COLS, m))]
    for b in blocks:
        starts = np.arange(0, m, b)
        cols += [starts, np.minimum(starts + b, m) - 1]
    return np.unique(np.concatenate(cols))


def check_columns(name: str, got: torch.Tensor, rows: int, m: int, cols: np.ndarray, want: np.ndarray) -> None:
    """Raise unless ``got`` is (rows, m) and its columns ``cols`` equal
    ``want``."""
    if tuple(got.shape) != (rows, m):
        raise AssertionError(f"{name}: output shape {tuple(got.shape)}, expected {(rows, m)}")
    sub = got.index_select(1, torch.from_numpy(cols).to(got.device)).cpu().numpy()
    if not np.array_equal(sub, want):
        bad = int((sub != want).sum())
        raise AssertionError(f"{name}: {bad} of {want.size} checked outputs "
                             f"(columns over every block) differ from the reference")
