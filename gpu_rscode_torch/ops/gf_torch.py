"""GF(2^w) primitives on tensors: the counterpart of the JAX package's
``ops/gf_jax.py``.

The tables come from :mod:`.gf` and are moved to the requested device per
call (they are at most a few hundred KB); the ops are branchless gathers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .gf import get_field


@functools.lru_cache(maxsize=None)
def _np_tables(w: int):
    gf = get_field(w)
    return np.asarray(gf.log, dtype=np.int64), gf.exp.astype(np.int64)


def tables(w: int = 8, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(log, exp) as int64 tensors on ``device`` (CPU when None)."""
    log, exp = _np_tables(w)
    return torch.as_tensor(log, device=device), torch.as_tensor(exp, device=device)


def mul_table(w: int = 8, device=None) -> torch.Tensor:
    """Full (2^w, 2^w) product table (w <= 8 only), int64."""
    gf = get_field(w)
    if gf.mul_table is None:
        raise ValueError(f"full mul table not materialised for w={w}")
    return torch.as_tensor(gf.mul_table.astype(np.int64), device=device)


def gf_mul(a: torch.Tensor, b: torch.Tensor, w: int = 8) -> torch.Tensor:
    """Elementwise GF multiply of integer tensors (int64 result)."""
    log, exp = tables(w, a.device)
    return exp[log[a.long()] + log[b.long()]]


def gf_inv(a: torch.Tensor, w: int = 8) -> torch.Tensor:
    """Elementwise inverse.  Zero maps to 0 (its sentinel lands in the zero
    pad): callers that need an error on zero check first."""
    gf = get_field(w)
    log, exp = tables(w, a.device)
    return exp[(gf.order - log[a.long()]) % (2 * gf.sentinel + 1)]
