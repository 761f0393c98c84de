"""Integer knobs of the resilience reads, read from the environment:
``RS_RETRY_RESELECT`` (survivor reselections of a degraded decode, default
3) and ``RS_RETRY_SUBSET_ATTEMPTS`` (batches of 100 candidate subsets the
survivor search tries, default 3)."""

from __future__ import annotations

import os


def int_env(name: str, default: int) -> int:
    """``int(os.environ[name])``, or ``default`` when unset or not an
    integer."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
