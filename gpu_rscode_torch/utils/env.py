"""Tolerant numeric env parsing: the one copy of try/cast/default.

A malformed value selects the DEFAULT; it never crashes an operation
mid-flight.  Import cost: stdlib only.
"""

from __future__ import annotations

import os


def int_env(name: str, default: int) -> int:
    """``int(os.environ[name])``, or ``default`` when unset or not an
    integer."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def float_env(name: str, default: float) -> float:
    """``float(os.environ[name])``, or ``default`` when unset or not a
    number."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default
