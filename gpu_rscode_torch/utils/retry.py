"""Integer knobs of the resilience reads, read from the environment:
``RS_RETRY_RESELECT`` (survivor reselections of a degraded decode, default
3) and ``RS_RETRY_SUBSET_ATTEMPTS`` (batches of 100 candidate subsets the
survivor search tries, default 3), parsed by :func:`.env.int_env`."""

from __future__ import annotations

from .env import int_env

__all__ = ["int_env"]
