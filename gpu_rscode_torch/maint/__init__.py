"""``rs maint`` — the always-on background-maintenance plane: the port's
copy of the JAX package's ``maint/``.

* :mod:`.controller` — the :class:`~.controller.MaintController` state
  machine: drain the three work sources (ledger-driven repair + scrub,
  store-stats-driven compaction) into idempotent jobs, paced by a
  burn-rate governor polling the SLO engine and a token bucket capping
  device bytes per second.  Progress lives only in the ledger: kill the
  process mid-job and the next pass converges.

Import cost: the standard library only at package level; jobs import the
api lazily when they actually run.
"""

from __future__ import annotations

__all__ = ["controller"]
