"""Resilience subsystem — fault injection, retry/backoff, chaos testing:
the port's copy of the JAX package's ``resilience/``.

* :mod:`.faults` — the deterministic, seedable fault-injection plane
  (``RS_FAULTS`` / ``--faults`` specs like ``read:ioerror@p=0.02``),
  a shared no-op when unset.
* :mod:`.retry` — bounded exponential backoff with seeded jitter,
  transient/fatal classification and a per-operation retry budget,
  applied to chunk reads, segment gathers and the write-behind drains.
* :mod:`.chaos` — the ``rs chaos`` harness: seeded encode ->
  corrupt-per-schedule -> scrub/auto-decode/repair on the device, every
  output differential-checked against the host GF oracle.

Import cost: the standard library only — :mod:`.faults` and
:mod:`.retry` are imported by ``parallel.io_executor``.  :mod:`.chaos`
imports the api lazily and is NOT imported here.
"""

from . import faults, retry

__all__ = ["faults", "retry"]
