"""``rs serve`` — resident multi-tenant encode/decode daemon.

The port's copy of the JAX package's ``serve/``: one resident process in
front of the card keeps the plan cache, the replayed CUDA graphs and the
staging pool warm across requests, and batches concurrent small requests
through them (docs/SERVE.md).

Modules:

* :mod:`.queue`    — bounded admission queue: reject past ``RS_SERVE_DEPTH``,
  per-tenant deficit-round-robin fairness, deadline-aware ordering;
* :mod:`.batcher`  — cross-request batching by (k, n, w, strategy) shape
  bucket under the ``RS_SERVE_BATCH_MS`` coalescing window;
* :mod:`.objcache` — the hot-object LRU in front of ``GET /o/``;
* :mod:`.daemon`   — the HTTP front end (`rs serve`): POST /encode /decode
  /scrub /update /append and the /o/ object routes, graceful drain on
  SIGTERM;
* :mod:`.loadgen`  — open-loop (Poisson) load harness (`rs loadgen`) with
  per-tenant mixes, latency percentiles and captures.

Import cost: the standard library at package level; the daemon imports
the PyTorch stack when it starts serving.
"""

from __future__ import annotations

__all__ = ["queue", "batcher", "daemon", "loadgen"]
