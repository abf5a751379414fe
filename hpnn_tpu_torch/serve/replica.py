"""One serving replica: a full :class:`~hpnn_tpu_torch.serve.server.Session`
pinned to a device, plus the bookkeeping the router needs (a copy of
``hpnn_tpu/serve/replica.py``).

A replica is deliberately *not* a new abstraction — it IS a Session
(registry + bucketed engine + micro-batchers), so every Session
behavior (warmup, hot-reload, readiness, shedding, fleet mode, health)
carries over verbatim.  What it adds:

* ``rank`` — the replica's stable index, stamped on its obs records
  (``replica.outstanding`` gauges carry ``rank=i`` the same way train
  sinks carry ``{rank}`` in ``HPNN_METRICS`` paths, so
  ``tools/obs_report.py --merge`` joins serve replicas like training
  ranks);
* a device pin — on ``cuda`` the engine holds its weights and captures
  its graphs on ``cuda:(rank % device_count)``, so on one card N
  replicas share ``cuda:0``; on the CPU N replicas are N independent
  batcher/drain thread stacks;
* an outstanding-requests counter — lock-protected, maintained by the
  router around every routed request; the router's
  least-outstanding-requests placement reads it (docs/serving.md).
"""

from __future__ import annotations

import threading

from hpnn_tpu_torch.serve.server import Session


class Replica(Session):
    """A rank-stamped, device-pinned Session (see module docstring)."""

    def __init__(self, rank: int, *, device_index: int | None = None,
                 **session_kwargs):
        self.rank = int(rank)
        if device_index is None:
            device_index = self.rank
        super().__init__(device_index=device_index, **session_kwargs)
        self._out_lock = threading.Lock()
        self._outstanding = 0

    # ------------------------------------------------- router bookkeeping
    def begin_request(self, rows: int = 1) -> int:
        """Count a routed request in, weighted by its row count, and
        return the new outstanding depth.  Row-weighting makes the
        router's placement least-outstanding-WORK, not request count:
        one resident 512-row block and one 1-row probe are wildly
        different loads, and counting them equally would park light
        traffic behind heavy dispatch chains (the head-of-line
        isolation ``tools/bench_serve.py --replicas`` measures)."""
        with self._out_lock:
            self._outstanding += int(rows)
            return self._outstanding

    def end_request(self, rows: int = 1) -> None:
        with self._out_lock:
            self._outstanding -= int(rows)

    def outstanding(self) -> int:
        """Rows currently routed here and not yet answered."""
        with self._out_lock:
            return self._outstanding
