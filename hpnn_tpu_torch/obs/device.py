"""Device telemetry: card memory occupancy and the port's builds (the
port of ``hpnn_tpu/obs/device.py``).

The drivers call :func:`sample` at round and chunk boundaries (never
inside the per-sample loop), emitting one gauge set per call:

* ``device.hbm_bytes_in_use`` / ``device.hbm_peak_bytes`` — PyTorch's
  caching allocator on the current card (``torch.cuda.memory_stats``:
  allocated bytes now and at peak); absent when no card is in use;
* ``device.compile_events`` / ``device.compile_time_s`` — the native
  builds this process ran (``ops/_build.py``'s ``nvcc`` and ``g++``
  runs), where the JAX package counts XLA compiles.

Everything is a host-side query: no launch, no device sync.  When the
registry is disabled the call is one memoized-bool check.
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch.obs import registry


def compile_stats() -> dict:
    """Cumulative builds (events, time_s) this process ran so far."""
    build = sys.modules.get("hpnn_tpu_torch.ops._build")
    log = build.build_log if build is not None else {}
    return {"events": len(log),
            "time_s": sum(secs for secs, _ in log.values())}


def sample(phase: str, step: int | None = None) -> None:
    """Emit one device-telemetry gauge set tagged with ``phase`` (and
    ``step`` when given).  No-op when the registry is disabled."""
    if not registry.enabled():
        return
    import torch

    fields = {"phase": phase}
    if step is not None:
        fields["step"] = int(step)
    # only a card this process already uses: never initialize CUDA here
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        ms = torch.cuda.memory_stats()
        used = int(ms.get("allocated_bytes.all.current", 0))
        registry.gauge("device.hbm_bytes_in_use", used, **fields)
        registry.gauge("device.hbm_peak_bytes",
                       int(ms.get("allocated_bytes.all.peak", used)), **fields)
    comp = compile_stats()
    registry.gauge("device.compile_events", comp["events"], **fields)
    registry.gauge("device.compile_time_s", round(comp["time_s"], 6), **fields)
