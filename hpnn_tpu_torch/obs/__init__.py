"""hpnn_tpu_torch.obs — structured metrics and numerics checks (the
port of the JAX package's obs core).

The byte-stable stdout token protocol (utils/logging.py) is the
reference-faithful surface and never changes; this package is the
structured side channel beside it, with the JAX package's event names
and record schemas (docs/observability.md), so ``tools/obs_report.py``,
``tools/ledger_diff.py`` and ``tools/check_obs_catalog.py`` read its
files unchanged:

* a metrics registry (counters, gauges, timers, histograms) with a
  JSONL sink, ``HPNN_METRICS=<path>`` (obs/registry.py);
* ``torch.profiler`` ranges for the protocol phases and the
  ``--profile DIR`` trace (obs/profiler.py);
* device telemetry at round/chunk boundaries — card memory, native
  builds (obs/device.py);
* live export: Prometheus text on ``GET /metrics`` and ``/healthz``
  (``--export-port``, obs/export.py);
* a flight recorder dumped on aborts and signals, ``HPNN_FLIGHT``
  (obs/flight.py);
* numerics: per-tensor probes, the checksum ledger and the NaN
  sentinel — ``HPNN_PROBES``, ``HPNN_LEDGER``, ``HPNN_NUMERICS``
  (obs/probes.py, obs/ledger.py);
* spans and the work catalog with its MFU gauges — ``HPNN_SPANS``,
  ``HPNN_COST`` (obs/spans.py, obs/cost.py).

Every knob unset: each env var is read once and memoized, and every
call is a constant-time no-op.  Nothing here writes to stdout.  The JAX
package's fleet-telemetry, forensics, drift, meter, blame and tuning
planes are not ported; their knobs are refused (``runtime.DEFERRED_ENV``).
"""

from hpnn_tpu_torch.obs import (cost, device, export, flight, ledger, probes,
                                spans)
from hpnn_tpu_torch.obs.profiler import annotate, step_annotation
from hpnn_tpu_torch.obs.registry import (
    ENV_KNOB,
    activate_memory,
    configure,
    count,
    enabled,
    event,
    flush,
    gauge,
    observe,
    sink_path,
    snapshot_state,
    summary,
    timer,
    _reset_for_tests,
)

def reset() -> None:
    """Forget every memoized knob reading and close the open sinks, so
    the next call re-reads the environment: for a driver that runs
    several configurations in one process."""
    _reset_for_tests()


# every environment knob of the ported obs core (each read once and
# memoized; _reset_for_tests forgets the readings)
ENV_KNOBS = ("HPNN_METRICS", "HPNN_LEDGER", "HPNN_PROBES", "HPNN_NUMERICS",
             "HPNN_SPANS", "HPNN_COST", "HPNN_TRACE", "HPNN_FLIGHT")

__all__ = [
    "ENV_KNOB",
    "ENV_KNOBS",
    "activate_memory",
    "annotate",
    "configure",
    "cost",
    "count",
    "device",
    "enabled",
    "event",
    "export",
    "flight",
    "flush",
    "gauge",
    "ledger",
    "observe",
    "probes",
    "reset",
    "sink_path",
    "snapshot_state",
    "spans",
    "step_annotation",
    "summary",
    "timer",
]
