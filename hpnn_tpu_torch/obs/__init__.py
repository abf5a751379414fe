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
* the ``--profile DIR`` trace (obs/profiler.py), in which, as under
  any ``torch.profiler``, every context-manager span is a range;
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
  ``HPNN_COST`` (obs/spans.py, obs/cost.py);
* the serve stack's planes, copied from the JAX package: the
  rolling-window SLO tracker ``HPNN_SLO_MS`` (obs/slo.py), trace
  context on the wire (obs/propagate.py, rides ``HPNN_SPANS``) and the
  lock-order watchdog ``HPNN_LOCKWATCH`` (obs/lockwatch.py);
* the serving planes, copied from the JAX package with their knobs:
  the fleet collector push ``HPNN_COLLECTOR`` (obs/collector.py, and
  ``cli/obs_collector.py``), alert rules ``HPNN_ALERTS``
  (obs/alerts.py), the tail sampler ``HPNN_SAMPLE`` (obs/forensics.py),
  capture capsules ``HPNN_CAPSULE_DIR`` (obs/triggers.py, whose
  ``profile/`` window is a ``torch.profiler`` trace), drift sketches
  ``HPNN_DRIFT`` (obs/drift.py), the per-tenant meter ``HPNN_METER``
  (obs/meter.py) and the rolling per-phase blame ``HPNN_BLAME``
  (obs/blame.py), the self-tuning plane's sensor
  (hpnn_tpu_torch/tune/, ``HPNN_TUNE``).

Every knob unset: each env var is read once and memoized, and every
call is a constant-time no-op.  Nothing here writes to stdout.
"""

from hpnn_tpu_torch.obs import (alerts, blame, collector, cost, device,
                                drift, export, flight, forensics, ledger,
                                lockwatch, meter, probes, propagate, slo,
                                spans, triggers)
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
             "HPNN_SPANS", "HPNN_COST", "HPNN_TRACE", "HPNN_FLIGHT",
             "HPNN_SLO_MS", "HPNN_SLO_WINDOW_S", "HPNN_SLO_TARGET",
             "HPNN_LOCKWATCH",
             # the serving planes (and the tuning plane's knobs)
             "HPNN_COLLECTOR", "HPNN_COLLECTOR_QUEUE", "HPNN_COLLECTOR_FLUSH_S",
             "HPNN_ALERTS", "HPNN_SAMPLE", "HPNN_SAMPLE_SLOW_MS",
             "HPNN_SAMPLE_RING", "HPNN_CAPSULE_DIR", "HPNN_CAPSULE_PROFILE_MS",
             "HPNN_CAPSULE_COOLDOWN_S", "HPNN_DRIFT", "HPNN_DRIFT_WINDOW",
             "HPNN_DRIFT_Z", "HPNN_METER", "HPNN_METER_TOPK", "HPNN_BLAME",
             "HPNN_BLAME_WINDOW", "HPNN_TUNE", "HPNN_TUNE_DOMINANT_PCT",
             "HPNN_TUNE_BURN", "HPNN_TUNE_COOLDOWN_S", "HPNN_TUNE_WATCH_S",
             "HPNN_TUNE_QUANT_ERR", "HPNN_TUNE_DRY")

__all__ = [
    "ENV_KNOB",
    "ENV_KNOBS",
    "activate_memory",
    "alerts",
    "blame",
    "collector",
    "configure",
    "cost",
    "count",
    "device",
    "drift",
    "enabled",
    "event",
    "export",
    "flight",
    "flush",
    "forensics",
    "gauge",
    "ledger",
    "lockwatch",
    "meter",
    "observe",
    "probes",
    "propagate",
    "reset",
    "sink_path",
    "slo",
    "snapshot_state",
    "spans",
    "summary",
    "timer",
    "triggers",
]
