"""Rolling-window SLO tracker (the ``HPNN_SLO_MS`` knob): a copy of
``hpnn_tpu/obs/slo.py``.

The serve stack answers requests; this module answers whether it is
answering them *well enough*.  With ``HPNN_SLO_MS=<ms>`` set, every
request outcome recorded at the ``serve.request`` lifecycle close
(serve/server.py ``Session.infer``) lands in a clock-injectable ring
bounded by ``HPNN_SLO_WINDOW_S`` seconds, and the tracker computes,
over that window:

* **p50 / p99** of the latencies of *served* requests — shed and
  expired outcomes never distort the percentile of the work that was
  actually accepted;
* **attainment** — the fraction of completed (non-shed) requests that
  finished within the objective; an expired or errored request is a
  miss, a shed one is excluded (it was rejected up front, which is the
  point of shedding: it spends error budget as lost goodput, not as
  latency);
* **error-budget burn rate** — ``(1 - attainment) / (1 - target)``:
  1.0 means the budget drains exactly at its sustainable rate, above
  1.0 the window is eating future budget (``HPNN_SLO_TARGET``,
  default 0.99).

The numbers export as ``slo.*`` gauges (``slo.p50_ms``, ``slo.p99_ms``,
``slo.attainment``, ``slo.burn_rate``, ``slo.window_requests``) on
``/metrics``, and :func:`health_doc` contributes the verdict section of
the serve ``/healthz`` document.  The freshest p99 snapshot is also
readable synchronously (:func:`current_p99_ms`) — that is the signal
the batcher's SLO-driven admission control sheds on
(serve/batcher.py, ``HPNN_SHED_P99_MS``).

Contract (same as every obs knob): ``HPNN_SLO_MS`` unset ⇒ one env
read ever, then every call is a constant-time no-op — no clock reads,
no allocation, no stdout bytes.  Gauge emission is throttled (every
``_PUBLISH_EVERY`` records) so a loaded server does not write five
JSONL lines per request.  stdlib-only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_SLO_MS"
ENV_WINDOW = "HPNN_SLO_WINDOW_S"
ENV_TARGET = "HPNN_SLO_TARGET"

DEFAULT_WINDOW_S = 60.0
DEFAULT_TARGET = 0.99

# request outcomes the tracker understands; anything else is "error"
OUTCOMES = ("ok", "shed", "expired", "error")

_PUBLISH_EVERY = 8

_enabled: bool | None = None
_tracker: "Tracker | None" = None
_tracker_lock = threading.Lock()


def enabled() -> bool:
    """True when ``HPNN_SLO_MS`` is set.  First call reads the env;
    later calls are a memo hit."""
    global _enabled
    if _enabled is None:
        _enabled = bool(os.environ.get(ENV_KNOB))
    return _enabled


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """Linear-interpolation percentile (numpy's default definition)
    over an already-sorted list; None when empty."""
    n = len(sorted_vals)
    if not n:
        return None
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= n:
        return sorted_vals[-1]
    return sorted_vals[lo] + frac * (sorted_vals[lo + 1] - sorted_vals[lo])


class Tracker:
    """Clock-injectable rolling window of request outcomes.

    ``record`` appends one ``(now, status, latency_s)`` entry and
    prunes anything older than ``window_s``; ``snapshot`` computes the
    windowed statistics.  Thread-safe; tests drive it with a fake
    ``clock`` and zero sleeps."""

    def __init__(self, slo_ms: float, *, window_s: float = DEFAULT_WINDOW_S,
                 target: float = DEFAULT_TARGET, clock=time.monotonic):
        if slo_ms <= 0:
            raise ValueError("slo_ms must be > 0")
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        self.slo_ms = float(slo_ms)
        self.window_s = float(window_s)
        self.target = float(target)
        self._clock = clock
        self._ring: deque[tuple[float, str, float | None]] = deque()
        self._lock = threading.Lock()
        self._n_since_pub = 0
        self._last: dict | None = None

    def _prune(self, now: float) -> None:
        lo = now - self.window_s
        ring = self._ring
        while ring and ring[0][0] < lo:
            ring.popleft()

    def record(self, status: str, latency_s: float | None = None) -> None:
        """Record one request outcome; publishes the ``slo.*`` gauges
        every ``_PUBLISH_EVERY`` records (and on the first)."""
        if status not in OUTCOMES:
            status = "error"
        now = self._clock()
        with self._lock:
            self._ring.append((now, status, latency_s))
            self._prune(now)
            self._n_since_pub += 1
            publish = (self._last is None
                       or self._n_since_pub >= _PUBLISH_EVERY)
        if publish:
            self.publish()

    def snapshot(self) -> dict:
        """The windowed statistics right now (prunes first)."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            entries = list(self._ring)
        lats = sorted(lat for (_, s, lat) in entries
                      if s == "ok" and lat is not None)
        completed = sum(1 for (_, s, _l) in entries if s != "shed")
        shed = len(entries) - completed
        within = sum(1 for v in lats if v * 1e3 <= self.slo_ms)
        attainment = within / completed if completed else 1.0
        burn = (1.0 - attainment) / max(1e-9, 1.0 - self.target)
        p50 = _percentile(lats, 0.50)
        p99 = _percentile(lats, 0.99)
        return {
            "slo_ms": self.slo_ms,
            "window_s": self.window_s,
            "target": self.target,
            "requests": len(entries),
            "served": len(lats),
            "shed": shed,
            "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
            "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
            "attainment": round(attainment, 6),
            "burn_rate": round(burn, 6),
            "verdict": "ok" if attainment >= self.target else "breach",
        }

    def publish(self) -> dict:
        """Compute a snapshot, cache it for :meth:`current_p99_ms`,
        and emit the ``slo.*`` gauges."""
        snap = self.snapshot()
        with self._lock:
            self._last = snap
            self._n_since_pub = 0
        if registry.enabled():
            if snap["p50_ms"] is not None:
                registry.gauge("slo.p50_ms", snap["p50_ms"])
            if snap["p99_ms"] is not None:
                registry.gauge("slo.p99_ms", snap["p99_ms"])
            registry.gauge("slo.attainment", snap["attainment"])
            registry.gauge("slo.burn_rate", snap["burn_rate"])
            registry.gauge("slo.window_requests", snap["requests"])
        return snap

    def current_p99_ms(self) -> float | None:
        """The p99 of the freshest published snapshot — a lock-light
        read for the admission-control hot path (no sort per submit)."""
        with self._lock:
            last = self._last
        return None if last is None else last["p99_ms"]


def _get_tracker() -> Tracker | None:
    """The process tracker, built from the env knobs on first use."""
    global _tracker
    if not enabled():
        return None
    t = _tracker
    if t is None:
        with _tracker_lock:
            t = _tracker
            if t is None:
                try:
                    slo_ms = float(os.environ.get(ENV_KNOB, ""))
                except ValueError:
                    return None
                window_s = float(os.environ.get(ENV_WINDOW, "")
                                 or DEFAULT_WINDOW_S)
                target = float(os.environ.get(ENV_TARGET, "")
                               or DEFAULT_TARGET)
                t = _tracker = Tracker(slo_ms, window_s=window_s,
                                       target=target)
    return t


def configure(slo_ms: float | None, *, window_s: float | None = None,
              target: float | None = None, clock=None) -> None:
    """Programmatic twin of the env knobs: (re)arm the tracker at
    ``slo_ms`` — or disable with None — forgetting any memoized state.
    ``clock`` (tests) is injected into the rebuilt tracker."""
    global _enabled, _tracker
    if slo_ms is None:
        os.environ.pop(ENV_KNOB, None)
    else:
        os.environ[ENV_KNOB] = repr(float(slo_ms))
    if window_s is not None:
        os.environ[ENV_WINDOW] = repr(float(window_s))
    if target is not None:
        os.environ[ENV_TARGET] = repr(float(target))
    with _tracker_lock:
        _enabled = None
        _tracker = None
    if slo_ms is not None and clock is not None:
        with _tracker_lock:
            _enabled = True
            _tracker = Tracker(
                float(slo_ms),
                window_s=(DEFAULT_WINDOW_S if window_s is None
                          else float(window_s)),
                target=DEFAULT_TARGET if target is None else float(target),
                clock=clock)


def record(status: str, latency_s: float | None = None) -> None:
    """Record one request outcome into the process tracker; a no-op
    when ``HPNN_SLO_MS`` is unset."""
    t = _get_tracker()
    if t is not None:
        t.record(status, latency_s)


def current_p99_ms() -> float | None:
    """Freshest windowed p99 (ms) of served requests, or None when the
    knob is off / nothing published yet — the shed-threshold input."""
    t = _get_tracker()
    return None if t is None else t.current_p99_ms()


def health_doc() -> dict:
    """The ``slo`` section of the serve ``/healthz`` document:
    ``{"mode": "off"}`` when untracked, else the windowed snapshot
    with its verdict."""
    t = _get_tracker()
    if t is None:
        return {"mode": "off"}
    doc = t.snapshot()
    doc["mode"] = "on"
    return doc


def _reset_for_tests() -> None:
    global _enabled, _tracker
    with _tracker_lock:
        _enabled = None
        _tracker = None
