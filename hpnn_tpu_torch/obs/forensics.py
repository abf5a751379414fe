"""Tail-latency forensics: head sampling + slow-request promotion.

A copy of ``hpnn_tpu/obs/forensics.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

``HPNN_SPANS=1`` records *every* request's span tree — perfect
attribution, fleet-hostile cost (one ``span.end`` record per request
per hop).  This module is the always-on middle ground (the
``HPNN_SAMPLE`` knob): a head-based coin flip arms the real span
machinery for only the sampled fraction of requests, and every
*unsampled* request pays just a two-clock-read probe whose latency
feeds a small ring — when a probe turns out slower than the ring's
adaptive threshold it is **retro-promoted**: its root span is emitted
after the fact (``promoted`` field set), so the tail is never lost to
the coin flip.  Exemplar spans therefore exist at ~zero steady-state
cost without ``HPNN_SPANS``.

How a sampled request gets a full tree without the global knob: the
edge calls :func:`request_span`, which mints a real ``spans.Span``
via ``spans.force_start``; downstream children (serve/batcher.py,
fleet/router.py) pass the parent span object explicitly, and
``spans.start``/``spans.span`` create a real child whenever the
parent is a real span even while ``HPNN_SPANS`` is unset.  Trace ids
ride the usual ``X-Trace-Id`` header — ``propagate.enabled()`` is
true when this knob is armed, so the HTTP edges mint/adopt traces and
cross-process trees stitch exactly as under ``HPNN_SPANS``.

Every emitted root (sampled or promoted) also marks a **histogram
exemplar** — the registry keeps the last trace id + value per log2
bucket (``registry.exemplar``) and ``/metrics`` renders them as
OpenMetrics-style ``# {trace_id="..."}`` suffixes (obs/export.py), so
a p99 bucket links straight to a reconstructable trace
(``tools/obs_report.py --spans --req``; slowest-N + phase blame:
``tools/tail_report.py``).  The last emitted roots are kept in a
bounded deque for capture capsules (obs/triggers.py).

Knobs (registered in ``hpnn_tpu_torch.config.KNOBS``):

* ``HPNN_SAMPLE=<p>`` — sampling probability in (0, 1]; arms the
  module (and file-less registry aggregation, registry._init);
* ``HPNN_SAMPLE_SLOW_MS=<ms>`` — absolute slow-promotion floor
  (default 0 = adaptive only: ring p95 × 2, warmup 16 probes);
* ``HPNN_SAMPLE_RING=<n>`` — latency-ring capacity (default 256,
  floor 16).

Contract (the usual obs rules, proven by tools/check_tokens.py):
unset ⇒ one env read ever, then constant-time no-ops; never a stdout
byte; stdlib only.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time

from hpnn_tpu_torch.obs import registry, spans

ENV_KNOB = "HPNN_SAMPLE"
ENV_SLOW_MS = "HPNN_SAMPLE_SLOW_MS"
ENV_RING = "HPNN_SAMPLE_RING"

DEFAULT_RING = 256
RING_FLOOR = 16
_WARMUP = 16          # probes before the adaptive threshold speaks
_THR_EVERY = 32       # recompute cadence (probes between recomputes)
_THR_FACTOR = 2.0     # threshold = ring p95 * factor
_RECENT_N = 128       # emitted roots kept for capture capsules

# None = env not read yet; False = disabled; dict = armed config
_cfg: dict | bool | None = None
_lock = threading.Lock()

_rng = random.Random()
_ring: collections.deque | None = None   # recent probe latencies (s)
_recent: collections.deque = collections.deque(maxlen=_RECENT_N)
_thr: float | None = None                # cached adaptive threshold
_since_thr = 0                           # probes since last recompute


def _knob(env: str, default: float, convert=float) -> float:
    """Parse one secondary knob; a malformed value warns on stderr —
    naming the actual offending variable — and falls back to its
    documented default, leaving sampling armed."""
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return convert(raw)
    except ValueError:
        import sys

        sys.stderr.write(f"hpnn obs: bad {env} value {raw!r}; "
                         f"using default {default}\n")
        return default


def _config() -> dict | None:
    """Parse the knobs once; a malformed rate warns on stderr and
    disarms, a malformed secondary knob warns and keeps its default
    (never a crash, never a stdout byte)."""
    global _cfg, _ring
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                raw = os.environ.get(ENV_KNOB, "")
                if not raw:
                    _cfg = False
                else:
                    try:
                        rate = float(raw)
                        if not 0.0 < rate <= 1.0:
                            raise ValueError("rate outside (0, 1]")
                    except ValueError as exc:
                        import sys

                        sys.stderr.write(
                            f"hpnn obs: bad {ENV_KNOB} value "
                            f"{raw!r}: {exc}; sampling disabled\n")
                        _cfg = False
                    else:
                        slow_ms = _knob(ENV_SLOW_MS, 0.0)
                        ring_n = max(RING_FLOOR, int(
                            _knob(ENV_RING, DEFAULT_RING, int)))
                        _cfg = {"rate": rate,
                                "slow_s": max(0.0, slow_ms) / 1e3,
                                "ring_n": ring_n}
                        _ring = collections.deque(maxlen=ring_n)
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when ``HPNN_SAMPLE`` parsed to a valid rate.  First call
    reads the env; later calls are a memo hit."""
    return _config() is not None


# serve edges call this per request; keep it allocation-free
armed = enabled


class _Probe:
    """The unsampled-request record: name + fields + start clock.
    ``id`` is None so children parent nothing; :func:`finish` decides
    at close time whether the request earned retro-promotion."""

    __slots__ = ("name", "fields", "t0", "_done")
    id = None
    parent = None

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields
        self.t0 = time.perf_counter()
        self._done = False


def request_span(name: str, **fields):
    """The edge's span mint: a real span under ``HPNN_SPANS``, a real
    *forced* span for the sampled fraction under ``HPNN_SAMPLE``
    (tagged ``sampled``), a lightweight probe for the rest, and the
    shared null span when nothing is armed.  Close whatever comes
    back with :func:`finish`."""
    if spans.enabled():
        return spans.start(name, **fields)
    cfg = _config()
    if cfg is None:
        return spans._NULL_SPAN
    if _rng.random() < cfg["rate"]:
        return spans.force_start(name, sampled=True, **fields)
    return _Probe(name, dict(fields))


def _threshold(cfg: dict) -> float:
    """The current slow-promotion threshold in seconds: the absolute
    floor when set, tightened by ring-p95 × factor once warmed up.
    Recomputed every ``_THR_EVERY`` probes — never per request.  The
    ring is copied under ``_lock`` (request threads append to it under
    the same lock — an unlocked sort would race the deque mutation and
    crash an otherwise-successful request)."""
    global _thr, _since_thr
    with _lock:
        thr = _thr
        if thr is not None and _since_thr < _THR_EVERY:
            return thr
        ring = _ring
        ordered = (sorted(ring)
                   if ring is not None and len(ring) >= _WARMUP
                   else None)
    if ordered:
        p95 = ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]
        adaptive = p95 * _THR_FACTOR
        thr = (min(adaptive, cfg["slow_s"]) if cfg["slow_s"] > 0
               else adaptive)
    else:
        thr = cfg["slow_s"] if cfg["slow_s"] > 0 else float("inf")
    with _lock:
        _thr = thr
        _since_thr = 0
    return thr


def _remember(sp, dt: float, promoted: bool) -> None:
    """Keep the emitted root's record shape for capture capsules and
    mark the histogram exemplar when a trace id is present."""
    rec = {"ev": "span.end", "kind": "event", "span": sp.id,
           "parent": sp.parent, "name": sp.name,
           "t0": round(sp.t0, 6), "dt": round(dt, 6)}
    rec.update(sp.fields)
    if promoted:
        rec["promoted"] = True
    with _lock:
        _recent.append(rec)
    trace = sp.fields.get("trace")
    if trace:
        # marks land only on aggregates something actually observes
        # into (registry.exemplar is a no-op otherwise): the edge's
        # own timer when it keeps one, plus the span.<name> summary
        # spans.finish always feeds.
        registry.exemplar(sp.name, dt, trace)
        registry.exemplar("span." + sp.name, dt, trace)


def finish(sp, **fields) -> None:
    """Close a :func:`request_span` result.  Real spans emit through
    ``spans.finish`` as usual (plus exemplar + capsule bookkeeping);
    probes feed the latency ring and, when slower than the adaptive
    threshold, retro-promote — a backdated root span is emitted with
    ``promoted`` set and ``forensics.tail_promote`` counts it."""
    if isinstance(sp, spans.Span):
        if sp._done:
            return
        dt = time.perf_counter() - sp.t0
        spans.finish(sp, **fields)
        if _config() is not None:
            with _lock:
                ring = _ring
                if ring is not None:
                    ring.append(dt)
            sp.fields.update(fields)
            _remember(sp, dt, promoted=False)
        return
    if not isinstance(sp, _Probe) or sp._done:
        return
    sp._done = True
    cfg = _config()
    if cfg is None:
        return
    dt = time.perf_counter() - sp.t0
    global _since_thr
    with _lock:
        ring = _ring
        if ring is not None:
            ring.append(dt)
        _since_thr += 1
    if dt < _threshold(cfg):
        return
    # retro-promotion: the probe earned a real record after all
    real = spans.force_start(sp.name, **sp.fields)
    real.t0 = sp.t0
    spans.finish(real, promoted=True, **fields)
    registry.count("forensics.tail_promote",
                   dt=round(dt, 6), root=sp.name)
    real.fields.update(fields)
    _remember(real, dt, promoted=True)


def recent_spans() -> list[dict]:
    """The last emitted roots (sampled + promoted), oldest first —
    the ``spans.jsonl`` payload of a capture capsule.  Snapshot under
    ``_lock``: the capsule thread iterates while request threads
    append."""
    with _lock:
        return list(_recent)


def health_doc() -> dict:
    """The sampler census for ``/healthz``."""
    cfg = _config()
    if cfg is None:
        return {"armed": False}
    with _lock:
        ring_len = len(_ring) if _ring is not None else 0
        thr = _thr
        recent_n = len(_recent)
    return {
        "armed": True,
        "rate": cfg["rate"],
        "ring": ring_len,
        "slow_threshold_ms": (None if thr in (None, float("inf"))
                              else round(thr * 1e3, 3)),
        "recent_spans": recent_n,
    }


def configure(rate: float | str | None) -> None:
    """Programmatic twin of the env knob (the CLI ``--sample`` flag):
    (re)arm sampling at ``rate`` — or disarm with None — and forget
    the memo.  Callers re-running ``obs.configure`` afterwards also
    refresh the registry's file-less activation."""
    if rate is None or rate == "":
        os.environ.pop(ENV_KNOB, None)
    else:
        os.environ[ENV_KNOB] = str(rate)
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _ring, _thr, _since_thr
    with _lock:
        _cfg = None
        _ring = None
        _thr = None
        _since_thr = 0
        _recent.clear()
