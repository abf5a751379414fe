"""Live metrics export: Prometheus text rendering + pull endpoints (the
port of ``hpnn_tpu/obs/export.py``).

It renders the registry's in-process aggregate snapshot
(``registry.snapshot_state()``) in the Prometheus text exposition
format (version 0.0.4), or as OpenMetrics 1.0 histograms when the
scraper asks for ``application/openmetrics-text``, and serves it from a
standalone stdlib HTTP server (:func:`start_export_server`) wired to
``train_nn``/``run_nn --export-port N``, so a training run is
scrapeable while it trains.  Starting a server calls
``registry.activate_memory()``, so the export path works even when
``HPNN_METRICS`` is unset.

Mapping: obs counters become Prometheus ``counter``s (``_total``
suffix), obs gauges become ``gauge``s, and timer/histogram aggregates
become ``summary`` metrics — q0.5/q0.9/q0.99 estimated from the
registry's log2 buckets — plus exact ``_sum``/``_count``.  Metric names
are ``hpnn_`` + the event name with non-alphanumerics mapped to ``_``.

``/healthz`` reports process-level health: registry state, uptime,
plus whatever the drivers published through :func:`set_health`.  The
JAX package's per-tenant families and trace exemplars are not ported.
stdlib only; nothing here ever writes stdout.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from hpnn_tpu_torch.obs import registry

QUANTILES = (0.5, 0.9, 0.99)
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")

_health: dict = {}
_health_lock = threading.Lock()


# ------------------------------------------------------------ health
def set_health(**fields) -> None:
    """Publish health fields (e.g. ``last_round={...}``) for the
    ``/healthz`` endpoints.  A plain dict update — cheap enough to call
    unconditionally from the drivers."""
    with _health_lock:
        _health.update(fields)


def health() -> dict:
    """The process-health document served on ``/healthz``."""
    snap = registry.snapshot_state()
    out = {
        "status": "ok",
        "pid": os.getpid(),
        "metrics_active": snap is not None,
    }
    if snap is not None:
        out["uptime_s"] = snap["uptime_s"]
        out["sink"] = snap["path"]
    with _health_lock:
        out.update(_health)
    return out


def _reset_for_tests() -> None:
    with _health_lock:
        _health.clear()


# ------------------------------------------------------------ render
def _metric_name(ev: str) -> str:
    """Sanitize a dotted obs name into a spec-valid Prometheus metric
    name: ``perf.mfu`` → ``hpnn_perf_mfu``.  The ``hpnn_`` prefix
    guarantees a legal leading character whatever the event name."""
    return "hpnn_" + _NAME_RE.sub("_", ev)


def _escape_label_value(v) -> str:
    """Escape one label value: backslash, double-quote and newline
    per the exposition spec, plus carriage return (a raw one breaks
    the line structure for a ``splitlines()``-style reader)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n").replace("\r", "\\r"))


def _render_labels(labels: dict) -> str:
    """Render ``{k="v",...}`` with sanitized names and escaped
    values; empty dict renders to nothing."""
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".9g")


def _quantile_estimate(agg: dict, q: float) -> float:
    """Estimate quantile ``q`` from a registry aggregate snapshot's
    log2 buckets: walk buckets in order until the cumulative count
    reaches ``q * n``, then interpolate linearly *within* the landing
    bucket ``k`` (span ``[2^(k-1), 2^k)``) by how far into its count
    the target falls — answering the upper bound alone overestimates
    by up to 2x.  The result is clamped to the observed [min, max],
    which also repairs bucket 0 (it additionally holds values ≤ 0,
    below its nominal span)."""
    buckets = agg.get("log2_buckets") or {}
    n = agg.get("n") or 0
    vmin, vmax = agg.get("min"), agg.get("max")
    if not n or not buckets:
        return 0.0
    target = q * n
    seen = 0
    for k in sorted(buckets, key=int):
        c = buckets[k]
        seen += c
        if seen >= target:
            ki = int(k)
            lo, hi = 2.0 ** (ki - 1), 2.0 ** ki
            frac = (target - (seen - c)) / c
            est = lo + frac * (hi - lo)
            if vmax is not None:
                est = min(est, float(vmax))
            if vmin is not None:
                est = max(est, float(vmin))
            return est
    return float(vmax) if vmax is not None else 0.0


def render_prometheus(snap: dict | None) -> str:
    """The Prometheus text exposition (0.0.4) of one registry
    snapshot.  ``snap=None`` (registry inactive) renders a comment-only
    document — a scrape of an idle process is 200, not an error."""
    lines = []
    if snap is None:
        lines.append("# hpnn obs registry inactive "
                     "(set HPNN_METRICS or start an export server)")
        return "\n".join(lines) + "\n"
    lines.append("# TYPE hpnn_obs_uptime_seconds gauge")
    lines.append(f"hpnn_obs_uptime_seconds {_fmt(snap['uptime_s'])}")
    for ev, total in sorted(snap["counters"].items()):
        m = _metric_name(ev) + "_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(total)}")
    for ev, value in sorted(snap["gauges"].items()):
        m = _metric_name(ev)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(value)}")
    for ev, agg in sorted(snap["aggregates"].items()):
        m = _metric_name(ev)
        lines.append(f"# TYPE {m} summary")
        for q in QUANTILES:
            est = _quantile_estimate(agg, q)
            labels = _render_labels({"quantile": q})
            lines.append(f"{m}{labels} {_fmt(est)}")
        lines.append(f"{m}_sum {_fmt(agg['total'])}")
        lines.append(f"{m}_count {agg['n']}")
    return "\n".join(lines) + "\n"


def render_openmetrics(snap: dict | None) -> str:
    """The OpenMetrics 1.0 text exposition of one registry snapshot —
    the variant negotiated by ``Accept: application/openmetrics-text``.
    Aggregates render as **histograms** with cumulative ``le`` buckets
    taken from the registry's log2 buckets (bucket ``k`` holds
    ``(2^(k-1), 2^k]``, so its upper bound is ``2^k``; bucket 0 also
    absorbs values ≤ 0).  Ends with the mandatory ``# EOF``."""
    lines = []
    if snap is None:
        lines.append("# hpnn obs registry inactive "
                     "(set HPNN_METRICS or start an export server)")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"
    lines.append("# TYPE hpnn_obs_uptime_seconds gauge")
    lines.append(f"hpnn_obs_uptime_seconds {_fmt(snap['uptime_s'])}")
    for ev, total in sorted(snap["counters"].items()):
        m = _metric_name(ev)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}_total {_fmt(total)}")
    for ev, value in sorted(snap["gauges"].items()):
        m = _metric_name(ev)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(value)}")
    for ev, agg in sorted(snap["aggregates"].items()):
        m = _metric_name(ev)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for k, c in sorted((agg.get("log2_buckets") or {}).items(),
                           key=lambda kv: int(kv[0])):
            cum += c
            lines.append(f'{m}_bucket{{le="{_fmt(2.0 ** int(k))}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {agg["n"]}')
        lines.append(f"{m}_sum {_fmt(agg['total'])}")
        lines.append(f"{m}_count {agg['n']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def wants_openmetrics(accept: str | None) -> bool:
    """Content negotiation for ``/metrics``: True when the scraper's
    Accept header names the OpenMetrics media type."""
    return bool(accept) and "application/openmetrics-text" in accept


def metrics_response(accept: str | None = None) -> tuple[bytes, str]:
    """The negotiated ``/metrics`` response for the current registry
    state: ``(body, content_type)`` — 0.0.4 text by default, the
    OpenMetrics histogram form when the Accept header asks for it."""
    snap = registry.snapshot_state()
    if wants_openmetrics(accept):
        return (render_openmetrics(snap).encode("utf-8"),
                OPENMETRICS_CONTENT_TYPE)
    return (render_prometheus(snap).encode("utf-8"),
            TEXT_CONTENT_TYPE)


# ------------------------------------------------------------ server
class _ExportHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # stdout stays byte-frozen
        sys.stderr.write("obs.export: %s - %s\n"
                         % (self.address_string(), fmt % args))

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            body, ctype = metrics_response(self.headers.get("Accept"))
            self._send(200, body, ctype)
        elif self.path == "/healthz":
            body = json.dumps(health()).encode("utf-8")
            self._send(200, body, "application/json")
        else:
            self._send(404, b'{"error": "not found"}', "application/json")


def start_export_server(host: str = "127.0.0.1",
                        port: int = 0) -> ThreadingHTTPServer:
    """Start the standalone export endpoint on a daemon thread and
    return the server (``server.server_address`` carries the bound
    port; pass ``port=0`` for an ephemeral one).  Activates in-memory
    aggregation so scrapes see data even without ``HPNN_METRICS``."""
    registry.activate_memory()
    server = ThreadingHTTPServer((host, port), _ExportHandler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="hpnn-obs-export", daemon=True)
    server._thread = thread
    thread.start()
    bound_host, bound_port = server.server_address[:2]
    registry.event("export.listen", host=bound_host, port=bound_port)
    return server


def stop_export_server(server: ThreadingHTTPServer) -> None:
    server.shutdown()
    server.server_close()
