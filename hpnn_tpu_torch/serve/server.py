"""Serving front ends: the in-process ``Session`` and the HTTP shim (a
copy of ``hpnn_tpu/serve/server.py`` over the port's engine).

The serving planes arm from the JAX package's knobs: ``/healthz``
carries the ``alerts``, ``sampler``, ``capsules``, ``drift``, ``blame``
and ``tune`` sections, ``/meterz``, ``/tunez`` and ``POST /v1/capture``
answer when ``HPNN_METER``, ``HPNN_TUNE`` and ``HPNN_CAPSULE_DIR`` are
armed (404 otherwise), and ``/tenantz`` answers on a
:class:`~hpnn_tpu_torch.tenant.TenantSession`.  ``POST /ingest`` feeds
an attached :class:`~hpnn_tpu_torch.online.OnlineSession` (it answers 404
on a plain serving process, as in the JAX package).

The reference's deployment story is *embedding* — a host scientific
code calls ``_NN(run,kernel)`` in its inner loop.  :class:`Session` is
that story kept resident: load kernels once, then ``infer(name, x)``
from any number of threads; requests coalesce through one
:class:`~hpnn_tpu_torch.serve.batcher.Batcher` per kernel into bucketed
captured forwards (:class:`~hpnn_tpu_torch.serve.engine.Engine`).

The HTTP layer is deliberately thin — stdlib ``http.server`` over the
same Session, for drivers that aren't Python:

* ``POST /v1/infer``  ``{"kernel": n, "inputs": [...]}`` →
  ``{"outputs": [...], "req_id": ...}``; 404 unknown kernel, 400
  malformed, **429** queue full or load shed (retriable,
  ``Retry-After`` set), **504** deadline exceeded (retriable,
  ``Retry-After`` set).  Every response carries an ``X-Request-Id``
  (client-sent ``req_id`` honored, else edge-minted) that threads
  through the request's spans (docs/serving.md).
* ``POST /v1/reload`` ``{"kernel": n}`` → re-read the kernel file.
* ``POST /v1/capture`` ``{"reason": s?}`` → snap a forensic capture
  capsule on demand (obs/triggers.py; ``HPNN_CAPSULE_DIR``); 404
  unarmed, 429 while one is in flight or cooling down.
* ``POST /ingest`` (alias ``/v1/ingest``)
  ``{"kernel": n?, "inputs": [...], "targets": [...]}`` → feed the
  online-learning sample buffer when an ``OnlineSession`` is attached
  (hpnn_tpu_torch/online/; docs/online.md); 404 on a plain serving process.
  Carries the same ``X-Request-Id`` echo as ``/v1/infer`` and runs
  under a ``serve.ingest`` span parented to the caller's trace.

Both POST data routes adopt ``X-Trace-Id``/``X-Parent-Span`` request
headers (obs/propagate.py) so the request's span tree parents across
the process boundary, and echo ``X-Trace-Id`` back.
* ``GET /healthz`` → **liveness**: always 200 while the process can
  answer — kernel/bucket census, bucket-compile count, per-kernel
  queue depth + oldest-waiter age + shed/expired counters, SLO
  verdict, process obs health, plus the readiness verdict.
* ``GET /readyz`` → **readiness**: 200 once the session is warm, 503
  + ``Retry-After`` while buckets are pre-warming or the promotion
  WAL is replaying (``Session.mark_unready``) — and the POST routes
  answer the same 503 so restart-under-traffic fails fast instead of
  timing out (docs/resilience.md).
* ``GET /metrics`` → the obs aggregate snapshot in Prometheus text
  format (obs/export.py; docs/observability.md).
* ``GET /tenantz`` → per-tenant quota/SLO census, pager state, and
  registry shard balance on a multi-tenant host
  (hpnn_tpu/tenant/; docs/tenancy.md); 404 on a plain session.
  ``/v1/infer`` on such a host routes by the ``X-Tenant`` request
  header (absent → the default tenant) and a quota rejection's 429
  body carries ``reason="quota"`` plus the tenant name.
* ``GET /tunez`` → the self-tuning plane's census — policy, applied/
  rolled-back/vetoed counts, the armed watch, recent decision ledger
  (hpnn_tpu/tune/; docs/selftuning.md); 404 when ``HPNN_TUNE`` is
  unarmed.
* ``GET /connz`` → the connection-plane census — live connection
  table, close-reason and guard-kill totals, per-IP census
  (hpnn_tpu/serve/conn.py; docs/serving.md); ``{"mode": "off"}``
  when no ``HPNN_CONN_*`` knob is armed.

The socket layer beneath the handlers is instrumented and guarded by
``serve/conn.py`` (``make_server`` wires it, so Router replicas and
ClusterRouter workers inherit it): accepted connections carry a
default socket timeout, handler-thread ``socket.timeout`` /
``ConnectionResetError`` become counted ``conn.close`` events instead
of stderr stack traces, and with the knobs armed the plane adds
header/body read deadlines, a per-IP cap, and a slow-client
byte-rate guard.

SIGTERM graceful drain: :func:`install_drain` chains a handler that
stops admission (readiness flips, new arrivals get 503 +
``Retry-After``), flushes in-flight batches, flushes the obs sink and
flight recorder exactly once (shared guard with the obs crash
handlers), and lets the driver exit 0 (docs/resilience.md).

Nothing here writes stdout (request logging is suppressed; errors go
to stderr) — the token protocol stays byte-frozen even when a server
runs inside a driver process.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hpnn_tpu_torch import obs, runtime, tune
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.serve import compile_cache, conn
from hpnn_tpu_torch.serve.batcher import (Batcher, DeadlineExceeded, QueueFull,
                                    Shed)
from hpnn_tpu_torch.serve.engine import (DEFAULT_MAX_BATCH, DEFAULT_N_BUCKETS,
                                   Engine)
from hpnn_tpu_torch.serve.registry import Registry, RegistryError


class Session:
    """Resident inference session: registry + engine + per-kernel
    micro-batchers behind one ``infer`` call.

    ``start=False`` runs with no drain threads (tests step batchers
    by hand via ``batcher_for(name).drain_once()``); ``clock`` is
    forwarded to the batchers for fake-clock tests.

    ``fleet=True`` (or ``HPNN_SERVE_FLEET=1``) routes every kernel
    through ONE shared batcher whose dispatch hook is
    ``engine.dispatch_fleet``: requests for different same-topology
    kernels coalesce into one stacked executable per drain, and
    mixed/singleton topologies transparently fall back to the
    per-kernel path inside the hook (docs/fleet.md).

    ``device`` is where the engine runs: ``cuda`` unless the caller
    asks for the CPU (``device="cpu"``); ``device_index`` pins a
    ``cuda`` engine to ``cuda:(i % device_count)``.
    """

    FLEET_BATCHER = "(fleet)"

    def __init__(self, *, max_batch: int = DEFAULT_MAX_BATCH,
                 n_buckets: int = DEFAULT_N_BUCKETS,
                 max_wait_ms: float = 2.0, max_depth: int = 256,
                 shed_age_ms: float | None = None,
                 shed_p99_ms: float | None = None,
                 clock=time.monotonic, start: bool = True,
                 mode: str | None = None, fleet: bool | None = None,
                 device_index: int | None = None, device=None):
        runtime.refuse_deferred("serve.Session")
        self.registry = Registry()
        self.engine = Engine(self.registry, max_batch=max_batch,
                             n_buckets=n_buckets, mode=mode,
                             device_index=device_index, device=device)
        self.max_wait_ms = float(max_wait_ms)
        self.max_depth = int(max_depth)
        self.shed_age_ms = shed_age_ms    # None → batcher reads env
        self.shed_p99_ms = shed_p99_ms
        if fleet is None:
            fleet = os.environ.get("HPNN_SERVE_FLEET", "") == "1"
        self.fleet = bool(fleet)
        self._clock = clock
        self._start = bool(start)
        self._lock = threading.Lock()
        # held by every method below that gives a kernel a new version:
        # an install captures the next version before publishing it, so
        # no other method may take that version number meanwhile
        self._versions = threading.RLock()
        self._batchers: dict[str, Batcher] = {}
        self._closed = False
        # the online-learning layer (hpnn_tpu_torch/online/) plugs in here:
        # ingest_hook(kernel|None, X, T) -> dict serves POST /ingest;
        # online_health() -> dict becomes /healthz's "online" section.
        # Both stay None on a plain serving process (route answers 404)
        self.ingest_hook = None
        self.online_health = None
        # POST /v1/reload calls reload_hook(name) in place of reload
        # when set: an online session queues it to its trainer thread
        self.reload_hook = None
        # readiness (distinct from liveness): a session is born ready
        # for the embed-and-go paths; drivers that bind the HTTP edge
        # before warmup/WAL-replay flip it with mark_unready/mark_ready
        # so restart-under-traffic answers 503 instead of hanging
        self._ready = True
        self._ready_reason: str | None = None
        # the self-tuning remediation plane (hpnn_tpu_torch/tune/,
        # docs/selftuning.md): a control loop over this session's
        # registry/engine, started only when HPNN_TUNE is armed.
        # Hosts that own an autoscaler or a quota enforcer wire them
        # in by rebuilding: tune.for_session(self, autoscaler=...,
        # quota=...).
        self.tuner = tune.for_session(self)
        if self.tuner is not None and self._start:
            self.tuner.start()

    # ------------------------------------------------------------ kernels
    def load_kernel(self, name: str, path: str, *,
                    model: str = "ann", warmup: bool = True):
        """Load a kernel file, install it, optionally pre-compile the
        whole bucket menu so serving never hits a compile stall."""
        with self._versions:
            entry = self.registry.load(name, path, model=model)
            if warmup:
                self.engine.warmup([name])
        return entry

    def register_kernel(self, name: str, kernel: kernel_mod.Kernel, *,
                        model: str = "ann", warmup: bool = True,
                        path: str | None = None,
                        mtime: float | None = None,
                        sig: tuple | None = None):
        """Install in-memory weights.  ``path``/``mtime``/``sig`` give
        the entry a reload source (the online WAL-restore path hands a
        checkpoint here); without them there is no file backing and no
        hot-reload."""
        with self._versions:
            entry = self.registry.register(name, kernel, model=model,
                                           path=path, mtime=mtime, sig=sig)
            if warmup:
                self.engine.warmup([name])
        return entry

    def _publish(self, new, *, warmup: bool = True):
        """Publish ``new`` (an entry the registry re-read from its file)
        with its forwards captured first, on the calling thread, as
        :meth:`install_kernel` does; then evict the older versions."""
        if warmup:
            self.engine.warmup_entry(new)
        entry = self.registry.publish(new)
        if warmup:
            self.engine.warmup([entry.name])
        self.engine.evict(entry.name, keep_version=entry.version)
        return entry

    def reload(self, name: str, *, warmup: bool = True):
        """Force a re-read of ``name``'s kernel file and re-warm it."""
        with self._versions:
            return self._publish(self.registry.reread(name), warmup=warmup)

    def maybe_reload(self, name: str) -> bool:
        """Hot-reload ``name`` if its file changed on disk."""
        with self._versions:
            new = self.registry.stale(name)
            if new is None:
                return False
            self._publish(new)
        return True

    def install_kernel(self, name: str, kernel: kernel_mod.Kernel, *,
                       warmup: bool = True):
        """Atomically promote in-memory ``kernel`` as a new version of
        resident ``name`` (the online promotion path, no disk
        round-trip): registry entry swap, engine warmed on the new
        version, old executables evicted.  In-flight batches finish
        on the entry they dispatched with — a request observes the
        old or the new version, never a torn mix (docs/online.md).
        The new version's forwards are captured BEFORE the registry
        publishes it, on the calling thread, so no batcher meets the
        new version without them and captures on its own thread."""
        with self._versions:
            if warmup and kernel_mod.validate(kernel):
                try:
                    prev = self.registry.get(name)
                except KeyError:
                    prev = None     # the registry's install refuses it
                if prev is not None:
                    self.engine.warmup_entry(prev._replace(
                        kernel=kernel, version=prev.version + 1))
            entry = self.registry.install(name, kernel)
            if warmup:
                # finds every forward built above (a version change
                # outside this session, e.g. a precision retag, builds)
                self.engine.warmup([name])
            self.engine.evict(name, keep_version=entry.version)
        return entry

    def kernels(self) -> list[str]:
        return self.registry.names()

    # ------------------------------------------------------------ readiness
    def mark_unready(self, reason: str) -> None:
        """Flip the readiness verdict (liveness unaffected): the HTTP
        edge answers 503 + Retry-After on /readyz and the POST routes
        until :meth:`mark_ready`.  Used around warmup / promotion-WAL
        replay at boot and by the SIGTERM drain."""
        self._ready = False
        self._ready_reason = str(reason)
        obs.event("serve.unready", reason=str(reason))

    def mark_ready(self) -> None:
        self._ready = True
        self._ready_reason = None
        obs.event("serve.ready")

    def is_ready(self) -> bool:
        return self._ready

    def ready_doc(self) -> dict:
        return {"ready": self._ready, "reason": self._ready_reason}

    # above this many kernels the health document summarizes (counts
    # + worst offenders) instead of enumerating — a 10k-kernel host
    # must not pay an O(n) namespace scan per /healthz scrape
    # (docs/tenancy.md)
    HEALTH_LIST_MAX = 64

    def health(self) -> dict:
        """The /healthz document: kernel census, bucket-compile census,
        per-batcher queue depth + oldest-waiter age + cumulative
        shed/expired counters, and the SLO verdict (obs/slo.py).
        Past ``HEALTH_LIST_MAX`` kernels, the per-kernel sections
        summarize: the kernel list becomes a census + sample, the
        batcher map keeps only totals + the worst offenders by queue
        depth, and the numerics/precision scans run on the sample."""
        with self._lock:
            batchers = dict(self._batchers)
        cache = self.engine.cache_stats()
        # the process's forward-cache lookups (serve/compile_cache.py)
        cache["graphs"] = compile_cache.stats()
        n_kernels = self.registry.count()
        big = n_kernels > self.HEALTH_LIST_MAX
        if big:
            kernels_doc: object = dict(self.registry.census(),
                                       sample=self.registry.sample(16))
            probe_names = self.registry.sample(16)
        else:
            kernels_doc = self.registry.names()
            probe_names = kernels_doc
        if len(batchers) > self.HEALTH_LIST_MAX:
            ranked = sorted(batchers.items(),
                            key=lambda kv: kv[1].depth(), reverse=True)
            batchers_doc: object = {
                "count": len(batchers),
                "depth_total": sum(b.depth()
                                   for _n, b in ranked),
                "shed_total": sum(sum(b.shed_counts().values())
                                  for _n, b in ranked),
                "expired_total": sum(b.expired_total()
                                     for _n, b in ranked),
                "worst": {
                    name: {"depth": b.depth(),
                           "oldest_wait_s": b.oldest_age(),
                           "shed": b.shed_counts(),
                           "expired": b.expired_total()}
                    for name, b in ranked[:8]
                },
            }
        else:
            batchers_doc = {
                name: {"depth": b.depth(),
                       "oldest_wait_s": b.oldest_age(),
                       "shed": b.shed_counts(),
                       "expired": b.expired_total()}
                for name, b in batchers.items()
            }
        doc = {
            "status": "ok",
            "live": True,
            "ready": self._ready,
            "ready_reason": self._ready_reason,
            "kernels": kernels_doc,
            "kernel_count": n_kernels,
            "buckets": list(self.engine.buckets),
            "compiled": self.engine.compiled_count(),
            "compile_cache": cache,
            "batchers": batchers_doc,
        }
        doc["numerics"] = obs.probes.health_doc(probe_names)
        # per-kernel serve precision policy + measured quant_err bound
        # (engine.precision_doc; docs/performance.md)
        doc["precision"] = self.engine.precision_doc(
            probe_names if big else None)
        doc["obs"] = obs.export.health()
        doc["slo"] = obs.slo.health_doc()
        doc["alerts"] = obs.alerts.health_doc()
        doc["sampler"] = obs.forensics.health_doc()
        doc["capsules"] = obs.triggers.health_doc()
        doc["drift"] = obs.drift.health_doc()
        # the rolling per-phase blame split + the remediation plane's
        # census (obs/blame.py, hpnn_tpu_torch/tune/; docs/selftuning.md)
        doc["blame"] = obs.blame.health_doc()
        doc["tune"] = tune.health_doc()
        if self.online_health is not None:
            doc["online"] = self.online_health()
        return doc

    # ------------------------------------------------------------ infer
    def batcher_for(self, name: str) -> Batcher:
        self.registry.get(name)  # KeyError for unknown kernels
        bname = self.FLEET_BATCHER if self.fleet else name
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            b = self._batchers.get(bname)
            if b is None:
                if self.fleet:
                    # ONE queue for every kernel: payloads carry their
                    # kernel name and the hook groups by topology
                    b = Batcher(
                        self.engine.dispatch_fleet,
                        max_batch=self.engine.max_batch,
                        max_wait_ms=self.max_wait_ms,
                        max_depth=self.max_depth,
                        shed_age_ms=self.shed_age_ms,
                        shed_p99_ms=self.shed_p99_ms,
                        clock=self._clock, name=bname,
                        start=self._start)
                else:
                    b = Batcher(
                        lambda payloads, _n=name: self.engine.dispatch(
                            _n, payloads),
                        max_batch=self.engine.max_batch,
                        max_wait_ms=self.max_wait_ms,
                        max_depth=self.max_depth,
                        shed_age_ms=self.shed_age_ms,
                        shed_p99_ms=self.shed_p99_ms,
                        clock=self._clock, name=name,
                        start=self._start)
                self._batchers[bname] = b
        return b

    def infer(self, name: str, x, *, timeout_s: float = 5.0,
              req_id: str | None = None, trace=None):
        """Forward ``x`` through kernel ``name`` via the micro-batcher.

        ``x`` may be one input vector ``(n_in,)`` → returns
        ``(n_out,)``, or a row block ``(R, n_in)`` → returns
        ``(R, n_out)``.  Raises :class:`KeyError` (unknown kernel),
        :class:`QueueFull` / :class:`DeadlineExceeded` (retriable).
        ``req_id`` (HTTP-edge minted) is threaded onto the request's
        spans and the outcome lands in the SLO tracker
        (``HPNN_SLO_MS``; obs/slo.py).  ``trace`` (an
        ``obs.propagate.Ctx`` from the wire, or from an upstream
        Router hop) parents this request's span tree to the remote
        caller's (docs/observability.md "Fleet telemetry").
        """
        arr = np.asarray(x)
        single = arr.ndim == 1
        rows = np.atleast_2d(arr)
        batcher = self.batcher_for(name)
        payload = (name, rows) if self.fleet else rows
        # root of the request lifecycle: serve.queue / serve.dispatch
        # children hang off it across the batcher threads (HPNN_SPANS)
        sfields = {"kernel": name, "rows": rows.shape[0]}
        if req_id is not None:
            sfields["req_id"] = req_id
        sfields.update(obs.propagate.fields(trace))
        # a real span under HPNN_SPANS, a sampled/promotable one under
        # HPNN_SAMPLE, the shared null span otherwise (obs/forensics.py)
        span = obs.forensics.request_span("serve.request", **sfields)
        slo_on = obs.slo.enabled()
        t0 = self._clock() if slo_on else 0.0
        try:
            with obs.timer("serve.request", kernel=name,
                           rows=rows.shape[0]):
                out = batcher.infer(payload, rows=rows.shape[0],
                                    timeout_s=timeout_s, span=span,
                                    req_id=req_id)
        except QueueFull as exc:  # Shed is a QueueFull subclass
            obs.forensics.finish(span, failed=type(exc).__name__)
            if slo_on:
                obs.slo.record("shed")
            raise
        except DeadlineExceeded as exc:
            obs.forensics.finish(span, failed=type(exc).__name__)
            if slo_on:
                obs.slo.record("expired")
            raise
        except BaseException as exc:
            obs.forensics.finish(span, failed=type(exc).__name__)
            if slo_on:
                obs.slo.record("error")
            raise
        obs.forensics.finish(span)
        if slo_on:
            obs.slo.record("ok", latency_s=self._clock() - t0)
        return out[0] if single else out

    # ------------------------------------------------------------ close
    def close(self):
        if self.tuner is not None:
            self.tuner.stop()
            self.tuner = None
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.close()


# edge-minted request-id suffix: unique within the process, cheap
_REQ_IDS = itertools.count(1)


class _RateCap:
    """Edge admission token bucket (``HPNN_SERVE_RATE_CAP``, rps).

    Models one worker's bounded serving capacity at the admission
    layer: above the cap, ``/v1/infer`` answers 429 with a fractional
    ``Retry-After`` (the time until a token regenerates) and
    ``reason="rate_cap"`` — the same shed surface the batcher uses, so
    fleet routers cool off and autoscalers scale on it without new
    plumbing (docs/serving.md "Cross-host fleet")."""

    def __init__(self, rate_rps: float, *, burst_s: float = 0.25,
                 clock=time.monotonic):
        self.rate = float(rate_rps)
        self.burst = max(1.0, self.rate * float(burst_s))
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def try_admit(self) -> float | None:
        """None = admitted (one token consumed); else seconds until
        the next token regenerates (the Retry-After to answer)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return None
            return (1.0 - self._tokens) / self.rate


def _rate_cap_from_env() -> _RateCap | None:
    raw = os.environ.get("HPNN_SERVE_RATE_CAP", "").strip()
    if not raw:
        return None
    rate = float(raw)  # junk raises: a silently dropped cap is a lie
    return _RateCap(rate) if rate > 0 else None


def _retry_after(exc: QueueFull) -> str:
    """The Retry-After header value for a retriable rejection."""
    if isinstance(exc, Shed):
        return str(max(1, int(math.ceil(exc.retry_after_s))))
    return "1"


class _Handler(conn.ConnHandlerMixin, BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "hpnn-serve/0.1"
    # one TCP segment per response: with the default unbuffered wfile,
    # status/headers and body go out as separate segments and Nagle +
    # delayed ACK stall the body ~40 ms on loopback — which dominated
    # every request until the load harness exposed it.  Buffered
    # writes (handle_one_request flushes per response, so keep-alive
    # stays correct) + TCP_NODELAY remove the stall.
    wbufsize = -1
    disable_nagle_algorithm = True

    # stdout is the token protocol's — request logs go to stderr
    def log_message(self, fmt, *args):
        sys.stderr.write("serve: %s - %s\n"
                         % (self.address_string(), fmt % args))

    @property
    def session(self) -> Session:
        return self.server.session  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict,
               headers: dict | None = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _not_ready(self) -> bool:
        """503 + Retry-After when the session is not (yet, or no
        longer) accepting work — boot warmup, WAL replay, drain."""
        if self.session.is_ready():
            return False
        doc = self.session.ready_doc()
        doc.update(error="not ready", retriable=True)
        self._reply(503, doc, headers={"Retry-After": "1"})
        return True

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, self.session.health())
        elif self.path == "/readyz":
            if not self._not_ready():
                self._reply(200, self.session.ready_doc())
        elif self.path == "/tenantz":
            # per-tenant quota/SLO census + pager + shard balance;
            # 404 on a host without tenancy (plain Session)
            tenant_doc = getattr(self.session, "tenant_doc", None)
            if tenant_doc is None:
                self._reply(404, {"error": "tenancy not enabled"})
            else:
                self._reply(200, tenant_doc())
        elif self.path == "/meterz":
            # per-tenant resource census (obs/meter.py): governed
            # top-K + _other per axis; 404 when HPNN_METER is unarmed
            doc = obs.meter.meterz_doc()
            if doc is None:
                self._reply(404, {"error": "meter not armed"})
            else:
                self._reply(200, doc)
        elif self.path == "/tunez":
            # the self-tuning plane's census (hpnn_tpu_torch/tune/):
            # policy, stats, armed watch, recent decision ledger; 404
            # when HPNN_TUNE is unarmed or no tuner is active
            doc = tune.tunez_doc()
            if doc is None:
                self._reply(404, {"error": "tune not armed"})
            else:
                self._reply(200, doc)
        elif self.path == "/connz":
            # connection-plane census (serve/conn.py): live table,
            # close-reason + guard-kill totals; {"mode": "off"} when
            # no HPNN_CONN_* knob is armed
            self._reply(200, conn.connz_doc(self.server))
        elif self.path == "/metrics":
            body, ctype = obs.export.metrics_response(
                self.headers.get("Accept"))
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def _read_json(self) -> dict | None:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            # conn.read_body applies the HPNN_CONN_BODY_MS deadline and
            # accounts torn uploads — the untimed blocking read was the
            # connection plane's original blind spot
            obj = json.loads(conn.read_body(self, n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None
        return obj if isinstance(obj, dict) else None

    def do_POST(self):
        req = self._read_json()
        if req is None:
            self._reply(400, {"error": "malformed JSON body"})
            return
        if self.path == "/v1/infer":
            self._infer(req)
        elif self.path == "/v1/reload":
            self._reload(req)
        elif self.path in ("/ingest", "/v1/ingest"):
            self._ingest(req)
        elif self.path == "/v1/capture":
            # manual forensic capsule (obs/triggers.py): 404 when
            # HPNN_CAPSULE_DIR is unarmed, 429 when suppressed
            code, payload = obs.triggers.http_capture(req)
            self._reply(code, payload)
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def _infer(self, req: dict):
        if self._not_ready():
            return
        cap = getattr(self.server, "rate_cap", None)
        if cap is not None:
            wait_s = cap.try_admit()
            if wait_s is not None:
                if obs.slo.enabled():
                    obs.slo.record("shed")
                self._reply(429, {"error": "rate cap exceeded",
                                  "retriable": True,
                                  "reason": "rate_cap"},
                            headers={"Retry-After": f"{wait_s:.3f}"})
                return
        name = req.get("kernel", "default")
        try:
            inputs = np.asarray(req.get("inputs"), dtype=np.float64)
        except (TypeError, ValueError):
            self._reply(400, {"error": "inputs must be numeric"})
            return
        if inputs.ndim not in (1, 2):
            self._reply(400, {"error": "inputs must be a vector or a "
                                       "list of vectors"})
            return
        timeout_s = float(req.get("timeout_s", 5.0))
        # the request id is minted here at the edge (client-sent ids
        # are honored) and rides every span + the response, so loadgen
        # runs cross-correlate with obs_report --spans --req <id>
        req_id = req.get("req_id")
        if not isinstance(req_id, str) or not req_id:
            req_id = f"{os.getpid():x}-{next(_REQ_IDS):x}"
        rid_hdr = {"X-Request-Id": req_id}
        # adopt the caller's X-Trace-Id/X-Parent-Span (or mint a trace
        # at the edge) so the span tree parents across the process
        # boundary; the trace id is echoed like the request id
        tctx = obs.propagate.extract(self.headers)
        if tctx is None and obs.propagate.enabled():
            tctx = obs.propagate.Ctx(obs.propagate.new_trace())
        if tctx is not None and tctx.trace:
            rid_hdr["X-Trace-Id"] = tctx.trace
        # multi-tenant hosts (tenant.TenantSession) route by the
        # X-Tenant header; a bare Session ignores tenancy entirely
        tenant = self.headers.get("X-Tenant")
        infer_for = getattr(self.session, "infer_for", None)
        try:
            if infer_for is not None:
                out = infer_for(tenant, name, inputs,
                                timeout_s=timeout_s, req_id=req_id,
                                trace=tctx)
            else:
                out = self.session.infer(name, inputs,
                                         timeout_s=timeout_s,
                                         req_id=req_id, trace=tctx)
        except KeyError:
            self._reply(404, {"error": f"unknown kernel {name!r}",
                              "req_id": req_id}, headers=rid_hdr)
        except QueueFull as exc:  # Shed included: both map to 429
            body = {"error": str(exc), "retriable": True,
                    "req_id": req_id}
            if isinstance(exc, Shed):
                body["reason"] = exc.reason
                # quota sheds name the offending tenant so callers
                # (and the quota drill) can attribute the rejection
                shed_tenant = getattr(exc, "tenant", None)
                if shed_tenant is not None:
                    body["tenant"] = shed_tenant
            self._reply(429, body,
                        headers={"Retry-After": _retry_after(exc),
                                 **rid_hdr})
        except DeadlineExceeded as exc:
            # retriable like 429, so it carries the same header
            self._reply(504, {"error": str(exc), "retriable": True,
                              "req_id": req_id},
                        headers={"Retry-After": "1", **rid_hdr})
        except ValueError as exc:
            self._reply(400, {"error": str(exc), "req_id": req_id},
                        headers=rid_hdr)
        else:
            self._reply(200, {"kernel": name, "req_id": req_id,
                              "outputs": np.asarray(out).tolist()},
                        headers=rid_hdr)

    def _ingest(self, req: dict):
        """``POST /ingest`` ``{"kernel": n?, "inputs": [[...]],
        "targets": [[...]], "req_id": id?}`` → ``{"accepted": N,
        "depth": D, "req_id": id}``.  Feeds the online-learning sample
        buffer; 404 when no online session is attached (plain serving
        process) or the kernel is unknown, 400 on
        malformed/width-mismatched samples.

        Like ``/v1/infer``, every response carries an
        ``X-Request-Id`` echo (client-sent ``req_id`` honored, else
        edge-minted) and, with spans armed, the ingest runs under a
        ``serve.ingest`` span parented to the caller's trace context —
        mixed ``loadgen --mix`` traffic is fully traceable.  The
        context is additionally noted for the online trainer
        (``obs.propagate.note``), parenting the training round the
        ingested rows later drive back to this request."""
        if self._not_ready():
            return
        req_id = req.get("req_id")
        if not isinstance(req_id, str) or not req_id:
            req_id = f"{os.getpid():x}-{next(_REQ_IDS):x}"
        rid_hdr = {"X-Request-Id": req_id}
        tctx = obs.propagate.extract(self.headers)
        if tctx is None and obs.propagate.enabled():
            tctx = obs.propagate.Ctx(obs.propagate.new_trace())
        if tctx is not None and tctx.trace:
            rid_hdr["X-Trace-Id"] = tctx.trace
        hook = self.session.ingest_hook
        if hook is None:
            self._reply(404, {"error": "online ingest not enabled",
                              "req_id": req_id}, headers=rid_hdr)
            return
        try:
            inputs = np.asarray(req.get("inputs"), dtype=np.float64)
            targets = np.asarray(req.get("targets"), dtype=np.float64)
        except (TypeError, ValueError):
            self._reply(400, {"error": "inputs/targets must be "
                                       "numeric", "req_id": req_id},
                        headers=rid_hdr)
            return
        if inputs.ndim not in (1, 2) or targets.ndim not in (1, 2):
            self._reply(400, {"error": "inputs/targets must be "
                                       "vectors or lists of vectors",
                              "req_id": req_id}, headers=rid_hdr)
            return
        kernel = req.get("kernel")
        if kernel is not None and not isinstance(kernel, str):
            self._reply(400, {"error": "kernel must be a string",
                              "req_id": req_id}, headers=rid_hdr)
            return
        sfields = {"req_id": req_id,
                   "rows": int(np.atleast_2d(inputs).shape[0])}
        if kernel is not None:
            sfields["kernel"] = kernel
        sfields.update(obs.propagate.fields(tctx))
        span = obs.spans.start("serve.ingest", **sfields)
        # the ingest → trainer → promote causal chain: the trainer
        # picks this up when the buffered rows drive a round
        obs.propagate.note("ingest", obs.propagate.ctx_from(
            span, trace=tctx.trace if tctx is not None else None))
        try:
            out = hook(kernel, inputs, targets)
        except KeyError:
            obs.spans.finish(span, failed="KeyError")
            self._reply(404, {"error": f"unknown kernel {kernel!r}",
                              "req_id": req_id}, headers=rid_hdr)
        except ValueError as exc:
            obs.spans.finish(span, failed="ValueError")
            self._reply(400, {"error": str(exc), "req_id": req_id},
                        headers=rid_hdr)
        else:
            obs.spans.finish(span)
            out = dict(out)
            out.setdefault("req_id", req_id)
            self._reply(200, out, headers=rid_hdr)

    def _reload(self, req: dict):
        name = req.get("kernel", "default")
        reload = getattr(self.session, "reload_hook", None) or self.session.reload
        try:
            entry = reload(name)
        except KeyError:
            self._reply(404, {"error": f"unknown kernel {name!r}"})
        except RegistryError as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:
            # a reload that blew up mid-flight (chaos raise@
            # registry.reload included) keeps the resident version —
            # report it as a server-side failure, not a hung socket
            self._reply(500, {"error": f"reload failed: {exc!r}",
                              "retriable": True})
        else:
            self._reply(200, {"kernel": name,
                              "version": entry.version})


def make_server(session: Session, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind the HTTP front end over ``session`` (port 0 = ephemeral;
    read ``server.server_address`` for the bound port).  Call
    ``serve_forever()`` — typically on a thread — and ``shutdown()``
    to stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.session = session  # type: ignore[attr-defined]
    server.rate_cap = _rate_cap_from_env()  # type: ignore[attr-defined]
    # connection-plane telemetry + guards (serve/conn.py): a no-op
    # unless an HPNN_CONN_* knob is armed; wiring it here is what lets
    # Router replicas and ClusterRouter workers inherit it for free
    conn.wrap_server(server, plane="serve")
    obs.event("serve.listen", host=host,
              port=server.server_address[1])
    return server


def install_drain(server: ThreadingHTTPServer, session: Session):
    """Install the SIGTERM graceful-drain handler (main thread only;
    a no-op elsewhere).  On SIGTERM, exactly once:

    1. readiness flips to ``draining`` — new arrivals get 503 +
       ``Retry-After`` while in-flight requests keep their sockets;
    2. the session closes: every queued request is drained through
       dispatch (or completed with an error), batcher threads join;
    3. the obs sink is summarized + flushed and the flight recorder
       dumped **exactly once** even though the obs crash handlers
       chain the same signal — both paths share
       ``obs.registry._crash_flush``'s signal-path guard, so whichever
       handler runs first does the postmortem and the other skips it
       (the satellite-3 fix; docs/resilience.md);
    4. ``server.shutdown()`` runs on a helper thread (calling it from
       the handler would deadlock a main-thread ``serve_forever``), so
       the driver's ``serve_forever`` returns and it exits 0.

    Returns the handler (tests invoke it directly)."""
    from hpnn_tpu_torch.obs import registry as obs_registry

    done = threading.Event()

    def _drain(signum=signal.SIGTERM, frame=None):
        if done.is_set():
            return
        done.set()
        session.mark_unready("draining")
        obs.event("serve.drain", signal=int(signum))
        # idle keep-alive connections are closed now with a counted
        # reason=drain; in-flight requests keep their sockets
        conn.drain_server(server)
        try:
            session.close()
        except Exception as exc:  # drain must finish no matter what
            sys.stderr.write(f"serve: drain close failed: {exc!r}\n")
        obs_registry._crash_flush("obs.signal", "SIGTERM", "drain")
        threading.Thread(target=server.shutdown, daemon=True,
                         name="hpnn-drain-shutdown").start()

    if threading.current_thread() is threading.main_thread():
        try:
            signal.signal(signal.SIGTERM, _drain)
        except (ValueError, OSError):
            pass
    return _drain
