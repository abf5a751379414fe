"""Central telemetry collector: worker push client + fleet endpoint.

A copy of ``hpnn_tpu/obs/collector.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Per-worker observability stops at the process boundary: every worker
has its own JSONL sink and its own ``/metrics``, and nothing holds the
fleet-level view ROADMAP item 1 (autoscaler) needs.  This module is
both halves of the missing hop:

* **push client** (``HPNN_COLLECTOR=<url>``): when armed, every
  registry record is ALSO offered to a bounded in-memory queue that a
  daemon flusher thread batches into ``POST <url>/v1/telemetry``.
  The emitting thread only ever appends to a deque under a lock —
  telemetry must never backpressure serving, so a full queue or a dead
  collector **drops** lines and counts them (``collector.drop``)
  instead of blocking or retrying inline.  The flusher accounts its
  own traffic with ``collector.push`` counts.

* **collector server** (:func:`start_collector`,
  ``cli/obs_collector.py``): accepts telemetry batches on
  ``POST /v1/telemetry`` into a bounded queue (overload sheds with a
  503 + drop count — same never-backpressure rule, one hop up), writes
  the merged stream to one JSONL file (each record tagged with the
  sender's ``pid``/``rank``), and folds workers' ``obs.summary``
  snapshots into **fleet aggregates**: summed counters, summed gauges,
  and merged log2 buckets, so fleet p99 comes out of
  ``export._quantile_estimate`` over the union — served on its own
  ``GET /metrics`` (Prometheus) and ``GET /fleetz`` (JSON: per-worker
  health/staleness + fleet totals).  Workers' ``meter.sketch``
  records (obs/meter.py, per-tenant resource sketches) merge the
  same way — latest per worker, space-saving merge per axis — into
  fleet ``hpnn_meter_*`` families on ``/metrics`` and a
  ``GET /meterz`` tenant census, so the fleet-wide top-K hog is
  computable centrally.  It can additionally **scrape**
  worker ``/metrics`` endpoints (``--scrape URL``) for liveness when
  workers cannot push.  With ``HPNN_CAPSULE_DIR`` armed it also
  answers ``POST /v1/capture`` — a manual forensic capsule of the
  collector process (obs/triggers.py) — and ``/healthz`` carries the
  capsule census.  The socket layer under the endpoint is the same
  connection plane the serve front end rides (hpnn_tpu_torch/serve/conn.py,
  lazily imported so ``import hpnn_tpu_torch.obs`` stays light): with
  ``HPNN_CONN_*`` knobs armed the collector gets per-connection
  open/close accounting, read deadlines, the per-IP cap and
  slow-client guard, and a ``GET /connz`` census of its own.

Batch wire format (``POST /v1/telemetry``, JSON)::

    {"pid": 4711, "rank": 0, "lines": ["{...}", "{...}", ...]}

where each line is one registry JSONL record, verbatim.

Contract (same as every obs knob): ``HPNN_COLLECTOR`` unset ⇒ one env
read ever, then the push hook is never installed — no thread, no
allocation, no stdout bytes (tools/check_tokens.py proves the byte
freeze with a live collector armed).  stdlib-only.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import Request, urlopen

from hpnn_tpu_torch.obs import export, meter, registry

ENV_URL = "HPNN_COLLECTOR"
ENV_QUEUE = "HPNN_COLLECTOR_QUEUE"
ENV_FLUSH_S = "HPNN_COLLECTOR_FLUSH_S"
DEFAULT_QUEUE = 2048
DEFAULT_FLUSH_S = 0.25
MAX_BATCH = 512

# ------------------------------------------------------------ client

# None = env not read yet; False = disarmed; _Client = armed
_client: "_Client | bool | None" = None
_client_lock = threading.Lock()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name) or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


class _Client:
    """Bounded-queue push client.  ``offer`` is the registry's emit
    hook: O(1) append-or-drop under a lock, never any I/O.  All
    network traffic happens on the daemon flusher thread."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.cap = max(8, _env_int(ENV_QUEUE, DEFAULT_QUEUE))
        self.flush_s = max(0.01, _env_float(ENV_FLUSH_S, DEFAULT_FLUSH_S))
        self._dq: list[str] = []
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self.dropped_full = 0
        self.dropped_push = 0
        self.pushed = 0
        self.batches = 0
        self._thread = threading.Thread(
            target=self._run, name="hpnn-obs-collector-push", daemon=True)
        self._thread.start()

    def offer(self, line: str) -> None:
        """Enqueue one serialized record; drop-with-count when full.
        Called inline by ``registry._emit`` — must stay O(1) and must
        never block on I/O."""
        with self._lock:
            if len(self._dq) >= self.cap:
                self.dropped_full += 1
                return
            self._dq.append(line)

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            self._flush_once()
        self._flush_once()  # final drain on shutdown

    def _flush_once(self) -> None:
        with self._flush_lock:
            with self._lock:
                batch = self._dq[:MAX_BATCH]
                del self._dq[:MAX_BATCH]
                n_full = self.dropped_full
                self.dropped_full = 0
            if n_full:
                # account queue-full drops from the flusher thread so
                # the emitting (serving) thread never re-enters obs
                registry.count("collector.drop", n=n_full,
                               reason="queue_full")
            if not batch:
                return
            body = json.dumps({
                "pid": os.getpid(),
                "rank": registry._process_index(),
                "lines": batch,
            }).encode("utf-8")
            req = Request(self.url + "/v1/telemetry", data=body,
                          headers={"Content-Type": "application/json"})
            try:
                with urlopen(req, timeout=2.0) as resp:
                    resp.read()
                self.pushed += len(batch)
                self.batches += 1
                registry.count("collector.push", n=len(batch))
            except Exception:
                # dead/overloaded collector: the batch is shed, not
                # retried — retrying would grow an unbounded backlog
                self.dropped_push += len(batch)
                registry.count("collector.drop", n=len(batch),
                               reason="push_error")

    def flush_now(self) -> None:
        """Synchronously drain what is queued (tests + shutdown)."""
        self._flush_once()

    def stats(self) -> dict:
        with self._lock:
            return {
                "queued": len(self._dq),
                "capacity": self.cap,
                "pushed": self.pushed,
                "batches": self.batches,
                "dropped_full": self.dropped_full + 0,
                "dropped_push": self.dropped_push,
            }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3.0)


def _config() -> "_Client | None":
    """The memoized push client, or None when ``HPNN_COLLECTOR`` is
    unset."""
    global _client
    c = _client
    if c is None:
        with _client_lock:
            if _client is None:
                url = os.environ.get(ENV_URL, "")
                _client = _Client(url) if url else False
            c = _client
    return c or None


def enabled() -> bool:
    """True when ``HPNN_COLLECTOR`` is set (memoized)."""
    return _config() is not None


def _install_push() -> None:
    """Arm the registry's emit hook (called from ``registry._init``
    when the knob is set).  Safe to call repeatedly."""
    c = _config()
    if c is not None:
        registry._push_hook = c.offer


def client_stats() -> dict | None:
    c = _config()
    return c.stats() if c is not None else None


def flush() -> None:
    """Push everything queued so far (blocking; tests + clean exits)."""
    c = _config()
    if c is not None:
        c.flush_now()


def _reset_for_tests() -> None:
    global _client
    with _client_lock:
        c = _client
        _client = None
    registry._push_hook = None
    if isinstance(c, _Client):
        try:
            c.close()
        except (OSError, RuntimeError):
            pass  # socket already dead / thread already joined


# ------------------------------------------------------------ server
class Collector:
    """Fleet telemetry aggregation state behind the HTTP endpoint."""

    def __init__(self, path: str | None = None, queue_max: int = 1024):
        self.path = path
        self._fp = open(path, "a") if path else None
        self._q: queue.Queue = queue.Queue(maxsize=max(8, queue_max))
        self._lock = threading.Lock()
        self.t0 = time.time()
        self.workers: dict[str, dict] = {}
        self.records_total = 0
        self.recv_dropped = 0
        self.batches = 0
        self.scrapes: dict[str, dict] = {}
        self._stop = threading.Event()
        self._consumer = threading.Thread(
            target=self._consume, name="hpnn-obs-collector", daemon=True)
        self._consumer.start()

    # -- ingest -------------------------------------------------------
    def submit(self, pid: int, rank: int, lines: list[str]) -> bool:
        """Queue one batch; False (shed) when the queue is full."""
        try:
            self._q.put_nowait((pid, rank, lines))
            return True
        except queue.Full:
            with self._lock:
                self.recv_dropped += len(lines)
            registry.count("collector.drop", n=len(lines),
                           reason="recv_queue_full", pid=pid)
            return False

    def _consume(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            pid, rank, lines = item
            self._absorb(pid, rank, lines)

    def _absorb(self, pid: int, rank: int, lines: list[str]) -> None:
        key = f"{pid}:{rank}"
        now = time.time()
        parsed = []
        for line in lines:
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, TypeError):
                continue
            if isinstance(rec, dict):
                parsed.append(rec)
        with self._lock:
            w = self.workers.get(key)
            if w is None:
                w = self.workers[key] = {
                    "pid": pid, "rank": rank, "records": 0,
                    "last_push": now, "summary": None, "meter": None,
                }
            w["records"] += len(parsed)
            w["last_push"] = now
            self.records_total += len(parsed)
            self.batches += 1
            for rec in parsed:
                if rec.get("ev") == "obs.summary":
                    w["summary"] = rec  # latest wins
                elif rec.get("ev") == "meter.sketch":
                    w["meter"] = rec  # latest wins (cumulative)
        if self._fp is not None:
            with self._lock:
                for rec in parsed:
                    rec.setdefault("pid", pid)
                    rec.setdefault("rank", rank)
                    self._fp.write(json.dumps(rec) + "\n")
                self._fp.flush()
        registry.count("collector.recv", n=len(parsed), pid=pid,
                       rank=rank)

    # -- aggregation --------------------------------------------------
    def _merged_snapshot(self) -> dict:
        """Fleet-level registry-shaped snapshot: counters and gauges
        summed across workers' latest summaries, log2 buckets merged
        per aggregate name (so fleet quantiles interpolate over the
        union)."""
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        aggs: dict[str, dict] = {}
        with self._lock:
            summaries = [w["summary"] for w in self.workers.values()
                         if w.get("summary")]
        for s in summaries:
            for name, v in (s.get("counters") or {}).items():
                counters[name] = counters.get(name, 0) + v
            for name, v in (s.get("gauges") or {}).items():
                gauges[name] = gauges.get(name, 0.0) + float(v)
            for name, a in (s.get("aggregates") or {}).items():
                m = aggs.get(name)
                if m is None:
                    m = aggs[name] = {"n": 0, "total": 0.0,
                                      "min": None, "max": None,
                                      "log2_buckets": {}}
                m["n"] += a.get("n") or 0
                m["total"] += a.get("total") or 0.0
                for bound, cur in (("min", min), ("max", max)):
                    v = a.get(bound)
                    if v is not None:
                        m[bound] = (v if m[bound] is None
                                    else cur(m[bound], v))
                for k, c in (a.get("log2_buckets") or {}).items():
                    bk = m["log2_buckets"]
                    bk[k] = bk.get(k, 0) + c
        return {
            "uptime_s": round(time.time() - self.t0, 3),
            "path": self.path,
            "counters": counters,
            "gauges": gauges,
            "aggregates": aggs,
        }

    def fleetz(self) -> dict:
        """The ``/fleetz`` JSON document: per-worker health/staleness
        plus fleet totals and the merged p99 of every aggregate the
        workers reported."""
        now = time.time()
        snap = self._merged_snapshot()
        with self._lock:
            workers = {
                key: {
                    "pid": w["pid"], "rank": w["rank"],
                    "records": w["records"],
                    "staleness_s": round(now - w["last_push"], 3),
                    "has_summary": w.get("summary") is not None,
                }
                for key, w in sorted(self.workers.items())
            }
            totals = {
                "workers": len(self.workers),
                "records": self.records_total,
                "batches": self.batches,
                "recv_dropped": self.recv_dropped,
            }
            scrapes = {u: dict(s) for u, s in self.scrapes.items()}
        p99 = {name: round(export._quantile_estimate(agg, 0.99), 6)
               for name, agg in sorted(snap["aggregates"].items())}
        doc = {
            "status": "ok",
            "uptime_s": snap["uptime_s"],
            "workers": workers,
            "totals": totals,
            "fleet": {
                "counters": snap["counters"],
                "gauges": snap["gauges"],
                "p99": p99,
            },
        }
        if scrapes:
            doc["scrape"] = scrapes
        return doc

    def meterz(self) -> dict | None:
        """The fleet ``/meterz`` census: workers' latest
        ``meter.sketch`` records merged per axis (totals add, entries
        sum, top-K + ``_other`` re-governed over the union) — the
        fleet-wide tenant blame view.  None when no worker has pushed
        a sketch (meter unarmed fleet-wide)."""
        with self._lock:
            docs = [w["meter"] for w in self.workers.values()
                    if w.get("meter")]
        if not docs:
            return None
        doc = meter.merge_sketch_docs(docs)
        doc["status"] = "ok"
        doc["workers"] = len(docs)
        return doc

    def metrics_body(self) -> bytes:
        """Fleet ``/metrics``: the merged snapshot rendered with the
        standard exposition renderer, plus the fleet-merged meter
        families and collector-level totals."""
        body = export.render_prometheus(self._merged_snapshot(),
                                        local_meter=False)
        mdoc = self.meterz()
        meter_lines = ([] if mdoc is None else export.render_meter_lines(
            {ax: d["top"] for ax, d in mdoc["axes"].items()}))
        with self._lock:
            n_workers = len(self.workers)
            stale = max(
                (time.time() - w["last_push"]
                 for w in self.workers.values()), default=0.0)
            extra = [
                "# TYPE hpnn_fleet_workers gauge",
                f"hpnn_fleet_workers {n_workers}",
                "# TYPE hpnn_fleet_records_total counter",
                f"hpnn_fleet_records_total {self.records_total}",
                "# TYPE hpnn_fleet_recv_dropped_total counter",
                f"hpnn_fleet_recv_dropped_total {self.recv_dropped}",
                "# TYPE hpnn_fleet_max_staleness_seconds gauge",
                f"hpnn_fleet_max_staleness_seconds {stale:.3f}",
            ]
        extra = meter_lines + extra
        return body.encode("utf-8") + ("\n".join(extra) + "\n").encode()

    def healthz(self) -> dict:
        with self._lock:
            doc = {
                "status": "ok",
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self.t0, 3),
                "workers": len(self.workers),
                "records": self.records_total,
                "recv_dropped": self.recv_dropped,
            }
        from hpnn_tpu_torch.obs import alerts, triggers

        doc["alerts"] = alerts.health_doc()
        doc["capsules"] = triggers.health_doc()
        return doc

    # -- scrape (pull) fallback ---------------------------------------
    def start_scraper(self, urls: list[str],
                      interval_s: float = 5.0) -> None:
        """Poll worker ``/metrics`` endpoints for liveness — the pull
        half for workers that cannot push."""

        def _loop():
            while not self._stop.wait(interval_s):
                for url in urls:
                    try:
                        with urlopen(url, timeout=2.0) as resp:
                            size = len(resp.read())
                        ok, err = True, None
                    except Exception as exc:
                        ok, size, err = False, 0, str(exc)[:120]
                    with self._lock:
                        self.scrapes[url] = {
                            "up": ok, "bytes": size,
                            "last_scrape": round(time.time(), 3),
                            **({"error": err} if err else {}),
                        }

        threading.Thread(target=_loop, name="hpnn-obs-collector-scrape",
                         daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        self._consumer.join(timeout=3.0)
        if self._fp is not None:
            try:
                self._fp.close()
            except (OSError, ValueError):
                pass  # already closed


class _CollectorHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    collector: Collector = None  # set by start_collector

    def log_message(self, fmt, *args):  # stdout stays byte-frozen
        sys.stderr.write("obs.collector: %s - %s\n"
                         % (self.address_string(), fmt % args))

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: dict) -> None:
        self._send(code, json.dumps(doc).encode("utf-8"),
                   "application/json")

    def _read_body(self, n: int) -> bytes:
        # the connection plane's deadline + torn-upload accounting
        # (serve/conn.py, lazy so `import hpnn_tpu_torch.obs` stays light);
        # a plain read when the plane is unarmed
        from hpnn_tpu_torch.serve import conn as conn_mod

        return conn_mod.read_body(self, n)

    def do_POST(self):
        if self.path == "/v1/capture":
            # manual forensic capsule of the collector process itself
            # (obs/triggers.py; HPNN_CAPSULE_DIR) — fleet aggregates
            # and the recv census land in gauges.json/health.json
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self._read_body(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                body = None
            from hpnn_tpu_torch.obs import triggers

            code, payload = triggers.http_capture(
                body if isinstance(body, dict) else None)
            self._send_json(code, payload)
            return
        if self.path != "/v1/telemetry":
            self._send_json(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self._read_body(n).decode("utf-8"))
            pid = int(doc["pid"])
            rank = int(doc.get("rank") or 0)
            lines = doc["lines"]
            if not isinstance(lines, list):
                raise ValueError("lines must be a list")
        except Exception as exc:
            self._send_json(400, {"error": f"bad batch: {exc}"})
            return
        if self.collector.submit(pid, rank, lines):
            self._send_json(200, {"ok": True, "queued": len(lines)})
        else:
            self._send_json(503, {"ok": False, "dropped": len(lines)})

    def do_GET(self):
        if self.path == "/metrics":
            self._send(200, self.collector.metrics_body(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/fleetz":
            self._send_json(200, self.collector.fleetz())
        elif self.path == "/meterz":
            doc = self.collector.meterz()
            if doc is None:
                self._send_json(404, {"error": "no meter sketches"})
            else:
                self._send_json(200, doc)
        elif self.path == "/healthz":
            self._send_json(200, self.collector.healthz())
        elif self.path == "/connz":
            # connection-plane census of the collector's own endpoint
            # (serve/conn.py); {"mode": "off"} when unarmed
            from hpnn_tpu_torch.serve import conn as conn_mod

            self._send_json(200, conn_mod.connz_doc(self.server))
        else:
            self._send_json(404, {"error": "not found"})


def start_collector(host: str = "127.0.0.1", port: int = 0,
                    path: str | None = None,
                    queue_max: int = 1024) -> ThreadingHTTPServer:
    """Start the collector endpoint on a daemon thread; returns the
    server (``server.server_address`` carries the bound port,
    ``server.collector`` the aggregation state)."""
    from hpnn_tpu_torch.serve import conn as conn_mod

    coll = Collector(path=path, queue_max=queue_max)
    handler = type("_BoundCollectorHandler",
                   (conn_mod.ConnHandlerMixin, _CollectorHandler),
                   {"collector": coll})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    server.collector = coll
    # connection-plane telemetry + guards on the collector's own
    # socket layer (a no-op unless an HPNN_CONN_* knob is armed)
    conn_mod.wrap_server(server, plane="collector")
    thread = threading.Thread(target=server.serve_forever,
                              name="hpnn-obs-collector-http", daemon=True)
    server._thread = thread
    thread.start()
    bound_host, bound_port = server.server_address[:2]
    registry.event("collector.listen", host=bound_host, port=bound_port)
    return server


def stop_collector(server: ThreadingHTTPServer) -> None:
    server.shutdown()
    server.server_close()
    server.collector.close()
