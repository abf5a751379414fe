"""Open/closed-loop HTTP traffic generator for the port's serving stack.

The twin of the repo's ``tools/loadgen.py`` over ``hpnn_tpu_torch``:
the same arrivals, loops, outcome classes, hostile modes and bench
fold-ins, with the trace hooks on the port's ``obs.propagate`` /
``obs.spans`` and :func:`run_bench_load` / :func:`run_bench_tenant` on
the port's ``serve`` / ``tenant`` (on ``cuda`` unless ``device="cpu"``).
It imports nothing of the JAX package.

Where bench_serve.py measures the in-process Session under a closed
loop (a client's next request starts when its previous one returns —
arrival rate adapts to service rate, so saturation hides), this tool
drives the HTTP front end (serve/server.py) the way production
traffic does:

* **open loop** — requests fire at scheduled arrival times regardless
  of completions: a Poisson process (``--process poisson``) or an
  on/off burst process (``--process burst``, Poisson-within-bursts
  scaled so the long-run average equals ``--rate``).  A bounded
  worker pool issues them (concurrency caps at ``--workers``, making
  this formally a partly-open loop);
* **closed loop** — ``--closed``: N clients in sequential loops for
  the duration (the saturation probe).

Request mix: kernel names (``--kernels a,b``, fleet-mode servers
coalesce same-topology kernels transparently) and row counts
(``--rows 1,2,4``) are drawn per request.  ``--mix FRAC`` makes that
fraction of requests ``POST /ingest`` sample feeds (``--n-out`` sets
the target width), so ONE loadgen run drives the full
train-while-serve loop against an ``online_nn`` server
(docs/online.md).  429 and 503 responses are retried
honoring ``Retry-After`` (capped; ``--retries 0`` records the shed
instead), 504/timeouts are terminal per request; connection-level
failures (refused, reset, incomplete response) are a distinct
``lost`` class — the blast-radius metric the chaos drills in
``hpnn_tpu_torch/tools/chaos_drill.py`` gate on (docs/resilience.md).  The server's
``X-Request-Id`` is recorded per outcome, so any row in the JSONL
(``--out``) cross-correlates with the span sink via
``tools/obs_report.py --spans --req <id>``.  With spans armed
(``HPNN_SPANS``) each request additionally opens a client-side
``loadgen.request`` span and carries its trace context in
``X-Trace-Id`` / ``X-Parent-Span`` headers (obs/propagate.py), so the
server-side spans parent across the process boundary and the report
stitches one client → edge → replica tree per request
(docs/observability.md "Fleet telemetry").

Hostile traffic: ``--hostile slowloris|torn|fuzz`` turns the tool
into an attack-class generator against a conn-guarded server
(``HPNN_CONN_*``, docs/serving.md "Connection plane") — raw sockets,
no HTTP client library, because the whole point is to misbehave below
the request layer.  ``slowloris`` trickles header bytes forever (one
bogus header line per ``--interval``), ``torn`` declares a
Content-Length and hangs up mid-body, ``fuzz`` sprays garbage where a
request line should be.  Each mode reports its own outcome classes
(slowloris: ``killed``/``answered``/``survived``; torn: ``torn``;
fuzz: ``rejected``/``dropped``/``ignored``; all: ``refused``), plus a
``hung`` count of attacker threads that failed to finish — the
torn-network chaos drill (``chaos_drill.py --drill torn``,
docs/resilience.md) asserts ``survived == 0`` and ``hung == 0``
while clean traffic keeps flowing.

Multi-tenant traffic: ``--tenants N`` spreads requests over N
synthetic tenants (``t000``..) drawn from a Zipf distribution
(``--zipf S``, heavier S = hotter head — real tenant populations are
head-heavy, and that skew is exactly what exercises a host's paging
LRU and per-tenant quotas, docs/tenancy.md).  Each request carries
its tenant in the ``X-Tenant`` header and its outcome row; the
summary adds a per-tenant census.

Outcome rows: ``{"t", "kernel", "rows", "status": ok|shed|timeout|
error|lost, "code", "latency_ms", "req_id", "attempts"}`` (plus
``tenant`` under ``--tenants``); the summary
(ONE JSON line on stdout, the bench.py convention) reports
p50/p99/p99.9 of *served* latencies, goodput vs offered load, and
shed/timeout rates.  :func:`run_bench_load` is the self-contained
bench.py fold-in: measure saturation closed-loop, then offer 2x that
open-loop against an SLO-armed, shedding server and report whether
goodput held and the windowed p99 stayed within the objective
(docs/observability.md "SLOs and load").

    python -m hpnn_tpu_torch.tools.loadgen --bench --device cpu
    python -m hpnn_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \
        --rate 200 --duration 10 --process burst --out run.jsonl
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue
import signal
import socket
import sys
import threading
import time
import urllib.parse

import numpy as np


def shield_sigpipe() -> None:
    """Put SIGPIPE back to Python's own default (ignored, so a write
    to a dead peer raises BrokenPipeError instead of killing us).  A
    load generator's target dying mid-write is an OUTCOME to record
    (``lost``), never a reason to die — but the embedded CLIs install
    SIG_DFL for shell-pipeline manners, and a host process that ran
    one of their mains would otherwise carry that disposition into
    the run.  No-op off the main thread."""
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    except (ValueError, AttributeError):  # non-main thread / platform
        pass


# ------------------------------------------------------------ summaries


def percentile_ms(lat_s: list[float], q: float) -> float:
    """Percentile ``q`` (in percent) of latencies given in seconds,
    answered in milliseconds — the shared definition for bench_serve
    and loadgen (linear interpolation, numpy default)."""
    return round(float(np.percentile(np.asarray(lat_s) * 1e3, q)), 3)


def latency_summary(lat_s: list[float]) -> dict:
    """p50/p99/p99.9/mean/max (ms) of latencies in seconds; None-
    filled when there were no served requests."""
    if not lat_s:
        return {"p50": None, "p99": None, "p999": None,
                "mean": None, "max": None}
    return {
        "p50": percentile_ms(lat_s, 50),
        "p99": percentile_ms(lat_s, 99),
        "p999": percentile_ms(lat_s, 99.9),
        "mean": round(float(np.mean(lat_s)) * 1e3, 3),
        "max": round(float(np.max(lat_s)) * 1e3, 3),
    }


def summarize(records: list[dict], duration_s: float, *,
              offered_rps: float | None = None) -> dict:
    """Aggregate one run's outcome rows: counts per status, goodput
    (served requests per second) vs offered load, shed/timeout rates,
    and the latency summary of *served* requests only."""
    n = len(records)
    counts = {s: 0 for s in ("ok", "shed", "timeout", "error", "lost")}
    ops: dict[str, int] = {}
    for r in records:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
        op = r.get("op", "infer")
        ops[op] = ops.get(op, 0) + 1
    ok_lat_s = [r["latency_ms"] / 1e3 for r in records
                if r["status"] == "ok"]
    goodput = counts["ok"] / duration_s if duration_s else 0.0
    if offered_rps is None:
        offered_rps = n / duration_s if duration_s else 0.0
    by_tenant: dict[str, dict] = {}
    tenant_lat_s: dict[str, list[float]] = {}
    for r in records:
        t = r.get("tenant")
        if t is None:
            continue
        d = by_tenant.setdefault(
            t, {"requests": 0, "ok": 0, "shed": 0})
        d["requests"] += 1
        if r["status"] in d:
            d[r["status"]] += 1
        if r["status"] == "ok":
            tenant_lat_s.setdefault(t, []).append(
                r["latency_ms"] / 1e3)
    for t, d in by_tenant.items():
        # per-tenant served-latency tail so drill assertions can
        # check victim-vs-offender p99 without scraping /metrics
        lat = tenant_lat_s.get(t)
        d["p50_ms"] = percentile_ms(lat, 50) if lat else None
        d["p99_ms"] = percentile_ms(lat, 99) if lat else None
    out = {
        "requests": n,
        "duration_s": round(duration_s, 3),
        "offered_rps": round(offered_rps, 1),
        "ok": counts["ok"],
        "shed": counts["shed"],
        "timeout": counts["timeout"],
        "error": counts["error"],
        "lost": counts["lost"],
        "goodput_rps": round(goodput, 1),
        "goodput_vs_offered": (round(goodput / offered_rps, 4)
                               if offered_rps else None),
        "shed_rate": round(counts["shed"] / n, 4) if n else 0.0,
        "timeout_rate": round(counts["timeout"] / n, 4) if n else 0.0,
        "lost_rate": round(counts["lost"] / n, 4) if n else 0.0,
        "ops": ops,
        "latency_ms": latency_summary(ok_lat_s),
    }
    if by_tenant:
        out["by_tenant"] = dict(sorted(by_tenant.items()))
    return out


def write_jsonl(path: str, records: list[dict], summary: dict) -> None:
    """One row per request outcome, then the summary as a final
    ``{"summary": ...}`` row."""
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"summary": summary}) + "\n")


# ------------------------------------------------------------ arrivals


def poisson_arrivals(rate_rps: float, duration_s: float,
                     rng: np.random.RandomState) -> list[float]:
    """Arrival offsets (seconds) of a homogeneous Poisson process."""
    if rate_rps <= 0:
        return []
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t >= duration_s:
            return out
        out.append(t)


def burst_arrivals(rate_rps: float, duration_s: float,
                   rng: np.random.RandomState, *,
                   on_s: float = 0.5, off_s: float = 0.5) -> list[float]:
    """On/off burst process: Poisson arrivals during ``on_s`` phases,
    silence during ``off_s`` phases, with the on-phase rate scaled so
    the long-run average still equals ``rate_rps``."""
    if rate_rps <= 0:
        return []
    burst_rate = rate_rps * (on_s + off_s) / on_s
    out, t = [], 0.0
    while t < duration_s:
        end_on, tt = min(t + on_s, duration_s), t
        while True:
            tt += float(rng.exponential(1.0 / burst_rate))
            if tt >= end_on:
                break
            out.append(tt)
        t += on_s + off_s
    return out


def make_arrivals(process: str, rate_rps: float, duration_s: float,
                  rng: np.random.RandomState) -> list[float]:
    if process == "poisson":
        return poisson_arrivals(rate_rps, duration_s, rng)
    if process == "burst":
        return burst_arrivals(rate_rps, duration_s, rng)
    raise ValueError(f"unknown arrival process {process!r}")


# ------------------------------------------------------------ tenants


def tenant_names(n: int) -> tuple[str, ...]:
    """``t000``.. — the synthetic tenant namespace of ``--tenants``."""
    return tuple(f"t{i:03d}" for i in range(int(n)))


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative Zipf(s) weights over ranks 0..n-1: item ``i`` draws
    with probability proportional to ``1/(i+1)^s``.  A draw is
    ``searchsorted(cdf, uniform())`` — O(log n) per request, so a 10k
    kernel namespace costs the generator nothing."""
    if n < 1:
        raise ValueError("zipf_cdf needs n >= 1")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                       float(s))
    return np.cumsum(w / w.sum())


def zipf_pick(cdf: np.ndarray, rng: np.random.RandomState) -> int:
    return int(np.searchsorted(cdf, rng.uniform(), side="right"))


# ------------------------------------------------------------ client


# Lazy handle on the obs propagation modules: None = not probed yet,
# False = spans disarmed (or package unavailable) — probed once, so
# the common un-instrumented run never pays a per-request check.
_TRACE_MODS = None


def _trace_mods():
    """(propagate, spans) when ``HPNN_SPANS`` is armed, else None."""
    global _TRACE_MODS
    if _TRACE_MODS is None:
        _TRACE_MODS = False
        from hpnn_tpu_torch.obs import propagate, spans
        if spans.enabled():
            _TRACE_MODS = (propagate, spans)
    return _TRACE_MODS or None


class _Client:
    """One keep-alive HTTP connection with reconnect-on-disconnect
    and the per-request retry policy (429 + ``Retry-After``)."""

    def __init__(self, url: str, timeout_s: float):
        u = urllib.parse.urlparse(
            url if "//" in url else "http://" + url)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.timeout_s = float(timeout_s)
        self._conn: http.client.HTTPConnection | None = None

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _post(self, path: str, body: bytes, headers: dict | None = None):
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        # one silent reconnect: a keep-alive peer may have gone away
        for attempt in (0, 1):
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port,
                        timeout=self.timeout_s + 1.0)
                    self._conn.connect()
                    # measurement hygiene: without TCP_NODELAY a
                    # Nagle/delayed-ACK stall adds ~40 ms to loopback
                    # latencies and caps the generator's offered rate
                    self._conn.sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._conn.request(
                    "POST", path, body=body, headers=hdrs)
                resp = self._conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.getheaders()), data
            except socket.timeout:
                self.close()
                raise
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    raise
        raise OSError("unreachable")

    def request(self, kernel: str, rows: int, body: bytes, *,
                max_retries: int = 2, retry_cap_s: float = 1.0,
                path: str = "/v1/infer", op: str = "infer",
                tenant: str | None = None) -> dict:
        """Issue one logical request (with 429/503 retries); returns
        its outcome row (latency spans all attempts, sleeps included).
        ``path``/``op`` route the mixed-traffic mode: infer requests
        hit ``/v1/infer``, ingest feeds hit ``/ingest``.

        Outcome classes: 429 exhausted -> ``shed`` (the server chose
        to refuse), 503 exhausted -> ``shed`` too (not-ready/draining
        is admission control, not failure), 504/timeout ->
        ``timeout``, connection refused/reset/incomplete response ->
        ``lost`` (nothing answered — the blast-radius class the chaos
        drills count), other codes -> ``error``."""
        attempts, code, req_id, status = 0, None, None, "error"
        span, hdrs, trace = None, None, None
        mods = _trace_mods()
        if mods is not None:
            propagate, spans = mods
            span = spans.start("loadgen.request", kernel=kernel,
                               rows=rows, op=op)
            ctx = propagate.ctx_from(span)
            if ctx is not None:
                trace = ctx.trace
                hdrs = propagate.inject({}, ctx)
        if tenant is not None:
            hdrs = dict(hdrs or {})
            hdrs["X-Tenant"] = tenant
        t_start = time.perf_counter()
        while True:
            attempts += 1
            try:
                code, headers, _data = self._post(path, body,
                                                  headers=hdrs)
            except socket.timeout:
                status, code = "timeout", None
                break
            except (http.client.HTTPException, OSError):
                # connection-level loss: refused (restart gap), reset
                # (kill -9 mid-flight), or a torn response — distinct
                # from shed (429/503) and expired (504)
                status, code = "lost", None
                break
            req_id = headers.get("X-Request-Id") or req_id
            if code == 200:
                status = "ok"
                break
            if code in (429, 503):
                if attempts > max_retries:
                    status = "shed"
                    break
                retry_s = 1.0
                try:
                    retry_s = float(headers.get("Retry-After", "1"))
                except ValueError:
                    pass
                time.sleep(min(max(retry_s, 0.0), retry_cap_s))
                continue
            status = "timeout" if code == 504 else "error"
            break
        if span is not None:
            done = {"status": status}
            if req_id is not None:
                done["req_id"] = req_id
            mods[1].finish(span, **done)
        rec = {
            "kernel": kernel,
            "rows": rows,
            "op": op,
            "status": status,
            "code": code,
            "latency_ms": round(
                (time.perf_counter() - t_start) * 1e3, 3),
            "req_id": req_id,
            "attempts": attempts,
        }
        if tenant is not None:
            rec["tenant"] = tenant
        if trace is not None:
            rec["trace"] = trace
        return rec


def _request_bodies(kernels, rows_choices, n_in: int,
                    timeout_s: float) -> dict:
    """Pre-serialized request bodies per (kernel, rows): payload
    values are irrelevant to load, so encode each combination once."""
    bodies = {}
    for k in kernels:
        for r in rows_choices:
            inputs = [[0.1] * int(n_in)] * int(r)
            bodies[(k, r)] = json.dumps(
                {"kernel": k, "inputs": inputs,
                 "timeout_s": timeout_s}).encode()
    return bodies


def _ingest_bodies(kernels, rows_choices, n_in: int, n_out: int,
                   seed: int = 0) -> dict:
    """Pre-serialized ``POST /ingest`` bodies per (kernel, rows) for
    the ``--mix`` mode.  Sample values are drawn once per combination
    (deterministic per seed): the online buffer just needs plausible
    finite rows, and re-encoding per request would bottleneck the
    generator, not the server."""
    rng = np.random.RandomState(seed)
    bodies = {}
    for k in kernels:
        for r in rows_choices:
            X = rng.uniform(0.0, 1.0, size=(int(r), int(n_in)))
            T = rng.uniform(0.0, 1.0, size=(int(r), int(n_out)))
            bodies[(k, r)] = json.dumps(
                {"kernel": k, "inputs": X.round(4).tolist(),
                 "targets": T.round(4).tolist()}).encode()
    return bodies


# ------------------------------------------------------------ hostile


HOSTILE_MODES = ("slowloris", "torn", "fuzz")


def _hostile_target(url: str) -> tuple[str, int]:
    u = urllib.parse.urlparse(url if "//" in url else "http://" + url)
    return u.hostname or "127.0.0.1", u.port or 80


def _attack_slowloris(host: str, port: int, *, duration_s: float,
                      interval_s: float,
                      stop: "threading.Event | None") -> str:
    """Trickle header bytes and never finish the request.  Against an
    unguarded server this pins a handler thread for ``duration_s``;
    against ``HPNN_CONN_MIN_BPS`` / ``HPNN_CONN_HDR_MS`` the server
    kills us first.  The recv timeout doubles as the trickle pacing:
    per-recv socket timeouts never fire for a client that always sends
    one more byte in time — which is exactly the defence bypass the
    byte-rate floor exists to close."""
    try:
        sock = socket.create_connection((host, port), timeout=2.0)
    except OSError:
        return "refused"
    try:
        sock.sendall(b"POST /v1/infer HTTP/1.1\r\nHost: lg\r\n")
        deadline = time.perf_counter() + duration_s
        i = 0
        while time.perf_counter() < deadline:
            if stop is not None and stop.is_set():
                break
            sock.sendall(f"X-Slow-{i}: y\r\n".encode())
            i += 1
            sock.settimeout(max(0.05, interval_s))
            try:
                data = sock.recv(256)
            except socket.timeout:
                continue
            # the server spoke first: an empty read is a guard/deadline
            # kill, bytes are an early error response — either way the
            # attack failed to pin the thread
            return "killed" if not data else "answered"
        return "survived"
    except (BrokenPipeError, ConnectionResetError, OSError):
        return "killed"
    finally:
        try:
            sock.close()
        except OSError:  # already torn down
            pass


def _attack_torn(host: str, port: int, *, body_claim: int = 400,
                 body_sent: int = 24) -> str:
    """Declare a Content-Length, send a fraction of it, hang up.  The
    server's body read comes up short (close reason ``torn_body``)."""
    try:
        sock = socket.create_connection((host, port), timeout=2.0)
    except OSError:
        return "refused"
    try:
        hdr = (b"POST /v1/infer HTTP/1.1\r\nHost: lg\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: " + str(int(body_claim)).encode()
               + b"\r\n\r\n")
        sock.sendall(hdr + b'{"kernel": "'
                     + b"x" * max(0, int(body_sent) - 13) + b'"')
        time.sleep(0.05)  # let the body read start before the tear
        return "torn"
    except (BrokenPipeError, ConnectionResetError, OSError):
        return "torn"
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _attack_fuzz(host: str, port: int, *, seed: int = 0) -> str:
    """Spray bytes that are not HTTP where a request line should be;
    a healthy front end answers 400 (``rejected``) or drops the
    connection (``dropped``) — never hangs (``ignored``)."""
    rng = np.random.RandomState(seed)
    try:
        sock = socket.create_connection((host, port), timeout=2.0)
    except OSError:
        return "refused"
    try:
        junk = bytes(rng.randint(1, 255, size=64, dtype=np.uint8))
        sock.sendall(junk + b"\r\n\r\n")
        sock.settimeout(2.0)
        try:
            data = sock.recv(512)
        except socket.timeout:
            return "ignored"
        if not data:
            return "dropped"
        return "rejected" if data.startswith(b"HTTP/") else "dropped"
    except (BrokenPipeError, ConnectionResetError, OSError):
        return "dropped"
    finally:
        try:
            sock.close()
        except OSError:
            pass


def run_hostile(url: str, *, mode: str, n_conns: int = 8,
                duration_s: float = 3.0, interval_s: float = 0.4,
                seed: int = 0,
                stop: "threading.Event | None" = None) -> dict:
    """Launch ``n_conns`` concurrent attackers of one mode and report
    the per-mode outcome census.  Every attacker thread is joined (with
    a margin past ``duration_s``); stragglers count as ``hung`` — the
    drill's no-hung-threads witness."""
    if mode not in HOSTILE_MODES:
        raise ValueError(f"unknown hostile mode {mode!r}")
    shield_sigpipe()
    host, port = _hostile_target(url)
    outcomes: list[str] = []
    lock = threading.Lock()

    def attacker(ci: int):
        if mode == "slowloris":
            out = _attack_slowloris(host, port, duration_s=duration_s,
                                    interval_s=interval_s, stop=stop)
        elif mode == "torn":
            out = _attack_torn(host, port)
        else:
            out = _attack_fuzz(host, port, seed=seed + ci)
        with lock:
            outcomes.append(out)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=attacker, args=(ci,),
                                daemon=True)
               for ci in range(max(1, int(n_conns)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + 5.0)
    hung = sum(1 for t in threads if t.is_alive())
    census: dict[str, int] = {}
    with lock:
        for o in outcomes:
            census[o] = census.get(o, 0) + 1
    return {
        "mode": mode,
        "conns": int(n_conns),
        "outcomes": dict(sorted(census.items())),
        "hung": hung,
        "duration_s": round(time.perf_counter() - t0, 3),
    }


# ------------------------------------------------------------ runners


def run_open_loop(url: str, *, rate_rps: float, duration_s: float,
                  process: str = "poisson",
                  kernels=("default",), rows_choices=(1,),
                  n_in: int = 8, timeout_s: float = 2.0,
                  max_retries: int = 2, retry_cap_s: float = 1.0,
                  n_workers: int = 16, seed: int = 0,
                  ingest_frac: float = 0.0, n_out: int = 2,
                  tenants: int = 0, zipf_s: float = 1.1,
                  out_path: str | None = None,
                  stop: "threading.Event | None" = None,
                  on_record=None) -> dict:
    """Offered-load run: arrivals are scheduled up front and fired on
    time by a worker pool whether or not earlier requests finished.
    ``ingest_frac`` of the arrivals become ``POST /ingest`` sample
    feeds (the ``--mix`` mode).  ``stop`` (an Event) ends the run
    early — the chaos drills schedule a generous duration and stop
    once recovery is confirmed; ``on_record`` observes each outcome
    row as it lands.  Returns the summary dict (and writes the JSONL
    to ``out_path``)."""
    shield_sigpipe()
    rng = np.random.RandomState(seed)
    arrivals = make_arrivals(process, rate_rps, duration_s, rng)
    bodies = _request_bodies(kernels, rows_choices, n_in, timeout_s)
    feed_bodies = (_ingest_bodies(kernels, rows_choices, n_in, n_out,
                                  seed) if ingest_frac > 0 else {})
    tnames = tenant_names(tenants) if tenants > 0 else ()
    tcdf = zipf_cdf(len(tnames), zipf_s) if tnames else None
    specs: "queue.Queue[tuple]" = queue.Queue()
    for t in arrivals:
        k = kernels[int(rng.randint(len(kernels)))]
        r = int(rows_choices[int(rng.randint(len(rows_choices)))])
        op = ("ingest" if ingest_frac > 0
              and rng.uniform() < ingest_frac else "infer")
        tn = tnames[zipf_pick(tcdf, rng)] if tnames else None
        specs.put((t, k, r, op, tn))
    records: list[dict] = []
    rec_lock = threading.Lock()
    t0 = time.perf_counter()

    def worker():
        client = _Client(url, timeout_s)
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                try:
                    t_due, k, r, op, tn = specs.get_nowait()
                except queue.Empty:
                    return
                delay = t0 + t_due - time.perf_counter()
                if delay > 0:
                    if stop is not None:
                        if stop.wait(delay):
                            return
                    else:
                        time.sleep(delay)
                if op == "ingest":
                    rec = client.request(
                        k, r, feed_bodies[(k, r)],
                        max_retries=max_retries,
                        retry_cap_s=retry_cap_s,
                        path="/ingest", op="ingest", tenant=tn)
                else:
                    rec = client.request(k, r, bodies[(k, r)],
                                         max_retries=max_retries,
                                         retry_cap_s=retry_cap_s,
                                         tenant=tn)
                rec["t"] = round(t_due, 6)
                with rec_lock:
                    records.append(rec)
                if on_record is not None:
                    on_record(rec)
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, int(n_workers)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if stop is None or not stop.is_set():
        wall_s = max(wall_s, duration_s)
    summary = summarize(records, wall_s, offered_rps=rate_rps)
    summary["process"] = process
    if out_path:
        write_jsonl(out_path, records, summary)
    return summary


def run_closed_loop(url: str, *, n_clients: int = 4,
                    duration_s: float = 2.0,
                    kernels=("default",), rows_choices=(1,),
                    n_in: int = 8, timeout_s: float = 2.0,
                    max_retries: int = 0, retry_cap_s: float = 1.0,
                    seed: int = 0, ingest_frac: float = 0.0,
                    n_out: int = 2,
                    tenants: int = 0, zipf_s: float = 1.1,
                    out_path: str | None = None) -> dict:
    """Saturation probe: N clients in sequential request loops for the
    duration.  Offered load equals achieved load by construction.
    ``ingest_frac`` of the requests become ``POST /ingest`` feeds."""
    shield_sigpipe()
    records: list[dict] = []
    rec_lock = threading.Lock()
    tnames = tenant_names(tenants) if tenants > 0 else ()
    tcdf = zipf_cdf(len(tnames), zipf_s) if tnames else None
    t0 = time.perf_counter()

    def client_loop(ci: int):
        rng = np.random.RandomState(seed + 1000 + ci)
        client = _Client(url, timeout_s)
        bodies = _request_bodies(kernels, rows_choices, n_in,
                                 timeout_s)
        feed_bodies = (_ingest_bodies(kernels, rows_choices, n_in,
                                      n_out, seed + ci)
                       if ingest_frac > 0 else {})
        try:
            while time.perf_counter() - t0 < duration_s:
                k = kernels[int(rng.randint(len(kernels)))]
                r = int(rows_choices[int(
                    rng.randint(len(rows_choices)))])
                tn = tnames[zipf_pick(tcdf, rng)] if tnames else None
                if ingest_frac > 0 and rng.uniform() < ingest_frac:
                    rec = client.request(
                        k, r, feed_bodies[(k, r)],
                        max_retries=max_retries,
                        retry_cap_s=retry_cap_s,
                        path="/ingest", op="ingest", tenant=tn)
                else:
                    rec = client.request(k, r, bodies[(k, r)],
                                         max_retries=max_retries,
                                         retry_cap_s=retry_cap_s,
                                         tenant=tn)
                rec["t"] = round(time.perf_counter() - t0, 6)
                with rec_lock:
                    records.append(rec)
        finally:
            client.close()

    threads = [threading.Thread(target=client_loop, args=(ci,),
                                daemon=True)
               for ci in range(max(1, int(n_clients)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    summary = summarize(records, wall_s)
    summary["n_clients"] = int(n_clients)
    if out_path:
        write_jsonl(out_path, records, summary)
    return summary


# ------------------------------------------------------------ bench


def run_bench_load(*, slo_ms: float = 50.0, seed: int = 7,
                   saturation_s: float = 1.5,
                   load_s: float = 3.0, device=None) -> dict:
    """The bench.py fold-in: stand up an in-process SLO-armed server
    over a tiny kernel (on ``device``: ``cuda`` unless ``"cpu"``),
    measure saturation closed-loop, then offer 2x that open-loop and
    report whether shedding held goodput near the plateau and the
    server-side windowed p99 of accepted requests within the
    objective."""
    from hpnn_tpu_torch import obs, serve
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve.server import make_server

    env_keys = (obs.slo.ENV_KNOB, obs.slo.ENV_WINDOW,
                obs.slo.ENV_TARGET)
    prev_env = {k: os.environ.get(k) for k in env_keys}
    obs.slo.configure(slo_ms, window_s=max(30.0, load_s * 4))
    session = None
    server = None
    try:
        k, _ = kernel_mod.generate(seed, 8, [5], 2)
        session = serve.Session(
            max_batch=16, n_buckets=3, max_wait_ms=1.0, max_depth=64,
            shed_age_ms=max(1.0, slo_ms / 4.0), device=device)
        session.register_kernel("bench", k)
        server = make_server(session, port=0)
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        common = dict(kernels=("bench",), rows_choices=(1, 2, 4),
                      n_in=8, timeout_s=2.0, max_retries=0)
        # discarded warmup: the first requests pay eager-path tracing
        # and would depress the saturation estimate
        run_closed_loop(url, n_clients=2, duration_s=0.3, seed=seed,
                        **common)
        sat = run_closed_loop(url, n_clients=8,
                              duration_s=saturation_s, seed=seed,
                              **common)
        sat_rps = sat["goodput_rps"]
        offered = max(10.0, 2.0 * sat_rps)
        load = run_open_loop(url, rate_rps=offered,
                             duration_s=load_s, process="poisson",
                             n_workers=16, seed=seed + 1, **common)
        slo_doc = obs.slo.health_doc()
        vs_sat = (load["goodput_rps"] / sat_rps if sat_rps else None)
        return {
            "metric": "serve_load",
            "device": str(session.engine.device),
            "slo_ms": float(slo_ms),
            "saturation_rps": sat_rps,
            "offered_rps": load["offered_rps"],
            "goodput_rps": load["goodput_rps"],
            "goodput_vs_saturation": (None if vs_sat is None
                                      else round(vs_sat, 4)),
            "p99_under_load_ms": slo_doc.get("p99_ms"),
            "slo_attainment": slo_doc.get("attainment"),
            "saturation": sat,
            "load": load,
            "slo": slo_doc,
        }
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if session is not None:
            session.close()
        for key, val in prev_env.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        obs.slo._reset_for_tests()


def vm_rss_mb() -> float | None:
    """Resident-set size of THIS process in MiB (Linux /proc; None
    elsewhere) — the bounded-memory witness of the tenant bench."""
    try:
        with open("/proc/self/status", encoding="ascii") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        pass
    return None


def run_bench_tenant(*, n_kernels: int = 10_000, resident: int = 256,
                     n_tenants: int = 8, zipf_s: float = 1.2,
                     traffic_s: float = 2.0, n_threads: int = 4,
                     hot_rate_rps: float = 50.0,
                     seed: int = 11, device=None) -> dict:
    """The multi-tenant hosting fold-in (docs/tenancy.md): one
    in-process :class:`~hpnn_tpu_torch.tenant.TenantSession` (on
    ``device``: ``cuda`` unless ``"cpu"``) hosting
    ``n_kernels`` kernels across ``n_tenants`` tenants with a
    ``resident``-kernel LRU paging cap, driven by Zipf(``zipf_s``)
    traffic — the head-heavy mix that makes paging and quotas earn
    their keep.  Reports registration throughput, RSS growth under the
    cap (the bounded-memory claim), measured cold-hit paging latency
    (p50/p99), goodput, and the quota-shed census (the hottest tenant
    runs with a ``hot_rate_rps`` budget so admission control
    demonstrably bites).  On the CPU the session runs in parity mode
    without page-in warmup, as the JAX package's bench does; on the
    card every page-in captures its bucket menu (the tenant host
    refuses lazy captures there)."""
    import tempfile

    from hpnn_tpu_torch import runtime
    from hpnn_tpu_torch.models.kernel import Kernel
    from hpnn_tpu_torch.serve.batcher import QueueFull
    from hpnn_tpu_torch.tenant import TenantSession, TenantSpec

    cpu = runtime.resolve_device(device).type == "cpu"
    tnames = tenant_names(n_tenants)
    specs = {tnames[0]: TenantSpec(tnames[0], "silver",
                                   rate_rps=float(hot_rate_rps))}
    rng = np.random.RandomState(seed)
    n_in, hid, n_out = 6, 4, 2
    session = None
    page_dir = tempfile.mkdtemp(prefix="hpnn_tenant_bench_")
    rss0 = vm_rss_mb()
    try:
        session = TenantSession(
            mode="parity" if cpu else None, fleet=True, max_wait_ms=0.5,
            shards=16, resident_max=int(resident),
            page_dir=page_dir, tenants=specs, page_warmup=not cpu,
            device=device)
        by_tenant: dict[str, list[str]] = {t: [] for t in tnames}
        t_reg = time.perf_counter()
        for j in range(int(n_kernels)):
            k = Kernel((
                rng.standard_normal((hid, n_in)),
                rng.standard_normal((n_out, hid))))
            tn = tnames[j % n_tenants]
            kn = f"k{j}"
            session.register_for(tn, kn, k, warmup=False)
            by_tenant[tn].append(kn)
        register_s = time.perf_counter() - t_reg
        kcdf = {t: zipf_cdf(len(ks), zipf_s)
                for t, ks in by_tenant.items()}
        tcdf = zipf_cdf(n_tenants, zipf_s)
        x = rng.standard_normal((2, n_in))
        # discarded warmup: the very first dispatch pays the eager-path
        # tracing stall and would otherwise dominate the measured p99
        session.infer_for(tnames[-1], by_tenant[tnames[-1]][0], x)
        counts_lock = threading.Lock()
        counts = {"ok": 0, "shed": 0, "error": 0}
        shed_by_tenant = {t: 0 for t in tnames}
        errors: list[str] = []
        lat_s: list[float] = []
        t0 = time.perf_counter()

        def tenant_loop(ti: int):
            trng = np.random.RandomState(seed + 100 + ti)
            while time.perf_counter() - t0 < traffic_s:
                tn = tnames[zipf_pick(tcdf, trng)]
                kn = by_tenant[tn][zipf_pick(kcdf[tn], trng)]
                t_req = time.perf_counter()
                try:
                    session.infer_for(tn, kn, x, timeout_s=2.0)
                except QueueFull:  # Shed subclass: quota or queue
                    with counts_lock:
                        counts["shed"] += 1
                        shed_by_tenant[tn] += 1
                    continue
                except Exception as exc:
                    with counts_lock:
                        counts["error"] += 1
                        errors.append(repr(exc))
                    continue
                dt = time.perf_counter() - t_req
                with counts_lock:
                    counts["ok"] += 1
                    lat_s.append(dt)

        threads = [threading.Thread(target=tenant_loop, args=(ti,),
                                    daemon=True)
                   for ti in range(max(1, int(n_threads)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        rss1 = vm_rss_mb()
        pager_doc = session.pager.health_doc()
        quota_doc = session.quota.health_doc()
        cap_ok = (pager_doc["resident"] <= int(resident))
        rss_growth = (round(rss1 - rss0, 1)
                      if rss0 is not None and rss1 is not None
                      else None)
        return {
            "metric": "tenant_host",
            "device": "cpu" if cpu else "cuda",
            "n_kernels": int(n_kernels),
            "n_tenants": int(n_tenants),
            "zipf_s": float(zipf_s),
            "resident_cap": int(resident),
            "register_s": round(register_s, 3),
            "register_krps": round(n_kernels / register_s / 1e3, 2),
            "rss_before_mb": rss0,
            "rss_after_mb": rss1,
            "rss_growth_mb": rss_growth,
            "resident": pager_doc["resident"],
            "paged": pager_doc["paged"],
            "resident_cap_ok": bool(cap_ok),
            "page_ins": pager_doc["page_ins"],
            "page_outs": pager_doc["page_outs"],
            "cold_p50_ms": pager_doc["cold_p50_ms"],
            "cold_p99_ms": pager_doc["cold_p99_ms"],
            "requests": sum(counts.values()),
            "ok": counts["ok"],
            "shed": counts["shed"],
            "errors": counts["error"],
            "error_sample": errors[:4],
            "goodput_rps": round(counts["ok"] / wall_s, 1)
                           if wall_s else 0.0,
            "p99_ms": (percentile_ms(lat_s, 99) if lat_s else None),
            "hot_tenant": tnames[0],
            "hot_rate_rps": float(hot_rate_rps),
            "quota_shed": shed_by_tenant[tnames[0]],
            "shed_by_tenant": {t: n for t, n in
                               sorted(shed_by_tenant.items()) if n},
            "tenants": quota_doc,
        }
    finally:
        if session is not None:
            session.close()
        import shutil

        shutil.rmtree(page_dir, ignore_errors=True)


# ------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open/closed-loop load generator for the HTTP "
                    "serving front end")
    ap.add_argument("--url", help="server base url "
                                  "(e.g. http://127.0.0.1:8000)")
    ap.add_argument("--bench", action="store_true",
                    help="self-contained in-process bench "
                         "(saturation probe + 2x open-loop)")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="offered load, requests/s (open loop)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--process", choices=("poisson", "burst"),
                    default="poisson")
    ap.add_argument("--closed", action="store_true",
                    help="closed loop (saturation probe) instead of "
                         "offered load")
    ap.add_argument("--clients", type=int, default=4,
                    help="closed-loop client count")
    ap.add_argument("--workers", type=int, default=16,
                    help="open-loop worker pool size")
    ap.add_argument("--kernels", default="default",
                    help="comma-separated kernel names")
    ap.add_argument("--rows", default="1",
                    help="comma-separated row counts to mix")
    ap.add_argument("--n-in", type=int, default=8,
                    help="input width of the target kernels")
    ap.add_argument("--mix", type=float, default=0.0, metavar="FRAC",
                    help="fraction of requests sent as POST /ingest "
                         "sample feeds (train-while-serve traffic; "
                         "needs an online_nn server)")
    ap.add_argument("--n-out", type=int, default=2,
                    help="target width of --mix ingest samples")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="spread requests over N synthetic tenants "
                         "(t000..) via the X-Tenant header")
    ap.add_argument("--zipf", type=float, default=1.1, metavar="S",
                    help="Zipf skew of the tenant draw (--tenants)")
    ap.add_argument("--hostile", choices=HOSTILE_MODES,
                    help="attack-class mode: raw-socket slowloris / "
                         "torn-body / fuzz clients instead of clean "
                         "traffic (docs/resilience.md)")
    ap.add_argument("--conns", type=int, default=8,
                    help="concurrent attacker connections (--hostile)")
    ap.add_argument("--interval", type=float, default=0.4,
                    help="slowloris trickle interval, seconds")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-request timeout_s")
    ap.add_argument("--retries", type=int, default=2,
                    help="max 429/503 retries per request (0: "
                         "record the shed)")
    ap.add_argument("--retry-cap", type=float, default=1.0,
                    help="cap on honored Retry-After sleeps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write per-request JSONL here")
    ap.add_argument("--device", help="--bench's device (cuda unless 'cpu')")
    args = ap.parse_args(argv)

    if args.bench:
        out = run_bench_load(seed=args.seed or 7, device=args.device)
        print(json.dumps(out))
        return 0
    if not args.url:
        ap.error("--url is required (or use --bench)")
    if args.hostile:
        summary = run_hostile(args.url, mode=args.hostile,
                              n_conns=args.conns,
                              duration_s=args.duration,
                              interval_s=args.interval,
                              seed=args.seed)
        print(json.dumps(summary))
        return 0 if not summary["hung"] else 1
    kernels = tuple(s for s in args.kernels.split(",") if s)
    rows = tuple(int(s) for s in args.rows.split(",") if s)
    if not 0.0 <= args.mix <= 1.0:
        ap.error("--mix must be in [0, 1]")
    if args.tenants < 0:
        ap.error("--tenants must be >= 0")
    common = dict(kernels=kernels, rows_choices=rows,
                  n_in=args.n_in, timeout_s=args.timeout,
                  max_retries=args.retries,
                  retry_cap_s=args.retry_cap, seed=args.seed,
                  ingest_frac=args.mix, n_out=args.n_out,
                  tenants=args.tenants, zipf_s=args.zipf,
                  out_path=args.out)
    if args.closed:
        summary = run_closed_loop(args.url, n_clients=args.clients,
                                  duration_s=args.duration, **common)
    else:
        summary = run_open_loop(args.url, rate_rps=args.rate,
                                duration_s=args.duration,
                                process=args.process,
                                n_workers=args.workers, **common)
    print(json.dumps(summary))
    return 0 if summary["requests"] else 1


if __name__ == "__main__":
    sys.exit(main())
