#!/usr/bin/env python3
"""Closed-loop load generator for the port's serving stack: the twin of
``tools/bench_serve.py``'s ``run_serve_bench``/``run_smoke``.

N client threads each issue R sequential ``Session.infer`` calls with
mixed row counts (closed loop: a client's next request starts when its
previous one returns), against a freshly generated kernel behind the
full stack — registry → micro-batcher → bucketed engine (one CUDA
graph a bucket on the card).  Reports per-request latency
(p50/p99/mean), request and row throughput, and the forward-cache
census (the steady-state invariant: forward count == bucket count after
warmup), under the JAX tool's keys, plus the device it ran on.

Two presets, the JAX tool's:

* default — the MNIST tutorial shape (784-300-10), 16 clients ×
  25 requests;
* ``--smoke`` — a tiny 8-5-2 kernel, 8 × 8 requests.

``--seconds S`` turns the fixed request count into a window: every
client loops until S seconds have passed, so the percentiles rest on
many thousands of requests rather than 400.  ``--replicas LIST`` names
the setups to load, comma-separated: 0 is one ``Session``, N > 0 a
``Router`` of N replicas.  ``--runs K`` repeats every setup K times,
each on a fresh session, in the order A B B A A B … so that a drift
of the host weighs on both alike; the line then holds every run and,
per setup, the median, least and greatest of p50, p99, requests/s and
rows/s.

Prints ONE JSON line.  Runs on ``cuda`` unless ``--device cpu``:

    python -m hpnn_tpu_torch.tools.bench_serve [--smoke] [--device cpu]
    python -m hpnn_tpu_torch.tools.bench_serve --seconds 10 --runs 3 --replicas 0,2
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

import numpy as np


# latency definitions copied from tools/loadgen.py, so this bench and
# the JAX package's tools report identically defined numbers
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


def closed_loop(session, name: str, n_in: int, *, n_clients: int = 16,
                n_requests: int = 25, mixed_rows=(1, 2, 4, 8),
                timeout_s: float = 30.0, on_answer=None,
                duration_s: float | None = None) -> dict:
    """The closed loop against ``session``'s kernel ``name``: client
    ``ci`` draws its inputs from ``RandomState(1000 + ci)``, as the JAX
    tool's do.  ``on_answer(x, out)``, when given, sees every served
    request's rows and answer (on the client's thread).  With
    ``duration_s`` each client sends requests until that many seconds
    have passed since the load began, and ``n_requests`` is ignored.
    Returns the load's part of the result dict."""
    from hpnn_tpu_torch import serve

    lats: list[list[float]] = [[] for _ in range(n_clients)]
    rows_done = [0] * n_clients
    rejected = [0] * n_clients
    errors: list[str] = []

    def client(ci: int):
        rng = np.random.RandomState(1000 + ci)
        j = 0
        while (j < n_requests if duration_s is None
               else time.perf_counter() - t0 < duration_s):
            rows = mixed_rows[(ci + j) % len(mixed_rows)]
            j += 1
            x = rng.uniform(-1.0, 1.0, size=(rows, n_in))
            t_req = time.perf_counter()
            try:
                out = session.infer(name, x, timeout_s=timeout_s)
            except serve.QueueFull:
                rejected[ci] += 1
                continue
            except Exception as exc:  # a failed load run must say why
                errors.append(repr(exc))
                return
            lats[ci].append(time.perf_counter() - t_req)
            rows_done[ci] += rows
            if on_answer is not None:
                on_answer(x, out)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    lat = [v for client_l in lats for v in client_l]
    out = {
        "n_clients": n_clients,
        "requests_per_client": (n_requests if duration_s is None
                                else None),
        "requests_served": len(lat),
        "requests_rejected": int(sum(rejected)),
        "rows_served": int(sum(rows_done)),
        "wall_s": round(wall_s, 3),
        "throughput_rps": round(len(lat) / wall_s, 1) if wall_s else 0.0,
        "rows_per_s": round(sum(rows_done) / wall_s, 1) if wall_s else 0.0,
        "latency_ms": latency_summary(lat),
    }
    if duration_s is not None:
        out["window_s"] = duration_s
    if errors:
        out["errors"] = errors[:5]
    return out


def run_serve_bench(
    *, n_in: int, hiddens: list[int], n_out: int,
    n_clients: int = 16, n_requests: int = 25,
    max_batch: int = 64, n_buckets: int = 4, max_wait_ms: float = 2.0,
    mixed_rows=(1, 2, 4, 8), seed: int = 11, timeout_s: float = 30.0,
    device=None, duration_s: float | None = None, replicas: int = 0,
) -> dict:
    """One closed-loop measurement against one ``Session``, or a
    ``Router`` of ``replicas`` replicas; returns the result dict."""
    import torch

    from hpnn_tpu_torch import serve
    from hpnn_tpu_torch.models import kernel as kernel_mod

    k, _ = kernel_mod.generate(seed, n_in, hiddens, n_out)
    kw = dict(max_batch=max_batch, n_buckets=n_buckets,
              max_wait_ms=max_wait_ms, device=device)
    session = (serve.Router(replicas, **kw) if replicas
               else serve.Session(**kw))
    t0 = time.perf_counter()
    session.register_kernel("bench", k)          # includes warmup
    warmup_s = time.perf_counter() - t0
    compiled_after_warmup = session.engine.compiled_count()
    try:
        load = closed_loop(session, "bench", n_in, n_clients=n_clients,
                           n_requests=n_requests, mixed_rows=mixed_rows,
                           timeout_s=timeout_s, duration_s=duration_s)
    finally:
        session.close()
    engine = (session.replicas[0] if replicas else session).engine
    dev = engine.device
    out = {
        "metric": "serve_infer_latency",
        "kernel_shape": f"{n_in}-{'-'.join(map(str, hiddens))}-{n_out}",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "mode": engine.mode,
        "replicas": replicas,
        **load,
        "warmup_s": round(warmup_s, 3),
        "buckets": list(engine.buckets),
        "compiled_after_warmup": compiled_after_warmup,
        # the steady-state invariant: serving captured NOTHING beyond
        # the warmed menu (one forward per bucket)
        "compiled_after_load": session.engine.compiled_count(),
    }
    if "errors" in out:  # keep the JAX tool's key order: errors last
        out["errors"] = out.pop("errors")
    return out


def _spread(values: list[float]) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def run_series(replicas: list[int], runs: int, **kw) -> dict:
    """``runs`` measurements of each setup in ``replicas`` (see
    :func:`run_serve_bench`), interleaved A B B A A B …; returns every
    run and, per setup, the spread of its headline numbers."""
    results = []
    for i in range(runs):
        for r in (replicas if i % 2 == 0 else replicas[::-1]):
            results.append(run_serve_bench(replicas=r, **kw))
    spread = {}
    for r in replicas:
        mine = [res for res in results if res["replicas"] == r]
        spread[str(r)] = {
            "p50_ms": _spread([m["latency_ms"]["p50"] for m in mine]),
            "p99_ms": _spread([m["latency_ms"]["p99"] for m in mine]),
            "throughput_rps": _spread([m["throughput_rps"] for m in mine]),
            "rows_per_s": _spread([m["rows_per_s"] for m in mine]),
            "requests_served": sum(m["requests_served"] for m in mine),
        }
    out = {"metric": "serve_infer_latency_series",
           "order": [res["replicas"] for res in results],
           "spread": spread, "runs": results}
    errors = [e for res in results for e in res.get("errors", ())]
    if errors:
        out["errors"] = errors[:5]
    return out


def run_smoke(device=None) -> dict:
    """The tiny preset."""
    return run_serve_bench(
        n_in=8, hiddens=[5], n_out=2, n_clients=8, n_requests=8,
        max_batch=16, n_buckets=3, max_wait_ms=1.0, seed=7, device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny 8-5-2 preset")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the engine runs (default cuda)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=25)
    ap.add_argument("--seconds", type=float, default=None,
                    help="load for a window of this many seconds")
    ap.add_argument("--replicas", default="0",
                    help="comma-separated setups: 0 = one Session, "
                         "N = a Router of N replicas")
    ap.add_argument("--runs", type=int, default=1,
                    help="measurements of each setup")
    args = ap.parse_args(argv)
    replicas = [int(r) for r in args.replicas.split(",")]
    if args.runs < 1 or any(r < 0 for r in replicas):
        ap.error("--runs must be >= 1 and --replicas >= 0")
    if args.smoke:
        kw = dict(n_in=8, hiddens=[5], n_out=2, n_clients=8, n_requests=8,
                  max_batch=16, n_buckets=3, max_wait_ms=1.0, seed=7)
    else:
        kw = dict(n_in=784, hiddens=[300], n_out=10,
                  n_clients=args.clients, n_requests=args.requests)
    kw.update(device=args.device, duration_s=args.seconds)
    if args.runs == 1 and len(replicas) == 1:
        out = run_serve_bench(replicas=replicas[0], **kw)
    else:
        out = run_series(replicas, args.runs, **kw)
    print(json.dumps(out))
    return 1 if out.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
