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

``--tenant`` runs the multi-tenant host bench instead
(:func:`run_bench_tenant`, the twin of ``tools/loadgen.py``'s
``run_bench_tenant`` with its keys): many kernels across Zipf tenants
behind a ``TenantSession`` whose resident set is smaller than the live
set, so cold hits page kernels in (checkpoint read, host-to-device copy,
graph captures) while the other tenants replay; the hottest tenant runs
under a rate quota.  On ``cuda`` it also samples
``torch.cuda.memory_allocated``/``memory_reserved``.

Prints ONE JSON line.  Runs on ``cuda`` unless ``--device cpu``:

    python -m hpnn_tpu_torch.tools.bench_serve [--smoke] [--device cpu]
    python -m hpnn_tpu_torch.tools.bench_serve --seconds 10 --runs 3 --replicas 0,2
    python -m hpnn_tpu_torch.tools.bench_serve --tenant [--seconds 10]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
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


# Zipf helpers copied from tools/loadgen.py (the tenant mix)
def tenant_names(n: int) -> tuple[str, ...]:
    """``t000``.. — the synthetic tenant namespace."""
    return tuple(f"t{i:03d}" for i in range(int(n)))


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative Zipf(s) weights over ranks 0..n-1: item ``i`` draws
    with probability proportional to ``1/(i+1)^s``."""
    if n < 1:
        raise ValueError("zipf_cdf needs n >= 1")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), float(s))
    return np.cumsum(w / w.sum())


def zipf_pick(cdf: np.ndarray, rng: np.random.RandomState) -> int:
    return int(np.searchsorted(cdf, rng.uniform(), side="right"))


def _quantiles(values: list[float]) -> dict:
    if not values:
        return {"p50": None, "p99": None}
    v = np.asarray(values)
    return {"p50": round(float(np.percentile(v, 50)), 3),
            "p99": round(float(np.percentile(v, 99)), 3)}


class _MemorySampler:
    """``torch.cuda.memory_allocated``/``memory_reserved`` of ``device``
    every ``every_s`` seconds on a thread, with the peaks between."""

    def __init__(self, device, every_s: float = 1.0):
        import torch

        self.torch, self.device, self.every_s = torch, device, every_s
        self.samples: list[dict] = []
        self.start = self.take()
        torch.cuda.reset_peak_memory_stats(device)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def take(self) -> dict:
        t = self.torch.cuda
        return {"allocated": t.memory_allocated(self.device),
                "reserved": t.memory_reserved(self.device)}

    def _run(self):
        t0 = time.perf_counter()
        while not self._stop.wait(self.every_s):
            self.samples.append(dict(self.take(),
                                     t_s=round(time.perf_counter() - t0, 3)))

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        t = self.torch.cuda
        return {"start": self.start, "end": self.take(),
                "peak": {"allocated": t.max_memory_allocated(self.device),
                         "reserved": t.max_memory_reserved(self.device)},
                "samples": self.samples}


def run_bench_tenant(*, n_kernels: int = 256, resident: int = 32,
                     n_tenants: int = 8, zipf_s: float = 1.2,
                     traffic_s: float = 10.0, n_threads: int = 16,
                     hot_rate_rps: float = 50.0, seed: int = 11,
                     device=None, n_in: int = 784, hiddens=(300,),
                     n_out: int = 10, rows=(1, 2, 4, 8), max_batch: int = 64,
                     n_buckets: int = 4, max_wait_ms: float = 2.0,
                     page_warmup: bool = True, page_dir: str | None = None,
                     on_answer=None, registered: dict | None = None) -> dict:
    """The multi-tenant host bench: one ``TenantSession`` hosting
    ``n_kernels`` ANN kernels of ``n_in``-``hiddens``-``n_out`` across
    ``n_tenants`` tenants with a ``resident``-kernel paging cap, loaded
    by ``n_threads`` closed-loop clients for ``traffic_s`` seconds, each
    request a Zipf(``zipf_s``) pick of tenant then kernel with
    ``rows[j % len(rows)]`` rows.  The hottest tenant is ``silver`` with
    a ``hot_rate_rps`` quota.  Reports ``tools/loadgen.py``'s
    ``run_bench_tenant`` keys, plus the device, the cold-hit split
    (checkpoint read, host-to-device copy, captures), captures per
    page-in, a probe kernel answered before and after a forced page
    cycle, and on ``cuda`` the card's memory at start, peak and end and
    once a second.  ``on_answer(tenant, kernel, x, out)`` sees every
    served request; ``registered``, when given, receives every scoped
    kernel name and its ``Kernel``.  Per-kernel batchers (``fleet=False``): the fleet
    batcher would capture a stacked graph for every new member set."""
    import torch

    from hpnn_tpu_torch import runtime, serve
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import compile_cache
    from hpnn_tpu_torch.tenant import TenantSession, TenantSpec

    dev = runtime.resolve_device(device)
    tnames = tenant_names(n_tenants)
    specs = {tnames[0]: TenantSpec(tnames[0], "silver",
                                   rate_rps=float(hot_rate_rps))}
    rng = np.random.RandomState(seed)
    shapes = list(zip([n_in, *hiddens], [*hiddens, n_out]))
    own_dir = page_dir is None
    page_dir = page_dir or tempfile.mkdtemp(prefix="hpnn_tenant_bench_")
    session = None
    rss0 = _vm_rss_mb()
    mem = _MemorySampler(dev) if dev.type == "cuda" else None
    try:
        session = TenantSession(
            device=dev, fleet=False, max_batch=max_batch, n_buckets=n_buckets,
            max_wait_ms=max_wait_ms, shards=16, resident_max=int(resident),
            page_dir=page_dir, tenants=specs, page_warmup=page_warmup)
        by_tenant: dict[str, list[str]] = {t: [] for t in tnames}
        t_reg = time.perf_counter()
        for j in range(int(n_kernels)):
            k = kernel_mod.Kernel(tuple(
                rng.uniform(-1.0, 1.0, (o, i)) / np.sqrt(i) for i, o in shapes))
            tn = tnames[j % n_tenants]
            kn = f"k{j}"
            session.register_for(tn, kn, k, warmup=False)
            by_tenant[tn].append(kn)
            if registered is not None:
                registered[f"{tn}:{kn}"] = k
        register_s = time.perf_counter() - t_reg
        if page_warmup:
            # the kernels the cap left resident capture here, as a
            # page-in would, not lazily on their batchers' threads
            with session.pager._lock:
                resident_names = list(session.pager._resident)
            session.engine.warmup(resident_names)
        kcdf = {t: zipf_cdf(len(ks), zipf_s) for t, ks in by_tenant.items()}
        tcdf = zipf_cdf(n_tenants, zipf_s)
        # the probe: the coldest tenant's first kernel, answered now
        probe_t, probe_k = tnames[-1], by_tenant[tnames[-1]][0]
        probe_x = rng.uniform(-1.0, 1.0, (max(rows), n_in))
        probe_before = np.asarray(session.infer_for(probe_t, probe_k, probe_x))
        counts_lock = threading.Lock()
        counts = {"ok": 0, "shed": 0, "error": 0}
        shed_by_tenant = {t: 0 for t in tnames}
        errors: list[str] = []
        lat_s: list[float] = []
        t0 = time.perf_counter()

        def tenant_loop(ti: int):
            trng = np.random.RandomState(seed + 100 + ti)
            j = 0
            while time.perf_counter() - t0 < traffic_s:
                tn = tnames[zipf_pick(tcdf, trng)]
                kn = by_tenant[tn][zipf_pick(kcdf[tn], trng)]
                x = trng.uniform(-1.0, 1.0, (rows[(ti + j) % len(rows)], n_in))
                j += 1
                t_req = time.perf_counter()
                try:
                    out = session.infer_for(tn, kn, x, timeout_s=30.0)
                except serve.QueueFull:  # Shed subclass: quota or queue
                    with counts_lock:
                        counts["shed"] += 1
                        shed_by_tenant[tn] += 1
                    continue
                except Exception as exc:  # counted and reported
                    with counts_lock:
                        counts["error"] += 1
                        errors.append(repr(exc))
                    continue
                dt = time.perf_counter() - t_req
                with counts_lock:
                    counts["ok"] += 1
                    lat_s.append(dt)
                if on_answer is not None:
                    on_answer(tn, kn, x, out)

        threads = [threading.Thread(target=tenant_loop, args=(ti,), daemon=True)
                   for ti in range(max(1, int(n_threads)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        # one more page cycle of the probe, then its answer again
        name = f"{probe_t}:{probe_k}"
        pager = session.pager
        with pager._lock:
            if name in pager._resident and not pager._pins.get(name):
                pager._page_out_locked(name)
        probe_after = np.asarray(session.infer_for(probe_t, probe_k, probe_x))
        memory = mem.stop() if mem is not None else None
        rss1 = _vm_rss_mb()
        pager_doc = pager.health_doc()
        quota_doc = session.quota.health_doc()
        split = pager.cold_split()
        out = {
            "metric": "tenant_host",
            "n_kernels": int(n_kernels),
            "n_tenants": int(n_tenants),
            "zipf_s": float(zipf_s),
            "resident_cap": int(resident),
            "register_s": round(register_s, 3),
            "register_krps": round(n_kernels / register_s / 1e3, 2),
            "rss_before_mb": rss0,
            "rss_after_mb": rss1,
            "rss_growth_mb": (round(rss1 - rss0, 1)
                              if rss0 is not None and rss1 is not None else None),
            "resident": pager_doc["resident"],
            "paged": pager_doc["paged"],
            "resident_cap_ok": pager_doc["resident"] <= int(resident),
            "page_ins": pager_doc["page_ins"],
            "page_outs": pager_doc["page_outs"],
            "cold_p50_ms": pager_doc.get("cold_p50_ms"),
            "cold_p99_ms": pager_doc.get("cold_p99_ms"),
            "requests": sum(counts.values()),
            "ok": counts["ok"],
            "shed": counts["shed"],
            "errors": counts["error"],
            "error_sample": errors[:4],
            "goodput_rps": round(counts["ok"] / wall_s, 1) if wall_s else 0.0,
            "p99_ms": percentile_ms(lat_s, 99) if lat_s else None,
            "hot_tenant": tnames[0],
            "hot_rate_rps": float(hot_rate_rps),
            "quota_shed": shed_by_tenant[tnames[0]],
            "shed_by_tenant": {t: n for t, n in sorted(shed_by_tenant.items()) if n},
            "tenants": quota_doc,
            # beyond loadgen's keys
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "kernel_shape": "-".join(str(n) for n in [n_in, *hiddens, n_out]),
            "n_threads": int(n_threads),
            "traffic_s": float(traffic_s),
            "wall_s": round(wall_s, 3),
            "latency_ms": latency_summary(lat_s),
            "page_warmup": bool(page_warmup),
            "cold_split_ms": {k: _quantiles([c[k] for c in split])
                              for k in ("read_ms", "h2d_ms", "capture_ms")},
            "captures_per_page_in": (float(np.mean([c["captures"] for c in split]))
                                     if split else None),
            "captures": compile_cache.counters()[1],
            "probe": {"kernel": name, "bitwise": bool(np.array_equal(
                probe_before, probe_after)),
                "max_abs_diff": float(np.max(np.abs(probe_before - probe_after)))},
            "memory": memory,
        }
        return out
    finally:
        if mem is not None and not mem._stop.is_set():
            mem.stop()
        if session is not None:
            session.close()
        if own_dir:
            shutil.rmtree(page_dir, ignore_errors=True)


def _vm_rss_mb() -> float | None:
    """Resident-set size of this process in MiB (Linux /proc)."""
    try:
        with open("/proc/self/status", encoding="ascii") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        pass
    return None


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
    ap.add_argument("--tenant", action="store_true",
                    help="the multi-tenant host bench (--seconds: its window)")
    args = ap.parse_args(argv)
    if args.tenant:
        out = run_bench_tenant(device=args.device,
                               traffic_s=args.seconds or 10.0)
        print(json.dumps(out))
        return 1 if out["errors"] else 0
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
