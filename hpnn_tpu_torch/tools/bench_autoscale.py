"""End-to-end autoscale ride: a load ramp the fleet follows (the port of
``tools/bench_autoscale.py``).

Real port ``serve_nn`` worker PROCESSES behind a
:class:`~hpnn_tpu_torch.fleet.router.ClusterRouter` HTTP edge (the
port's ``serve.make_server``), an
:class:`~hpnn_tpu_torch.fleet.autoscaler.Autoscaler` closing the loop on
the router's own gauges, and an open-loop Poisson ramp at ~3.3x the
single-worker plateau:

1. spawn ONE worker, measure its saturation plateau closed-loop;
2. offer ~3.3x that open-loop for ``ramp_s``: the worker sheds, the
   router's ``shed_total`` climbs, the autoscaler scales 1 → N
   (``fleet.scale_up``, readiness-gated spawns; each worker captures its
   bucket menu at boot, there is no compile cache);
3. windowed goodput over the ramp's tail against the 1-worker plateau,
   and its p99 (``goodput_x``, ``p99_ms``);
4. after the ramp the sheds age out of the calm window and the
   autoscaler drains back to min width (``settle_s``: ramp end → width
   1).

Per-worker capacity is pinned by ``HPNN_SERVE_RATE_CAP`` (the serve
edge's admission token bucket, set in the workers' environment only),
so N workers really serve N times one worker's rate on a host whose
cores they share.  The load generator is this module's own (stdlib
HTTP, one connection a request), so the tool needs nothing of the JAX
package's ``tools/loadgen.py``.

    python -m hpnn_tpu_torch.tools.bench_autoscale [--device cpu]
        [--cap RPS] [--max-width N] [--ramp-s S] [--seed N]

Workers run on ``cuda`` unless ``--device cpu`` is given.  Prints one
JSON document; exits 0 when the fleet scaled to >= 2, reached 1.5x the
plateau with p99 under 2 s, and settled back to one worker.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np

KERNEL = "auto"
CONF = (f"[name] {KERNEL}\n[type] ANN\n[init] generate\n[seed] 7\n"
        "[input] 8\n[hidden] 5\n[output] 2\n[train] BP\n")
N_IN = 8


def percentile_ms(lat_s: list[float], q: float) -> float:
    """Percentile ``q`` of latencies in seconds, in milliseconds."""
    return round(float(np.percentile(np.asarray(lat_s) * 1e3, q)), 3)


def post_infer(host: str, port: int, body: bytes, timeout_s: float):
    """One ``POST /v1/infer``: ``(status, retry_after_s, latency_s)``;
    status 0 for a transport failure."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("POST", "/v1/infer", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        try:
            retry = float(resp.headers.get("Retry-After", "") or 0.0)
        except ValueError:
            retry = 0.0
        return resp.status, retry, time.perf_counter() - t0
    except (OSError, http.client.HTTPException):
        return 0, 0.0, time.perf_counter() - t0
    finally:
        conn.close()


def _body(rng, timeout_s: float) -> bytes:
    return json.dumps({"kernel": KERNEL, "inputs": rng.uniform(-1, 1, N_IN).tolist(),
                       "timeout_s": timeout_s}).encode()


def closed_loop(host: str, port: int, *, n_clients: int, duration_s: float,
                seed: int, timeout_s: float = 2.0, max_retries: int = 2,
                retry_cap_s: float = 0.2) -> dict:
    """Saturation probe: ``n_clients`` back-to-back request loops; a 429
    is retried after its ``Retry-After`` (capped), so the probe measures
    the admitted rate.  Returns ``{"goodput_rps", "ok", "shed"}``."""
    counts = {"ok": 0, "shed": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()

    def client(ci):
        rng = np.random.RandomState(seed + 1000 + ci)
        while time.perf_counter() - t0 < duration_s:
            body = _body(rng, timeout_s)
            for attempt in range(max_retries + 1):
                status, retry, _lat = post_infer(host, port, body, timeout_s + 3.0)
                if status != 429 or attempt == max_retries:
                    break
                time.sleep(min(retry, retry_cap_s))
            with lock:
                counts["ok" if status == 200 else "shed"] += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.perf_counter() - t0, duration_s)
    return dict(counts, goodput_rps=round(counts["ok"] / wall, 3))


def open_loop(host: str, port: int, *, rate_rps: float, duration_s: float,
              seed: int, n_workers: int = 16, timeout_s: float = 2.0) -> list[dict]:
    """Offered load: Poisson arrivals scheduled up front and fired on
    time by a worker pool whether or not earlier requests finished, no
    retries.  Returns one record a request: ``{"t"`` (scheduled second),
    ``"status"`` (ok | shed | expired | error), ``"latency_ms"}``."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_rps, int(rate_rps * duration_s * 1.5) + 16)
    arrivals = np.cumsum(gaps)
    specs: queue.Queue = queue.Queue()
    for t in arrivals[arrivals < duration_s]:
        specs.put(float(t))
    records: list[dict] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    names = {200: "ok", 429: "shed", 504: "expired"}

    def worker(wi):
        wrng = np.random.RandomState(seed + 7 + wi)
        while True:
            try:
                t_due = specs.get_nowait()
            except queue.Empty:
                return
            delay = t0 + t_due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            status, _retry, lat = post_infer(host, port, _body(wrng, timeout_s),
                                             timeout_s + 3.0)
            with lock:
                records.append({"t": round(t_due, 6),
                                "status": names.get(status, "error"),
                                "latency_ms": round(lat * 1e3, 3)})

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records


def run_bench_autoscale(*, cap_rps: float = 60.0, max_width: int = 3,
                        ramp_s: float = 16.0, window_s: float = 4.0,
                        seed: int = 9, ready_timeout_s: float = 120.0,
                        device: str | None = None) -> dict:
    """One full ramp ride (module doc); returns the result document.
    Raises when the first worker cannot start."""
    from hpnn_tpu_torch.fleet.autoscaler import Autoscaler, Policy
    from hpnn_tpu_torch.fleet.router import ClusterRouter
    from hpnn_tpu_torch.fleet.worker import WorkerSupervisor
    from hpnn_tpu_torch.serve.server import make_server

    out: dict = {"metric": "autoscale", "cap_rps": float(cap_rps),
                 "max_width": int(max_width), "device": device or "cuda"}
    workdir = tempfile.mkdtemp(prefix="hpnn_autoscale_")
    conf_path = os.path.join(workdir, "nn.conf")
    with open(conf_path, "w") as fp:
        fp.write(CONF)
    sup = WorkerSupervisor(
        conf_path, workdir=workdir, kind="serve",
        args=("--device", device) if device else (),
        ready_timeout_s=ready_timeout_s,
        # the cap lives in the WORKERS' env only: the edge is uncapped
        env={"HPNN_SERVE_RATE_CAP": str(cap_rps)})
    router = server = scaler = None
    try:
        sup.spawn()
        router = ClusterRouter(supervisor=sup)
        server = make_server(router, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = "127.0.0.1", server.server_address[1]

        closed_loop(host, port, n_clients=2, duration_s=0.4, seed=seed)  # warmup
        sat_rps = closed_loop(host, port, n_clients=4, duration_s=2.0,
                              seed=seed)["goodput_rps"]
        out["sat_rps_1worker"] = sat_rps
        if not sat_rps:
            raise RuntimeError("no goodput from the 1-worker probe")

        policy = Policy(min_width=1, max_width=int(max_width),
                        up_step=max(1, int(max_width) - 1),
                        up_cooldown_s=2.0, down_for_s=3.0, down_cooldown_s=3.0)
        scaler = Autoscaler(sup, router, policy=policy, interval_s=0.5)
        widths: list[tuple[float, int]] = [(0.0, sup.width())]
        stop_sampler = threading.Event()
        t0 = time.monotonic()

        def sampler():
            while not stop_sampler.is_set():
                w = sup.width()
                if w != widths[-1][1]:
                    widths.append((round(time.monotonic() - t0, 3), w))
                stop_sampler.wait(0.1)

        sampler_t = threading.Thread(target=sampler, daemon=True)
        sampler_t.start()
        scaler.start()
        # past even the full fleet's capacity, so max width sheds
        # steadily and holds wide until the ramp ends
        offered = max(10.0, 3.3 * sat_rps)
        records = open_loop(host, port, rate_rps=offered, duration_s=ramp_s,
                            seed=seed + 1)
        t_ramp_end = time.monotonic()
        out["offered_rps"] = round(offered, 3)
        out["requests"] = len(records)
        out["by_status"] = {s: sum(r["status"] == s for r in records)
                            for s in ("ok", "shed", "expired", "error")}
        tail_ok = [r for r in records if r["status"] == "ok" and r["t"] >= ramp_s - window_s]
        out["window_s"] = window_s
        out["goodput_rps"] = round(len(tail_ok) / window_s, 1)
        out["goodput_x"] = round(len(tail_ok) / window_s / sat_rps, 3)
        out["p99_ms"] = (percentile_ms([r["latency_ms"] / 1e3 for r in tail_ok], 99)
                         if tail_ok else None)

        settle_deadline = t_ramp_end + 45.0
        while sup.width() > policy.min_width and time.monotonic() < settle_deadline:
            time.sleep(0.1)
        settled = sup.width() == policy.min_width
        out["settle_s"] = round(time.monotonic() - t_ramp_end, 3) if settled else None
        scaler.stop()
        stop_sampler.set()
        sampler_t.join(timeout=5.0)
        out["width_timeline"] = widths
        out["scaled_to"] = max(w for _t, w in widths)
        up_t = [t for t, w in widths if w > 1]
        out["react_s"] = round(up_t[0], 3) if up_t else None
        out["ok"] = bool(out["scaled_to"] >= 2 and out["goodput_x"] >= 1.5
                         and out["p99_ms"] is not None and out["p99_ms"] < 2000.0
                         and settled)
        return out
    finally:
        if scaler is not None:
            scaler.stop()
        if server is not None:
            server.shutdown()
            server.server_close()
        if router is not None:
            router.close()
        sup.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="autoscaler ramp ride over real serve_nn worker processes")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the workers' device (default cuda)")
    ap.add_argument("--cap", type=float, default=60.0,
                    help="per-worker HPNN_SERVE_RATE_CAP (requests/s)")
    ap.add_argument("--max-width", type=int, default=3)
    ap.add_argument("--ramp-s", type=float, default=16.0)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    out = run_bench_autoscale(cap_rps=args.cap, max_width=args.max_width,
                              ramp_s=args.ramp_s, seed=args.seed, device=args.device)
    print(json.dumps(out))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
