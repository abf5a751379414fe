"""One run of one benchmark cell: set-up, measured window, check.

Everything that belongs to one configuration, traffic mix or metric is
found by name in ``BENCHMARK.json``:

* ``benchmark/configs/<config>.json``: the model's sizes and training
  mode (the cell's ``config``);
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, among
  them ``driver``, the module ``benchmark/drivers/<driver>.py`` that
  sets the cell up, runs one timed call, and judges the outputs;
* ``benchmark/metrics/<name>.py`` (end-to-end) and
  ``benchmark/layer_metrics/<name>.py`` (per layer): one ``read(run)``
  each, returning the metric's value or None where it finds nothing to
  read.

A driver module provides ``setup(cell) -> state``, ``warm(state)``,
``call(state) -> units`` (one timed call; ``units`` the samples or rows
it trained), ``release(state)`` (frees the program's device state after
the window), ``work(state) -> dict`` (the counts the metrics read) and
``check(state) -> [(name, value, limit), ...]`` (the comparison with the
plain reference; a value above its limit is not correct).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "hpnn_tpu")


class Refused(Exception):
    """A run that must print no result."""


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            btime = next(int(l.split()[1]) for l in fp if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as fp:
        return json.load(fp)


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def resolve(bench: dict, workload: str) -> dict:
    """The cell's workload entry, configuration, traffic, driver module
    and its metrics (entries of ``end_to_end`` and ``per_layer`` that
    list it, or list no cells), each with its reader."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, conf_entry["file"])) as fp:
        config = json.load(fp)
    traffic = load_json("traffic", w["traffic"] + ".json")
    driver = load_module(os.path.join(HERE, "drivers", traffic["driver"] + ".py"),
                         "bench_driver_" + traffic["driver"])

    def metrics(kind, folder):
        out = []
        for m in bench[kind]:
            if workload in m.get("workloads", [workload]):
                path = os.path.join(HERE, folder, m["name"] + ".py")
                out.append((m, load_module(path, "bench_metric_" + m["name"])))
        return out

    return {"workload": w, "config": config, "traffic": traffic, "driver": driver,
            "end_to_end": metrics("end_to_end", "metrics"),
            "per_layer": metrics("per_layer", "layer_metrics")}


def program_in_checkout() -> None:
    """The program under test is this checkout's own package."""
    try:
        import hpnn_tpu_torch
    except ImportError as exc:
        raise Refused(f"the program is missing from the checkout: {exc}") from None
    if not os.path.abspath(hpnn_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise Refused(f"hpnn_tpu_torch loads from {hpnn_tpu_torch.__file__}, "
                      f"outside the checkout {ROOT}")


def jax_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             config: dict | None = None, log=sys.stderr) -> dict:
    """Run one cell once; returns the result object the command prints.
    ``device`` "cpu" and ``config`` (keys that replace the cell's
    configuration's) are for the tests: the first skips the look for a
    card, the second runs the cell at a size the CPU holds."""
    t_start = time.time() if t_start is None else t_start
    program_in_checkout()
    cell = resolve(spec(), workload)
    cell["config"].update(config or {})
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card only")
        if torch.cuda.device_count() < cell["workload"]["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                          f"{cell['workload']['chips']}")
    driver = cell["driver"]
    workdir = tempfile.mkdtemp(prefix="hpnn-bench-")
    cwd = os.getcwd()
    try:
        cell.update(seed=int(seed), device=device, workdir=workdir)
        state = driver.setup(cell)
        tr = tracing.Trace(trace and device == "cuda")
        tr.warm()
        driver.warm(state)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        calls = []
        with tr:
            t0 = time.perf_counter()
            while True:
                c0 = time.perf_counter()
                with torch.profiler.record_function(tracing.CALL):
                    units = driver.call(state)
                c1 = time.perf_counter()
                calls.append({"wall_s": c1 - c0, "units": units})
                if c1 - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        os.chdir(cwd)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        work = driver.work(state)
        driver.release(state)
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = driver.check(state, load_json("limits", workload + ".json"))
        check_s = time.perf_counter() - t_check
        found = jax_modules()
        if found:
            raise Refused(f"JAX modules loaded in the measuring process: {found}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    run = {"setup_s": setup_s, "window_s": window_s, "calls": calls, "work": work,
           "trace": tr.summary}
    metrics = {}
    for m, reader in cell["per_layer" if trace else "end_to_end"]:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["workload"]["chips"], "memory_peak_bytes": peak}
    if device == "cuda":
        dev["power"] = power_limit()
    result = {"correct": correct, "attempted": len(calls), "failed": state["failed"],
              "metrics": metrics, "device": dev}
    if trace and tr.summary is not None:
        dev["busy_s"] = tr.summary["busy_s"]
        dev["window_s"] = tr.summary["window_s"]
        result["breakdown"] = {"device_ops": tr.summary["device_ops"],
                               "idle_gaps": tr.summary["idle_gaps"]}
    print(f"bench: {workload} seed {seed}: {len(calls)} calls in {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s, check {check_s:.3f} s", file=log)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=log)
    log.flush()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    t_start = process_start()
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except Refused as exc:
        print(f"bench: refused: {exc}", file=sys.stderr)
        return 3
    with contextlib.redirect_stdout(sys.__stdout__):
        print(json.dumps(result), flush=True)
    return 0
