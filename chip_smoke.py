#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that hpnn_tpu_torch runs on an
NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. probe   — torch/CUDA versions, the card, its power limit.
2. build   — compiles every CUDA source of the main path from the
   checkout (``hpnn_tpu_torch/csrc/*.cu``) with nvcc for sm_90a.
3. pinned  — the convergence kernel against its plain PyTorch version
   at 784-300-10 with delta = -1e30, so every sample runs exactly
   K+1 iterations: ANN/SNN x BP/BPM, float and double.
4. main    — ``train_nn`` then ``run_nn`` (the package's CLIs) on a
   seeded synthetic MNIST-shaped dataset: ANN 784-300-10 BP, then
   SNN 784-300-10 BP; the kernel's launch count is read around it.
5. real    — kernel against plain at the loop's own delta/min_iter
   (max_iter lowered so the plain Python loop stays short).
6. timing  — the kernel, its plain version and its bound on one chunk.

The last two lines are the kernel table and the device line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
SEED = 10958
N_IN, N_HID, N_OUT = 784, 300, 10
N_TRAIN_ANN, N_TRAIN_SNN, N_TEST = 256, 16, 256
CHUNK = 64            # HPNN_FUSE_CHUNK for the main path
PINNED_K = 20         # phase 3: max_iter, so K+1 iterations per sample
REAL_MAX_ITER = 1500  # phase 5: caps the plain loop's run time
TIMED_ITERS = 200     # phase 6: iterations per sample, pinned
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Tolerances of kernel vs plain on the same inputs.  Both run the same
# arithmetic; only the order of each dot product's and reduction's sum
# differs (warp shuffles vs torch's kernels).  float64: a reordered sum
# of <= 784 terms moves by ~1e-16 relative per step, so 1e-10 absolute
# on weights (|w| < 1) and outputs (|o| <= 1) leaves a wide margin after
# 21 iterations.  float32: the same reordering moves ~1e-7 relative per
# step and feeds back through 21 updates; 1e-4 absolute is well above
# that drift and far below any real fault (a wrong term is O(1e-2)).
TOL = {"float32": 1e-4, "float64": 1e-10}
# Phase 5 in float32: reduction order moves trajectories near the
# thresholds, so totals are held to a band, not per sample.
REAL_F32_NITER_BAND = 0.05   # relative, on the total N_ITER
REAL_F32_FIRST_OK_BAND = 1   # samples, on the first-try OK count


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data
def make_dataset(np, rng, n, protos):
    """``n`` MNIST-shaped samples: a class prototype (15% ink) with
    stroke-intensity jitter and 3% random pixels; +-1 one-hot targets."""
    X = np.empty((n, N_IN))
    T = -np.ones((n, N_OUT))
    for i in range(n):
        c = int(rng.integers(0, N_OUT))
        x = protos[c] * rng.uniform(0.6, 1.0, N_IN)
        flip = rng.random(N_IN) < 0.03
        X[i] = np.where(flip, rng.uniform(0.0, 1.0, N_IN), x)
        T[i, c] = 1.0
    return X, T


def write_samples(directory, X, T):
    os.makedirs(directory)
    for i, (x, t) in enumerate(zip(X, T)):
        with open(os.path.join(directory, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {N_IN}\n" + " ".join("%.5f" % v for v in x) + "\n")
            fp.write(f"[output] {N_OUT}\n" + " ".join("%.1f" % v for v in t) + "\n")


def write_conf(path, *, name, kind, train_dir, test_dir, init="generate"):
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[type] {kind}\n[init] {init}\n[seed] {SEED}\n"
                 f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
                 f"[train] BP\n[sample_dir] {train_dir}\n[test_dir] {test_dir}\n")


# --------------------------------------------------------------- helpers
def run_cli(main, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def cuda_ms(torch, fn, reps=3):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def work_of(weights, S, iters, momentum, dtype_bytes):
    """(bytes, flops) the function must move and compute: weights read
    and written once, samples read once, stats and outputs written
    once; per iteration 2|W| (forward) + 2|W_1:| (hidden deltas) + 3|W|
    (BP update) or 5|W| (BPM update) flops, plus a forward per sample."""
    sizes = [int(w.numel()) for w in weights]
    n_w, n_tail = sum(sizes), sum(sizes[1:])
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = (2 * n_w + S * (n_in + 2 * n_out + 2)) * dtype_bytes + 12 * S
    flops = 2 * n_w * S + iters * ((7 if momentum else 5) * n_w + 2 * n_tail)
    return nbytes, flops


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases
def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hpnn_tpu_torch")):
        print("chip_smoke: run from a checkout (hpnn_tpu_torch/ not found "
              "beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch.cli import run_nn, train_nn
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import _build, convergence
    from hpnn_tpu_torch.train import loop

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu")]
    check(not bad, f"the port pulled in {bad[:5]}")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    log(f"[probe] nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.build("convergence", force=True)
    _build.load("convergence")
    log(f"[build] convergence.cu built in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log["convergence"][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    k0, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    rng = np.random.default_rng(SEED)
    protos = (rng.random((N_OUT, N_IN)) < 0.15).astype(np.float64)
    Xtr, Ttr = make_dataset(np, rng, N_TRAIN_ANN, protos)
    Xte, Tte = make_dataset(np, rng, N_TEST, protos)

    def tensors(dtype, S, snn=False):
        w, _ = km.to_torch(k0.weights, device=dev, dtype=dtype)
        T = Ttr[:S].copy()
        if snn:
            T = np.where(T > 0, 1.0, 0.0)
        return (w, torch.tensor(Xtr[:S], dtype=dtype, device=dev),
                torch.tensor(T, dtype=dtype, device=dev))

    # 3. pinned iteration count
    max_err = {"float32": 0.0, "float64": 0.0}
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                kw = dict(model=model, momentum=momentum, min_iter=5,
                          max_iter=PINNED_K)
                wk, X, T = tensors(dtype, 4, snn=model == "snn")
                wp = tuple(w.clone() for w in wk)
                sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
                torch.cuda.synchronize()
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                check(sk.n_iter.tolist() == [PINNED_K + 1] * 4, f"{tag}: kernel n_iter {sk.n_iter.tolist()}")
                check(sk.n_iter.tolist() == sp.n_iter.tolist(), f"{tag}: n_iter differs")
                check(sk.first_ok.tolist() == sp.first_ok.tolist(), f"{tag}: first_ok differs")
                check(sk.final_ok.tolist() == sp.final_ok.tolist(), f"{tag}: final_ok differs")
                err = max([float((a - b).abs().max()) for a, b in zip(wk, wp)]
                          + [float((sk.out - sp.out).abs().max())])
                check(math.isfinite(err) and err <= TOL[name],
                      f"{tag}: max |kernel - plain| {err:.3e} > {TOL[name]:.0e}")
                max_err[name] = max(max_err[name], err)
                log(f"[pinned] {tag}: n_iter {sk.n_iter.tolist()} first_ok "
                    f"{sk.first_ok.tolist()} max|diff| {err:.3e} (tol {TOL[name]:.0e})")

    # 4. main path: train_nn then run_nn through the CLIs
    shutil.rmtree(WORK, ignore_errors=True)
    write_samples(os.path.join(WORK, "train"), Xtr, Ttr)
    write_samples(os.path.join(WORK, "train_snn"), Xtr[:N_TRAIN_SNN], Ttr[:N_TRAIN_SNN])
    write_samples(os.path.join(WORK, "test"), Xte, Tte)
    os.environ["HPNN_FUSE_CHUNK"] = str(CHUNK)
    cwd = os.getcwd()
    main_stats = {}
    convergence.launches = 0
    try:
        for kind_name, n_train, train_dir in (
                ("ANN", N_TRAIN_ANN, "train"), ("SNN", N_TRAIN_SNN, "train_snn")):
            run_dir = os.path.join(WORK, kind_name.lower())
            os.makedirs(run_dir)
            os.chdir(run_dir)
            write_conf("nn.conf", name=f"smoke_{kind_name.lower()}", kind=kind_name,
                       train_dir=f"../{train_dir}", test_dir="../test")
            before = convergence.launches
            rc, out, secs = run_cli(train_nn.main, ["-v", "-v", "nn.conf"])
            check(rc == 0, f"{kind_name} train_nn exit {rc}")
            launched = convergence.launches - before
            n_iters = [int(v) for v in re.findall(r"N_ITER=\s*(\d+)", out)]
            n_ok = len(re.findall(r" OK N_ITER", out))
            check(len(n_iters) == n_train, f"{kind_name}: {len(n_iters)} token lines")
            check(launched == math.ceil(n_train / CHUNK),
                  f"{kind_name}: {launched} launches for {n_train} samples")
            check(os.path.exists("kernel.tmp") and os.path.exists("kernel.opt"),
                  f"{kind_name}: kernel files missing")
            _, w_opt = kernel_format.load_kernel("kernel.opt")
            check([w.shape for w in w_opt] == [(N_HID, N_IN), (N_OUT, N_HID)]
                  and all(np.isfinite(w).all() for w in w_opt),
                  f"{kind_name}: kernel.opt malformed or not finite")
            write_conf("cont.conf", name=f"smoke_{kind_name.lower()}", kind=kind_name,
                       train_dir=f"../{train_dir}", test_dir="../test", init="kernel.opt")
            rc, eout, esecs = run_cli(run_nn.main, ["-v", "-v", "cont.conf"])
            check(rc == 0, f"{kind_name} run_nn exit {rc}")
            n_pass = eout.count("[PASS]")
            n_tested = eout.count("TESTING FILE")
            check(n_tested == N_TEST, f"{kind_name}: {n_tested} eval lines")
            if kind_name == "ANN":
                check(n_pass > N_TEST / N_OUT,
                      f"ANN: PASS {n_pass}/{N_TEST} not above chance")
            else:
                # per-sample SNN-BP with +-1 targets drives every
                # non-target output to TINY and most samples to the
                # 102399 cap, so a few dozen samples leave it near chance;
                # hold its eval to the token protocol instead
                check(eout.count("BEST CLASS") == N_TEST, "SNN: BEST CLASS tokens missing")
            total = sum(n_iters)
            main_stats[kind_name] = dict(
                samples=n_train, launches=launched, seconds=secs,
                samples_per_s=n_train / secs, mean_n_iter=total / n_train,
                us_per_iter_wall=secs / total * 1e6, first_ok=n_ok,
                passed=n_pass, eval_seconds=esecs)
            log(f"[main] {kind_name} 784-300-10 BP: {n_train} samples in {secs:.2f} s "
                f"({n_train / secs:.2f} samples/s), mean N_ITER {total / n_train:.1f}, "
                f"{secs / total * 1e6:.2f} us/iteration wall, first-try OK {n_ok}, "
                f"{launched} launches; run_nn PASS {n_pass}/{N_TEST} in {esecs:.2f} s")
    finally:
        os.chdir(cwd)
    main_launches = convergence.launches
    check(main_launches > 0, "the main path launched no convergence kernel")

    # 5. real thresholds.  ANN starts from the main path's trained
    # kernel.opt on unseen test samples (an untrained ANN-BP takes
    # thousands of iterations per sample); SNN from the generated kernel.
    _, w_ann = kernel_format.load_kernel(os.path.join(WORK, "ann", "kernel.opt"))
    for model in ("ann", "snn"):
        for momentum in (False, True):
            mi = loop.MIN_BPM_ITER if momentum else loop.MIN_BP_ITER
            kw = dict(model=model, momentum=momentum, min_iter=mi,
                      max_iter=REAL_MAX_ITER)
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                if model == "ann":
                    wk, _ = km.to_torch(w_ann, device=dev, dtype=dtype)
                    X = torch.tensor(Xte[:8], dtype=dtype, device=dev)
                    T = torch.tensor(Tte[:8], dtype=dtype, device=dev)
                else:
                    wk, X, T = tensors(dtype, 8)
                wp = tuple(w.clone() for w in wk)
                delta = loop.DELTA_BPM if momentum else loop.DELTA_BP
                sk = convergence.train_epoch(wk, X, T, 0.2, delta, **kw)
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, delta, **kw)
                nk, npl = sk.n_iter.tolist(), sp.n_iter.tolist()
                fk, fp = int(sk.first_ok.sum()), int(sp.first_ok.sum())
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                if name == "float64":
                    check(nk == npl, f"{tag}: n_iter kernel {nk} plain {npl}")
                    check(sk.first_ok.tolist() == sp.first_ok.tolist(),
                          f"{tag}: first_ok differs")
                else:
                    rel = abs(sum(nk) - sum(npl)) / max(1, sum(npl))
                    check(rel <= REAL_F32_NITER_BAND,
                          f"{tag}: total N_ITER {sum(nk)} vs {sum(npl)}")
                    check(abs(fk - fp) <= REAL_F32_FIRST_OK_BAND,
                          f"{tag}: first_ok count {fk} vs {fp}")
                log(f"[real] {tag}: N_ITER kernel {nk} plain {npl} first_ok {fk}/{fp}")


    # 6. timing: 4 samples x TIMED_ITERS iterations each, every mode and
    # type; the kernel row of the result is ANN-BP float32, the main path's
    timings = []
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                wk, X, T = tensors(dtype, 4)
                kw = dict(model=model, momentum=momentum, min_iter=5,
                          max_iter=TIMED_ITERS - 1)
                k_ms = cuda_ms(torch, lambda: convergence.train_epoch(
                    wk, X, T, 0.2, -1e30, **kw))
                wp = tuple(w.clone() for w in wk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
                torch.cuda.synchronize()
                p_ms = (time.perf_counter() - t0) * 1e3
                iters = int(sp.n_iter.sum())
                nbytes, flops = work_of(wk, 4, iters, momentum, X.element_size())
                b_ms, b_by = bound_ms(nbytes, flops, name)
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                timings.append(dict(config=tag, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                    bound_by=b_by, iters=iters))
                log(f"[timing] {tag} 784-300-10, 4 samples x {TIMED_ITERS} iterations: "
                    f"kernel {k_ms:.3f} ms ({k_ms / iters * 1e3:.2f} us/iteration), "
                    f"plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
                    f"{flops} flop)")
    head = timings[0]
    ms, plain_ms, b_ms, b_by = head["ms"], head["plain_ms"], head["bound_ms"], head["bound_by"]
    # a chunk of real samples at the loop's own thresholds, as train_nn sends it
    wk, _ = km.to_torch(k0.weights, device=dev, dtype=torch.float32)
    X = torch.tensor(Xtr[:CHUNK], dtype=torch.float32, device=dev)
    T = torch.tensor(Ttr[:CHUNK], dtype=torch.float32, device=dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    st = convergence.train_epoch(wk, X, T, 0.2, loop.DELTA_BP, model="ann",
                                 min_iter=loop.MIN_BP_ITER, max_iter=loop.MAX_BP_ITER)
    e1.record()
    torch.cuda.synchronize()
    chunk_ms, chunk_iters = e0.elapsed_time(e1), int(st.n_iter.sum())
    log(f"[timing] ANN-BP chunk of {CHUNK} real samples: {chunk_ms:.1f} ms, "
        f"{chunk_iters} iterations ({chunk_ms / chunk_iters * 1e3:.2f} us/iteration)")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "convergence",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/convergence.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:260",
        "replaces_fn": "train_sample_fused",
        "launches": main_launches,
        "max_abs_err": max_err["float32"],
        "max_abs_err_f32": max_err["float32"],
        "max_abs_err_f64": max_err["float64"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "timed": f"ANN-BP 784-300-10 float32, 4 samples x {TIMED_ITERS} iterations",
        "chunk_ms": chunk_ms,
        "chunk_iters": chunk_iters,
        "main": main_stats,
        "by_config": timings,
    }]
    log(f"[card] {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
