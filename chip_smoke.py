#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that hpnn_tpu_torch runs on an
NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. probe   — torch/CUDA versions, the card, its power limit.
2. build   — compiles every CUDA source of the main paths from the
   checkout (``hpnn_tpu_torch/csrc/*.cu``) with nvcc for sm_90a, one
   nvcc per source, and the native host library
   (``csrc/hpnn_native.cpp``) with g++, all started together; the host
   library must load.
3. pinned  — the convergence kernel against its plain PyTorch version
   at 784-300-10 with delta = -1e30, so every sample runs exactly
   K+1 iterations: ANN/SNN x BP/BPM, float and double; then the kernel
   against itself, bitwise, under every plan (8 and 16 CTAs, weights
   resident and streamed).
4. main    — ``train_nn`` then ``run_nn`` (the package's CLIs) on a
   seeded synthetic MNIST-shaped dataset: ANN 784-300-10 BP, then
   SNN 784-300-10 BP; the kernel's launch count is read around it.
5. real    — kernel against plain at the loop's own delta/min_iter
   (max_iter lowered so the plain Python loop stays short).
6. timing  — the kernel at each cluster size, its plain version and
   its bound, every mode and type; one chunk of real samples.
7. batch pinned — the four batch-step entry points against their plain
   versions at 784-300-10 BP and 851-230-230 BPM, B = 256, S = 8, ANN
   and SNN, float and double; then bitwise: banked step == direct step
   on every block, grid epoch == S banked steps, dbuf epoch == grid
   epoch, grid epoch == itself run again.
8. batch main — ``train_nn --batch 256 --epochs 5`` then ``run_nn`` and
   ``run_nn --batch`` on 4096 + 1024 synthetic MNIST-shaped files: ANN
   and SNN BP; again with ``HPNN_BANK_DBUF=1`` (byte-identical stdout
   and kernel.opt); ANN with ``HPNN_BANK=0`` (per-step launches) equal
   byte for byte to ``HPNN_BANK_REFRESH=1``; ANN with ``--device cpu``
   in float64, the band the card's float32 run is held to.  The
   batch-step launch counts are read around this phase.
9. batch timing — each entry point, its plain version and its bound
   over one epoch of a 60000 x 784 bank in device memory, B = 256, on
   the cooperative grid (the entry points' team) and on one 16-CTA
   cluster (``batch_step._cluster_team``).
10. fleet pinned — the fleet epoch (#6) against its plain version at
   784-300-10 BP and 851-230-230 BPM, 4 members, B = 256, S = 8, ANN
   and SNN, float and double; then bitwise: member i of #6 == #5 and
   #4 on bank i with orders[i], #6 == itself run again, and #6 at
   every cluster size (1, 2, 4, 8, 16 CTAs a member) == #6 planned.
11. fleet main — ``train.fleet.train_fleet`` on 8 members of 784-300-10
   ANN-BP, 4096 synthetic MNIST-shaped rows, B = 256, 8 epochs, with
   the launch counts read around it; bitwise: ``train_sequential`` ==
   the fleet, ``train_fleet_multi`` (2 rounds) == 2 chained
   ``train_fleet`` calls; the same fleet on the CPU in float64 within
   the bands; then the HPNN-sized fleet (64 members of 32-16-4, B = 1,
   30 ticks), one launch a tick against one per member, bitwise equal,
   and one such tick of #6 against its plain version (ANN/SNN x BP/BPM,
   float and double), the weights held to have moved.
12. fleet timing — #6 over one epoch of 8 and of 32 members' 60000-row
   banks at each cluster size, against its plain version (8 members),
   its bound and the members' #5 epochs run one after another; then #6
   planned at 1-32 members against N times one #5 epoch, and the
   least N at which the fleet is the faster.
13. resume, streaming, ledger, obs, native — on phase 4's ANN round
   (256 samples, chunks of 64) and phase 8's batch round: the launch of
   chunk 2 raises and ``HPNN_FUSE_STATE`` resumes (tokens and kernel.opt
   byte-identical to an uninterrupted run), and a batch run stopped
   after epoch 2 of 5 resumes the same way; ``HPNN_FUSE_EPOCH=0``
   launches #1 once a sample with the chunked run's stdout and
   kernel.opt; the per-sample, batch and 8-member fleet rounds in
   float64 on the card and on the CPU, each with ``HPNN_LEDGER`` and
   ``HPNN_TRACE``: ``tools/ledger_diff.py`` exits 0 and the #DBG lines
   agree tag by tag within 1e-12; every obs knob on leaves stdout and
   kernel.opt byte-identical and records ``perf.mfu`` for #1, #4 and #6
   (``tools/check_obs_catalog.py --ledger`` and ``--perf`` pass); the
   native host library parses the 4096-file bank bitwise as the Python
   walk does, both timed, with both rounds' wall times.

The last two lines are the kernel table and the device line.

``--phase-split`` also builds the phase-clock variants
(``-DHPNN_PHASE_CLOCKS``) of the convergence and batch-step kernels,
holds each bitwise against its kernel and prints where an iteration's
time goes in phase 6 and a #4 step's (on each team) in phase 9.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
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
CLUSTERS = (16, 8)    # phase 6: cluster sizes timed
REAL_MAX_ITER = 1500  # phase 5: caps the plain loop's run time
TIMED_ITERS = 200     # phase 6: iterations per sample, pinned
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
# Phases 7-9: the batch path (tutorials/mnist/tutorial.sh --batch).
BATCH, EPOCHS, PINNED_S = 256, 5, 8
N_BATCH_TRAIN, N_BATCH_TEST = 4096, 1024   # the tutorial's 60k / 10k, cut
XRD = (851, 230, 230)                      # the XRD kernel's shape
TIMED_ROWS = 60000                         # one MNIST epoch, in memory
SCALING_B, SCALING_STEPS = (16, 64, 256), 64  # per-step time against B
# Batch kernel vs plain: the same arithmetic, each sum in another order.
# float32 moves ~1e-7 relative per operation: 1e-5 after a step, 1e-4
# after the S = 8 steps of an epoch; float64 within 1e-10.  Losses are
# held relative to max(1, |loss|).
BATCH_TOL = {("float32", "step"): 1e-5, ("float32", "epoch"): 1e-4,
             ("float64", "step"): 1e-10, ("float64", "epoch"): 1e-10}
# The card's float32 main path against the CPU's float64 run of the
# same protocol: losses within 1e-3 relative, counts within
# max(2, 0.5% of n).
BAND_LOSS_REL, BAND_COUNT_REL = 1e-3, 0.005
# Phases 10-12: the fleet path (hpnn_tpu/train/fleet.py, bench.py's fleet).
FLEET_N = 4                                   # phase 10: members
FLEET_MAIN_N, FLEET_EPOCHS, FLEET_ROWS = 8, 8, 4096
# lr of the full-width fleet: the loss falls over all 8 epochs and the
# counts climb from a fraction of the rows, so the count band between the
# card's f32 and the CPU's f64 run can tell two runs apart
FLEET_LR = 0.003
HPNN_FLEET = (64, (32, 16, 4), 30)            # bench.py: members, shape, ticks
FLEET_TIMED_N = (8, 32)                       # phase 12: members timed at every C
FLEET_CROSS_N = (1, 2, 4, 8, 16, 32)          # phase 12: members against sequential #5
EPOCH_RE = re.compile(r"BATCH EPOCH +(\d+) loss= (\S+) acc= +\S+% \((\d+)/(\d+)\)")
BATCH_KERNELS = (
    # entry point, TPU kernel it replaces (pallas_call line), on the main path
    ("train_step_fused_batch", "hpnn_tpu/ops/pallas_train.py:528", True),
    ("train_step_fused_banked", "hpnn_tpu/ops/pallas_train.py:629", False),
    ("train_epoch_grid_banked", "hpnn_tpu/ops/pallas_train.py:733", True),
    ("train_epoch_dbuf_banked", "hpnn_tpu/ops/pallas_train.py:882", True),
)


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


# ------------------------------------------------- convergence plans
def plans_of(convergence, weights, dtype, momentum):
    """Every plan the kernel can take for these weights: each cluster
    size, with the owned weight rows resident where they fit and
    streamed."""
    out = []
    for C in CLUSTERS:
        p = convergence.plan(weights, dtype, momentum, cluster=C)
        out.append(dict(cluster=C))
        if p.weights_resident:
            out.append(dict(cluster=C, weights_resident=False))
    return out


def plan_str(p):
    return (f"{p.cluster} CTAs, W {'shared' if p.weights_resident else 'device'}, dw "
            f"{'shared' if p.dw_resident else 'device'}, {p.smem_bytes} B a CTA")


def same_run(a, b):
    """Two (weights, stats) results equal bitwise."""
    return all(x.equal(y) for x, y in zip(list(a[0]) + list(a[1]), list(b[0]) + list(b[1])))


# ---------------------------------------------------------- batch phases
def state_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def loss_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def batch_bank(np, rng, shape, rows):
    n_in, _, n_out = shape
    X = rng.random((rows, n_in))
    T = -np.ones((rows, n_out))
    T[np.arange(rows), rng.integers(0, n_out, rows)] = 1.0
    return X, T


def batch_pinned(np, torch, dev):
    """Phase 7: each entry point against its plain version, then the
    bitwise agreements.  Returns {entry: {dtype: max error}}."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs

    rng = np.random.default_rng(SEED + 7)
    err = {name: {"float32": 0.0, "float64": 0.0} for name, _, _ in BATCH_KERNELS}

    for shape, momentum in (((N_IN, N_HID, N_OUT), False), (XRD, True)):
        k, _ = km.generate(SEED, shape[0], [shape[1]], shape[2])
        X, T = batch_bank(np, rng, shape, PINNED_S * BATCH)
        dw0 = ([rng.uniform(-1e-3, 1e-3, np.shape(w)) for w in k.weights]
               if momentum else None)
        order = rng.permutation(PINNED_S)
        for model in ("ann", "snn"):
            kw = dict(model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = (f"{model}-{'BPM' if momentum else 'BP'} "
                       f"{'-'.join(map(str, shape))} {dname}")
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    w, dw = km.to_torch(k.weights, dw0, device=dev, dtype=dtype)
                    return list(w), list(dw)

                def steps(fn, w, dw, first, direct):
                    """S single steps in ``order`` (``direct``: each block
                    passed as X/T, else by index); the state after the
                    first goes to ``first``."""
                    out = []
                    for blk in order:
                        if direct:
                            rows = slice(int(blk) * BATCH, (int(blk) + 1) * BATCH)
                            out.append(fn(w, dw, Xd[rows], Td[rows], **kw)[2])
                        else:
                            out.append(fn(w, dw, Xd, Td, int(blk), batch=BATCH, **kw)[2])
                        if len(out) == 1:
                            first.append([t.clone() for t in w + dw] + [out[0].reshape(1)])
                    return torch.stack(out)

                line = []
                for name, _, _ in BATCH_KERNELS:
                    fn, plain = getattr(bs, name), getattr(bs, name + "_plain")
                    (wk, dwk), (wp, dwp) = fresh(), fresh()
                    if "epoch" in name:
                        lk = fn(wk, dwk, Xd, Td, order, batch=BATCH, **kw)[2]
                        lp = plain(wp, dwp, Xd, Td, order, batch=BATCH, **kw)[2]
                    else:
                        fk, fp = [], []
                        direct = name == "train_step_fused_batch"
                        lk = steps(fn, wk, dwk, fk, direct)
                        lp = steps(plain, wp, dwp, fp, direct)
                        fk, fp = fk[0], fp[0]
                        e1 = max(state_err(fk[:-1], fp[:-1]), loss_err(fk[-1], fp[-1]))
                        tol1 = BATCH_TOL[(dname, "step")]
                        check(math.isfinite(e1) and e1 <= tol1,
                              f"{name} {tag}: first step |kernel - plain| {e1:.3e} > {tol1:.0e}")
                    torch.cuda.synchronize()
                    e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                    tol = BATCH_TOL[(dname, "epoch")]
                    check(math.isfinite(e) and e <= tol,
                          f"{name} {tag}: {PINNED_S} steps |kernel - plain| {e:.3e} > {tol:.0e}")
                    err[name][dname] = max(err[name][dname], e)
                    line.append(f"{name.replace('train_', '')} {e:.2e}")
                log(f"[batch-pinned] {tag}, B={BATCH} S={PINNED_S}: max|kernel - plain| "
                    + ", ".join(line))

            # bitwise: one sum order everywhere, whatever the entry point
            Xd = torch.tensor(X, dtype=torch.float32, device=dev)
            Td = torch.tensor(T, dtype=torch.float32, device=dev)
            runs = {}
            for run in ("step", "banked", "grid", "dbuf", "grid again"):
                w, dw = km.to_torch(k.weights, dw0, device=dev, dtype=torch.float32)
                w, dw = list(w), list(dw)
                if run == "step":
                    losses = torch.stack([bs.train_step_fused_batch(
                        w, dw, Xd[int(b) * BATCH:(int(b) + 1) * BATCH],
                        Td[int(b) * BATCH:(int(b) + 1) * BATCH], **kw)[2] for b in order])
                elif run == "banked":
                    losses = torch.stack([bs.train_step_fused_banked(
                        w, dw, Xd, Td, int(b), batch=BATCH, **kw)[2] for b in order])
                else:
                    fn = bs.train_epoch_dbuf_banked if run == "dbuf" else bs.train_epoch_grid_banked
                    losses = fn(w, dw, Xd, Td, order, batch=BATCH, **kw)[2]
                runs[run] = [t.cpu() for t in w + dw] + [losses.cpu()]
            for a, b in (("banked", "step"), ("grid", "banked"), ("dbuf", "grid"),
                         ("grid again", "grid")):
                check(all(torch.equal(x, y) for x, y in zip(runs[a], runs[b])),
                      f"{model} {shape}: {a} differs bitwise from {b}")
            log(f"[batch-pinned] {model}-{'BPM' if momentum else 'BP'} "
                f"{'-'.join(map(str, shape))} float32: banked == step per block, "
                f"grid == {PINNED_S} banked steps, dbuf == grid, grid == grid again (bitwise)")
    return err


def epochs_of(out):
    return [(int(e), float(l), int(ok), int(n)) for e, l, ok, n in EPOCH_RE.findall(out)]


def batch_main(np, torch, protos):
    """Phase 8: the batch path through the CLIs.  Returns (launches by
    entry point over the whole phase, per-run statistics)."""
    from hpnn_tpu_torch.cli import run_nn, train_nn
    from hpnn_tpu_torch.fileio import samples as sample_io
    from hpnn_tpu_torch.ops import batch_step as bs

    # pixels 0-255 unnormalized, as the tutorial's pmnist writes them
    rng = np.random.default_rng(SEED + 1)
    Xtr, Ttr = make_dataset(np, rng, N_BATCH_TRAIN, protos)
    Xte, Tte = make_dataset(np, rng, N_BATCH_TEST, protos)
    Xtr, Xte = np.round(255 * Xtr), np.round(255 * Xte)
    bdir = os.path.join(WORK, "batch")
    write_samples(os.path.join(bdir, "train"), Xtr, Ttr)
    write_samples(os.path.join(bdir, "test"), Xte, Tte)
    t0 = time.perf_counter()
    sample_io.read_dir(os.path.join(bdir, "train"))
    parse_s = time.perf_counter() - t0
    log(f"[batch-main] host parse of the {N_BATCH_TRAIN} training files: {parse_s:.2f} s")
    n_steps = math.ceil(N_BATCH_TRAIN / BATCH)
    runs = (
        # label, type, environment, extra CLI args, expected launches, eval
        ("ANN", "ANN", {}, [], {"train_epoch_grid_banked": EPOCHS}, True),
        ("SNN", "SNN", {}, [], {"train_epoch_grid_banked": EPOCHS}, True),
        ("ANN dbuf", "ANN", {"HPNN_BANK_DBUF": "1"}, [],
         {"train_epoch_dbuf_banked": EPOCHS}, False),
        ("SNN dbuf", "SNN", {"HPNN_BANK_DBUF": "1"}, [],
         {"train_epoch_dbuf_banked": EPOCHS}, False),
        ("ANN bank0", "ANN", {"HPNN_BANK": "0"}, [],
         {"train_step_fused_batch": EPOCHS * n_steps}, False),
        ("ANN refresh1", "ANN", {"HPNN_BANK_REFRESH": "1"}, [],
         {"train_epoch_grid_banked": EPOCHS}, False),
        ("ANN cpu f64", "ANN", {}, ["--device", "cpu"], {}, False),
    )
    cwd = os.getcwd()
    got, stats = {}, {}
    for name in bs.launches:
        bs.launches[name] = 0
    try:
        for label, kind, env, extra, expect, with_eval in runs:
            run_dir = os.path.join(bdir, label.replace(" ", "_").lower())
            os.makedirs(run_dir)
            os.chdir(run_dir)
            write_conf("nn.conf", name=f"batch_{kind.lower()}", kind=kind,
                       train_dir="../train", test_dir="../test")
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            before = dict(bs.launches)
            try:
                rc, out, secs = run_cli(train_nn.main, extra + [
                    "--batch", str(BATCH), "--epochs", str(EPOCHS), "-v", "-v", "nn.conf"])
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            check(rc == 0, f"{label}: train_nn --batch exit {rc}")
            launched = {k: bs.launches[k] - before[k] for k in bs.launches}
            check(launched == {k: expect.get(k, 0) for k in bs.launches},
                  f"{label}: launches {launched}, expected {expect}")
            ep = epochs_of(out)
            check(len(ep) == EPOCHS and all(e[3] == N_BATCH_TRAIN for e in ep),
                  f"{label}: {len(ep)} BATCH EPOCH lines")
            check(all(math.isfinite(e[1]) for e in ep), f"{label}: loss not finite")
            with open("kernel.opt") as fp:
                opt = fp.read()
            got[label] = (out, opt, ep)
            st = dict(seconds=secs, samples_per_s=N_BATCH_TRAIN * EPOCHS / secs,
                      launches=launched, losses=[e[1] for e in ep],
                      counts=[e[2] for e in ep])
            msg = (f"[batch-main] {label} 784-300-10 BP --batch {BATCH} --epochs {EPOCHS}: "
                   f"{secs:.2f} s ({N_BATCH_TRAIN * EPOCHS / secs:.0f} samples/s with the "
                   f"parse), loss {ep[0][1]:.6f} -> {ep[-1][1]:.6f}, acc {ep[0][2]} -> "
                   f"{ep[-1][2]}/{N_BATCH_TRAIN}, launches "
                   f"{ {k: v for k, v in launched.items() if v} }")
            if with_eval:
                check(ep[-1][1] < ep[0][1], f"{label}: last loss not below the first")
                write_conf("cont.conf", name=f"batch_{kind.lower()}", kind=kind,
                           train_dir="../train", test_dir="../test", init="kernel.opt")
                rc, eout, esecs = run_cli(run_nn.main, extra + ["-v", "-v", "cont.conf"])
                check(rc == 0, f"{label}: run_nn exit {rc}")
                rc, bout, bsecs = run_cli(run_nn.main, extra + ["--batch", "-v", "-v",
                                                                "cont.conf"])
                check(rc == 0, f"{label}: run_nn --batch exit {rc}")
                for what, o in (("run_nn", eout), ("run_nn --batch", bout)):
                    check(o.count("TESTING FILE") == N_BATCH_TEST, f"{label} {what}: eval lines")
                p1, p2 = eout.count("[PASS]"), bout.count("[PASS]")
                check(abs(p1 - p2) <= max(2, BAND_COUNT_REL * N_BATCH_TEST),
                      f"{label}: run_nn PASS {p1} vs run_nn --batch PASS {p2}")
                st.update(run_nn_pass=p1, run_nn_batch_pass=p2, run_nn_s=esecs,
                          run_nn_batch_s=bsecs)
                msg += (f"; run_nn PASS {p1}/{N_BATCH_TEST} in {esecs:.2f} s, "
                        f"run_nn --batch PASS {p2}/{N_BATCH_TEST} in {bsecs:.2f} s")
            stats[label] = st
            log(msg)
            os.chdir(bdir)
    finally:
        os.chdir(cwd)
    main_launches = dict(bs.launches)
    for a, b in (("ANN dbuf", "ANN"), ("SNN dbuf", "SNN"), ("ANN bank0", "ANN refresh1")):
        check(got[a][0] == got[b][0], f"{a} stdout differs from {b}")
        check(got[a][1] == got[b][1], f"{a} kernel.opt differs from {b}")
        log(f"[batch-main] {a} == {b}: stdout and kernel.opt byte-identical")
    card, cpu = got["ANN"][2], got["ANN cpu f64"][2]
    for (e, lc, okc, n), (_, lh, okh, _) in zip(card, cpu):
        check(abs(lc - lh) <= BAND_LOSS_REL * abs(lh),
              f"epoch {e}: card f32 loss {lc} vs cpu f64 {lh}")
        check(abs(okc - okh) <= max(2, BAND_COUNT_REL * n),
              f"epoch {e}: card f32 count {okc} vs cpu f64 {okh}")
    rel = max(abs(c[1] - h[1]) / abs(h[1]) for c, h in zip(card, cpu))
    dok = max(abs(c[2] - h[2]) for c, h in zip(card, cpu))
    log(f"[batch-main] ANN card f32 vs cpu f64: max loss rel diff {rel:.3e} "
        f"(band {BAND_LOSS_REL:.0e}), max count diff {dok} (band "
        f"max(2, {BAND_COUNT_REL:.1%} of {N_BATCH_TRAIN}))")
    stats["band"] = dict(max_loss_rel=rel, max_count_diff=dok, parse_s=parse_s)
    return main_launches, stats


def batch_timing(np, torch, dev, phase_split=False):
    """Phase 9: each entry point over one epoch of a 60000-row bank at
    784-300-10 ANN-BP float32, its plain version, and the bound; with
    ``phase_split``, where a #4 step's time goes on each team."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms
    from hpnn_tpu_torch.ops import batch_step as bs

    S = math.ceil(TIMED_ROWS / BATCH)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    X = torch.rand((TIMED_ROWS, N_IN), generator=g, device=dev)
    labels = torch.randint(0, N_OUT, (TIMED_ROWS,), generator=g, device=dev)
    T = -torch.ones((TIMED_ROWS, N_OUT), device=dev)
    T[torch.arange(TIMED_ROWS, device=dev), labels] = 1.0
    # the epoch's permuted bank, its tail wrapped as train_kernel_batched does
    perm = np.resize(np.random.RandomState(SEED).permutation(TIMED_ROWS), S * BATCH)
    perm = torch.from_numpy(perm).to(dev)
    Xp, Tp = X[perm], T[perm]
    del X, T
    order = np.random.RandomState(SEED + 1).permutation(S)
    k, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    w = list(km.to_torch(k.weights, device=dev, dtype=torch.float32)[0])
    kw = dict(model="ann", momentum=False)

    def rows(b):
        return slice(int(b) * BATCH, (int(b) + 1) * BATCH)

    def on_team(c, fn):
        """``fn`` on the grid (c = 0) or on one cluster of c CTAs."""
        def run():
            with bs._cluster_team(c) if c else contextlib.nullcontext():
                return fn()
        return run

    entry_fns = {
        "train_step_fused_batch": lambda: [bs.train_step_fused_batch(
            w, [], Xp[rows(b)], Tp[rows(b)], **kw) for b in order],
        "train_step_fused_banked": lambda: [bs.train_step_fused_banked(
            w, [], Xp, Tp, int(b), batch=BATCH, **kw) for b in order],
        "train_epoch_grid_banked": lambda: bs.train_epoch_grid_banked(
            w, [], Xp, Tp, order, batch=BATCH, **kw),
        "train_epoch_dbuf_banked": lambda: bs.train_epoch_dbuf_banked(
            w, [], Xp, Tp, order, batch=BATCH, **kw),
    }

    # the entry points' team, the grid (0), and the other: one 16-CTA cluster
    teams = (0, 16)
    fns = {(name, c): on_team(c, fn) for c in teams for name, fn in entry_fns.items()}
    times = {key: [] for key in fns}
    for turn in range(2):  # in turns, the second in the reverse order
        for key in (list(fns) if turn == 0 else list(fns)[::-1]):
            times[key].append(cuda_ms(torch, fns[key]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs.train_epoch_grid_banked_plain(w, [], Xp, Tp, order, batch=BATCH, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.isfinite(t).all() for t in w), "timing: weights not finite")
    nbytes, flops = batch_work([tuple(t.shape) for t in w], S, False, 4, BATCH)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")

    def team_name(c):
        return f"one {c}-CTA cluster" if c else "the grid"

    out = {}
    for name, _, _ in BATCH_KERNELS:
        ts, other = times[(name, teams[0])], times[(name, teams[1])]
        ms, other_ms = statistics.median(ts), statistics.median(other)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         runs_ms=ts, us_per_step=ms / S * 1e3, team=team_name(teams[0]),
                         other_team=team_name(teams[1]), other_team_ms=other_ms,
                         other_team_runs_ms=other)
        log(f"[batch-timing] {name}: one epoch of {S} steps, B={BATCH}, "
            f"{TIMED_ROWS}-row bank, ANN-BP 784-300-10 float32: {ms:.3f} ms on "
            f"{team_name(teams[0])} ({ms / S * 1e3:.2f} us/step; runs "
            f"{', '.join(f'{t:.3f}' for t in ts)}); {other_ms:.3f} ms on "
            f"{team_name(teams[1])} (runs {', '.join(f'{t:.3f}' for t in other)})")
    log(f"[batch-timing] plain epoch {plain_ms:.1f} ms; bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B, {flops} flop; {b_ms / S * 1e3:.2f} us/step)")
    if phase_split:
        # the phase-clock build on the same inputs (bitwise the kernel's),
        # its cycles shared out over the measured time of a step
        for c in teams:
            def epoch(wc, c=c):
                return on_team(c, lambda: bs.train_epoch_grid_banked(
                    wc, [], Xp, Tp, order, batch=BATCH, **kw)[2])()

            wa, wb = [t.clone() for t in w], [t.clone() for t in w]
            la, clocks = bs.phase_clocks(lambda: epoch(wa))
            lb = epoch(wb)
            check(all(torch.equal(a, b) for a, b in zip([la] + wa, [lb] + wb)),
                  f"the batch-step phase-clock build differs bitwise on {team_name(c)}")
            ms = statistics.median(times[("train_epoch_grid_banked", c)])
            cyc = sum(clocks.values())
            split = {k: v / cyc * ms / S * 1e3 for k, v in clocks.items() if v}
            out["train_epoch_grid_banked"].setdefault("split_us_per_step", {})[team_name(c)] = split
            log(f"[batch-timing] #4 on {team_name(c)}: us/step by phase (rank 0's thread 0, "
                f"sync waits included): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    # where a step's time goes: the grid epoch's time per step against
    # the rows per step (SCALING_STEPS leading blocks of the bank)
    scaling = {}
    for b in SCALING_B:
        ms = cuda_ms(torch, lambda: bs.train_epoch_grid_banked(
            w, [], Xp, Tp, np.arange(SCALING_STEPS), batch=b, **kw))
        scaling[b] = ms / SCALING_STEPS * 1e3
    log("[batch-timing] grid epoch, us per step by rows per step: "
        + ", ".join(f"B={b} {us:.2f}" for b, us in scaling.items()))
    return out


# ---------------------------------------------------------- fleet phases
def fleet_pinned(np, torch, dev):
    """Phase 10: the fleet epoch (#6) against its plain version, then
    the bitwise agreements with #5 and #4.  Returns {dtype: max error}."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs

    rng = np.random.default_rng(SEED + 10)
    err = {"float32": 0.0, "float64": 0.0}
    for shape, momentum in (((N_IN, N_HID, N_OUT), False), (XRD, True)):
        ks = [km.generate(SEED + i, shape[0], [shape[1]], shape[2])[0] for i in range(FLEET_N)]
        W = [np.stack([k.weights[l] for k in ks]) for l in range(2)]
        dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W] if momentum else None
        banks = [batch_bank(np, rng, shape, PINNED_S * BATCH) for _ in range(FLEET_N)]
        orders = np.stack([rng.permutation(PINNED_S) for _ in range(FLEET_N)])
        for model in ("ann", "snn"):
            kw = dict(batch=BATCH, model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = (f"{model}-{'BPM' if momentum else 'BP'} "
                       f"{'-'.join(map(str, shape))} {dname}")
                Xd = torch.tensor(np.stack([x for x, _ in banks]), dtype=dtype, device=dev)
                Td = torch.tensor(np.stack([t for _, t in banks]), dtype=dtype, device=dev)

                def fresh():
                    w, dw = km.to_torch(W, dW, device=dev, dtype=dtype)
                    return list(w), list(dw)

                (wk, dwk), (wp, dwp), (w2, dw2), (w0, dw0) = fresh(), fresh(), fresh(), fresh()
                lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
                lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
                torch.cuda.synchronize()
                e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                tol = BATCH_TOL[(dname, "epoch")]
                check(math.isfinite(e) and e <= tol,
                      f"fleet {tag}: {PINNED_S} steps |kernel - plain| {e:.3e} > {tol:.0e}")
                err[dname] = max(err[dname], e)
                # bitwise: #6 again, and each member's #5 and #4 epochs
                l2 = bs.train_fleet_epoch_dbuf_banked(w2, dw2, Xd, Td, orders, **kw)[2]
                check(all(torch.equal(a, b) for a, b in zip(wk + dwk + [lk], w2 + dw2 + [l2])),
                      f"fleet {tag}: #6 run again differs bitwise")
                for C in bs.CLUSTER_SIZES:
                    wc, dwc = fresh()
                    lc = bs.train_fleet_epoch_dbuf_banked(wc, dwc, Xd, Td, orders, cluster=C,
                                                          **kw)[2]
                    check(all(torch.equal(a, b) for a, b in zip(wk + dwk + [lk], wc + dwc + [lc])),
                          f"fleet {tag}: #6 at {C} CTAs a member differs bitwise from the plan's")
                for i in range(FLEET_N):
                    for fn in (bs.train_epoch_dbuf_banked, bs.train_epoch_grid_banked):
                        wi, dwi = [t[i].clone() for t in w0], [t[i].clone() for t in dw0]
                        li = fn(wi, dwi, Xd[i], Td[i], orders[i], **kw)[2]
                        check(torch.equal(li, lk[i])
                              and all(torch.equal(a, b[i]) for a, b in zip(wi + dwi, wk + dwk)),
                              f"fleet {tag}: member {i} differs bitwise from {fn.__name__}")
                plan = bs.fleet_cluster(FLEET_N, [tuple(t.shape[1:]) for t in wk], BATCH,
                                        bs.cluster_capacity(dtype, dev))
                log(f"[fleet-pinned] {tag}, N={FLEET_N} B={BATCH} S={PINNED_S}: "
                    f"max|kernel - plain| {e:.2e} (tol {tol:.0e}); member i == #5 == #4 "
                    f"on bank i, #6 == #6 again, #6 at C = "
                    f"{', '.join(map(str, bs.CLUSTER_SIZES))} == #6 planned (C={plan}) (bitwise)")
    return err


def fleet_main(np, torch, dev, protos):
    """Phase 11: the fleet path through ``train.fleet``.  Returns
    (launches by entry point over the whole phase, statistics)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.train import fleet

    rng = np.random.default_rng(SEED + 11)
    X, T = make_dataset(np, rng, FLEET_ROWS, protos)
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(FLEET_MAIN_N)]
    N, E, S = FLEET_MAIN_N, FLEET_EPOCHS, FLEET_ROWS // BATCH
    seeds = list(range(N))
    kw = dict(epochs=E, batch=BATCH, lr=FLEET_LR)
    stats = {}

    def run(label, fn, expect):
        before = dict(bs.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: bs.launches[k] - before[k] for k in bs.launches
                    if bs.launches[k] != before[k]}
        check(launched == expect, f"fleet {label}: launches {launched}, expected {expect}")
        stats[label] = dict(seconds=secs, launches=launched)
        return res

    def same(a, b):
        return (all(np.array_equal(x, y) for ka, kb in zip(a[0], b[0])
                    for x, y in zip(ka.weights, kb.weights))
                and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))

    for name in bs.launches:
        bs.launches[name] = 0
    fl = run("fleet", lambda: fleet.train_fleet(ks, X, T, seeds=seeds, **kw),
             {"train_fleet_epoch_dbuf_banked": E})
    _, losses, counts = fl
    check(losses.shape == (N, E, S) and counts.shape == (N, E), "fleet: result shapes")
    check(np.isfinite(losses).all(), "fleet: loss not finite")
    by_epoch = losses.mean(axis=2)              # (N, E)
    check((by_epoch[:, -1] < by_epoch[:, 0]).all(), "fleet: a member's loss did not fall")
    check(counts[:, 0].max() < FLEET_ROWS,
          "fleet: a member counted every row after one epoch, so counts cannot tell runs apart")
    log(f"[fleet-main] train_fleet {N} x 784-300-10 ANN-BP, {FLEET_ROWS} rows, B={BATCH}, "
        f"{E} epochs, lr {FLEET_LR}: {stats['fleet']['seconds']:.2f} s, mean loss "
        f"{by_epoch[:, 0].mean():.6f} -> {by_epoch[:, -1].mean():.6f}, count "
        f"{counts[:, 0].min()}..{counts[:, 0].max()} -> {counts[:, -1].min()}.."
        f"{counts[:, -1].max()}/{FLEET_ROWS}, launches {stats['fleet']['launches']}")
    sq = run("sequential", lambda: fleet.train_sequential(ks, X, T, seeds=seeds, **kw),
             {"train_epoch_grid_banked": N * E})
    check(same(fl, sq), "train_sequential differs bitwise from train_fleet")
    mr = run("multi K=2", lambda: fleet.train_fleet_multi(ks, X, T, rounds=2, **kw),
             {"train_fleet_epoch_dbuf_banked": 2 * E})
    # round 0 of the default seed_rounds is the fleet run above
    r1 = run("round 2 of 2 chained", lambda: fleet.train_fleet(
        fl[0], X, T, seeds=list(range(N, 2 * N)), **kw), {"train_fleet_epoch_dbuf_banked": E})
    check(same((mr[0], mr[1][:, 1], mr[2][:, 1]), r1)
          and np.array_equal(mr[1][:, 0], fl[1]) and np.array_equal(mr[2][:, 0], fl[2]),
          "train_fleet_multi (2 rounds) differs bitwise from 2 chained train_fleet calls")
    log(f"[fleet-main] bitwise: train_sequential == train_fleet ({stats['sequential']['seconds']:.2f} s, "
        f"{N * E} launches of #4); train_fleet_multi 2 rounds == 2 chained train_fleet "
        f"({stats['multi K=2']['seconds']:.2f} s)")
    cpu = run("cpu f64", lambda: fleet.train_fleet(ks, X, T, seeds=seeds, device="cpu", **kw), {})
    rel = float(np.max(np.abs(fl[1] - cpu[1]) / np.abs(cpu[1])))
    dok = int(np.max(np.abs(fl[2].astype(np.int64) - cpu[2])))
    check(rel <= BAND_LOSS_REL, f"fleet card f32 vs cpu f64: loss rel diff {rel:.3e}")
    check(dok <= max(2, BAND_COUNT_REL * FLEET_ROWS), f"fleet card f32 vs cpu f64: count diff {dok}")
    stats["band"] = dict(max_loss_rel=rel, max_count_diff=dok)
    log(f"[fleet-main] card f32 vs cpu f64 ({stats['cpu f64']['seconds']:.2f} s): max loss rel "
        f"diff {rel:.3e} over every member, epoch and step (band {BAND_LOSS_REL:.0e}), "
        f"max count diff {dok}")

    # the HPNN-sized fleet of bench.py: one new sample per member and tick
    n_m, (hi, hh, ho), ticks = HPNN_FLEET
    hks = [km.generate(1000 + i, hi, [hh], ho)[0] for i in range(n_m)]
    Xh = torch.tensor(rng.normal(size=(1, hi)), dtype=torch.float32, device=dev)
    Th = -torch.ones((1, ho), dtype=torch.float32, device=dev)
    Th[0, int(rng.integers(0, ho))] = 1.0
    fperms, forders = fleet.fleet_plan(range(n_m), n_rows=1, batch=1, epochs=1)
    plans = [fleet.member_plan(i, n_rows=1, batch=1, epochs=1) for i in range(n_m)]
    fleet_fn = fleet.make_fleet_epoch_fn(1, count=False)
    member_fn = fleet.make_member_epoch_fn(1, count=False)
    stacked = fleet.stack_kernels(hks, dtype=torch.float32)
    members = [km.to_torch(k.weights, device=dev, dtype=torch.float32)[0] for k in hks]

    def fleet_ticks():
        for _ in range(ticks):
            fleet_fn(stacked, (), Xh, Th, fperms, forders)

    def sequential_ticks():
        for _ in range(ticks):
            for w, (p, o) in zip(members, plans):
                member_fn(w, (), Xh, Th, p, o)

    tick = {}
    for label, fn, expect in (
            ("hpnn fleet", fleet_ticks, {"train_fleet_epoch_dbuf_banked": ticks}),
            ("hpnn sequential", sequential_ticks, {"train_epoch_grid_banked": n_m * ticks}),
            ("hpnn fleet again", fleet_ticks, {"train_fleet_epoch_dbuf_banked": ticks}),
            ("hpnn sequential again", sequential_ticks, {"train_epoch_grid_banked": n_m * ticks})):
        run(label, fn, expect)
        tick[label] = stats[label]["seconds"] / ticks * 1e3
    check(all(torch.equal(s[i], w) for i, ws in enumerate(members) for s, w in zip(stacked, ws)),
          "HPNN-sized fleet differs bitwise from its members run one by one")
    check(not any(torch.equal(s[i], torch.tensor(w, dtype=torch.float32, device=dev))
                  for i, k in enumerate(hks) for s, w in zip(stacked, k.weights)),
          f"HPNN-sized fleet: a member's layer did not move in {2 * ticks} ticks")
    stats["hpnn_ms_per_tick"] = tick
    log(f"[fleet-main] HPNN-sized fleet, {n_m} x {hi}-{hh}-{ho} ANN-BP, B=1, {ticks} ticks x2, "
        f"bitwise equal, every layer of every member moved: fleet {tick['hpnn fleet']:.3f} / "
        f"{tick['hpnn fleet again']:.3f} ms a tick (1 launch), sequential "
        f"{tick['hpnn sequential']:.3f} / {tick['hpnn sequential again']:.3f} ms a tick "
        f"({n_m} launches)")
    path_launches = dict(bs.launches)
    stats["hpnn_vs_plain"] = hpnn_tick_vs_plain(np, torch, dev, rng, hks)
    return path_launches, stats


def hpnn_tick_vs_plain(np, torch, dev, rng, hks):
    """#6 against its plain version on one tick of the HPNN-sized fleet
    (B = 1, S = 1: one row a step, one-row tiles, the loss warp over one
    row), ANN/SNN x BP/BPM, float and double, on the same stacked
    weights, banks and orders; the kernel's weights must have moved.
    Returns {dtype: max error}."""
    from hpnn_tpu_torch.ops import batch_step as bs

    n_m = len(hks)
    (n_hid, n_in), (n_out, _) = (w.shape for w in hks[0].weights)
    W = [np.stack([k.weights[l] for k in hks]) for l in range(2)]
    dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W]
    X = rng.normal(size=(n_m, 1, n_in))
    T = -np.ones((n_m, 1, n_out))
    T[np.arange(n_m), 0, rng.integers(0, n_out, n_m)] = 1.0
    orders = np.zeros((n_m, 1), dtype=np.int64)
    err = {"float32": 0.0, "float64": 0.0}
    for model in ("ann", "snn"):
        for momentum in (False, True):
            kw = dict(batch=1, model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    return ([torch.tensor(w, dtype=dtype, device=dev) for w in W],
                            [torch.tensor(m, dtype=dtype, device=dev) for m in dW]
                            if momentum else [])

                (w0, dw0), (wk, dwk), (wp, dwp) = fresh(), fresh(), fresh()
                lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
                lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
                torch.cuda.synchronize()
                e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                tol = BATCH_TOL[(dname, "step")]
                check(math.isfinite(e) and e <= tol,
                      f"HPNN-sized tick {tag}: |kernel - plain| {e:.3e} > {tol:.0e}")
                check(all(not torch.equal(a[i], b[i]) for a, b in zip(wk + dwk, w0 + dw0)
                          for i in range(n_m)),
                      f"HPNN-sized tick {tag}: the kernel left a member's state unchanged")
                err[dname] = max(err[dname], e)
    log(f"[fleet-main] HPNN-sized tick, #6 vs plain, N={n_m} B=1 S=1, ANN/SNN x BP/BPM: "
        f"max|kernel - plain| f32 {err['float32']:.2e} (tol {BATCH_TOL[('float32', 'step')]:.0e}), "
        f"f64 {err['float64']:.2e} (tol {BATCH_TOL[('float64', 'step')]:.0e}); every member's "
        f"weights (and dw) moved")
    return err


def fleet_timing(np, torch, dev):
    """Phase 12: #6 over one epoch of each member's 60000-row bank,
    ANN-BP 784-300-10 float32, for FLEET_TIMED_N members at every
    cluster size; against its plain version (the first N), its bound and
    the members' #5 epochs one after another.  Then #6 as planned for
    FLEET_CROSS_N members against N times one #5 epoch.  Returns
    ({N: timings}, crossover)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms
    from hpnn_tpu_torch.ops import batch_step as bs

    S = math.ceil(TIMED_ROWS / BATCH)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    X = torch.rand((TIMED_ROWS, N_IN), generator=g, device=dev)
    labels = torch.randint(0, N_OUT, (TIMED_ROWS,), generator=g, device=dev)
    T = -torch.ones((TIMED_ROWS, N_OUT), device=dev)
    T[torch.arange(TIMED_ROWS, device=dev), labels] = 1.0
    n_max = max(FLEET_TIMED_N + FLEET_CROSS_N)
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(n_max)]
    kw = dict(batch=BATCH, model="ann", momentum=False)
    cap = bs.cluster_capacity(torch.float32, dev)
    log(f"[fleet-timing] clusters the card holds at once, by CTAs a cluster: "
        + ", ".join(f"{C}: {n}" for C, n in cap.items()))
    # each member's permuted bank, its tail wrapped as train_kernel_batched
    # does; the first N members' banks are a leading slice
    perm = np.stack([np.resize(np.random.RandomState(SEED + i).permutation(TIMED_ROWS),
                               S * BATCH) for i in range(n_max)])
    idx = torch.from_numpy(perm).to(dev)
    Xb_all, Tb_all = X[idx], T[idx]
    del idx, X, T
    orders_all = np.stack([np.random.RandomState(SEED + 100 + i).permutation(S)
                           for i in range(n_max)])
    W_all = [torch.tensor(np.stack([k.weights[l] for k in ks]), dtype=torch.float32,
                          device=dev) for l in range(2)]
    shapes = [tuple(t.shape[1:]) for t in W_all]

    def fleet_fn(W, N, C):
        return lambda: bs.train_fleet_epoch_dbuf_banked(
            W, [], Xb_all[:N], Tb_all[:N], orders_all[:N], cluster=C, **kw)

    out = {}
    for N in FLEET_TIMED_N:
        W = [t[:N].clone() for t in W_all]
        members = [[t[i].clone() for t in W] for i in range(N)]
        plan = bs.fleet_cluster(N, shapes, BATCH, cap)
        fns = {C: fleet_fn(W, N, C) for C in bs.CLUSTER_SIZES}
        runs, seq = {C: [] for C in fns}, []
        for turn in range(2):  # in turns, the second in the reverse order
            for C in (list(fns) if turn == 0 else list(fns)[::-1]):
                runs[C].append(cuda_ms(torch, fns[C]))
            seq.append(cuda_ms(torch, lambda: [bs.train_epoch_dbuf_banked(
                members[i], [], Xb_all[i], Tb_all[i], orders_all[i], **kw) for i in range(N)]))
        by_c = {C: statistics.median(v) for C, v in runs.items()}
        ms, seq_ms = by_c[plan], statistics.median(seq)
        nbytes, flops = batch_work(shapes, S, False, 4, BATCH)
        b_ms, b_by = bound_ms(N * nbytes, N * flops, "float32")
        plain_ms = None
        if N == FLEET_TIMED_N[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs.train_fleet_epoch_dbuf_banked_plain(W, [], Xb_all[:N], Tb_all[:N],
                                                   orders_all[:N], **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(t).all() for t in W), "fleet timing: weights not finite")
        out[N] = dict(ms=ms, cluster=plan, ms_by_cluster=by_c, runs_by_cluster=runs,
                      sequential_dbuf_ms=seq_ms, sequential_runs_ms=seq, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, ms_per_step=ms / S,
                      bank_bytes=(Xb_all[:N].numel() + Tb_all[:N].numel()) * 4)
        log(f"[fleet-timing] #6, {N} members x one epoch of {S} steps, B={BATCH}, "
            f"{TIMED_ROWS}-row banks ({out[N]['bank_bytes'] / 1e9:.2f} GB), ANN-BP 784-300-10 "
            f"float32, by CTAs a member: "
            + ", ".join(f"C={C} {v:.3f} ms (runs {', '.join(f'{t:.3f}' for t in runs[C])})"
                        for C, v in by_c.items())
            + f"; planned C={plan}: {ms:.3f} ms ({ms / S:.4f} ms/step); {N} sequential #5 "
            f"epochs {seq_ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in seq)}); bound "
            f"{b_ms:.4f} ms ({b_by})"
            + (f"; plain {plain_ms:.1f} ms" if plain_ms is not None else ""))
        del W, members
    # where the fleet overtakes its members' #5 epochs one after another
    one = [t[0].clone() for t in W_all]
    t5 = statistics.median(cuda_ms(torch, lambda: bs.train_epoch_dbuf_banked(
        one, [], Xb_all[0], Tb_all[0], orders_all[0], **kw)) for _ in range(2))
    cross = {}
    for N in FLEET_CROSS_N:
        plan = bs.fleet_cluster(N, shapes, BATCH, cap)
        f_ms = (out[N]["ms"] if N in out else
                cuda_ms(torch, fleet_fn([t[:N].clone() for t in W_all], N, None)))
        cross[N] = dict(cluster=plan, fleet_ms=f_ms, sequential_ms=N * t5)
    faster = [N for N in FLEET_CROSS_N if cross[N]["fleet_ms"] < cross[N]["sequential_ms"]]
    overtakes = next((N for N in FLEET_CROSS_N
                      if all(M in faster for M in FLEET_CROSS_N if M >= N)), None)
    log(f"[fleet-timing] #6 planned against N x one #5 epoch ({t5:.3f} ms): "
        + ", ".join(f"N={N} (C={c['cluster']}) {c['fleet_ms']:.3f} vs {c['sequential_ms']:.3f} ms"
                    for N, c in cross.items())
        + f"; the fleet is the faster from N = {overtakes} on")
    del Xb_all, Tb_all, W_all
    torch.cuda.empty_cache()
    return out, dict(dbuf_epoch_ms=t5, by_members=cross, overtakes_at=overtakes,
                     clusters_at_once=cap)


# ------------------------------------------- crash-resume, streaming, obs
# Phase 13: the reference's cross-backend bars (ChangeLog:33-38), on the
# #DBG trace as tools/ledger_diff.py holds the ledger to them
VEC_TOL, MAT_TOL = 1e-14, 1e-12
DBG_RE = re.compile(r"#DBG: acc\[(.+)/(\d+)\]=(\S+)")


@contextlib.contextmanager
def knobs(obs, env):
    """``env`` set for the block, the port's memoized obs readings
    forgotten on the way in and out."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    obs.reset()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs.reset()


def training_lines(out):
    return [ln for ln in out.splitlines() if "TRAINING FILE" in ln]


def traces_agree(got, ref):
    """(ok, max |diff|, lines): the #DBG lines tag by tag, each value
    within the reference's bar (weights are matrices, eval outputs
    vectors)."""
    a = [(m.group(1), int(m.group(2)), float(m.group(3))) for m in DBG_RE.finditer(got)]
    b = [(m.group(1), int(m.group(2)), float(m.group(3))) for m in DBG_RE.finditer(ref)]
    if not a or [x[:2] for x in a] != [x[:2] for x in b]:
        return False, math.inf, len(a)
    worst, ok = 0.0, True
    for (tag, _, va), (_, _, vb) in zip(a, b):
        tol = VEC_TOL if tag.startswith("out@") else MAT_TOL
        worst = max(worst, abs(va - vb))
        ok = ok and abs(va - vb) <= tol
    return ok, worst, len(a)


def ledger_diff(a, b):
    """tools/ledger_diff.py at its default bars: (exit code, report)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ledger_diff.py"),
                          a, b], capture_output=True, text=True, timeout=120)
    return out.returncode, (out.stdout + out.stderr).strip()


def ledger_rel_dev(a, b):
    """Max relative deviation of ledger ``a``'s checksums from ``b``'s,
    row by row."""
    rows = [[json.loads(ln) for ln in open(p) if '"ledger.round"' in ln] for p in (a, b)]
    check(len(rows[0]) == len(rows[1]) > 0, f"ledgers {a} and {b}: row counts differ")
    return max(abs(ra["checksums"][k] - rb["checksums"][k]) / abs(rb["checksums"][k])
               for ra, rb in zip(*rows) for k in rb["checksums"])


def resume_obs_native(np, torch, dev, protos):
    """Phase 13: crash-resume (per-sample and batch), the streaming
    per-sample loop, the card's float64 ledger and #DBG trace against
    the CPU's (per-sample, batch, fleet), obs leaving the tokens alone
    with its MFU records, and the native parse.  Returns statistics."""
    from hpnn_tpu_torch import native, obs
    from hpnn_tpu_torch.cli import train_nn
    from hpnn_tpu_torch.fileio import samples as sample_io
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.ops import convergence
    from hpnn_tpu_torch.parallel import dp
    from hpnn_tpu_torch.train import batch, driver, fleet, loop

    sdir = os.path.join(WORK, "resume_obs")
    os.makedirs(sdir)
    ps_dir, b_dir = os.path.join(WORK, "train"), os.path.join(WORK, "batch", "train")
    cwd = os.getcwd()
    stats = {}

    def cli(label, argv, env=(), raises=None):
        """train_nn in its own directory: (stdout, kernel.opt text or
        None, seconds, the directory).  ``raises``: the exception the
        run must end with (its stdout is still returned)."""
        run_dir = os.path.join(sdir, label)
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        try:
            write_conf("nn.conf", name="smoke_ann", kind="ANN",
                       train_dir=b_dir if "--batch" in argv else ps_dir, test_dir=ps_dir)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with knobs(obs, dict(env)), contextlib.redirect_stdout(buf):
                try:
                    rc = train_nn.main(argv + ["-v", "-v", "nn.conf"])
                except Exception as exc:  # the deliberate launch error only
                    check(raises is not None and isinstance(exc, raises),
                          f"{label}: train_nn raised {exc!r}")
                    rc = None
            secs = time.perf_counter() - t0
            check(raises is None or rc is None, f"{label}: the launch error did not surface")
            check(raises is not None or rc == 0, f"{label}: train_nn exit {rc}")
            opt = open("kernel.opt").read() if rc == 0 else None
            return buf.getvalue(), opt, secs, run_dir
        finally:
            os.chdir(cwd)

    # 1. resume: the launch of chunk 2 raises; the rerun resumes
    out_a, opt_a, secs_a, _ = cli("chunked", [])
    check(len(training_lines(out_a)) == N_TRAIN_ANN, "chunked: token lines")
    state = os.path.join(sdir, "round.state")
    real_epoch, calls = loop.train_epoch, [0]

    def dying_epoch(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("the launch of chunk 2 raised (deliberately)")
        return real_epoch(*a, **kw)

    loop.train_epoch = dying_epoch
    try:
        part1, _, _, _ = cli("crashed", [], {"HPNN_FUSE_STATE": state}, raises=RuntimeError)
    finally:
        loop.train_epoch = real_epoch
    with np.load(state, allow_pickle=False) as z:
        done, hint = int(z["done"]), int(z["chunk"])
    want_hint = max(min(32, CHUNK), CHUNK // 2)  # halved, not below 32
    check((done, hint) == (CHUNK, want_hint),
          f"crash checkpoint: done {done}, chunk {hint} (want {CHUNK}, {want_hint})")
    part2, opt_r, _, _ = cli("resumed", [], {"HPNN_FUSE_STATE": state})
    check(training_lines(part1 + part2) == training_lines(out_a),
          "resume: the two attempts' tokens differ from the uninterrupted run's")
    check(opt_r == opt_a, "resume: kernel.opt differs from the uninterrupted run's")
    check(not os.path.exists(state), "resume: the completed round left its checkpoint")
    log(f"[resume] ANN 784-300-10 BP, {N_TRAIN_ANN} samples in chunks of {CHUNK}: chunk 2's "
        f"launch raised after {done} samples (checkpoint chunk hint {hint}); the resumed "
        f"round's tokens ({len(training_lines(part2))} lines) after the crashed one's "
        f"({len(training_lines(part1))}) and kernel.opt byte-identical to the "
        f"uninterrupted run ({secs_a:.2f} s)")

    bargv = ["--batch", str(BATCH), "--epochs", str(EPOCHS)]
    out_b, opt_b, secs_b, _ = cli("batch", bargv)
    names = sample_io.list_sample_files(b_dir)
    k0 = km.generate(SEED, N_IN, [N_HID], N_OUT)[0]
    key = batch._batch_state_key(
        b_dir, "ann", False, tuple(w.shape for w in k0.weights), BATCH,
        dp.default_lr("ann", False), EPOCHS,
        "cuda-kernel-bank8/generate", names=names)
    # a checkpoint at epoch 0 with a block cap of 2: the run checkpoints
    # after epochs 2 and 4; the launch of epoch 3 raises
    bstate = os.path.join(sdir, "batch.state")
    wdt = np.float32 if dev.type == "cuda" else np.float64  # the run's compute dtype
    driver._save_fuse_state(bstate, key, SEED, 0, 2, [w.astype(wdt) for w in k0.weights])
    real_grid, calls[0] = bs.train_epoch_grid_banked, 0

    def dying_grid(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("the launch of epoch 3 raised (deliberately)")
        return real_grid(*a, **kw)

    bs.train_epoch_grid_banked = dying_grid
    try:
        bpart1, _, _, _ = cli("batch_crashed", bargv, {"HPNN_FUSE_STATE": bstate},
                              raises=RuntimeError)
    finally:
        bs.train_epoch_grid_banked = real_grid
    with np.load(bstate, allow_pickle=False) as z:
        check(int(z["done"]) == 2, f"batch crash checkpoint: done {int(z['done'])}")
    bpart2, opt_br, _, _ = cli("batch_resumed", bargv, {"HPNN_FUSE_STATE": bstate})
    check(epochs_of(bpart1) + epochs_of(bpart2) == epochs_of(out_b)
          and len(epochs_of(out_b)) == EPOCHS,
          "batch resume: the epoch tokens differ from the uninterrupted run's")
    check(opt_br == opt_b, "batch resume: kernel.opt differs from the uninterrupted run's")
    log(f"[resume] --batch {BATCH} --epochs {EPOCHS} on {N_BATCH_TRAIN} files: stopped after "
        f"epoch 2 (blocks of 2), resumed: epoch tokens and kernel.opt byte-identical to "
        f"the uninterrupted run ({secs_b:.2f} s)")

    # 2. streaming: one launch of #1 a sample
    before = convergence.launches
    out_s, opt_s, secs_s, _ = cli("streaming", [], {"HPNN_FUSE_EPOCH": "0"})
    launched = convergence.launches - before
    check(launched == N_TRAIN_ANN, f"streaming: {launched} launches for {N_TRAIN_ANN} samples")
    check(out_s == out_a and opt_s == opt_a,
          "streaming: stdout or kernel.opt differs from the chunked card run")
    stats["streaming"] = dict(seconds=secs_s, launches=launched, chunked_seconds=secs_a,
                              chunked_launches=math.ceil(N_TRAIN_ANN / CHUNK))
    log(f"[streaming] HPNN_FUSE_EPOCH=0: {launched} launches of #1 in {secs_s:.2f} s against "
        f"the chunked run's {math.ceil(N_TRAIN_ANN / CHUNK)} in {secs_a:.2f} s; stdout and "
        f"kernel.opt byte-identical")

    # 3. float64 ledger and trace, the card against the CPU
    f64 = {"HPNN_DTYPE": "float64", "HPNN_TRACE": "1"}
    diffs = {}
    for what, argv in (("per-sample", []), ("batch", bargv)):
        runs = {}
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            lpath = os.path.join(sdir, f"ledger_{what}_{where}.jsonl")
            runs[where] = cli(f"f64_{what}_{where}", extra + argv,
                              dict(f64, HPNN_LEDGER=lpath)) + (lpath,)
        rc, report = ledger_diff(runs["cuda"][4], runs["cpu"][4])
        check(rc == 0, f"{what} f64: ledger_diff card vs cpu exit {rc}:\n{report}")
        ok, worst, n = traces_agree(runs["cuda"][0], runs["cpu"][0])
        check(ok, f"{what} f64: #DBG lines of the card and the CPU disagree "
                  f"(max |diff| {worst:.3e} over {n} lines)")
        same_tokens = ([ln for ln in runs["cuda"][0].splitlines() if "#DBG" not in ln
                        and "[GPU]" not in ln] ==
                       [ln for ln in runs["cpu"][0].splitlines() if "#DBG" not in ln])
        max_abs = re.search(r"max \|a-b\|: (\S+)", report).group(1)
        diffs[what] = dict(ledger_max_abs_diff=float(max_abs), trace_max_abs_diff=worst,
                           trace_lines=n, tokens_identical=same_tokens,
                           cuda_seconds=runs["cuda"][2], cpu_seconds=runs["cpu"][2])
        log(f"[ledger] {what} round in float64, card vs CPU: ledger_diff exit 0 (max |a-b| "
            f"{max_abs}), {n} #DBG lines within 1e-12 (max |diff| {worst:.3e}), tokens "
            f"{'byte-identical' if same_tokens else 'differ'}; card {runs['cuda'][2]:.2f} s, "
            f"CPU {runs['cpu'][2]:.2f} s")
    rng = np.random.default_rng(SEED + 11)   # phase 11's fleet data
    Xf, Tf = make_dataset(np, rng, FLEET_ROWS, protos)
    fks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(FLEET_MAIN_N)]
    fkw = dict(epochs=FLEET_EPOCHS, batch=BATCH, lr=FLEET_LR, seeds=list(range(FLEET_MAIN_N)))
    fl_paths = {}
    for where in ("cuda", "cpu"):
        fl_paths[where] = os.path.join(sdir, f"ledger_fleet_{where}.jsonl")
        t0 = time.perf_counter()
        with knobs(obs, {"HPNN_LEDGER": fl_paths[where]}):
            fleet.train_fleet(fks, Xf, Tf, dtype="f64", device=where, **fkw)
        diffs.setdefault("fleet", {})[f"{where}_seconds"] = time.perf_counter() - t0
    rc, report = ledger_diff(fl_paths["cuda"], fl_paths["cpu"])
    check(rc == 0, f"fleet f64: ledger_diff card vs cpu exit {rc}:\n{report}")
    diffs["fleet"]["ledger_max_abs_diff"] = float(
        re.search(r"max \|a-b\|: (\S+)", report).group(1))
    log(f"[ledger] fleet of {FLEET_MAIN_N} in float64, card vs CPU: ledger_diff exit 0 over "
        f"{FLEET_MAIN_N} member rows (max |a-b| {diffs['fleet']['ledger_max_abs_diff']:.3e})")
    stats["card_vs_cpu_f64"] = diffs

    # 4. obs leaves the tokens alone, and records MFU (a sink and a
    # ledger per run: each starts its rows and span ids anew)
    odir = os.path.join(sdir, "obs")
    os.makedirs(odir)

    def all_on(label):
        return {"HPNN_METRICS": os.path.join(odir, f"metrics_{label}.jsonl"),
                "HPNN_SPANS": "1", "HPNN_COST": "1", "HPNN_PROBES": "1",
                "HPNN_LEDGER": os.path.join(odir, f"ledger_{label}.jsonl"),
                "HPNN_FLIGHT": os.path.join(odir, f"flight_{label}.jsonl")}

    out_o, opt_o, secs_o, _ = cli("obs", [], all_on("per-sample"))
    check(out_o == out_a and opt_o == opt_a, "obs on: per-sample stdout or kernel.opt differs")
    out_ob, opt_ob, secs_ob, _ = cli("obs_batch", bargv, all_on("batch"))
    check(out_ob == out_b and opt_ob == opt_b, "obs on: batch stdout or kernel.opt differs")
    plain = fleet.train_fleet(fks, Xf, Tf, **fkw)
    t0 = time.perf_counter()
    with knobs(obs, all_on("fleet")):
        traced = fleet.train_fleet(fks, Xf, Tf, **fkw)
    secs_of = time.perf_counter() - t0
    check(all(np.array_equal(x, y) for ka, kb in zip(plain[0], traced[0])
              for x, y in zip(ka.weights, kb.weights)), "obs on: the fleet's weights differ")
    mfu = {}
    for label, exe in (("per-sample", "driver.train_epoch"), ("batch", "batch.epoch"),
                       ("fleet", "fleet.epoch")):
        conf = all_on(label)
        for ln in open(conf["HPNN_METRICS"]):
            r = json.loads(ln)
            if r["ev"] == "perf.mfu":
                mfu.setdefault((r["exe"], r.get("kernel")), []).append(r["value"])
        vals = [v for (e, _), vs in mfu.items() if e == exe for v in vs]
        check(vals and all(math.isfinite(v) and v > 0 for v in vals),
              f"metrics: no perf.mfu of {exe}")
        for flag, path in (("--ledger", conf["HPNN_LEDGER"]), ("--perf", conf["HPNN_METRICS"])):
            out = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                               "check_obs_catalog.py"),
                                  flag, path], capture_output=True, text=True, timeout=120,
                                 cwd=ROOT)
            check(out.returncode == 0,
                  f"check_obs_catalog.py {flag} ({label}): {out.stderr.strip()}")
    ledger_f32 = all_on("per-sample")["HPNN_LEDGER"]
    stats["obs"] = dict(
        per_sample_seconds=secs_o, per_sample_seconds_off=secs_a, batch_seconds=secs_ob,
        batch_seconds_off=secs_b, fleet_seconds=secs_of,
        mfu={f"{e} {k}": dict(n=len(v), mean=statistics.fmean(v), min=min(v), max=max(v))
             for (e, k), v in mfu.items()})
    log(f"[obs] every obs knob on (metrics, spans, cost, probes, ledger, flight): per-sample "
        f"{secs_o:.2f} s (off {secs_a:.2f}), batch {secs_ob:.2f} s (off {secs_b:.2f}): stdout "
        f"and kernel.opt byte-identical; fleet weights bitwise equal; check_obs_catalog.py "
        f"--ledger and --perf pass")
    for name, v in stats["obs"]["mfu"].items():
        log(f"[obs] perf.mfu {name}: mean {v['mean']:.4e} over {v['n']} launches "
            f"({v['min']:.4e}..{v['max']:.4e})")
    rel = ledger_rel_dev(ledger_f32, os.path.join(sdir, "ledger_per-sample_cpu.jsonl"))
    stats["f32_card_vs_f64_cpu_ledger_max_rel_dev"] = rel
    log(f"[obs] per-sample ledger, card float32 vs CPU float64: max relative deviation "
        f"{rel:.3e} (reported, not gated)")

    # 5. the native parse
    check(native.lib() is not None, "the native host library did not load")
    times = {}
    for what, d in (("batch", b_dir), ("per-sample", ps_dir)):
        got = {}
        # in turns: native, Python, Python, native
        for walk in ("native", "python", "python", "native"):
            with knobs(obs, {"HPNN_NO_NATIVE": "1"} if walk == "python" else {}):
                t0 = time.perf_counter()
                got[walk] = sample_io.read_dir(d)
                times.setdefault(f"{what} {walk}", []).append(time.perf_counter() - t0)
        a, b = got["native"], got["python"]
        check(a[0] == b[0] and a[1].tobytes() == b[1].tobytes()
              and a[2].tobytes() == b[2].tobytes(),
              f"{what}: the native parse differs from the Python walk")
        log(f"[native] {len(a[0])} {what} files: native parse "
            f"{' / '.join(f'{t:.3f}' for t in times[what + ' native'])} s, Python walk "
            f"{' / '.join(f'{t:.3f}' for t in times[what + ' python'])} s, bitwise equal")
    out_np, _, secs_np, _ = cli("python_walk", [], {"HPNN_NO_NATIVE": "1"})
    out_nb, _, secs_nb, _ = cli("python_walk_batch", bargv, {"HPNN_NO_NATIVE": "1"})
    check(out_np == out_a and out_nb == out_b, "the Python walk's rounds print other tokens")
    # --profile on the card: the trace holds #1's kernels and the
    # chunks' ranges
    out_p, opt_p, _, pdir = cli("profile", ["--profile", "trace"])
    check(out_p == out_a and opt_p == opt_a, "--profile: stdout or kernel.opt differs")
    events = json.load(open(os.path.join(pdir, "trace", "trace.json")))["traceEvents"]
    n_kern = sum(1 for e in events if "convergence_cluster" in str(e.get("name", "")))
    n_rng = sum(1 for e in events if str(e.get("name", "")).startswith("hpnn.fused_chunk#"))
    check(n_kern >= math.ceil(N_TRAIN_ANN / CHUNK) and n_rng >= math.ceil(N_TRAIN_ANN / CHUNK),
          f"--profile: {n_kern} convergence kernels and {n_rng} chunk ranges in the trace")
    log(f"[obs] --profile: trace.json holds {n_kern} convergence_cluster kernel events and "
        f"{n_rng} hpnn.fused_chunk ranges; stdout and kernel.opt byte-identical")
    stats["native"] = dict(parse_s=times, per_sample_round_s=dict(native=secs_a,
                                                                  python=secs_np),
                           batch_round_s=dict(native=secs_b, python=secs_nb))
    log(f"[native] round wall: per-sample {secs_np:.2f} s with the Python walk, {secs_a:.2f} s "
        f"native; batch {secs_nb:.2f} s with the Python walk, {secs_b:.2f} s native; tokens "
        f"byte-identical")
    return stats


# ---------------------------------------------------------------- phases
def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase-split", action="store_true",
                    help="time the kernels' phases (two more nvcc builds)")
    args = ap.parse_args()

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
    from hpnn_tpu_torch.obs.cost import bound_ms, work_of
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

    # 2. build: one nvcc per source and g++ for the host library, all
    # started together
    t0 = time.perf_counter()
    builds = (("convergence", None), ("batch_step", None))
    if args.phase_split:
        builds += (("convergence", "HPNN_PHASE_CLOCKS"), ("batch_step", "HPNN_PHASE_CLOCKS"))
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        host = pool.submit(_build.build_host, "hpnn_native", force=True)
        list(pool.map(lambda b: _build.build(b[0], force=True, define=b[1]), builds))
        host.result()
    for name, define in builds:
        _build.load(name, define)
        secs, out = _build.build_log[(name, define) if define else name]
        log(f"[build] {name}.cu{' -D' + define if define else ''} built in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    from hpnn_tpu_torch import native
    check(native.lib() is not None, "the native host library (csrc/hpnn_native.cpp) did not load")
    log(f"[build] hpnn_native.cpp built in {_build.build_log['hpnn_native'][0]:.1f} s and "
        f"loaded: the sample parse, kernel dumps and shuffle run natively")
    log(f"[build] all sources in {time.perf_counter() - t0:.1f} s")
    from hpnn_tpu_torch.ops import batch_step
    for dtype, code in batch_step._DTYPE_CODE.items():
        smem = batch_step._library().hpnn_batch_smem_bytes(code)
        check(smem == batch_step.shared_bytes(dtype),
              f"batch_step.cu takes {smem} bytes of shared memory a block in {dtype}, "
              f"ops/batch_step.py says {batch_step.shared_bytes(dtype)}")
    log(f"[build] batch_step.cu: {batch_step.shared_bytes(torch.float32)} / "
        f"{batch_step.shared_bytes(torch.float64)} bytes of dynamic shared memory a block "
        f"(f32 / f64), as ops/batch_step.py lays them out")

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
                w0 = tuple(w.clone() for w in wk)
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
                # the kernel against itself under every plan, bitwise
                for plan in plans_of(convergence, w0, dtype, momentum):
                    w = tuple(t.clone() for t in w0)
                    check(same_run((w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)),
                                   (wk, sk)), f"{tag}: plan {plan} differs bitwise from the default")
                log(f"[pinned] {tag}: default plan ({plan_str(convergence.plan(w0, dtype, momentum))}) "
                    f"== every plan of {plans_of(convergence, w0, dtype, momentum)} (bitwise)")

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
    # type, at each cluster size, in turns; the kernel row of the result
    # is ANN-BP float32, the main path's
    timings = []
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                wk, X, T = tensors(dtype, 4)
                kw = dict(model=model, momentum=momentum, min_iter=5,
                          max_iter=TIMED_ITERS - 1)
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                fns = {f"C={C}": (lambda C=C: convergence.train_epoch(
                    wk, X, T, 0.2, -1e30, cluster=C, **kw)) for C in CLUSTERS}
                runs = {k: [] for k in fns}
                for k in list(fns) + list(fns)[::-1]:
                    runs[k].append(cuda_ms(torch, fns[k]))
                by = {k: statistics.median(v) for k, v in runs.items()}
                p = convergence.plan(wk, dtype, momentum)
                k_ms = by[f"C={p.cluster}"]
                wp = tuple(w.clone() for w in wk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
                torch.cuda.synchronize()
                p_ms = (time.perf_counter() - t0) * 1e3
                iters = int(sp.n_iter.sum())
                nbytes, flops = work_of(wk, 4, iters, momentum, X.element_size())
                b_ms, b_by = bound_ms(nbytes, flops, name)
                timings.append(dict(config=tag, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                    bound_by=b_by, iters=iters, cluster=p.cluster,
                                    smem_bytes=p.smem_bytes, ms_by_plan=by, runs_ms=runs,
                                    us_per_iter={k: v / iters * 1e3 for k, v in by.items()}))
                log(f"[timing] {tag} 784-300-10, 4 samples x {TIMED_ITERS} iterations: "
                    + ", ".join(f"{k} {v:.3f} ms ({v / iters * 1e3:.2f} us/iteration)"
                                for k, v in by.items())
                    + f"; default {plan_str(p)}; plain {p_ms:.1f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}: {nbytes} B, {flops} flop)")
                if args.phase_split:
                    # the phase-clock build on the same inputs (bitwise the
                    # kernel's), its cycles shared out over the measured time
                    wc, wq = tuple(w.clone() for w in wk), tuple(w.clone() for w in wk)
                    sc, clocks = convergence.phase_clocks(wc, X, T, 0.2, -1e30, **kw)
                    sq = convergence.train_epoch(wq, X, T, 0.2, -1e30, **kw)
                    check(same_run((wc, sc), (wq, sq)),
                          f"{tag}: the phase-clock build differs bitwise from the kernel")
                    cyc = sum(clocks.values())
                    split = {k: v / cyc * k_ms / iters * 1e3 for k, v in clocks.items() if v}
                    timings[-1].update(split_us_per_iter=split, clocks=clocks)
                    log(f"[timing] {tag}: us/iteration by phase (C={p.cluster}, rank 0, "
                        f"barrier waits included): "
                        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
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

    # 7-9. the batch path
    batch_err = batch_pinned(np, torch, dev)
    batch_launches, batch_stats = batch_main(np, torch, protos)
    for name, _, on_path in BATCH_KERNELS:
        check(not on_path or batch_launches[name] > 0,
              f"the batch main path launched no {name}")
    batch_times = batch_timing(np, torch, dev, args.phase_split)

    # 10-12. the fleet path
    fleet_err = fleet_pinned(np, torch, dev)
    fleet_launches, fleet_stats = fleet_main(np, torch, dev, protos)
    check(fleet_launches["train_fleet_epoch_dbuf_banked"] > 0,
          "the fleet main path launched no train_fleet_epoch_dbuf_banked")
    fleet_times, fleet_cross = fleet_timing(np, torch, dev)

    # 13. crash-resume, streaming, the float64 ledger card vs CPU, obs, native
    t13 = time.perf_counter()
    slice6 = resume_obs_native(np, torch, dev, protos)
    log(f"[resume-obs-native] phase 13 in {time.perf_counter() - t13:.1f} s")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu")]
    check(not bad, f"the port pulled in {bad[:5]}")
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
        "cluster": head["cluster"],
        "smem_bytes": head["smem_bytes"],
        "us_per_iter": ms / head["iters"] * 1e3,
        "chunk_ms": chunk_ms,
        "chunk_iters": chunk_iters,
        "main": main_stats,
        "by_config": timings,
        "resume_obs_native": slice6,
    }]
    for name, replaces, on_path in BATCH_KERNELS:
        t = batch_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "hpnn_tpu_torch/csrc/batch_step.cu",
            "replaces": replaces,
            "launches": batch_launches[name],
            "on_main_path": on_path,
            "max_abs_err": batch_err[name]["float32"],
            "max_abs_err_f32": batch_err[name]["float32"],
            "max_abs_err_f64": batch_err[name]["float64"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "timed": (f"ANN-BP 784-300-10 float32, one epoch of "
                      f"{math.ceil(TIMED_ROWS / BATCH)} steps of B={BATCH} over a "
                      f"{TIMED_ROWS}-row bank"),
            "us_per_step": t["us_per_step"],
            "runs_ms": t["runs_ms"],
            "team": t["team"],
            "other_team": t["other_team"],
            "other_team_ms": t["other_team_ms"],
        })
    kernels[1]["main"] = batch_stats
    t8 = fleet_times[FLEET_TIMED_N[0]]
    fleet_err = {d: max(e, fleet_stats["hpnn_vs_plain"][d]) for d, e in fleet_err.items()}
    kernels.append({
        "name": "train_fleet_epoch_dbuf_banked",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/batch_step.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:1041",
        "launches": fleet_launches["train_fleet_epoch_dbuf_banked"],
        "on_main_path": True,
        "max_abs_err": fleet_err["float32"],
        "max_abs_err_f32": fleet_err["float32"],
        "max_abs_err_f64": fleet_err["float64"],
        "ms": t8["ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        "library_ms": None,
        "timed": (f"ANN-BP 784-300-10 float32, {FLEET_TIMED_N[0]} members x one epoch of "
                  f"{math.ceil(TIMED_ROWS / BATCH)} steps of B={BATCH} over "
                  f"{TIMED_ROWS}-row banks"),
        "cluster": t8["cluster"],
        "ms_by_cluster": t8["ms_by_cluster"],
        "by_members": fleet_times,
        "crossover": fleet_cross,
        "main": fleet_stats,
        "launches_by_entry": fleet_launches,
    })
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
