"""Training and evaluation drivers (the reference's L3 workload layer).

``train_kernel`` reimplements ``_NN(train,kernel)``
(ref: libhpnn src/libhpnn.c:1149-1305): scan the samples dir,
seed the glibc stream, draw files in random order without replacement,
and train each sample to convergence; ``run_kernel`` reimplements
``_NN(run,kernel)`` (src/libhpnn.c:1306-1536): same scan/shuffle over
the tests dir, forward pass, argmax vs target.

The stdout tokens are a de-facto metrics API consumed by the tutorial
monitor scripts (they grep ``OK`` and ``PASS`` counts, ref:
tutorials/mnist/tutorial.bash:179-196) and are reproduced byte-for-byte:

    NN: TRAINING FILE: %16.16s\\t init=... OK|NO N_ITER=... final=... SUCCESS!|FAIL!
    NN: TESTING FILE: %16.16s\\t [PASS] | [FAIL idx=N]

Quirks preserved: SNN BP ends with ``final=...\\n`` and never prints
SUCCESS!/FAIL! (ref: src/snn.c:1495-1497); the SNN eval path prints a
``BEST CLASS`` token and, at -vvv, a class-probability table
(ref: src/libhpnn.c:1489-1508); LNN configs are routed down the SNN
path (ref: src/libhpnn.c:1249,1458).

Training runs in chunks of ``HPNN_FUSE_CHUNK`` samples (default 1024):
the shuffled samples are stacked on the device and each chunk is one
call of ``loop.train_epoch`` — one kernel launch on the GPU — with the
weights carried chunk to chunk.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType, resolve_time_seed
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.train import loop
from hpnn_tpu_torch.utils import logging as log
from hpnn_tpu_torch.utils.glibc_random import shuffled_order

EVAL_CHUNK = 4096  # eval rows per batched forward: bounds host+device memory


def _device_alloc_report(weights) -> None:
    """The device half of ALLOC_REPORT (ref: src/ann.c:199): nothing
    when the tensors live on the host (the CPU line covers them)."""
    if weights[0].device.type != "cuda":
        return
    total = sum(w.numel() * w.element_size() for w in weights)
    log.nn_out(sys.stdout, "[GPU] ANN total allocation: %i (bytes)\n", total)


def _model_of(conf: NNConf) -> str:
    return "snn" if conf.type in (NNType.SNN, NNType.LNN) else "ann"


def train_kernel(conf: NNConf, *, device=None) -> bool:
    """Train every sample in ``conf.samples`` once (one 'round') on
    ``device`` (default ``cuda``; raises ``runtime.DeviceUnavailable``
    when CUDA is absent)."""
    if conf.kernel is None or conf.samples is None or conf.type == NNType.UKN:
        return False
    if conf.train not in (NNTrain.BP, NNTrain.BPM):
        # CG/SPLX parse but are unimplemented (ref: src/libhpnn.c:1253-1257)
        return True
    if not os.path.isdir(conf.samples):
        log.nn_error(sys.stderr, "can't open sample directory: %s\n", conf.samples)
        return False
    census = sample_io.list_sample_files(conf.samples)
    dev = runtime.resolve_device(device)
    dtype = runtime.compute_dtype(dev)
    momentum = conf.train == NNTrain.BPM
    model = _model_of(conf)
    if momentum:
        min_iter, max_iter, delta = loop.MIN_BPM_ITER, loop.MAX_BPM_ITER, loop.DELTA_BPM
    else:
        min_iter, max_iter, delta = loop.MIN_BP_ITER, loop.MAX_BP_ITER, loop.DELTA_BP
    alpha = 0.2  # ref: src/libhpnn.c:1248 — BPM always called with .2

    weights, _ = kernel_mod.to_torch(conf.kernel.weights, device=dev, dtype=dtype)
    _device_alloc_report(weights)

    conf.seed = resolve_time_seed(conf.seed)
    files = [census[i] for i in shuffled_order(conf.seed, len(census))]
    # a file whose dims do not match the kernel is skipped with a
    # warning (the reference reads it into out-of-bounds C memory)
    exp_dims = (weights[0].shape[1], weights[-1].shape[0])
    parsed = [_checked_sample(conf.samples, f, exp_dims) for f in files]
    readable = [s is not None for s in parsed]
    fname_it = iter(zip(files, readable))

    def emit_header_only_until_readable():
        """Print header-only lines for unreadable files until the next
        readable one; returns its fname or None."""
        for fname, was_read in fname_it:
            log.nn_out(sys.stdout, "TRAINING FILE: %16.16s\t", fname)
            if was_read:
                return fname
        return None

    if any(readable):
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        X = torch.from_numpy(np.stack([s[0] for s in parsed if s is not None])
                             .astype(np_dtype)).to(dev)
        T = torch.from_numpy(np.stack([s[1] for s in parsed if s is not None])
                             .astype(np_dtype)).to(dev)
        parsed = None  # the token loop only needs the readable mask
        chunk = max(1, int(os.environ.get("HPNN_FUSE_CHUNK", "1024")))
        done = 0
        while done < X.shape[0]:
            Xc, Tc = X[done : done + chunk], T[done : done + chunk]
            stats = loop.train_epoch(
                weights, Xc, Tc, alpha, delta, model=model, momentum=momentum,
                min_iter=min_iter, max_iter=max_iter)
            ep0, n_iter, dep, first_ok, final_ok = (
                s.cpu().numpy() for s in stats[:5])
            done += Xc.shape[0]
            for i in range(Xc.shape[0]):
                if emit_header_only_until_readable() is None:
                    break
                _print_train_tokens(ep0[i], first_ok[i], n_iter[i], dep[i],
                                    final_ok[i], model, momentum)
    # trailing unreadable files still get their header lines
    emit_header_only_until_readable()
    conf.kernel = kernel_mod.Kernel(kernel_mod.to_numpy(weights)[0])
    return True


def _checked_sample(sample_dir, fname, exp_dims):
    """read_sample + kernel-dimension check; mismatches are skipped
    with a warning (→ None, a header-only token line)."""
    sample = sample_io.read_sample(os.path.join(sample_dir, fname))
    if sample is None:
        return None
    if sample[0].shape[0] != exp_dims[0] or sample[1].shape[0] != exp_dims[1]:
        log.nn_error(
            sys.stderr,
            "sample %s dimension mismatch (%ix%i, kernel %ix%i)! SKIP\n",
            fname, sample[0].shape[0], sample[1].shape[0], *exp_dims,
        )
        return None
    return sample


def _print_train_tokens(ep0, first_ok, n_iter, dep, final_ok, model, momentum):
    log.nn_cout(sys.stdout, " init=%15.10f", float(ep0))
    log.nn_cout(sys.stdout, " OK" if bool(first_ok) else " NO")
    log.nn_cout(sys.stdout, " N_ITER=%8i", int(n_iter))
    if model == "snn" and not momentum:
        # SNN BP quirk: no SUCCESS!/FAIL! (ref: src/snn.c:1495-1497)
        log.nn_cout(sys.stdout, " final=%15.10f\n", float(dep))
    else:
        log.nn_cout(sys.stdout, " final=%15.10f", float(dep))
        log.nn_cout(sys.stdout, " SUCCESS!\n" if bool(final_ok) else " FAIL!\n")
    log.flush()


def run_kernel(conf: NNConf, *, device=None) -> None:
    """Evaluate every sample in ``conf.tests`` (argmax vs target) on
    ``device`` (default ``cuda``).

    The outputs of every file that matches the kernel's dims come from
    one batched forward per ``EVAL_CHUNK`` files (a plain matmul
    forward, ``models.kernel.KernelModule``); outputs do not depend on
    the visit order, so precomputing keeps the seeded-shuffle token
    stream.  Unreadable files print a header-only line; a file whose
    dims do not match the kernel goes through the per-file forward,
    which raises (as the JAX package's does)."""
    if conf.kernel is None or conf.tests is None or conf.type == NNType.UKN:
        return
    if not os.path.isdir(conf.tests):
        log.nn_error(sys.stderr, "can't open test directory: %s\n", conf.tests)
        return
    files = sample_io.list_sample_files(conf.tests)
    dev = runtime.resolve_device(device)
    dtype = runtime.compute_dtype(dev)
    model = _model_of(conf)
    weights, _ = kernel_mod.to_torch(conf.kernel.weights, device=dev, dtype=dtype)
    net = kernel_mod.KernelModule(weights, model=model).eval()
    _device_alloc_report(weights)
    conf.seed = resolve_time_seed(conf.seed)
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]

    targets = {}   # fname -> target vector (batchable files)
    out_of = {}    # fname -> precomputed output row
    odd = {}       # readable but not the kernel's dims: per-file forward
    bad = set()    # unreadable/malformed: header-only token line
    grp_files, grp_x = [], []

    def _flush():
        if not grp_files:
            return
        xs = torch.from_numpy(np.stack(grp_x)).to(device=dev, dtype=dtype)
        with torch.inference_mode():
            oc = net(xs).cpu().numpy()
        for j, f in enumerate(grp_files):
            out_of[f] = oc[j]
        grp_files.clear()
        grp_x.clear()

    for f in files:
        s = sample_io.read_sample(os.path.join(conf.tests, f))
        if s is None:
            bad.add(f)
        elif s[0].size != n_in or s[1].size != n_out:
            odd[f] = s
        else:
            targets[f] = s[1]
            grp_files.append(f)
            grp_x.append(s[0])
            if len(grp_files) == EVAL_CHUNK:
                _flush()
    _flush()

    for idx in shuffled_order(conf.seed, len(files)):
        fname = files[idx]
        log.nn_out(sys.stdout, "TESTING FILE: %16.16s\t", fname)
        if fname in bad:
            continue
        if fname in out_of:
            print_verdict(out_of[fname], targets[fname], model)
        else:
            tr_in, tr_out = odd[fname]
            x = torch.from_numpy(tr_in).to(device=dev, dtype=dtype)
            with torch.inference_mode():
                o = loop.run_sample(weights, x, model=model).cpu().numpy()
            print_verdict(o, tr_out, model)
        log.flush()


def print_verdict(out: np.ndarray, target: np.ndarray, model: str) -> None:
    """The eval token protocol for one sample — PASS/FAIL (+ SNN BEST
    CLASS and -vvv probability table) (ref: src/libhpnn.c:1443-1514)."""
    if model == "ann":
        # ref: src/libhpnn.c:1443-1457 — target threshold 0.5,
        # LAST index above threshold wins
        guess = _first_argmax(out)
        # C quirk: is_ok starts at TRUE==1, so an all-negative
        # target leaves class index 1 (ref: src/libhpnn.c:1443)
        is_ok = _last_above(target, 0.5, default=1)
        if guess == is_ok:
            log.nn_cout(sys.stdout, " [PASS]\n")
        else:
            log.nn_cout(sys.stdout, " [FAIL idx=%i]\n", is_ok + 1)
    else:
        # ref: src/libhpnn.c:1489-1514 — threshold 0.1, plus the
        # BEST CLASS token and -vvv probability table
        log.nn_dbg(sys.stdout, " CLASS | PROBABILITY (%s)\n", "%")
        log.nn_dbg(sys.stdout, "-------|----------------\n")
        for idx in range(out.shape[0]):
            log.nn_dbg(sys.stdout, " %5i | %15.10f\n", idx + 1, out[idx] * 100.0)
        log.nn_dbg(sys.stdout, "-------|----------------\n")
        guess = _first_argmax_pos(out)
        is_ok = _last_above(target, 0.1, default=0)
        log.nn_cout(
            sys.stdout, " BEST CLASS idx=%i P=%15.10f", guess + 1, out[guess] * 100.0
        )
        if guess == is_ok:
            log.nn_cout(sys.stdout, " [PASS]\n")
        else:
            log.nn_cout(sys.stdout, " [FAIL idx=%i]\n", is_ok + 1)


def _first_argmax(out: np.ndarray) -> int:
    """First index of the maximum, starting from probe=-1 (ANN eval)."""
    res, guess = -1.0, out.shape[0]
    for idx in range(out.shape[0]):
        if res < out[idx]:
            guess, res = idx, out[idx]
    return guess


def _first_argmax_pos(out: np.ndarray) -> int:
    """SNN eval starts from probe=0 and keeps index 0 on ties."""
    res, guess = 0.0, 0
    for idx in range(out.shape[0]):
        if out[idx] > res:
            res, guess = out[idx], idx
    return guess


def _last_above(target: np.ndarray, thr: float, default: int = 0) -> int:
    ok = default
    for idx in range(target.shape[0]):
        if target[idx] > thr:
            ok = idx
    return ok
