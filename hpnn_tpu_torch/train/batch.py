"""Minibatch training (``train_nn --batch``) and batched evaluation
(``run_nn --batch``) on one device.

The port of ``hpnn_tpu/train/batch.py``: one steepest-descent step per
B-sample minibatch on the mean error (``parallel/dp.py``), the steps run
by the batch-step kernels (``ops/batch_step.py``).  Its acceptance bar is
final accuracy, not bitwise parity with the per-sample protocol.

Data path, chosen by the JAX package's knobs:

* default (``HPNN_BANK`` unset or not ``0``): the samples stay on the
  device as a bank, permuted once per refresh group of
  ``HPNN_BANK_REFRESH`` epochs (default 8); each epoch visits the
  permuted bank's B-row blocks in a fresh random order, all S steps in
  ONE launch of ``train_epoch_grid_banked`` (``HPNN_BANK_DBUF=1``:
  ``train_epoch_dbuf_banked``).  ``HPNN_BANK_REFRESH=1`` permutes every
  epoch and visits the blocks in sequence: exactly the legacy gather's
  batches.
* ``HPNN_BANK=0``: the legacy gather, ``X[idx]`` per step on the
  device, one launch of ``train_step_fused_batch`` per step.

The JAX package groups epochs into dispatches under a time budget
(``HPNN_DISPATCH_BUDGET_S``); that grouping changes no result, and here
every epoch (or step) is its own launch, so it has no counterpart.

Stdout token, after every epoch (the loss is the mean of the epoch's
per-step losses; the count runs over the unpadded samples):

    NN: BATCH EPOCH %4i loss= %.10f acc= %7.3f%% (%i/%i)
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType, resolve_time_seed
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.parallel import dp
from hpnn_tpu_torch.train.driver import _device_alloc_report, _model_of, print_verdict
from hpnn_tpu_torch.utils import logging as log
from hpnn_tpu_torch.utils.glibc_random import shuffled_order


@contextlib.contextmanager
def _full_fp32_matmul():
    """Matmuls in full float32 on the card (TF32 off), the counterpart
    of the JAX package's ``default_matmul_precision("float32")`` pin."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def make_eval_fn(*, model: str):
    """``ev(weights, X) -> out``: the forward of a ``(rows, n_in)``
    batch, plain ``torch.matmul`` in full precision."""
    mod = snn if model == "snn" else ann

    def ev(weights, X):
        with _full_fp32_matmul(), torch.inference_mode():
            return mod.run_batch(weights, X)

    return ev


def count_correct(out, T, model: str) -> torch.Tensor:
    """Argmax-vs-target count with the per-sample eval's quirks
    (``driver.print_verdict``), over ``(rows, n_out)`` tensors."""
    n_out = T.shape[1]
    rev = torch.flip(T, dims=(1,))

    def last_above(thr):
        # argmax over bool is not defined for every backend: count in uint8
        return n_out - 1 - torch.argmax((rev > thr).to(torch.uint8), dim=1)

    if model == "ann":
        # probe=-1 quirk: if no output exceeds -1.0 the guess stays out
        # of range and can never PASS
        guess = torch.where(out.max(dim=1).values > -1.0, torch.argmax(out, dim=1), n_out)
        # C quirk: is_ok starts at TRUE==1 (ref: src/libhpnn.c:1443)
        is_ok = torch.where((T > 0.5).any(dim=1), last_above(0.5), 1)
    else:
        # SNN probe starts at 0 and keeps index 0 unless out > 0
        guess = torch.where((out > 0).any(dim=1), torch.argmax(out, dim=1), 0)
        is_ok = torch.where((T > 0.1).any(dim=1), last_above(0.1), 0)
    return torch.sum(guess == is_ok)


def accuracy_counts(out: np.ndarray, T: np.ndarray, model: str) -> int:
    """:func:`count_correct` of host arrays."""
    return int(count_correct(torch.from_numpy(out), torch.from_numpy(T), model))


def make_device_count_fn(*, model: str):
    """``count(weights, X, T) -> int``: eval and count on the device;
    only the count comes to the host."""
    ev = make_eval_fn(model=model)

    def count(weights, X, T):
        return int(count_correct(ev(weights, X), T, model))

    return count


def train_kernel_batched(conf: NNConf, batch_size: int, epochs: int,
                         lr: float | None = None, *, device=None) -> bool:
    """Minibatch-SGD training round over ``conf.samples`` on ``device``
    (default ``cuda``; raises ``runtime.DeviceUnavailable`` when CUDA is
    absent).

    ``lr=None`` keeps the reference's per-sample learning rate for the
    model and mode; ``--lr`` overrides it."""
    if conf.kernel is None or conf.samples is None or conf.type == NNType.UKN:
        return False
    if conf.train not in (NNTrain.BP, NNTrain.BPM):
        return True  # CG/SPLX parse but are unimplemented (reference parity)
    if not os.path.isdir(conf.samples):
        log.nn_error(sys.stderr, "can't open sample directory: %s\n", conf.samples)
        return False
    names, X_np, T_np = sample_io.read_dir(conf.samples)
    n = len(names)
    if n == 0:
        log.nn_error(sys.stderr, "no samples in %s\n", conf.samples)
        return False
    dev = runtime.resolve_device(device)
    dtype = runtime.compute_dtype(dev)
    model = _model_of(conf)
    momentum = conf.train == NNTrain.BPM
    B = max(1, int(batch_size))
    if lr is None:
        lr = dp.default_lr(model, momentum)
    use_bank = os.environ.get("HPNN_BANK", "1") != "0"
    bank_refresh = (max(1, int(os.environ.get("HPNN_BANK_REFRESH", "8")))
                    if use_bank else 0)
    epoch_kernel = (batch_step.train_epoch_dbuf_banked
                    if use_bank and os.environ.get("HPNN_BANK_DBUF", "") == "1"
                    else batch_step.train_epoch_grid_banked)
    pad = (-n) % B
    n_steps = (n + pad) // B

    weights, dw = kernel_mod.to_torch(
        conf.kernel.weights,
        [np.zeros_like(np.asarray(w)) for w in conf.kernel.weights] if momentum else None,
        device=dev, dtype=dtype)
    _device_alloc_report(weights + dw)
    X = torch.from_numpy(X_np).to(device=dev, dtype=dtype)
    T = torch.from_numpy(T_np).to(device=dev, dtype=dtype)
    count_fn = make_device_count_fn(model=model)
    kw = dict(model=model, momentum=momentum, lr=lr, alpha=0.2)

    conf.seed = resolve_time_seed(conf.seed)
    rng = np.random.RandomState(conf.seed & 0x7FFFFFFF)
    if pad:
        # no silent caps: the tail wrap re-trains `pad` sample slots per
        # epoch so every batch is full; stderr, since stdout is the
        # grep-able token stream
        log.nn_warn(
            sys.stderr,
            "batch wrap: %i duplicate sample slots per epoch (n=%i, batch=%i)\n",
            pad, n, B,
        )

    # the RNG is drawn exactly as the JAX package draws it: a permutation
    # at each refresh-group start (every epoch without the bank), then
    # the epoch's block order when the group spans several epochs
    def draw_perm():
        order = rng.permutation(n)
        # np.resize repeats the permutation as needed, even when B > 2n
        return np.resize(order, n + pad) if pad else order

    def draw_order():
        # at refresh=1 the freshly permuted bank makes sequential blocks
        # a random batching: the legacy gather's trajectory
        if bank_refresh == 1:
            return np.arange(n_steps)
        return rng.permutation(n_steps)

    # the epoch drivers of the JAX package's make_multi_epoch_bank_fn
    # (bank) and make_multi_epoch_fn (gather), as loops over launches;
    # the permutation and the gather stay torch indexing on the device
    Xp = Tp = None
    for epoch in range(1, epochs + 1):
        if use_bank:
            if (epoch - 1) % bank_refresh == 0:
                perm = torch.from_numpy(draw_perm()).to(dev)
                Xp, Tp = X[perm], T[perm]
            _, _, losses = epoch_kernel(weights, dw, Xp, Tp, draw_order(),
                                        batch=B, **kw)
        else:
            idx = torch.from_numpy(draw_perm().reshape(n_steps, B)).to(dev)
            losses = torch.stack([
                batch_step.train_step_fused_batch(weights, dw, X[ix], T[ix], **kw)[2]
                for ix in idx])
        loss = float(np.mean(losses.cpu().numpy()))
        okc = count_fn(weights, X, T)
        log.nn_out(
            sys.stdout,
            "BATCH EPOCH %4i loss= %.10f acc= %7.3f%% (%i/%i)\n",
            epoch, loss, 100.0 * okc / n, okc, n,
        )
        log.flush()
    conf.kernel = kernel_mod.Kernel(
        tuple(w.astype(np.float64) for w in kernel_mod.to_numpy(weights)[0]))
    return True


def run_kernel_batched(conf: NNConf, *, device=None) -> None:
    """Evaluate ``conf.tests`` with one batched forward, then print the
    per-sample token protocol in the same seeded shuffle order as the
    per-sample driver.  Unreadable files, and files whose dims differ
    from the first readable one, print their TESTING FILE header with
    no verdict."""
    if conf.kernel is None or conf.tests is None or conf.type == NNType.UKN:
        return
    if not os.path.isdir(conf.tests):
        log.nn_error(sys.stderr, "can't open test directory: %s\n", conf.tests)
        return
    # one listing drives the bulk read and the shuffle
    all_files = sample_io.list_sample_files(conf.tests)
    names, X, T = sample_io.read_dir(conf.tests, files=all_files)
    if not names:
        return
    dev = runtime.resolve_device(device)
    dtype = runtime.compute_dtype(dev)
    model = _model_of(conf)
    weights, _ = kernel_mod.to_torch(conf.kernel.weights, device=dev, dtype=dtype)
    _device_alloc_report(weights)
    ev = make_eval_fn(model=model)
    out = ev(weights, torch.from_numpy(X).to(device=dev, dtype=dtype)).cpu().numpy()

    conf.seed = resolve_time_seed(conf.seed)
    row_of = {name: i for i, name in enumerate(names)}
    for idx in shuffled_order(conf.seed, len(all_files)):
        name = all_files[idx]
        log.nn_out(sys.stdout, "TESTING FILE: %16.16s\t", name)
        i = row_of.get(name)
        if i is None:  # unreadable or malformed: header only, no verdict
            continue
        print_verdict(out[i], T[i], model)
    log.flush()
