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

Every epoch (or step) is its own launch.  The epochs are grouped into
the blocks of the JAX package's multi-epoch dispatches (its step-count
cap, whole refresh groups), and the block ends carry what the JAX
dispatch ends carry: the epoch tokens, the numerics check
(``HPNN_LEDGER``/``HPNN_PROBES``), the ``#DBG`` trace (``HPNN_TRACE``)
and the crash-resume checkpoint (``HPNN_FUSE_STATE``, keyed as the
per-sample round's, with the batch hyperparameters, the body and the
data path).  The JAX package also shrinks its blocks to a dispatch time
budget (``HPNN_DISPATCH_BUDGET_S``); the port's launches are single
epochs, so it has no such budget.

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

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType, resolve_time_seed
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.parallel import dp
from hpnn_tpu_torch.train.driver import (
    _body_of, _fuse_state_key, _init_identity, _load_fuse_state, _model_of,
    _save_fuse_state, _to_host, print_verdict)
from hpnn_tpu_torch.utils import debug
from hpnn_tpu_torch.utils import logging as log
from hpnn_tpu_torch.utils import trace as trace_mod
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


def _batch_state_key(sample_dir, model, momentum, shapes, B, lr, epochs,
                     init_key="", names=None):
    """Round identity for batch crash-resume checkpoints: the
    per-sample scheme (``driver._fuse_state_key``) extended with the
    batch hyperparameters, over the readable samples' ``names``."""
    return _fuse_state_key(sample_dir, model, momentum, shapes,
                           f"batch/B{B}/lr{lr}/E{epochs}/{init_key}", names=names)


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
    runtime.refuse_deferred("train_nn")
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
    use_dbuf = use_bank and os.environ.get("HPNN_BANK_DBUF", "") == "1"
    epoch_kernel = (batch_step.train_epoch_dbuf_banked if use_dbuf
                    else batch_step.train_epoch_grid_banked)
    pad = (-n) % B
    n_steps = (n + pad) // B

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    weights_np = [np.asarray(w, dtype=np_dtype) for w in conf.kernel.weights]
    weights, dw = kernel_mod.to_torch(
        weights_np, [np.zeros_like(w) for w in weights_np] if momentum else None,
        device=dev, dtype=dtype)
    debug.device_alloc_report(weights + dw)
    X = torch.from_numpy(X_np).to(device=dev, dtype=dtype)
    T = torch.from_numpy(T_np).to(device=dev, dtype=dtype)
    count_fn = make_device_count_fn(model=model)
    kw = dict(model=model, momentum=momentum, lr=lr, alpha=0.2)
    shapes = tuple(tuple(int(d) for d in w.shape) for w in weights)
    body = _body_of(dev)

    # crash-resume (HPNN_FUSE_STATE): the checkpoint holds the epochs
    # done and the weights (and dw) after every block of epochs; the
    # RNG fast-forwards by replaying the done epochs' draws.  The key
    # binds the body and the data path, as the per-sample key does.
    state_path = os.environ.get("HPNN_FUSE_STATE")
    state_key = state = None
    if state_path:
        state_key = _batch_state_key(
            conf.samples, model, momentum, shapes, B, lr, epochs,
            body + ("-dbuf" if use_dbuf else "")
            + (f"-bank{bank_refresh}/" if use_bank else "/")
            + _init_identity(conf, weights_np), names=names)
        state = _load_fuse_state(state_path, state_key)
        if state is not None and conf.seed not in (0, int(state["seed"])):
            state = None  # a different seeded run asked for: start over
    done_epochs = 0
    cap_hint = 0  # the epochs-a-block cap carried in the checkpoint
    if state is not None:
        conf.seed = int(state["seed"])
        done_epochs, cap_hint = int(state["done"]), int(state["chunk"])
        obs.count("resume.restore", done=done_epochs, chunk=cap_hint,
                  path="batch", body=body)
        if int(state["resume_done"]) == done_epochs and cap_hint:
            # no progress since the last resume: halve the block
            halved = max(1, cap_hint // 2)
            obs.count("batch.cap_halved", reason="resume_stall",
                      done=done_epochs, old=cap_hint, new=halved)
            cap_hint = halved
        saved, _ = kernel_mod.to_torch(state["weights"], device=dev, dtype=dtype)
        weights, dw = saved[:len(weights)], saved[len(weights):]
    conf.seed = resolve_time_seed(conf.seed)
    rng = np.random.RandomState(conf.seed & 0x7FFFFFFF)

    def save_state(epoch_now, cap=0, resume_done=-1):
        if state_path:
            _save_fuse_state(state_path, state_key, conf.seed, epoch_now, cap,
                             _to_host(weights + dw), resume_done=resume_done)

    loss = float("nan")
    if pad:
        # no silent caps: the tail wrap re-trains `pad` sample slots per
        # epoch so every batch is full; stderr, since stdout is the
        # grep-able token stream
        log.nn_warn(
            sys.stderr,
            "batch wrap: %i duplicate sample slots per epoch (n=%i, batch=%i)\n",
            pad, n, B,
        )

    def print_epoch(epoch, loss, okc):
        log.nn_out(
            sys.stdout,
            "BATCH EPOCH %4i loss= %.10f acc= %7.3f%% (%i/%i)\n",
            epoch, loss, 100.0 * okc / n, okc, n,
        )
        log.flush()
        if obs.enabled():
            obs.gauge("batch.loss", loss, epoch=epoch)
            obs.gauge("batch.acc", okc / n, epoch=epoch, ok=okc, n=n)

    obs.event("round.start", mode="batch", samples=n, batch=B, epochs=epochs,
              body=body, bank=bank_refresh, data_shards=1,
              resumed=state is not None)
    round_span = obs.spans.start("train.round", mode="batch")

    # the RNG is drawn exactly as the JAX package draws it: a permutation
    # at each refresh-group start (every epoch without the bank), then
    # the epoch's block order when the group spans several epochs
    cur_perm = [None]  # the refresh group's permutation (a mid-group block reuses it)

    def draw_perm():
        order = rng.permutation(n)
        # np.resize repeats the permutation as needed, even when B > 2n
        cur_perm[0] = np.resize(order, n + pad) if pad else order
        return cur_perm[0]

    def draw_order():
        # at refresh=1 the freshly permuted bank makes sequential blocks
        # a random batching: the legacy gather's trajectory
        if bank_refresh == 1:
            return np.arange(n_steps)
        return rng.permutation(n_steps)

    def replay_epoch(e):
        # consume exactly the draws epoch ``e`` consumed, so a resume
        # shuffles the remaining epochs as the original run would have
        if use_bank:
            if e % bank_refresh == 0:
                draw_perm()
            if bank_refresh > 1:
                draw_order()
        else:
            draw_perm()

    epoch_work = obs.cost.batch_work(shapes, n_steps, momentum, X.element_size(), B)
    step_work = obs.cost.batch_work(shapes, 1, momentum, X.element_size(), B)

    def run_block(perms, orders):
        """The block's epochs, each its own launch (or, without the
        bank, one launch a step), then each epoch's count: returns
        (per-epoch mean losses, per-epoch counts)."""
        losses, counts = [], []
        if use_bank:
            for perm, group in zip(perms, orders):
                idx = torch.from_numpy(perm).to(dev)
                Xp, Tp = X[idx], T[idx]
                for order in group:
                    ls = obs.cost.timed_launch(
                        "batch.epoch", lambda: epoch_kernel(
                            weights, dw, Xp, Tp, order, batch=B, **kw)[2],
                        nbytes=epoch_work[0], flops=epoch_work[1], dtype=dtype,
                        device=dev, kernel=epoch_kernel.__name__)
                    losses.append(float(np.mean(ls.cpu().numpy())))
                    counts.append(count_fn(weights, X, T))
        else:
            for perm in perms:
                idx = torch.from_numpy(perm.reshape(n_steps, B)).to(dev)
                ls = torch.stack([obs.cost.timed_launch(
                    "batch.step", lambda ix=ix: batch_step.train_step_fused_batch(
                        weights, dw, X[ix], T[ix], **kw)[2],
                    nbytes=step_work[0], flops=step_work[1], dtype=dtype, device=dev,
                    kernel="train_step_fused_batch") for ix in idx])
                losses.append(float(np.mean(ls.cpu().numpy())))
                counts.append(count_fn(weights, X, T))
        return losses, counts

    for e in range(done_epochs):
        # resume: the crashed run printed these epochs' tokens
        replay_epoch(e)
    # epochs are grouped into blocks as the JAX package groups them into
    # dispatches (its step-count cap, whole refresh groups; a block
    # never straddles a group boundary): the tokens, the numerics
    # check, the #DBG trace and the checkpoint come at block ends, so
    # ledgers and traces pair row for row with the JAX package's
    e_cap = max(1, 65536 // max(1, n_steps))
    if cap_hint:
        e_cap = min(e_cap, cap_hint)
    if use_bank and e_cap >= bank_refresh:
        e_cap = (e_cap // bank_refresh) * bank_refresh
    # mark this position as resumed: a next resume that finds `done`
    # unchanged halves the cap
    save_state(done_epochs, cap=e_cap, resume_done=done_epochs)
    epoch = done_epochs
    block_i = 0
    while epoch < epochs:
        e_block = min(e_cap, epochs - epoch)
        if not use_bank:
            perms, orders = [draw_perm() for _ in range(e_block)], None
        elif epoch % bank_refresh:
            # mid-group (a cap below R): finish the group's permutation
            e_block = min(e_block, bank_refresh - epoch % bank_refresh)
            perms = [cur_perm[0]]
            orders = [[draw_order() for _ in range(e_block)]]
        else:
            r_eff = bank_refresh if e_block >= bank_refresh else e_block
            e_block -= e_block % r_eff
            perms, orders = [], []
            for _ in range(e_block // r_eff):
                perms.append(draw_perm())
                orders.append([draw_order() for _ in range(r_eff)])
        bspan = obs.spans.start("batch.block", parent=round_span, i=block_i,
                                epoch=epoch, epochs=e_block)
        with obs.step_annotation("hpnn.batch_block", block_i), \
                obs.timer("batch.block_dispatch", epoch=epoch, epochs=e_block, body=body):
            losses, counts = run_block(perms, orders)
        obs.spans.finish(bspan)
        block_i += 1
        for loss, okc in zip(losses, counts):
            epoch += 1
            print_epoch(epoch, loss, okc)
        if obs.probes.enabled():
            obs.probes.check_weights(weights, step=epoch, where="batch_block")
        trace_mod.trace(f"w@{epoch}", weights)
        save_state(epoch, cap=e_cap)
    conf.kernel = kernel_mod.Kernel(
        tuple(w.astype(np.float64) for w in kernel_mod.to_numpy(weights)[0]))
    # run completed: drop this run's checkpoint (another key's is left)
    if state_path and _load_fuse_state(state_path, state_key) is not None:
        os.remove(state_path)
    obs.event("round.end", mode="batch", epochs=epochs, loss=loss, body=body)
    obs.spans.finish(round_span, epochs=epochs)
    obs.summary()
    return True


def run_kernel_batched(conf: NNConf, *, device=None) -> None:
    """Evaluate ``conf.tests`` with one batched forward, then print the
    per-sample token protocol in the same seeded shuffle order as the
    per-sample driver.  Unreadable files, and files whose dims differ
    from the first readable one, print their TESTING FILE header with
    no verdict."""
    if conf.kernel is None or conf.tests is None or conf.type == NNType.UKN:
        return
    runtime.refuse_deferred("run_nn")
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
    debug.device_alloc_report(weights)
    ev = make_eval_fn(model=model)
    with obs.spans.span("eval.batch_forward", files=len(names)), \
            obs.annotate("hpnn.eval_forward"), \
            obs.timer("eval.batch_forward", size=len(names)):
        out = ev(weights, torch.from_numpy(X).to(device=dev, dtype=dtype)).cpu().numpy()
    obs.event("eval.round", files=len(all_files), batched=len(names), odd=0,
              unreadable=len(all_files) - len(names), tp=False)

    conf.seed = resolve_time_seed(conf.seed)
    row_of = {name: i for i, name in enumerate(names)}
    for idx in shuffled_order(conf.seed, len(all_files)):
        name = all_files[idx]
        log.nn_out(sys.stdout, "TESTING FILE: %16.16s\t", name)
        i = row_of.get(name)
        if i is None:  # unreadable or malformed: header only, no verdict
            continue
        print_verdict(out[i], T[i], model)
        trace_mod.trace(f"out@{name}", [out[i]])
    log.flush()
    obs.summary()
