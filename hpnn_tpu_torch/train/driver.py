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
weights carried chunk to chunk.  ``HPNN_FUSE_EPOCH=0`` (or
``HPNN_PALLAS=1``) selects the streaming loop instead: each sample is
parsed, trained (one launch on a one-row chunk) and token-printed in
turn, with the same tokens.

Crash-resume (``HPNN_FUSE_STATE=<path>``, the chunked path): after
every chunk the weights, the samples done and the chunk size are saved
atomically; a rerun of the same round resumes there and prints the
remaining tokens.  The checkpoint's key binds the sample census, the
network, the starting weights and the body that trains (``cuda-kernel``
on a card, ``plain`` on the CPU: their float32 bits differ, so a resume
stays on the body that wrote it).  A launch that raises saves the chunk
hint halved (from the host copy of the last checkpointed weights: the
card may be unusable after the error) and re-raises; a rerun that finds
no progress since the last resume halves it too.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
import zipfile

import numpy as np
import torch

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType, resolve_time_seed
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.train import loop
from hpnn_tpu_torch.utils import debug
from hpnn_tpu_torch.utils import logging as log
from hpnn_tpu_torch.utils import trace as trace_mod
from hpnn_tpu_torch.utils.glibc_random import shuffled_order

EVAL_CHUNK = 4096  # eval rows per batched forward: bounds host+device memory


def _model_of(conf: NNConf) -> str:
    return "snn" if conf.type in (NNType.SNN, NNType.LNN) else "ann"


def _body_of(dev: torch.device) -> str:
    """The tag of the body that trains on ``dev``: the CUDA kernel or
    the plain version (crash-resume keys carry it)."""
    return "cuda-kernel" if dev.type == "cuda" else "plain"


def _streaming() -> bool:
    """``HPNN_FUSE_EPOCH=0`` or ``HPNN_PALLAS=1``: the streaming loop."""
    return (os.environ.get("HPNN_FUSE_EPOCH", "1") == "0"
            or os.environ.get("HPNN_PALLAS", "0") == "1")


def _to_host(weights) -> tuple:
    return tuple(w.detach().cpu().numpy() for w in weights)


def train_kernel(conf: NNConf, *, device=None) -> bool:
    """Train every sample in ``conf.samples`` once (one 'round') on
    ``device`` (default ``cuda``; raises ``runtime.DeviceUnavailable``
    when CUDA is absent)."""
    if conf.kernel is None or conf.samples is None or conf.type == NNType.UKN:
        return False
    if conf.train not in (NNTrain.BP, NNTrain.BPM):
        # CG/SPLX parse but are unimplemented (ref: src/libhpnn.c:1253-1257)
        return True
    runtime.refuse_deferred("train_nn")
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
    kw = dict(model=model, momentum=momentum, min_iter=min_iter, max_iter=max_iter)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    weights_np = [np.asarray(w, dtype=np_dtype) for w in conf.kernel.weights]
    weights, _ = kernel_mod.to_torch(weights_np, device=dev, dtype=dtype)
    debug.device_alloc_report(weights)
    body = _body_of(dev)

    # crash-resume: the key binds the round identity (census, network,
    # starting weights, body); the stored seed lets a `[seed] 0` round
    # replay the shuffle it started with, and an explicitly seeded conf
    # never adopts a checkpoint of another seed
    state_path = os.environ.get("HPNN_FUSE_STATE")
    state_key = state = None
    if state_path:
        state_key = _fuse_state_key(
            conf.samples, model, momentum,
            tuple(tuple(int(d) for d in w.shape) for w in weights),
            f"{body}/" + _init_identity(conf, weights_np), names=census)
        state = _load_fuse_state(state_path, state_key)
        if state is not None and conf.seed not in (0, int(state["seed"])):
            state = None  # a different seeded round asked for: start over
    conf.seed = int(state["seed"]) if state is not None else resolve_time_seed(conf.seed)
    files = [census[i] for i in shuffled_order(conf.seed, len(census))]
    # a file whose dims do not match the kernel is skipped with a
    # warning (the reference reads it into out-of-bounds C memory)
    exp_dims = (weights[0].shape[1], weights[-1].shape[0])
    parsed = bank = None
    if not _streaming():
        parsed = [_checked_sample(conf.samples, f, exp_dims) for f in files]
        bank = _stack_epoch_bank(parsed, np_dtype)
    if bank is not None:
        readable = [s is not None for s in parsed]
        parsed = None  # the token loop only needs the readable mask
        X, T = (torch.from_numpy(a).to(dev) for a in bank)
        bank = None
        weights = _fused_round(
            conf, weights, X, T, files, readable, alpha, delta, kw, body,
            state_path, state_key, state)
    else:
        # streaming; reuse the parse when the chunked path found no
        # trainable sample rather than re-reading the dir
        pairs = (zip(files, parsed) if parsed is not None else
                 ((f, _checked_sample(conf.samples, f, exp_dims)) for f in files))
        _streaming_round(weights, pairs, len(files), alpha, delta, kw, np_dtype)
    conf.kernel = kernel_mod.Kernel(_to_host(weights))
    # round completed (either path): drop THIS round's checkpoint so the
    # next round over the same samples cannot mistake it for its own
    if state_path and _load_fuse_state(state_path, state_key) is not None:
        os.remove(state_path)
    obs.summary()
    return True


def _fused_round(conf, weights, X, T, files, readable, alpha, delta, kw, body,
                 state_path, state_key, state):
    """The chunked round over the stacked ``(X, T)``; returns the
    trained weights (the tensors of ``weights`` or, after a resume, the
    restored ones)."""
    model, momentum = kw["model"], kw["momentum"]
    dev, dtype = X.device, X.dtype
    chunk = max(1, int(os.environ.get("HPNN_FUSE_CHUNK", "1024")))
    done = 0  # samples already trained (and token-printed)
    if state is not None:
        # resume: the chunk-carried weights, the absolute progress and
        # the chunk hint (halved by a crashed predecessor)
        done, chunk = int(state["done"]), int(state["chunk"])
        obs.count("resume.restore", done=done, chunk=chunk, body=body)
        weights, _ = kernel_mod.to_torch(state["weights"], device=dev, dtype=dtype)
    # host copy of the last checkpointed weights: after a launch error
    # the card may be unusable, so the crash save reads only this copy
    host_w = None
    if state_path:
        host_w = tuple(state["weights"]) if state is not None else _to_host(weights)
        if state is not None and int(state["resume_done"]) == done:
            # an earlier attempt resumed here and died without progress
            # (killed with no handler run): halve so that a chunk over
            # some budget shrinks instead of retrying at the same size
            halved = max(min(32, chunk), chunk // 2)
            if halved != chunk:
                obs.count("fuse.chunk_halved", reason="resume_stall",
                          done=done, old=chunk, new=halved)
            chunk = halved
        # mark this position as resumed (and cover a kill before the
        # first save with a checkpoint)
        _save_fuse_state(state_path, state_key, conf.seed, done, chunk, host_w,
                         resume_done=done)
    obs.event("round.start", mode="fused", samples=int(X.shape[0]), chunk=chunk,
              body=body, resumed=state is not None)
    round_span = obs.spans.start("train.round", mode="fused")
    obs.device.sample("round_start")
    fname_it = iter(zip(files, readable))

    def emit_header_only_until_readable(silent=False):
        """Print header-only lines for unreadable files until the next
        readable one; returns its fname or None.  ``silent`` consumes
        without printing (the resume's skip)."""
        for fname, was_read in fname_it:
            if not silent:
                log.nn_out(sys.stdout, "TRAINING FILE: %16.16s\t", fname)
            if was_read:
                return fname
        return None

    for _ in range(done):  # resume: skip the part already printed
        if emit_header_only_until_readable(silent=True) is None:
            break
    chunk_i = 0  # launch ordinal, the profiler's step number
    while done < X.shape[0]:
        Xc, Tc = X[done : done + chunk], T[done : done + chunk]
        size = int(Xc.shape[0])
        cspan = obs.spans.start("train.chunk", parent=round_span, i=chunk_i,
                                size=size, body=body)
        obs.cost.synchronize(dev)
        t_disp = time.perf_counter()
        try:
            # the timer brackets the launch and the stats fetch (the
            # host copy is the fence)
            with obs.step_annotation("hpnn.fused_chunk", chunk_i), \
                    obs.timer("driver.chunk_dispatch", done=done, size=size, body=body):
                stats = loop.train_epoch(weights, Xc, Tc, alpha, delta, **kw)
                stats = tuple(s.cpu().numpy() for s in stats[:5])
        except Exception as exc:
            obs.spans.finish(cspan, failed=type(exc).__name__)
            if isinstance(exc, RuntimeError) and state_path:
                # a launch error: the next attempt retries this chunk at
                # half the size (never above the configured size, not
                # below 32 or the configured size, whichever is smaller)
                next_chunk = max(min(32, chunk), chunk // 2)
                obs.count("fuse.chunk_halved", reason="dispatch_crash", done=done,
                          old=chunk, new=next_chunk, exc=type(exc).__name__)
                _save_fuse_state(state_path, state_key, conf.seed, done,
                                 next_chunk, host_w)
            obs.event("round.abort", mode="fused", done=done, exc=type(exc).__name__)
            obs.spans.finish(round_span, failed=type(exc).__name__)
            obs.flush()
            obs.flight.dump("round.abort")
            obs.export.set_health(last_round={
                "mode": "fused", "ok": False, "done": done, "exc": type(exc).__name__})
            raise
        if obs.cost.enabled():
            nbytes, flops = obs.cost.work_of(weights, size, int(stats[1].sum()),
                                             momentum, X.element_size())
            obs.cost.record_dispatch(
                "driver.train_epoch", time.perf_counter() - t_disp, nbytes=nbytes,
                flops=flops, dtype=dtype, device=dev, units=size, kernel=body)
        obs.spans.finish(cspan)
        done += size
        chunk_i += 1
        if obs.enabled():
            # the stats are host arrays already (fetched for the tokens)
            obs.observe("train.n_iter", stats[1], chunk_end=done)
            obs.count("train.samples", n=size)
            obs.count("train.first_ok", n=int(stats[3].sum()))
            obs.count("train.final_ok", n=int(stats[4].sum()))
            obs.gauge("fuse.chunk_size", chunk, done=done)
            obs.device.sample("chunk", step=chunk_i)
        if obs.probes.enabled():
            # outside the launch's try: a sentinel abort propagates
            # as itself, never as a launch error
            obs.probes.check_weights(weights, step=done, where="fused_chunk")
        trace_mod.trace(f"w@{done}", weights)
        if state_path:
            host_w = _to_host(weights)
            _save_fuse_state(state_path, state_key, conf.seed, done, chunk, host_w)
        for i in range(size):
            if emit_header_only_until_readable() is None:
                break
            _print_train_tokens(stats[0][i], stats[3][i], stats[1][i], stats[2][i],
                                stats[4][i], model, momentum)
    # trailing unreadable files still get their header lines
    emit_header_only_until_readable()
    obs.event("round.end", mode="fused", samples=done, chunks=chunk_i, body=body)
    obs.spans.finish(round_span, samples=done, chunks=chunk_i)
    obs.device.sample("round_end")
    obs.export.set_health(last_round={
        "mode": "fused", "ok": True, "samples": done, "chunks": chunk_i})
    return weights


def _streaming_round(weights, pairs, n_files, alpha, delta, kw, np_dtype):
    """One sample at a time: parse, train (a one-row chunk: one launch
    of the kernel on a card, the plain loop on the CPU), print."""
    model, momentum = kw["model"], kw["momentum"]
    dev, dtype = weights[0].device, weights[0].dtype
    obs.event("round.start", mode="streaming", samples=n_files)
    round_span = obs.spans.start("train.round", mode="streaming")
    # per-round convergence stats, collected only when the sink is live
    n_iters = [] if obs.enabled() else None
    first_oks = final_oks = 0
    for i, (fname, sample) in enumerate(pairs):
        log.nn_out(sys.stdout, "TRAINING FILE: %16.16s\t", fname)
        if sample is None:
            continue
        x, t = (torch.from_numpy(np.asarray(a, dtype=np_dtype)).to(dev).reshape(1, -1)
                for a in sample)
        obs.cost.synchronize(dev)
        t_disp = time.perf_counter()
        with obs.annotate("hpnn.sample_loop"):
            stats = loop.train_epoch(weights, x, t, alpha, delta, **kw)
            ep0, n_iter, dep, first_ok, final_ok = (
                s.cpu().numpy()[0] for s in stats[:5])
        if obs.cost.enabled():
            nbytes, flops = obs.cost.work_of(weights, 1, int(n_iter), momentum,
                                             x.element_size())
            obs.cost.record_dispatch(
                "driver.train_sample", time.perf_counter() - t_disp, nbytes=nbytes,
                flops=flops, dtype=dtype, device=dev, units=1, kernel=_body_of(dev))
        _print_train_tokens(ep0, first_ok, n_iter, dep, final_ok, model, momentum)
        if n_iters is not None:
            n_iters.append(int(n_iter))
            first_oks += int(first_ok)
            final_oks += int(final_ok)
        trace_mod.trace(f"w@{i + 1}", weights)
    if n_iters:
        obs.observe("train.n_iter", n_iters)
        obs.count("train.samples", n=len(n_iters))
        obs.count("train.first_ok", n=first_oks)
        obs.count("train.final_ok", n=final_oks)
    if obs.probes.enabled():
        obs.probes.check_weights(weights, step=n_files, where="round")
    obs.event("round.end", mode="streaming", samples=n_files)
    obs.spans.finish(round_span, samples=n_files)
    obs.device.sample("round_end")
    obs.export.set_health(last_round={
        "mode": "streaming", "ok": True, "samples": n_files})


def _init_identity(conf, weights_np) -> str:
    """Identity of the round's STARTING weights for checkpoint keys.

    File-initialized rounds (``[init] kernel.opt``, every continued
    round) hash the loaded weight bytes, so a leftover checkpoint of
    another round over the same dir and topology is never adopted with
    the wrong weights.  Generated rounds keep the literal "generate":
    their checkpoint stores the whole round state, the generated
    weights included, so adopting it IS the right resume."""
    if not getattr(conf, "f_kernel", None):
        return "generate"
    h = hashlib.sha256()
    for w in weights_np:
        h.update(np.ascontiguousarray(np.asarray(w)).tobytes())
    return h.hexdigest()


def _fuse_state_key(sample_dir, model, momentum, shapes, init_key="", names=None):
    """Round identity for crash-resume checkpoints: the sample dir's
    file census plus the network (model/mode/topology) plus the
    starting-weights identity (:func:`_init_identity`, tagged with the
    body), so a checkpoint is never adopted by another round over the
    same samples.  Pass the already-listed census as ``names``."""
    if names is None:
        names = sample_io.list_sample_files(sample_dir)
    ident = f"{model}/{momentum}/{shapes}/{init_key}"
    return hashlib.sha256(("\n".join(names) + "\0" + ident).encode()).hexdigest()


def _load_fuse_state(path, key):
    """A crash-resume checkpoint as a dict, or None when absent,
    unreadable or of another round identity."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            n = int(z["n_layers"])
            return {
                "seed": int(z["seed"]),
                "done": int(z["done"]),
                "chunk": int(z["chunk"]),
                "resume_done": int(z["resume_done"]) if "resume_done" in z else -1,
                "weights": tuple(z[f"w{i}"] for i in range(n)),
            }
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # unreadable or partial: start over


def _save_fuse_state(path, key, seed, done, chunk, weights, resume_done=-1):
    """Atomically checkpoint a round: ``done`` samples (or epochs)
    trained, ``chunk`` the size hint for the next attempt, ``weights``
    host arrays.  ``resume_done`` marks a just-resumed position, so the
    next resume can tell "no progress since the last resume"."""
    tmp = path + ".tmp"
    arrs = {f"w{i}": np.asarray(w) for i, w in enumerate(weights)}
    np.savez(tmp, key=key, seed=seed, done=done, chunk=chunk,
             resume_done=resume_done, n_layers=len(weights), **arrs)
    # np.savez appends .npz to a name without it
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)


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


def _stack_epoch_bank(parsed, np_dtype):
    """Stack the parsed, dimension-checked samples (skipped entries are
    None) into the chunked round's host (X, T), or None when nothing is
    trainable."""
    xs = [np.asarray(s[0], dtype=np_dtype) for s in parsed if s is not None]
    ts = [np.asarray(s[1], dtype=np_dtype) for s in parsed if s is not None]
    if not xs:
        return None
    return np.stack(xs), np.stack(ts)


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
    runtime.refuse_deferred("run_nn")
    if not os.path.isdir(conf.tests):
        log.nn_error(sys.stderr, "can't open test directory: %s\n", conf.tests)
        return
    files = sample_io.list_sample_files(conf.tests)
    dev = runtime.resolve_device(device)
    dtype = runtime.compute_dtype(dev)
    model = _model_of(conf)
    weights, _ = kernel_mod.to_torch(conf.kernel.weights, device=dev, dtype=dtype)
    net = kernel_mod.KernelModule(weights, model=model).eval()
    debug.device_alloc_report(weights)
    if obs.probes.enabled():
        obs.probes.check_weights(weights, step=0, where="eval")
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
        with obs.spans.span("eval.batch_forward", files=len(grp_files)), \
                obs.annotate("hpnn.eval_forward"), \
                obs.timer("eval.batch_forward", size=len(grp_files)), \
                torch.inference_mode():
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
    obs.event("eval.round", files=len(files), batched=len(out_of), odd=len(odd),
              unreadable=len(bad), tp=False)
    obs.device.sample("eval")

    for idx in shuffled_order(conf.seed, len(files)):
        fname = files[idx]
        log.nn_out(sys.stdout, "TESTING FILE: %16.16s\t", fname)
        if fname in bad:
            continue
        if fname in out_of:
            o = out_of[fname]
            print_verdict(o, targets[fname], model)
        else:
            tr_in, tr_out = odd[fname]
            x = torch.from_numpy(tr_in).to(device=dev, dtype=dtype)
            with torch.inference_mode():
                o = loop.run_sample(weights, x, model=model).cpu().numpy()
            print_verdict(o, tr_out, model)
        trace_mod.trace(f"out@{fname}", [o])
        log.flush()
    obs.summary()


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
