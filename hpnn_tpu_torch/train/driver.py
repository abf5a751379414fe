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

With a mesh of two or more model ranks (``--mesh 1xM``, the
reference's ``mpirun -np M`` row split) every rank trains its row
blocks of the zero-padded kernel through ``parallel/tp.py`` (torch
ops and collectives; the kernel serves one device), in the same chunks
and with the same tokens, which rank 0 alone prints; at the round's end
the row blocks are gathered and the padding stripped.  Every rank
checks first that all of them list the same sample files, and after
every chunk that all of them left every sample's do-while alike.
Crash-resume is a one-process feature, as in the JAX package.
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
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.parallel import dist
from hpnn_tpu_torch.parallel import mesh as mesh_mod
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


def _census(directory: str, what: str):
    """The directory's listing, checked to be every rank's (a missing
    directory lists as a marker no real listing gives, so missing and
    empty ranks disagree here instead of deadlocking later); None,
    with the message printed, when the ranks differ."""
    have = os.path.isdir(directory)
    names = sample_io.list_sample_files(directory) if have else ["\x00missing"]
    if not dist.census_consistent(names):
        log.nn_error(sys.stderr, "%s dir %s differs across processes (count or order)!\n",
                     what, directory)
        return None
    return names if have else []


def _tp_shard(mesh, weights_np, dtype):
    """Pad the layer rows to multiples of the model axis and take this
    rank's row blocks: (row_blocks, padded_host) or None when the mesh
    has fewer than two model ranks (the single-device path)."""
    if mesh is None or mesh.shape[mesh_mod.MODEL_AXIS] < 2:
        return None
    from hpnn_tpu_torch.parallel import tp

    padded, _ = mesh_mod.pad_kernel(weights_np, mesh.shape[mesh_mod.MODEL_AXIS])
    return tp.shard_kernel(padded, mesh, dtype=dtype), padded


def _mesh_device(mesh, device):
    """A mesh's ranks run on its device; otherwise ``device``'s rule.
    Raises ``ValueError`` when both are given and name different
    devices (a rank's inputs and its row blocks would part)."""
    if mesh is None:
        return runtime.resolve_device(device)
    if device is not None and not _same_device(runtime.resolve_device(device), mesh.device):
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` names the current card, as ``cuda:{current}`` does."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return norm(a) == norm(b)


def train_kernel(conf: NNConf, mesh=None, *, device=None) -> bool:
    """Train every sample in ``conf.samples`` once (one 'round') on
    ``device`` (default ``cuda``; raises ``runtime.DeviceUnavailable``
    when CUDA is absent).  With a ``mesh`` (``parallel/mesh.Mesh``) of
    two or more model ranks the round runs tensor-parallel on the
    mesh's device; tokens and weights are the single-device round's."""
    if conf.kernel is None or conf.samples is None or conf.type == NNType.UKN:
        return False
    if conf.train not in (NNTrain.BP, NNTrain.BPM):
        # CG/SPLX parse but are unimplemented (ref: src/libhpnn.c:1253-1257)
        return True
    runtime.refuse_deferred("train_nn")
    # the listing, the shuffle, the parse and the bank's copy to the
    # device (the chunked path; the streaming path parses as it trains)
    with obs.spans.span("train.samples") as samples_span:
        # the census collective runs on every rank before any
        # filesystem-dependent return
        census = _census(conf.samples, "sample")
        if census is None:
            return False
        if not os.path.isdir(conf.samples):
            log.nn_error(sys.stderr, "can't open sample directory: %s\n", conf.samples)
            return False
        dev = _mesh_device(mesh, device)
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
        tp_state = _tp_shard(mesh, weights_np, dtype)
        if tp_state is not None:
            weights = tp_state[0]
            epoch_fn = _make_tp_epoch(mesh, weights_np, kw)
        else:
            weights, _ = kernel_mod.to_torch(weights_np, device=dev, dtype=dtype)
            epoch_fn = loop.train_epoch
        debug.device_alloc_report(weights)
        body = "tp" if tp_state is not None else _body_of(dev)

        # crash-resume: the key binds the round identity (census, network,
        # starting weights, body); the stored seed lets a `[seed] 0` round
        # replay the shuffle it started with, and an explicitly seeded conf
        # never adopts a checkpoint of another seed.  One process only: in a
        # world the ranks would race on one file (the JAX rule)
        state_path = os.environ.get("HPNN_FUSE_STATE")
        if runtime.process_count() > 1:
            state_path = None
        state_key = state = None
        if state_path:
            state_key = _fuse_state_key(
                conf.samples, model, momentum,
                tuple(tuple(int(d) for d in w.shape) for w in weights),
                f"{body}/" + _init_identity(conf, weights_np), names=census)
            state = _load_fuse_state(state_path, state_key)
            if state is not None and conf.seed not in (0, int(state["seed"])):
                state = None  # a different seeded round asked for: start over
        conf.seed = (int(state["seed"]) if state is not None
                     else dist.resolve_time_seed(conf.seed))
        files = [census[i] for i in shuffled_order(conf.seed, len(census))]
        # a file whose dims do not match the kernel is skipped with a
        # warning (the reference reads it into out-of-bounds C memory)
        exp_dims = (weights_np[0].shape[1], weights_np[-1].shape[0])
        parsed = X = T = None
        if not _streaming():
            parsed = [_checked_sample(conf.samples, f, exp_dims) for f in files]
            bank = _stack_epoch_bank(parsed, np_dtype)
            if bank is not None:
                readable = [s is not None for s in parsed]
                parsed = None  # the token loop only needs the readable mask
                X, T = (torch.from_numpy(a).to(dev) for a in bank)
                bank = None
        obs.spans.finish(samples_span, files=len(files))
    if X is not None:
        weights = _fused_round(
            conf, weights, X, T, files, readable, alpha, delta, kw, body,
            state_path, state_key, state, epoch_fn, mesh)
    else:
        # streaming; reuse the parse when the chunked path found no
        # trainable sample rather than re-reading the dir
        pairs = (zip(files, parsed) if parsed is not None else
                 ((f, _checked_sample(conf.samples, f, exp_dims)) for f in files))
        _streaming_round(weights, pairs, len(files), alpha, delta, kw, np_dtype,
                         epoch_fn, dev, mesh)
    if tp_state is not None:
        from hpnn_tpu_torch.parallel import tp

        conf.kernel = kernel_mod.Kernel(mesh_mod.unpad_kernel(
            tp.gather_kernel(weights, mesh), [w.shape[0] for w in weights_np]))
    else:
        conf.kernel = kernel_mod.Kernel(_to_host(weights))
    # round completed (either path): drop THIS round's checkpoint so the
    # next round over the same samples cannot mistake it for its own
    if state_path and _load_fuse_state(state_path, state_key) is not None:
        os.remove(state_path)
    obs.summary()
    return True


def _make_tp_epoch(mesh, weights_np, kw):
    """The tensor-parallel chunk trainer with ``loop.train_epoch``'s
    signature: the targets padded with zero columns to the padded
    output rows (a fixed point of the row-split math)."""
    from hpnn_tpu_torch.parallel import tp

    n_out = weights_np[-1].shape[0]
    pad_out = mesh_mod.pad_up(n_out, mesh.shape[mesh_mod.MODEL_AXIS])

    def epoch(weights, X, T, alpha, delta, **kw2):
        T = torch.nn.functional.pad(T, (0, pad_out - n_out))
        return tp.train_epoch(weights, X, T, alpha, delta, n_out=n_out, mesh=mesh, **kw2)

    return epoch


def _full_weights(weights, mesh):
    """The whole kernel on every rank (a mesh's row blocks gathered)
    for the probes and the #DBG trace, which see what the JAX package's
    global arrays hold."""
    if mesh is None or mesh.shape[mesh_mod.MODEL_AXIS] < 2:
        return weights
    from hpnn_tpu_torch.parallel import tp

    return tp.gather_kernel(weights, mesh)


def _check_lockstep(stats, done, mesh) -> None:
    """After a chunk, every rank of a mesh must have left every
    sample's do-while on the same iteration with the same result (the
    decision is made from replicated values, so any spread is a bug)."""
    if mesh is None or runtime.process_count() < 2:
        return
    from hpnn_tpu_torch.parallel import dp

    names = ("n_iter", "first_ok", "final_ok", "ep0", "dep")
    vals = [float(stats[1].sum()), float(stats[3].sum()), float(stats[4].sum()),
            float(np.abs(stats[0]).sum()), float(np.abs(stats[2]).sum())]
    bad = dp.divergence_check(names, vals, [0.0] * len(names))
    if bad:
        raise RuntimeError(f"the mesh's ranks left the do-while differently after "
                           f"{done} samples: {bad}")


def _fused_round(conf, weights, X, T, files, readable, alpha, delta, kw, body,
                 state_path, state_key, state, epoch_fn, mesh):
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
    with obs.spans.span("train.round", mode="fused") as round_span:
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
        chunk_i = 0  # launch ordinal, the chunk span's i
        while done < X.shape[0]:
            Xc, Tc = X[done : done + chunk], T[done : done + chunk]
            size = int(Xc.shape[0])
            with obs.spans.span("train.chunk", parent=round_span, i=chunk_i, size=size,
                                body=body) as cspan:
                obs.cost.synchronize(dev)
                t_disp = time.perf_counter()
                try:
                    # the timer brackets the launch and the stats fetch (the
                    # host copy is the fence)
                    with obs.timer("driver.chunk_dispatch", done=done, size=size, body=body):
                        stats = epoch_fn(weights, Xc, Tc, alpha, delta, **kw)
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
            _check_lockstep(stats, done, mesh)
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
                obs.probes.check_weights(_full_weights(weights, mesh), step=done,
                                         where="fused_chunk")
            if trace_mod.enabled():
                trace_mod.trace(f"w@{done}", _full_weights(weights, mesh))
            if state_path:
                host_w = _to_host(weights)
                _save_fuse_state(state_path, state_key, conf.seed, done, chunk, host_w)
            with obs.spans.span("train.tokens", n=size):
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


def _streaming_round(weights, pairs, n_files, alpha, delta, kw, np_dtype, epoch_fn,
                     dev, mesh):
    """One sample at a time: parse, train (a one-row chunk: one launch
    of the kernel on a card, the plain loop on the CPU, the row-split
    loop on a mesh), print."""
    model, momentum = kw["model"], kw["momentum"]
    dtype = weights[0].dtype
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
        with obs.spans.span("train.sample", parent=round_span, i=i):
            stats = epoch_fn(weights, x, t, alpha, delta, **kw)
            stats = tuple(s.cpu().numpy() for s in stats[:5])
            ep0, n_iter, dep, first_ok, final_ok = (s[0] for s in stats)
        _check_lockstep(stats, i + 1, mesh)
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
        if trace_mod.enabled():
            trace_mod.trace(f"w@{i + 1}", _full_weights(weights, mesh))
    if n_iters:
        obs.observe("train.n_iter", n_iters)
        obs.count("train.samples", n=len(n_iters))
        obs.count("train.first_ok", n=first_oks)
        obs.count("train.final_ok", n=final_oks)
    if obs.probes.enabled():
        obs.probes.check_weights(_full_weights(weights, mesh), step=n_files, where="round")
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


def run_kernel(conf: NNConf, mesh=None, *, device=None) -> None:
    """Evaluate every sample in ``conf.tests`` (argmax vs target) on
    ``device`` (default ``cuda``).

    The outputs of every file that matches the kernel's dims come from
    one batched forward per ``EVAL_CHUNK`` files (a plain matmul
    forward, ``models.kernel.KernelModule``; on a mesh of two or more
    model ranks the row-split forward of ``parallel/tp.py``); outputs do
    not depend on the visit order, so precomputing keeps the
    seeded-shuffle token stream.  ``HPNN_NO_BATCH_EVAL=1`` sends every
    readable file through the per-file forward instead.  Unreadable
    files print a header-only line; a file whose dims do not match the
    kernel goes through the per-file forward, which raises (as the JAX
    package's does)."""
    if conf.kernel is None or conf.tests is None or conf.type == NNType.UKN:
        return
    runtime.refuse_deferred("run_nn")
    files = _census(conf.tests, "test")
    if files is None:
        return
    if not os.path.isdir(conf.tests):
        log.nn_error(sys.stderr, "can't open test directory: %s\n", conf.tests)
        return
    dev = _mesh_device(mesh, device)
    dtype = runtime.compute_dtype(dev)
    model = _model_of(conf)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    weights_np = [np.asarray(w, dtype=np_dtype) for w in conf.kernel.weights]
    n_in, n_out = weights_np[0].shape[1], weights_np[-1].shape[0]
    sharded = _tp_shard(mesh, weights_np, dtype)
    if sharded is not None:
        from hpnn_tpu_torch.parallel import tp

        weights = sharded[0]
        run_one = tp.make_run_fn(mesh, model=model, n_out=n_out)
        run_rows = tp.make_batched_run_fn(mesh, model=model, n_out=n_out)

        def forward(x):
            return run_one(weights, x)[:n_out]

        def batched(xs):
            return run_rows(weights, xs)[:, :n_out]
    else:
        weights, _ = kernel_mod.to_torch(weights_np, device=dev, dtype=dtype)
        net = kernel_mod.KernelModule(weights, model=model).eval()

        def forward(x):
            with torch.inference_mode():
                return loop.run_sample(weights, x, model=model)

        def batched(xs):
            with torch.inference_mode():
                return net(xs)
    debug.device_alloc_report(weights)
    if obs.probes.enabled():
        # the host copies: the checks see the kernel the user loaded
        obs.probes.check_weights(tuple(weights_np), step=0, where="eval")
    conf.seed = dist.resolve_time_seed(conf.seed)
    no_batch = bool(os.environ.get("HPNN_NO_BATCH_EVAL"))

    targets = {}   # fname -> target vector (batchable files)
    out_of = {}    # fname -> precomputed output row
    odd = {}       # per-file forward: HPNN_NO_BATCH_EVAL, or not the kernel's dims
    bad = set()    # unreadable/malformed: header-only token line
    grp_files, grp_x = [], []

    def _flush():
        if not grp_files:
            return
        xs = torch.from_numpy(np.stack(grp_x)).to(device=dev, dtype=dtype)
        with obs.spans.span("eval.batch_forward", files=len(grp_files)), \
                obs.timer("eval.batch_forward", size=len(grp_files)):
            oc = batched(xs).cpu().numpy()
        for j, f in enumerate(grp_files):
            out_of[f] = oc[j]
        grp_files.clear()
        grp_x.clear()

    for f in files:
        s = sample_io.read_sample(os.path.join(conf.tests, f))
        if s is None:
            bad.add(f)
        elif no_batch or s[0].size != n_in or s[1].size != n_out:
            odd[f] = s
        else:
            targets[f] = s[1]
            grp_files.append(f)
            grp_x.append(s[0])
            if len(grp_files) == EVAL_CHUNK:
                _flush()
    _flush()
    obs.event("eval.round", files=len(files), batched=len(out_of), odd=len(odd),
              unreadable=len(bad), tp=sharded is not None)
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
            o = forward(x).cpu().numpy()
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
