"""Fleet training: N same-topology kernels trained at once on one card.

The port of ``hpnn_tpu/train/fleet.py``, with its public names and
return shapes.  libhpnn's natural users run many small kernels beside a
scientific calculation, an ensemble rather than one big net; the fleet
trains them together so that the launch overhead and the card are
shared.

Semantics, as in the JAX package:

* **Same topology required.**  Members share layer shapes and dtype
  (:func:`stack_kernels` validates).
* **Per-member RNG streams.**  Each member draws its bank permutations
  and block orders from its own seed (:func:`member_plan`, numpy's
  ``RandomState``, so the plans equal the JAX package's array for
  array).  Member ``i`` of a fleet run therefore follows the trajectory
  of a standalone run of that member with the same seed:
  :func:`train_fleet` equals :func:`train_sequential` bitwise.
* **Scan-ordered bank reuse.**  Per refresh group each member's bank
  ``X[perm]`` is gathered once on the device; each epoch visits the
  bank's B-row blocks in the member's own order.

Where the JAX package vmaps ``dp.train_step_math`` (XLA), the port runs
each epoch of the whole fleet as ONE launch of kernel #6,
``ops.batch_step.train_fleet_epoch_dbuf_banked`` (one thread-block
cluster per member, its size planned from the card), then counts each
member over the full ``X``, ``T``.  The
per-member baseline (:func:`make_member_epoch_fn`,
:func:`train_sequential`) launches #4, ``train_epoch_grid_banked``,
once per member and epoch.  The epoch functions update the stacked
weights (and dw) IN PLACE and return them.

Parity mode: with ``HPNN_LEDGER`` (or ``HPNN_PROBES``/``HPNN_NUMERICS``)
set, :func:`train_fleet`, :func:`train_fleet_multi` and
:func:`train_sequential` write one ``ledger.round`` row per member, in
member order, from the members' final weights, so ``tools/ledger_diff.py``
pairs a fleet ledger with a sequential one, a card run's with a CPU
run's, and the port's with the JAX package's.  Observability as in the
JAX package: ``fleet.size`` gauge, ``fleet.round`` / ``fleet.multi_round``
/ ``fleet.sequential`` events, ``train.fleet_round`` /
``train.multi_round`` / ``train.member_round`` spans (a
``train.fleet_round`` covers the whole call, its children
``fleet.stage``, ``fleet.plan``, ``fleet.gather``, ``fleet.epoch``,
``fleet.count``, ``fleet.sync`` and ``fleet.result`` each part), and under
``HPNN_COST`` the ``perf.*`` gauges of every launch of #6
(``fleet.epoch``) and #4 (``fleet.member_epoch``).

``dtype="bf16"`` runs the kernel's bf16 build: weights, dw and the data
cast once to bfloat16 before the first launch, every product
accumulated in float32 inside the kernel, and the results cast back
through float32 to the members' dtype, as the JAX package casts them.
On the CPU the plain version runs the step math on bfloat16 tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.parallel import dp
from hpnn_tpu_torch.train import batch as batch_mod

__all__ = [
    "stack_kernels",
    "unstack_kernels",
    "member_plan",
    "fleet_plan",
    "multi_round_plan",
    "make_fleet_epoch_fn",
    "make_member_epoch_fn",
    "make_fleet_multi_round_fn",
    "train_fleet",
    "train_fleet_multi",
    "train_sequential",
    "quant_probe_fleet",
]

# the ``dtype=`` names of the JAX package
TRAIN_DTYPES = ("bf16", "f32", "f64")
_TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
                 "f64": torch.float64}


def _train_dtype(name, dev):
    """The compute dtype: ``runtime.compute_dtype`` for None, else the
    named one."""
    if name is None:
        return runtime.compute_dtype(dev)
    if name not in TRAIN_DTYPES:
        raise ValueError(f"unknown train dtype {name!r}; one of {TRAIN_DTYPES}")
    return _TORCH_DTYPES[name]


# ------------------------------------------------------------------ stacking
def _check_same_topology(kernels):
    if not kernels:
        raise ValueError("fleet needs at least one kernel")
    ref_shapes = tuple(np.shape(w) for w in kernels[0].weights)
    ref_dtype = np.asarray(kernels[0].weights[0]).dtype
    for i, k in enumerate(kernels):
        shapes = tuple(np.shape(w) for w in k.weights)
        dtype = np.asarray(k.weights[0]).dtype
        if shapes != ref_shapes or dtype != ref_dtype:
            raise ValueError(
                f"fleet member {i} topology {shapes}/{dtype} "
                f"!= member 0 {ref_shapes}/{ref_dtype}; same-topology "
                "kernels only (the serve layer groups mixed populations)")


def stack_kernels(kernels, *, device=None, dtype=None) -> tuple:
    """Stack N same-topology kernels' weights along a new leading
    member axis: ``stacked[l].shape == (N,) + weights[l].shape``, as
    contiguous tensors on ``device`` (default ``cuda``; raises
    ``runtime.DeviceUnavailable`` without a card) in ``dtype`` (default
    the members' own).  The kernels may come from either package: their
    weights are host numpy arrays.  Validates topology/dtype agreement
    first."""
    _check_same_topology(kernels)
    dev = runtime.resolve_device(device)
    return tuple(
        torch.tensor(np.stack([np.asarray(k.weights[l]) for k in kernels]),
                     device=dev, dtype=dtype)
        for l in range(len(kernels[0].weights)))


def unstack_kernels(stacked) -> list:
    """Inverse of :func:`stack_kernels`: split the member axis back into
    a list of :class:`Kernel` (host numpy copies, in the tensors'
    dtype; bfloat16, which numpy lacks, comes back as float32)."""
    mats = [(w.float() if w.dtype == torch.bfloat16 else w)
            .detach().to("cpu", copy=True).numpy() for w in stacked]
    return [kernel_mod.Kernel(weights=tuple(m[i] for m in mats))
            for i in range(mats[0].shape[0])]


# ------------------------------------------------------------------ planning
def member_plan(seed: int, *, n_rows: int, batch: int, epochs: int,
                refresh: int = 8):
    """One member's private RNG stream → (perms, orders) index plan for
    the scan-ordered bank: perms ``(G, n_rows)`` int32 bank permutations
    (one per refresh group) and orders ``(G, R, S)`` int32 per-epoch
    block orders, with ``G·R == epochs`` and ``S == n_rows // batch``.
    When ``refresh`` does not divide ``epochs`` it degrades to refresh=1
    (a fresh permutation every epoch)."""
    if n_rows % batch:
        raise ValueError(f"batch {batch} must divide n_rows {n_rows}")
    n_steps = n_rows // batch
    if epochs % refresh:
        refresh = 1
    groups = epochs // refresh
    rng = np.random.RandomState(seed)
    perms = np.stack([rng.permutation(n_rows) for _ in range(groups)])
    orders = np.stack([
        np.stack([rng.permutation(n_steps) for _ in range(refresh)])
        for _ in range(groups)])
    return perms.astype(np.int32), orders.astype(np.int32)


def fleet_plan(seeds, *, n_rows: int, batch: int, epochs: int,
               refresh: int = 8):
    """Stack :func:`member_plan` over members: perms ``(N, G, n_rows)``,
    orders ``(N, G, R, S)``, one independent stream per member."""
    plans = [member_plan(int(s), n_rows=n_rows, batch=batch,
                         epochs=epochs, refresh=refresh) for s in seeds]
    return (np.stack([p for p, _ in plans]),
            np.stack([o for _, o in plans]))


def multi_round_plan(seed_rounds, *, n_rows: int, batch: int,
                     epochs: int, refresh: int = 8):
    """Stack :func:`fleet_plan` over K training rounds: given
    ``seed_rounds[k][i]`` (round ``k``, member ``i``) returns perms
    ``(N, K, G, n_rows)`` and orders ``(N, K, G, R, S)``.  Round ``k``
    draws exactly the plan a standalone :func:`train_fleet` call with
    ``seeds=seed_rounds[k]`` would."""
    plans = [fleet_plan(seeds_k, n_rows=n_rows, batch=batch,
                        epochs=epochs, refresh=refresh)
             for seeds_k in seed_rounds]
    n = {p.shape[0] for p, _ in plans}
    if len(n) != 1:
        raise ValueError(f"rounds disagree on member count: {sorted(n)}")
    return (np.stack([p for p, _ in plans], axis=1),
            np.stack([o for _, o in plans], axis=1))


# ------------------------------------------------------------------ epoch fns
def _epoch_setup(n_steps, model, momentum, lr, alpha, count):
    """The step keywords, the per-member counter ``counter(weights, X, T)
    -> int32 tensor`` (None when ``count`` is off) and the block size
    of a bank."""
    lr = dp.default_lr(model, momentum) if lr is None else float(lr)
    kw = dict(model=model, momentum=momentum, lr=lr, alpha=alpha)
    ev = batch_mod.make_eval_fn(model=model)

    def counter(weights, X, T):
        return batch_mod.count_correct(ev(weights, X), T, model).to(torch.int32)

    def batch_of(X):
        if n_steps < 1 or X.shape[0] % n_steps:
            raise ValueError(f"{X.shape[0]} rows are not {n_steps} whole blocks")
        return X.shape[0] // n_steps

    return kw, counter if count else None, batch_of


def _timed(name, fn, weights, n_steps, batch, members, momentum, kernel):
    """One launch, recorded under ``HPNN_COST`` against ``members``
    times one member's epoch of work (``obs.cost.batch_work``)."""
    if not obs.cost.enabled():
        return fn()
    nbytes, flops = obs.cost.batch_work(
        [tuple(w.shape) for w in weights], n_steps, momentum,
        weights[0].element_size(), batch)
    # against the card's peak for the stored type (bf16's is its
    # tensor-core rate, though the kernel's products run on float32 FMA)
    return obs.cost.timed_launch(
        name, fn, nbytes=members * nbytes, flops=members * flops,
        dtype=weights[0].dtype, device=weights[0].device,
        kernel=kernel, members=members)


def make_member_epoch_fn(n_steps: int, *, model: str = "ann",
                         momentum: bool = False, lr: float | None = None,
                         alpha: float = 0.2, count: bool = True):
    """Single-member run, the per-kernel loop baseline:
    ``run(weights, dw, X, T, perms[G, n_rows], orders[G, R, S]) ->
    (weights, dw, losses[G·R, S], counts[G·R])``, one launch of
    ``train_epoch_grid_banked`` per epoch."""
    kw, counter, batch_of = _epoch_setup(n_steps, model, momentum, lr, alpha, count)

    def run(weights, dw, X, T, perms, orders):
        B = batch_of(X)
        perms, orders = np.asarray(perms), np.asarray(orders)
        losses, counts = [], []
        for g in range(orders.shape[0]):
            idx = torch.from_numpy(perms[g]).to(device=X.device, dtype=torch.long)
            Xp, Tp = X[idx], T[idx]
            for r in range(orders.shape[1]):
                losses.append(_timed(
                    "fleet.member_epoch", lambda: batch_step.train_epoch_grid_banked(
                        weights, dw, Xp, Tp, orders[g, r], batch=B, **kw)[2],
                    weights, n_steps, B, 1, momentum, "train_epoch_grid_banked"))
                counts.append(torch.zeros((), dtype=torch.int32, device=X.device)
                              if counter is None else counter(weights, X, T))
        return weights, dw, torch.stack(losses), torch.stack(counts)

    return run


def make_fleet_epoch_fn(n_steps: int, *, model: str = "ann",
                        momentum: bool = False, lr: float | None = None,
                        alpha: float = 0.2, count: bool = True):
    """Fleet run over the leading member axis of (weights, dw, perms,
    orders); X/T are shared (each member reads its own permutation of
    the same bank).  ``run(stacked_w, stacked_dw, X, T, perms[N, G,
    n_rows], orders[N, G, R, S]) -> (stacked_w, stacked_dw,
    losses[N, G·R, S], counts[N, G·R])``: per refresh group one gather
    of the members' banks, per epoch ONE launch of
    ``train_fleet_epoch_dbuf_banked`` for the whole fleet."""
    kw, counter, batch_of = _epoch_setup(n_steps, model, momentum, lr, alpha, count)

    def run(stacked_w, stacked_dw, X, T, perms, orders):
        B = batch_of(X)
        perms, orders = np.asarray(perms), np.asarray(orders)
        n = orders.shape[0]
        losses, counts = [], []
        for g in range(orders.shape[1]):
            with obs.spans.span("fleet.gather", members=n):
                idx = torch.from_numpy(perms[:, g]).to(device=X.device, dtype=torch.long)
                X_banks, T_banks = X[idx], T[idx]
            for r in range(orders.shape[2]):
                with obs.spans.span("fleet.epoch", members=n):
                    losses.append(_timed(
                        "fleet.epoch", lambda: batch_step.train_fleet_epoch_dbuf_banked(
                            stacked_w, stacked_dw, X_banks, T_banks, orders[:, g, r],
                            batch=B, **kw)[2],
                        [w[0] for w in stacked_w], n_steps, B, n, momentum,
                        "train_fleet_epoch_dbuf_banked"))
                # each member counted on its own copy of its weights: the
                # operands a standalone run's count sees, so the counts
                # agree bitwise with train_sequential's too
                with obs.spans.span("fleet.count", members=n):
                    counts.append(
                        torch.zeros(n, dtype=torch.int32, device=X.device)
                        if counter is None else torch.stack([
                            counter(tuple(w[i].clone() for w in stacked_w), X, T)
                            for i in range(n)]))
        return (stacked_w, stacked_dw, torch.stack(losses, dim=1),
                torch.stack(counts, dim=1))

    return run


def make_fleet_multi_round_fn(n_steps: int, *, model: str = "ann",
                              momentum: bool = False,
                              lr: float | None = None,
                              alpha: float = 0.2, count: bool = True):
    """K-round fleet run: the fleet run chained over the round axis.
    ``run(stacked_w, stacked_dw, X, T, perms[N, K, G, n_rows],
    orders[N, K, G, R, S]) -> (stacked_w, stacked_dw, losses[N, K, G·R,
    S], counts[N, K, G·R])``, every round's losses and counts kept."""
    base = make_fleet_epoch_fn(n_steps, model=model, momentum=momentum,
                               lr=lr, alpha=alpha, count=count)

    def run(stacked_w, stacked_dw, X, T, perms, orders):
        perms, orders = np.asarray(perms), np.asarray(orders)
        losses, counts = [], []
        for k in range(orders.shape[1]):
            _, _, l_k, c_k = base(stacked_w, stacked_dw, X, T, perms[:, k], orders[:, k])
            losses.append(l_k)
            counts.append(c_k)
        return (stacked_w, stacked_dw, torch.stack(losses, dim=1),
                torch.stack(counts, dim=1))

    return run


# ------------------------------------------------------------------ training
def _zeros_dw(stacked_or_weights, momentum: bool):
    if not momentum:
        return ()
    return tuple(torch.zeros_like(w) for w in stacked_or_weights)


def _setup(prog, kernels, X, T, dtype, device):
    """Refusals, then the device, compute dtype, members' host dtype
    and the data as tensors."""
    runtime.refuse_deferred(prog)
    dev = runtime.resolve_device(device)
    cdt = _train_dtype(dtype, dev)
    _check_same_topology(kernels)
    host_dtype = np.asarray(kernels[0].weights[0]).dtype
    Xd = torch.as_tensor(X, device=dev, dtype=cdt).contiguous()
    Td = torch.as_tensor(T, device=dev, dtype=cdt).contiguous()
    return dev, cdt, host_dtype, Xd, Td


def _result(stacked, losses, counts, host_dtype, dtype):
    """Kernels cast back to the members' host dtype; losses (float32
    under an explicit ``dtype``, as in the JAX package) and counts as
    numpy."""
    out = [kernel_mod.Kernel(tuple(w.astype(host_dtype) for w in k.weights))
           for k in unstack_kernels(stacked)]
    if dtype is not None:
        losses = losses.float()
    return out, losses.cpu().numpy(), counts.cpu().numpy()


def _record_member_rows(kernels, *, step):
    """Parity hook: one numerics check (one ``ledger.round`` row) per
    member, in member order; no work unless a numerics knob is set."""
    for k in kernels:
        obs.probes.check_weights(k.weights, step=step, where="fleet_round")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seeds(seeds, n):
    seeds = list(range(n)) if seeds is None else list(seeds)
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} members")
    return seeds


def train_fleet(kernels, X, T, *, epochs: int, batch: int, seeds=None,
                model: str = "ann", momentum: bool = False,
                lr: float | None = None, alpha: float = 0.2,
                refresh: int = 8, count: bool = True,
                dtype: str | None = None, device=None):
    """Train the whole fleet, one launch per epoch.

    Returns ``(kernels_out, losses[N, epochs, S], counts[N, epochs])``
    where member ``i`` trained on its own RNG stream ``seeds[i]``
    (default ``0..N-1``).  Runs on ``device`` (default ``cuda``; raises
    ``runtime.DeviceUnavailable`` without a card) in ``dtype`` ("bf16",
    "f32", "f64"; default ``runtime.compute_dtype``); the weights come
    back in the members' own dtype."""
    n = len(kernels)
    with obs.spans.span("train.fleet_round", members=n, epochs=epochs, mode="fleet"):
        seeds = _seeds(seeds, n)
        with obs.spans.span("fleet.stage", members=n):
            dev, cdt, host_dtype, Xd, Td = _setup("train_fleet", kernels, X, T, dtype,
                                                  device)
            stacked = stack_kernels(kernels, device=dev, dtype=cdt)
            dw = _zeros_dw(stacked, momentum)
        with obs.spans.span("fleet.plan", members=n):
            perms, orders = fleet_plan(seeds, n_rows=Xd.shape[0], batch=batch,
                                       epochs=epochs, refresh=refresh)
        n_steps = Xd.shape[0] // batch
        fn = make_fleet_epoch_fn(n_steps, model=model, momentum=momentum,
                                 lr=lr, alpha=alpha, count=count)
        obs.gauge("fleet.size", n, where="train")
        t0 = time.perf_counter()
        stacked, dw, losses, counts = fn(stacked, dw, Xd, Td, perms, orders)
        with obs.spans.span("fleet.sync", members=n):
            _sync(dev)
        dt = time.perf_counter() - t0
        obs.event("fleet.round", members=n, epochs=epochs, batch=batch, steps=n_steps,
                  mode="fleet", dispatch_s=round(dt, 6), dtype=dtype or str(host_dtype))
        with obs.spans.span("fleet.result", members=n):
            out = _result(stacked, losses, counts, host_dtype, dtype)
            _record_member_rows(out[0], step=epochs)
    return out


def train_fleet_multi(kernels, X, T, *, rounds: int, epochs: int,
                      batch: int, seed_rounds=None, model: str = "ann",
                      momentum: bool = False, lr: float | None = None,
                      alpha: float = 0.2, refresh: int = 8,
                      count: bool = True, dtype: str | None = None,
                      device=None):
    """Train K rounds of the whole fleet in one call: round ``k`` uses
    seeds ``seed_rounds[k]`` (default round-major ``k*N .. k*N+N-1``),
    and the result equals K chained :func:`train_fleet` calls with the
    same seeds bitwise.  Returns ``(kernels_out, losses[N, rounds,
    epochs, S], counts[N, rounds, epochs])``."""
    n = len(kernels)
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if seed_rounds is None:
        seed_rounds = [[k * n + i for i in range(n)] for k in range(rounds)]
    seed_rounds = [list(s) for s in seed_rounds]
    if len(seed_rounds) != rounds or any(len(s) != n for s in seed_rounds):
        raise ValueError(f"seed_rounds must be {rounds} rounds x {n} members")
    dev, cdt, host_dtype, Xd, Td = _setup("train_fleet_multi", kernels, X, T,
                                          dtype, device)
    stacked = stack_kernels(kernels, device=dev, dtype=cdt)
    dw = _zeros_dw(stacked, momentum)
    perms, orders = multi_round_plan(seed_rounds, n_rows=Xd.shape[0], batch=batch,
                                     epochs=epochs, refresh=refresh)
    n_steps = Xd.shape[0] // batch
    fn = make_fleet_multi_round_fn(n_steps, model=model, momentum=momentum,
                                   lr=lr, alpha=alpha, count=count)
    obs.gauge("fleet.size", n, where="train_multi")
    with obs.spans.span("train.multi_round", members=n, k=rounds, epochs=epochs,
                        mode="multi_round"):
        t0 = time.perf_counter()
        stacked, dw, losses, counts = fn(stacked, dw, Xd, Td, perms, orders)
        _sync(dev)
        dt = time.perf_counter() - t0
    obs.event("fleet.multi_round", members=n, k=rounds, epochs=epochs, batch=batch,
              steps=n_steps, mode="multi_round", dispatch_s=round(dt, 6),
              dtype=dtype or str(host_dtype))
    out = _result(stacked, losses, counts, host_dtype, dtype)
    # one row per member from the final weights: a multi-round ledger
    # pairs with the LAST round of a sequential baseline
    _record_member_rows(out[0], step=rounds * epochs)
    return out


def quant_probe_fleet(kernels, X, T, *, epochs: int, batch: int,
                      seeds=None, dtype: str = "bf16", **kwargs):
    """Paired low-precision/full-precision fleet round: :func:`train_fleet`
    twice with identical RNG plans, at the compute dtype and under
    ``dtype``; returns ``(out_low, out_ref, err)`` with ``err`` the max
    over members and layers of ``|low - ref|``, and the
    ``numerics.quant_err`` gauge.  An unknown ``dtype`` raises before
    either run."""
    if dtype is not None:
        _train_dtype(dtype, None)
    out_ref, _, _ = train_fleet(kernels, X, T, epochs=epochs, batch=batch,
                                seeds=seeds, **kwargs)
    out_low, _, _ = train_fleet(kernels, X, T, epochs=epochs, batch=batch,
                                seeds=seeds, dtype=dtype, **kwargs)
    err = 0.0
    for k_low, k_ref in zip(out_low, out_ref):
        for wl, wr in zip(k_low.weights, k_ref.weights):
            d = np.max(np.abs(np.asarray(wl, dtype=np.float64)
                              - np.asarray(wr, dtype=np.float64)))
            err = max(err, float(d))
    obs.gauge("numerics.quant_err", err, where="fleet", dtype=dtype,
              members=len(kernels), epochs=epochs)
    return out_low, out_ref, err


def train_sequential(kernels, X, T, *, epochs: int, batch: int,
                     seeds=None, model: str = "ann",
                     momentum: bool = False, lr: float | None = None,
                     alpha: float = 0.2, refresh: int = 8,
                     count: bool = True, device=None):
    """The per-kernel loop baseline: identical math, identical
    per-member RNG streams, but one launch per member and epoch.  Equal
    to :func:`train_fleet` bitwise, in the same return layout."""
    seeds = _seeds(seeds, len(kernels))
    dev, cdt, host_dtype, Xd, Td = _setup("train_sequential", kernels, X, T,
                                          None, device)
    n_steps = Xd.shape[0] // batch
    fn = make_member_epoch_fn(n_steps, model=model, momentum=momentum,
                              lr=lr, alpha=alpha, count=count)
    obs.gauge("fleet.size", len(kernels), where="train_sequential")
    out, all_losses, all_counts = [], [], []
    t0 = time.perf_counter()
    for i, (k, seed) in enumerate(zip(kernels, seeds)):
        perms, orders = member_plan(int(seed), n_rows=Xd.shape[0], batch=batch,
                                    epochs=epochs, refresh=refresh)
        w, _ = kernel_mod.to_torch(k.weights, device=dev, dtype=cdt)
        with obs.spans.span("train.member_round", member=i, epochs=epochs,
                            mode="sequential"):
            w, dw, losses, counts = fn(w, _zeros_dw(w, momentum), Xd, Td, perms, orders)
            _sync(dev)
        out.append(kernel_mod.Kernel(tuple(
            t.cpu().numpy().astype(host_dtype) for t in w)))
        all_losses.append(losses.cpu().numpy())
        all_counts.append(counts.cpu().numpy())
    obs.event("fleet.sequential", members=len(kernels), epochs=epochs, batch=batch,
              steps=n_steps, mode="sequential",
              dispatch_s=round(time.perf_counter() - t0, 6))
    _record_member_rows(out, step=epochs)
    return out, np.stack(all_losses), np.stack(all_counts)
