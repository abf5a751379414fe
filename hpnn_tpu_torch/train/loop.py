"""Per-sample convergence training loop — the innermost hot loop.

The reference trains each sample with a data-dependent do-while (up to
102399 iterations) around one backprop step + re-forward
(``ann_train_BP``/``ann_train_BPM``, ref: libhpnn src/ann.c:
2281-2467; ``snn_train_BP/BPM``, src/snn.c:1414-1597):

    iter = 0
    do {
        iter++
        dEp = train_step()               # Ep - Epr of this step
        is_ok = argmax(out) == argmax-of-last(target == 1.0)
        if iter == 1: record first-try OK/NO
        if iter > MAX_ITER: break        # before the MIN clamp!
        is_ok &= (iter > MIN_ITER)
    } while (dEp > delta || !is_ok)

Here that loop has two forms: :func:`train_sample` is the plain
PyTorch version (one host round trip per iteration), and
:func:`train_epoch` trains a chunk of samples — through the CUDA kernel
(``ops/convergence.py``) for CUDA tensors, through the plain version
for CPU tensors.

Iteration bounds (ref: include/libhpnn.h:67-74): BP 31..102399,
BPM 15..102399, both with delta = 1e-6.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hpnn_tpu_torch.models import ann, snn

MIN_BP_ITER = 31
MAX_BP_ITER = 102399
DELTA_BP = 1e-6
MIN_BPM_ITER = 15
MAX_BPM_ITER = 102399
DELTA_BPM = 1e-6


class SampleResult(NamedTuple):
    weights: tuple
    dw: tuple
    ep0: torch.Tensor    # error after initial forward ( init= token)
    n_iter: int          # iterations executed ( N_ITER= token)
    dep: torch.Tensor    # last Ep-Epr ( final= token)
    first_ok: bool       # argmax match after iteration 1 ( OK/ NO token)
    final_ok: bool       # reported SUCCESS!/FAIL!
    out: torch.Tensor    # final output vector


def target_argmax(target) -> int:
    """p_trg: LAST index with target exactly 1.0, else 0 (ref C loop)."""
    hits = np.flatnonzero(np.asarray(target.detach().cpu()) == 1.0)
    return int(hits[-1]) if hits.size else 0


def first_argmax(out_np: np.ndarray) -> int:
    """First index of the max; the first NaN wins if any (jnp.argmax)."""
    return int(np.argmax(out_np))


def convergence_loop(
    one_iteration,
    weights,
    dw,
    acts0,
    ep0,
    p_trg: int,
    delta: float,
    *,
    min_iter: int,
    max_iter: int,
    argmax=first_argmax,
) -> SampleResult:
    """The reference's do-while convergence skeleton.

    ``one_iteration(w, m, acts) -> (w, m, acts, dEp)``; ``argmax`` maps
    the output vector (host array) to the guessed class (the mesh path
    masks its padded outputs).  C-parity
    quirks live here: the first iteration always runs, the max-iter
    break comes before the min-iter clamp, first_ok is captured at
    it==1, and final_ok = ok & (it > min_iter) after the loop.  The
    CUDA kernel (csrc/convergence.cu) mirrors this skeleton; any quirk
    change here must be applied there too.
    """
    # compare in the working dtype, as the kernel does (delta is cast)
    delta_c = torch.tensor(delta, dtype=ep0.dtype).item()
    w, m, acts = weights, dw, acts0
    it, ok, first_ok = 0, False, False
    while True:
        it += 1
        w, m, acts, dep = one_iteration(w, m, acts)
        host = torch.cat([dep.reshape(1), acts[-1]]).cpu().numpy()
        dep_v = float(host[0])
        ok = argmax(host[1:]) == p_trg
        if it == 1:
            first_ok = ok
        ok_eff = ok and it > min_iter
        if not (it <= max_iter and (dep_v > delta_c or not ok_eff)):
            break
    final_ok = ok and it > min_iter
    return SampleResult(w, m, ep0, it, dep, first_ok, final_ok, acts[-1])


def train_sample(
    weights,
    dw,
    x,
    target,
    alpha,
    delta,
    *,
    model: str = "ann",
    momentum: bool = False,
    min_iter: int = MIN_BP_ITER,
    max_iter: int = MAX_BP_ITER,
) -> SampleResult:
    """Train one sample to convergence with plain tensor operations."""
    mod = snn if model == "snn" else ann
    acts0 = mod.forward(weights, x)
    ep0 = mod.train_error(acts0[-1], target)

    def one_iteration(w, m, acts):
        if momentum:
            return mod.train_iteration_momentum(w, m, acts, x, target, alpha)
        w, acts, dep = mod.train_iteration(w, acts, x, target)
        return w, m, acts, dep

    return convergence_loop(
        one_iteration, weights, dw, acts0, ep0, target_argmax(target), delta,
        min_iter=min_iter, max_iter=max_iter,
    )


def train_epoch(
    weights,
    X,
    T,
    alpha,
    delta,
    *,
    model: str = "ann",
    momentum: bool = False,
    min_iter: int = MIN_BP_ITER,
    max_iter: int = MAX_BP_ITER,
):
    """Train the rows of ``(X, T)`` in order, the weights carried sample
    to sample and updated in place; the momentum is zeroed at every
    sample start (``ann_raz_momentum``, ref: src/ann.c:1921-1938).

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; returns the per-sample ``convergence.EpochStats``."""
    from hpnn_tpu_torch.ops import convergence

    return convergence.train_epoch(
        weights, X, T, alpha, delta,
        model=model, momentum=momentum, min_iter=min_iter, max_iter=max_iter,
    )


def run_sample(weights, x, *, model: str = "ann"):
    """Forward pass only (``ann_kernel_run``/``snn_kernel_run``)."""
    mod = snn if model == "snn" else ann
    return mod.run(weights, x)
