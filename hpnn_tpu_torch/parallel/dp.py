"""Minibatch steepest descent: the math of one data-parallel step, on
one device and over a mesh (the port of ``hpnn_tpu/parallel/dp.py``).

One step per minibatch on the MEAN sample error, at the reference's
per-sample learning rates (the delta-rule update ``W += η·δ⊗v`` is
``W -= η·∇Ep``).

Over a ``(data, model)`` mesh (:func:`make_gspmd_train_step` and its
epoch, :func:`make_gspmd_epoch_fn`; the JAX package's explicit-``pmean``
pure-DP step is the same function on a mesh of one model rank): each
data shard takes its B/D rows of every batch, each model rank its row block of every layer (padded as
``parallel/tp.py`` pads, the padded outputs masked), the forward and
deltas run through ``tp``'s batched functions, and the local mean
gradients are averaged over the data axis with an all-reduce
(``coll.pmean``), as is the post-update loss.

* ANN: the gradient is the hand delta rule, which is what ``jax.grad``
  over the JAX package's ``ann.act`` (whose custom JVP is ``dact(y)``)
  computes.
* SNN: the reference's hand delta ``δ = t − o`` (the softmax+CE
  shortcut, without the Jacobian of its quirky ``exp(z−1)/(TINY+Σ)``
  forward), and targets read as 0/1: the sample containers write ±1
  one-hots, and a batch MEAN of ``t − o`` with ``t = −1`` on all but one
  output sinks every logit until training freezes, while the clamp
  ``−1 → 0`` gives the standard softmax-CE reading of the same files.

Every function computes in the dtype and on the device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.parallel import coll, tp
from hpnn_tpu_torch.parallel.mesh import DATA_AXIS


def _targets(T, model: str):
    return torch.clamp_min(T, 0.0) if model == "snn" else T


def _forward(weights, X, model: str):
    """All layer activations of a ``(B, n_in)`` batch: (X, v_1, ..., out)."""
    acts = [X]
    v = X
    for l, w in enumerate(weights):
        z = torch.matmul(v, w.T)
        v = snn.softmax_out(z) if model == "snn" and l == len(weights) - 1 else ann.act(z)
        acts.append(v)
    return acts


def _row_errors(out, T, model: str):
    """Per-row sample error of ``(B, n_out)`` outputs against targets
    already read for the model."""
    if model == "snn":
        return -torch.sum(T * torch.log(out + snn.TINY), dim=-1) / out.shape[-1]
    d = T - out
    return 0.5 * torch.sum(d * d, dim=-1)


def sample_loss(weights, x, target, *, model: str = "ann"):
    """Error of one sample (SNN targets read as 0/1)."""
    return batch_loss(weights, x[None], target[None], model=model)


def batch_loss(weights, X, T, *, model: str = "ann"):
    """Mean per-sample error over the batch's leading axis."""
    out = _forward(weights, X, model)[-1]
    return torch.mean(_row_errors(out, _targets(T, model), model))


def batch_grads(weights, X, T, *, model: str):
    """Mean gradient over the batch: ``-(1/B) Σ_b δ_b ⊗ v_b`` per layer,
    with the output δ ``(t − o)·dact(o)`` (ANN) or ``t − o`` (SNN) and
    the hidden ``δ_l = (δ_{l+1} · W_{l+1}) · dact(v_l)``."""
    T = _targets(T, model)
    acts = _forward(weights, X, model)
    out = acts[-1]
    d = T - out if model == "snn" else (T - out) * ann.dact(out)
    ds = [d]
    for l in range(len(weights) - 1, 0, -1):
        ds.insert(0, torch.matmul(ds[0], weights[l]) * ann.dact(acts[l]))
    inv_b = 1.0 / X.shape[0]
    # sgd_step does W −= lr·g, the reference does W += η·δ⊗v
    return tuple(-inv_b * torch.matmul(dl.T, v) for dl, v in zip(ds, acts[:-1]))


def sgd_step(weights, grads, lr):
    return tuple(w - lr * g for w, g in zip(weights, grads))


def momentum_step(weights, dw, grads, lr, alpha):
    """Batched analogue of the reference's BPM triad
    ``dw += η·δ⊗v; W += dw; dw *= α``."""
    new_w, new_dw = [], []
    for w, m, g in zip(weights, dw, grads):
        m = m - lr * g
        new_w.append(w + m)
        new_dw.append(alpha * m)
    return tuple(new_w), tuple(new_dw)


def default_lr(model: str, momentum: bool) -> float:
    if model == "snn":
        return snn.SNN_LEARN_RATE
    return ann.BPM_LEARN_RATE if momentum else ann.BP_LEARN_RATE


def train_step_math(weights, dw, X, T, *, model: str, momentum: bool,
                    lr: float, alpha: float):
    """One minibatch steepest-descent step and the post-update loss.
    Returns (weights, dw, loss) as new tensors; ``dw`` is passed through
    unchanged without momentum."""
    grads = batch_grads(weights, X, T, model=model)
    if momentum:
        weights, dw = momentum_step(weights, dw, grads, lr, alpha)
    else:
        weights = sgd_step(weights, grads, lr)
    return weights, dw, batch_loss(weights, X, T, model=model)


# ------------------------------------------------------------ over a mesh
def make_gspmd_train_step(mesh, *, model: str = "ann", momentum: bool = False,
                          lr: float | None = None, alpha: float = 0.2, n_out: int):
    """The DP × TP step: ``step(weights_loc, dw_loc, X_loc, T_loc) ->
    (weights_loc, dw_loc, loss)`` on this rank's ``(b, n)`` rows of the
    batch and row blocks of the (padded) kernel: the local mean
    gradient of the local row blocks, averaged over the data axis, and
    the loss the batch mean after the update; ``n_out`` is the real
    output count.  Matmuls in full float32 (TF32 off), as the
    kernels'."""
    if lr is None:
        lr = default_lr(model, momentum)

    def step(weights_loc, dw_loc, X, T):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            T = _targets(T, model)
            acts = tp.forward_local(weights_loc, X, model=model, n_out=n_out, mesh=mesh)
            ds = tp.deltas_local(weights_loc, acts, T, model=model, mesh=mesh)
            inv_b = 1.0 / X.shape[0]
            grads = tuple(
                coll.pmean(-inv_b * torch.matmul(tp._my_block(dl, mesh).T, v), mesh,
                           DATA_AXIS, layer=i)
                for i, (dl, v) in enumerate(zip(ds, acts[:-1])))
            if momentum:
                weights_loc, dw_loc = momentum_step(weights_loc, dw_loc, grads, lr, alpha)
            else:
                weights_loc = sgd_step(weights_loc, grads, lr)
            out = tp.forward_local(weights_loc, X, model=model, n_out=n_out, mesh=mesh)[-1]
            loss = torch.mean(tp.train_error(out, T, model, n_out))
            return weights_loc, dw_loc, coll.pmean(loss, mesh, DATA_AXIS, role="loss")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return step


def make_gspmd_epoch_fn(mesh, *, model: str = "ann", momentum: bool = False,
                        lr: float | None = None, alpha: float = 0.2, n_out: int,
                        gather: bool = False):
    """A whole epoch of :func:`make_gspmd_train_step` steps:
    ``epoch(weights_loc, dw_loc, *data) -> (weights_loc, dw_loc,
    losses)``.  ``gather=False``: ``data`` is this rank's
    ``(n_steps, b, n)`` shards of the epoch's batches
    (:func:`shard_batch_steps`); ``gather=True`` (one data shard):
    ``(X, T, idx)``, the whole bank and the ``(n_steps, B)`` row
    indices of each step."""
    step = make_gspmd_train_step(mesh, model=model, momentum=momentum, lr=lr,
                                 alpha=alpha, n_out=n_out)

    def epoch(weights_loc, dw_loc, *data):
        if gather:
            X, T, idx = data
            batches = ((X[ix], T[ix]) for ix in idx)
        else:
            batches = zip(*data)
        losses = []
        for Xb, Tb in batches:
            weights_loc, dw_loc, loss = step(weights_loc, dw_loc, Xb, Tb)
            losses.append(loss)
        return weights_loc, dw_loc, torch.stack(losses)

    return epoch


def divergence_check(names, values, tols, *, step=None, where=None):
    """Cross-rank checksum comparison: the divergence sentinel's core.

    Every rank all-gathers its same-ordered per-tensor checksums
    (``dist.allgather_checksums``) and compares each column against
    rank 0 under its tolerance (1e-14 vectors / 1e-12 matrices, the
    reference's ChangeLog:33-38).  Returns finding dicts ``{"tensor",
    "spread", "tol", "values"}``, empty when the ranks agree or the
    process is alone."""
    from hpnn_tpu_torch.parallel import dist

    every = dist.allgather_checksums(values)
    if every.shape[0] < 2:
        return []
    findings = []
    for i, name in enumerate(names):
        col = every[:, i]
        if np.isnan(col).any():
            # divergent iff SOME ranks went NaN; all-NaN ranks "agree"
            # (the numerics.nan event covers that failure)
            if np.isnan(col).all():
                continue
            spread = float("nan")
        else:
            spread = float(np.abs(col - col[0]).max())
            if spread <= float(tols[i]):
                continue
        findings.append({"tensor": name, "spread": spread, "tol": float(tols[i]),
                         "values": [float(v) for v in col]})
    return findings


def shard_batch_steps(Xs, Ts, mesh):
    """This data shard's rows of ``(n_steps, B, n)`` epoch batches."""
    k, i = mesh.shape[DATA_AXIS], mesh.index[DATA_AXIS]
    b = Xs.shape[1] // k
    return Xs[:, i * b:(i + 1) * b], Ts[:, i * b:(i + 1) * b]
