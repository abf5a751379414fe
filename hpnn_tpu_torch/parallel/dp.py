"""Minibatch steepest descent: the math of one data-parallel step.

The port of ``hpnn_tpu/parallel/dp.py``'s step math, on one device:
one step per minibatch on the MEAN sample error, at the reference's
per-sample learning rates (the delta-rule update ``W += η·δ⊗v`` is
``W -= η·∇Ep``).  Sharding, collectives and multi-process placement
belong to the multi-GPU slice and are not here.

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

import torch

from hpnn_tpu_torch.models import ann, snn


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
