"""ANN (tanh-sigmoid MLP) numerics: forward / error / deltas / updates.

Plain functions over tuples of weight tensors, the plain PyTorch
counterpart of the reference's serial C code (ref:
libhpnn src/ann.c).  Vectors are 1-D tensors; ``weights[l]``
is ``(n_l, m_l)``.  Every function computes in the dtype and on the
device of its inputs.

Math (all from the reference, SURVEY.md §2.3):

* activation  ``act(x) = 2/(1+exp(-x)) - 1``; derivative expressed in
  terms of the *output* ``dact(y) = -0.5*(y^2-1)``
  (ref: src/ann.c:883-888).
* forward     ``v_l = act(W_l · v_{l-1})`` for every layer including
  the output layer (ref: src/ann.c:892-1242).
* error       ``Ep = 0.5 * Σ (t-o)^2`` (ref: src/ann.c:1246-1275).
* deltas      output: ``δ = (t-o)·dact(o)``; hidden:
  ``δ_l = (W_{l+1}^T · δ_{l+1}) · dact(v_l)`` (ref: src/ann.c:1279-1592).
* BP update   ``W_l += η · δ_l ⊗ v_{l-1}`` with η = BP_LEARN_RATE = 0.001
  (ref: src/ann.c:1636-1857; the ``#define LEARN_RATE 0.01`` at
  src/ann.c:1597 is dead in the BP code).
* BPM update  ``dw += η·δ⊗v; W += dw; dw *= α`` with
  η = BPM_LEARN_RATE = 0.0005 (ref: src/ann.c:1982-2277).
* one training iteration computes Ep, deltas, update, then re-runs the
  forward pass and returns ``Ep - Epr`` (ref: src/ann.c:1862-1872).
"""

from __future__ import annotations

import torch

BP_LEARN_RATE = 0.001
BPM_LEARN_RATE = 0.0005


def act(x):
    return 2.0 / (1.0 + torch.exp(-x)) - 1.0


def dact(y):
    return -0.5 * (y * y - 1.0)


def forward(weights, x):
    """All layer activations: (x, v_1, ..., v_out)."""
    acts = [x]
    v = x
    for w in weights:
        v = act(torch.mv(w, v))
        acts.append(v)
    return tuple(acts)


def run(weights, x):
    """Output vector only (``ann_kernel_run``)."""
    return forward(weights, x)[-1]


def run_batch(weights, X):
    """``run`` over the rows of a ``(B, n_in)`` batch."""
    v = X
    for w in weights:
        v = act(torch.matmul(v, w.T))
    return v


def train_error(out, target):
    d = target - out
    return 0.5 * torch.sum(d * d)


def hidden_deltas(weights, acts, d_out):
    """δ per weight layer from the output δ, returned input-first."""
    ds = [d_out]
    for l in range(len(weights) - 1, 0, -1):
        ds.insert(0, torch.mv(weights[l].T, ds[0]) * dact(acts[l]))
    return tuple(ds)


def deltas(weights, acts, target):
    """δ per weight layer, output first computed, returned input-first."""
    return hidden_deltas(weights, acts, (target - acts[-1]) * dact(acts[-1]))


def bp_update(weights, acts, ds, lr):
    return tuple(
        w + lr * torch.outer(d, v) for w, d, v in zip(weights, ds, acts[:-1])
    )


def bpm_update(weights, dw, acts, ds, lr, alpha):
    new_w = []
    new_dw = []
    for w, m, d, v in zip(weights, dw, ds, acts[:-1]):
        m = m + lr * torch.outer(d, v)
        new_w.append(w + m)
        new_dw.append(alpha * m)
    return tuple(new_w), tuple(new_dw)


def train_iteration(weights, acts, x, target):
    """One BP iteration (``ann_kernel_train``, src/ann.c:1596-1872).

    ``acts`` must hold the activations of the *current* weights.
    Returns (new_weights, new_acts, Ep - Epr).
    """
    ep = train_error(acts[-1], target)
    ds = deltas(weights, acts, target)
    weights = bp_update(weights, acts, ds, BP_LEARN_RATE)
    acts = forward(weights, x)
    epr = train_error(acts[-1], target)
    return weights, acts, ep - epr


def train_iteration_momentum(weights, dw, acts, x, target, alpha):
    """One BPM iteration (``ann_kernel_train_momentum``, src/ann.c:1942)."""
    ep = train_error(acts[-1], target)
    ds = deltas(weights, acts, target)
    weights, dw = bpm_update(weights, dw, acts, ds, BPM_LEARN_RATE, alpha)
    acts = forward(weights, x)
    epr = train_error(acts[-1], target)
    return weights, dw, acts, ep - epr
