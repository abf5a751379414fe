"""SNN (softmax-output MLP) numerics.

The SNN kernel shares the ANN's hidden layers and differs only at the
output and in the loss (ref: libhpnn src/snn.c, SURVEY.md §2.4):

* forward: hidden layers as ANN; output logits ``z = W·v`` are turned
  into ``o_i = exp(z_i - 1) / dv`` with ``dv = TINY + Σ_j exp(z_j - 1)``
  — the reference's quirks, reproduced exactly: the constant ``-1``
  shift (NOT a max-subtraction) and the TINY=1e-14 seed of the
  denominator (ref: src/snn.c:282-335; common.h:79).
* error: cross-entropy ``Ep = -(1/N) Σ t_i log(o_i + TINY)``
  (ref: src/snn.c:444-477).
* deltas: output ``δ = (t - o)`` (softmax+CE shortcut, no dact,
  ref: src/snn.c:510-512); hidden layers identical to ANN.
* updates: same shapes as ANN but η = LEARN_RATE = 0.01 for BOTH the
  plain and the momentum path (ref: src/snn.c:799).
"""

from __future__ import annotations

import torch

from hpnn_tpu_torch.models import ann

TINY = 1e-14
SNN_LEARN_RATE = 0.01


def softmax_out(z):
    """``exp(z-1) / (TINY + Σ exp(z-1))`` over the last dimension."""
    e = torch.exp(z - 1.0)
    return e / (TINY + torch.sum(e, dim=-1, keepdim=True))


def forward(weights, x):
    acts = [x]
    v = x
    for w in weights[:-1]:
        v = ann.act(torch.mv(w, v))
        acts.append(v)
    acts.append(softmax_out(torch.mv(weights[-1], v)))
    return tuple(acts)


def run(weights, x):
    return forward(weights, x)[-1]


def run_batch(weights, X):
    """``run`` over the rows of a ``(B, n_in)`` batch; stacked weights
    ``(N, n, m)`` with a ``(N, B, n_in)`` batch run N networks at once."""
    v = X
    for w in weights[:-1]:
        v = ann.act(torch.matmul(v, w.mT))
    return softmax_out(torch.matmul(v, weights[-1].mT))


def train_error(out, target):
    n = out.shape[0]
    return -torch.sum(target * torch.log(out + TINY)) / n


def deltas(weights, acts, target):
    return ann.hidden_deltas(weights, acts, target - acts[-1])


def train_iteration(weights, acts, x, target):
    """One SNN BP iteration (``snn_kernel_train``, src/snn.c:796-1075)."""
    ep = train_error(acts[-1], target)
    ds = deltas(weights, acts, target)
    weights = ann.bp_update(weights, acts, ds, SNN_LEARN_RATE)
    acts = forward(weights, x)
    epr = train_error(acts[-1], target)
    return weights, acts, ep - epr


def train_iteration_momentum(weights, dw, acts, x, target, alpha):
    """One SNN BPM iteration (``snn_kernel_train_momentum``, src/snn.c:1077)."""
    ep = train_error(acts[-1], target)
    ds = deltas(weights, acts, target)
    weights, dw = ann.bpm_update(weights, dw, acts, ds, SNN_LEARN_RATE, alpha)
    acts = forward(weights, x)
    epr = train_error(acts[-1], target)
    return weights, dw, acts, ep - epr
