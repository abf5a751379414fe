"""MNIST-shaped samples, made from the seed on the run's device.

A frozen copy of ``chip_smoke.py`` ``make_dataset`` (:447-458) and its
prototypes (:3451), drawn in bulk: ten 15%-ink prototypes, each sample
one of them (uniform over the classes) under a stroke-intensity jitter
U(0.6, 1), with 3% of its pixels replaced by U(0, 1); targets a ±1
one-hot.  MNIST itself needs a download, which a run cannot make.
"""

from __future__ import annotations

import torch

from benchmark.frozen.data import generator, uniform


def make(cfg, seed, device, n, dtype=torch.float32):
    """``n`` samples ``(X, T)`` of ``cfg``'s widths on ``device``."""
    n_in, n_out = cfg["input"], cfg["output"]
    gen = generator(seed, device)
    protos = (torch.rand((n_out, n_in), generator=gen, device=device,
                         dtype=torch.float64) < 0.15).to(torch.float64)
    cls = torch.randint(0, n_out, (n,), generator=gen, device=device)
    jitter = uniform(gen, (n, n_in), 0.6, 1.0, device)
    flip = torch.rand((n, n_in), generator=gen, device=device, dtype=torch.float64) < 0.03
    noise = torch.rand((n, n_in), generator=gen, device=device, dtype=torch.float64)
    X = torch.where(flip, noise, protos[cls] * jitter)
    T = -torch.ones((n, n_out), device=device, dtype=torch.float64)
    T[torch.arange(n, device=device), cls] = 1.0
    return X.to(dtype), T.to(dtype)
