"""XRD powder patterns of the 230 space groups, as ``pdif`` bins them.

Frozen copies, drawn in bulk on the run's device:
``hpnn_tpu_torch/tools/synth_rruff.py`` ``class_peaks`` (:53, copied as
it is) and ``render_spectrum`` (:64): each space group 8-16
characteristic peaks in 2θ ∈ [7°, 88°]; each pattern those peaks
jittered by N(0, 0.1°), scaled by U(0.6, 1.4), Lorentzian with a
half-width U(0.06°, 0.18°), scaled by U(2000, 20000), over a sloping
background U(20, 120) with counting noise, on a 0.02° grid from 5° to
90°.  Then ``hpnn_tpu_torch/tools/pdif.py`` ``dif_2_sample`` (:247) as
``pdif -i 850 -o 230`` runs it: 2θ and intensities read to two
decimals, as the raw files print them, summed into 850 bins with the
converter's accumulated edges, normalised to the largest bin, the
temperature in kelvin over 273.15 in front (drawn U(15, 35) °C), and a
±1 one-hot over the 230 groups.  The RRUFF archives need a download,
which a run cannot make.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.data import generator, uniform

GRID_LO, GRID_HI, GRID_STEP = 5.0, 90.0, 0.02
MIN_THETA, MAX_THETA = 5.0, 90.0


def class_peaks(space: int, seed: int):
    """Deterministic characteristic peaks for one space group:
    (positions [K], relative intensities [K]) with K in 8..16."""
    rng = np.random.RandomState((seed * 1009 + space) % 2**32)
    k = int(rng.randint(8, 17))
    pos = np.sort(rng.uniform(7.0, 88.0, size=k))
    inten = rng.lognormal(mean=0.0, sigma=0.8, size=k)
    inten /= inten.max()
    return pos, inten


def raw_grid():
    """The raw files' 2θ column as the converter reads it back."""
    grid = np.arange(GRID_LO, GRID_HI + GRID_STEP / 2, GRID_STEP)
    return np.array(["%.2f" % t for t in grid], dtype=np.float64)


def pdif_bins(theta, n_bins):
    """The converter's bin of each raw point, -1 where it falls outside:
    points below 5° are skipped, then bin b takes the points under its
    upper edge, the edges accumulated one interval at a time, and points
    past the last edge are dropped (pdif.py :257-271)."""
    interval = (MAX_THETA - MIN_THETA) / n_bins
    out = np.full(theta.shape[0], -1, dtype=np.int64)
    j, n = 0, theta.shape[0]
    while j < n and theta[j] < MIN_THETA:
        j += 1
    hi = MIN_THETA + interval
    for b in range(n_bins):
        while j < n and theta[j] < hi:
            out[j] = b
            j += 1
        hi += interval
    return out


def patterns(seed, device, *, classes, per_class, n_bins, dtype=torch.float32):
    """All ``classes × per_class`` patterns ``(X, T)``, class-major:
    X is ``(n, n_bins + 1)``, T ``(n, classes)``."""
    gen = generator(seed, device)
    tables = [class_peaks(g, int(seed) % 2**32) for g in range(1, classes + 1)]
    k_max = max(len(p) for p, _ in tables)
    pos, inten = np.zeros((classes, k_max)), np.zeros((classes, k_max))
    for g, (p, a) in enumerate(tables):
        pos[g, :len(p)] = p
        inten[g, :len(a)] = a
    n = classes * per_class
    cls = torch.arange(classes, device=device).repeat_interleave(per_class)
    f64 = dict(device=device, dtype=torch.float64)
    jpos = torch.tensor(pos, **f64)[cls] + 0.10 * torch.randn((n, k_max), generator=gen, **f64)
    jint = torch.tensor(inten, **f64)[cls] * uniform(gen, (n, k_max), 0.6, 1.4, device)
    gamma = uniform(gen, (n, 1), 0.06, 0.18, device)
    scale = uniform(gen, (n, 1), 2000.0, 20000.0, device)
    back = uniform(gen, (n, 1), 20.0, 120.0, device)
    temp_k = uniform(gen, (n,), 15.0, 35.0, device) + 273.15
    theta_np = raw_grid()
    theta = torch.tensor(theta_np, **f64)
    y = torch.zeros((n, theta.shape[0]), **f64)
    for k in range(k_max):
        y += jint[:, k:k + 1] / (1.0 + ((theta - jpos[:, k:k + 1]) / gamma) ** 2)
    y *= scale
    y += back * (1.0 - (theta - GRID_LO) / (GRID_HI - GRID_LO))
    y += torch.sqrt(torch.clamp_min(y, 1.0)) * torch.randn(y.shape, generator=gen, **f64)
    y = torch.round(torch.clamp_min(y, 0.0) * 100.0) / 100.0
    bins = torch.tensor(pdif_bins(theta_np, n_bins), device=device)
    keep = bins >= 0
    hist = torch.zeros((n, n_bins), **f64).index_add_(1, bins[keep], y[:, keep])
    hist /= hist.max(dim=1, keepdim=True).values
    X = torch.cat([(temp_k / 273.15)[:, None], hist], dim=1)
    T = -torch.ones((n, classes), **f64)
    T[torch.arange(n, device=device), cls] = 1.0
    return X.to(dtype), T.to(dtype), gen


def make(cfg, seed, device, n, dtype=torch.float32):
    """``n`` of the patterns, drawn without replacement by the seed."""
    X, T, gen = patterns(seed, device, classes=cfg["output"], per_class=cfg["per_class"],
                         n_bins=cfg["input"] - 1, dtype=dtype)
    pick = torch.randperm(X.shape[0], generator=gen, device=device)[:n]
    return X[pick].contiguous(), T[pick].contiguous()
