"""``snn_stops`` — the sample orders that give an SNN round's N_ITER
list, and where each sample's do-while stopped.

A per-sample round trains its files in an order that follows the
directory listing, which changes with the filesystem.  Given a conf
(``[type] SNN``, ``[train] BP``) and the N_ITER tokens a round printed,
in training order, this searches the orders of the conf's sample files
that reproduce the list with the plain loop in float64 on the CPU, and
prints each with, per sample, the argument ``z - 1`` of the target
output's exp at the last iteration and whether every other output was
exactly 0 there.  Once they are, the stop rests on that exp alone: 0 or
the least subnormal (``exp`` of an argument in [-745.13, -744.04)).

usage: python -m hpnn_tpu_torch.tools.snn_stops [--max-iter N] nn.conf 36,210,107
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from hpnn_tpu_torch import config
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import snn
from hpnn_tpu_torch.train import loop


def _train(w, x, t, max_iter):
    """One sample's plain SNN-BP do-while: (weights, N_ITER, the target's
    exp argument at the last iteration, every other output exactly 0)."""
    ti = loop.target_argmax(t)
    acts0 = snn.forward(w, x)
    last = {}

    def one_iteration(w, m, acts):
        w, acts, dep = snn.train_iteration(w, acts, x, t)
        last["arg"] = float(torch.mv(w[-1], acts[-2])[ti]) - 1.0
        others = torch.cat([acts[-1][:ti], acts[-1][ti + 1:]])
        last["others_zero"] = bool(torch.all(others == 0))
        return w, m, acts, dep

    r = loop.convergence_loop(one_iteration, w, (), acts0, snn.train_error(acts0[-1], t),
                              ti, loop.DELTA_BP, min_iter=loop.MIN_BP_ITER,
                              max_iter=max_iter)
    return r.weights, r.n_iter, last["arg"], last["others_zero"]


def orders(w0, X, T, n_iter, max_iter):
    """Every order of the rows of ``(X, T)`` whose N_ITER list is
    ``n_iter``, as ``(order, [(arg, others_zero) per sample])``."""
    found = []

    def search(w, used, stops):
        depth = len(used)
        if depth == len(n_iter):
            found.append((used, stops))
            return
        for i in range(len(X)):
            if i in used:
                continue
            w1, n, arg, zero = _train(w, X[i], T[i], min(n_iter[depth] + 1, max_iter))
            if n == n_iter[depth]:
                search(w1, used + [i], stops + [(arg, zero)])

    search(w0, [], [])
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="snn_stops", description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-iter", type=int, default=loop.MAX_BP_ITER)
    ap.add_argument("conf")
    ap.add_argument("n_iter", help="the round's N_ITER tokens, comma-separated")
    a = ap.parse_args(argv)
    conf = config.load_conf(a.conf)
    if conf is None or conf.kernel is None or conf.samples is None:
        print(f"snn_stops: can't load {a.conf}", file=sys.stderr)
        return 1
    names, X, T = sample_io.read_dir(conf.samples)
    names = sorted(names)
    _, X, T = sample_io.read_dir(conf.samples, names)
    X, T = (torch.tensor(np.asarray(v), dtype=torch.float64) for v in (X, T))
    w0 = tuple(torch.tensor(np.asarray(w), dtype=torch.float64) for w in conf.kernel.weights)
    n_iter = [int(v) for v in a.n_iter.split(",")]
    found = orders(w0, X, T, n_iter, a.max_iter)
    for order, stops in found:
        print(" ".join(os.path.splitext(names[i])[0] for i in order) + ": "
              + ", ".join(f"{arg:.4f}{' all-0' if zero else ''}" for arg, zero in stops))
    print(f"{len(found)} orders")
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
