"""The fleet: ``train_fleet`` calls back to back over data on the card.

Set-up makes the data set on the device (the largest multiple of the
batch within the config's ``train_samples`` rows) and the traffic's
``members`` starting kernels (float32, the type they train in), then
warms up on one call.  A timed call is one
``hpnn_tpu_torch.train.fleet.train_fleet(kernels, X, T, epochs=E,
batch=B, seeds=..., momentum=..., lr=...)``, E the whole epochs in
``rows_per_call`` rows of a member: a gather of each member's bank per
refresh group, one launch of kernel #6 an epoch for all members, each
member counted over every row after each epoch, the kernels copied
back.  Every call starts from the same members and member seeds, so
every call does the same work.

The check runs the plain reference (``benchmark/reference/ann.py``,
float64) once on the same members, data and plans (drawn again from
the member seeds), and holds every call's losses and counts, and the
weights of three calls drawn by the seed and of the last, to it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen import data, draws
from benchmark.frozen import work as counts
from benchmark.reference import ann as ref


def _program():
    from hpnn_tpu_torch.models.kernel import Kernel
    from hpnn_tpu_torch.train import fleet

    return fleet, Kernel


def setup(cell):
    cfg, traffic, seed, dev = cell["config"], cell["traffic"], cell["seed"], cell["device"]
    B, n = traffic["batch"], traffic["members"]
    rows = cfg["train_samples"] // B * B
    dtype = torch.float32 if dev == "cuda" else torch.float64
    X, T = data.dataset(cfg).make(cfg, seed, dev, rows, dtype=dtype)
    gen = data.generator(seed + 1, dev)
    members = [[w.to(dtype).cpu().numpy() for w in data.weights(gen, data.sizes(cfg), dev)]
               for _ in range(n)]
    fleet, Kernel = _program()
    kernels = [Kernel(tuple(m)) for m in members]
    momentum = cfg["train"] == "BPM"
    rng = np.random.default_rng(seed)
    st = {
        "cfg": cfg, "seed": int(seed), "device": dev, "X": X, "T": T, "members": members,
        "kernels": kernels, "rows": rows, "batch": B,
        "epochs": max(1, traffic["rows_per_call"] // rows),
        "member_seeds": [(int(seed) + 7919 * i) % 2**32 for i in range(n)],
        "momentum": momentum, "lr": cfg["batch_lr"],
        "keep": set(rng.choice(64, size=3, replace=False).tolist()),
        "results": [], "kept": {}, "last": None, "failed": 0,
    }
    return st


def _call(st):
    fleet, _ = _program()
    kw = {} if st["lr"] is None else {"lr": st["lr"]}
    return fleet.train_fleet(st["kernels"], st["X"], st["T"], epochs=st["epochs"],
                             batch=st["batch"], seeds=st["member_seeds"],
                             momentum=st["momentum"], device=st["device"], **kw)


def warm(st):
    _call(st)


def call(st):
    out, losses, cnts = _call(st)
    k = len(st["results"])
    st["results"].append((losses, cnts))
    if k in st["keep"]:
        st["kept"][k] = out
    st["last"] = (k, out)
    return len(st["kernels"]) * st["rows"] * st["epochs"]


def work(st):
    """The counted work of every call: each member's epochs of batch
    steps (#6) and its count over every row after each epoch."""
    sizes = data.sizes(st["cfg"])
    shapes = [(o, i) for i, o in zip(sizes[:-1], sizes[1:])]
    per = len(st["kernels"]) * st["epochs"] * len(st["results"])
    b, f = counts.batch_work(shapes, st["rows"] // st["batch"], st["momentum"], 4,
                             st["batch"])
    _, ef = counts.forward_work(shapes, st["rows"], 4)
    return {"fleet_bound_s": per * counts.bound_s(b, f, "float32")[0],
            "flops": per * (f + ef)}


def release(st):
    st["kernels"] = None


def reference(st, mode="exact", rows_used=None):
    """The plain reference's ``(layers, losses, counts)`` of one call."""
    perms, orders = draws.fleet_plan(st["member_seeds"], n_rows=st["rows"],
                                     batch=st["batch"], epochs=st["epochs"])
    lr = st["lr"] if st["lr"] is not None else (ref.BPM if st["momentum"] else ref.BP)["lr"]
    return ref.fleet_reference(start_layers(st), st["X"].to(torch.float64),
                               st["T"].to(torch.float64), perms, orders, batch=st["batch"],
                               momentum=st["momentum"], lr=lr, mode=mode,
                               rows_used=rows_used)


def start_layers(st):
    return [np.stack([m[l] for m in st["members"]]).astype(np.float64)
            for l in range(len(st["members"][0]))]


def judge(st, results, outs):
    """The numbers compared: ``results`` every call's (losses, counts),
    ``outs`` the judged calls' members, each a list of layers."""
    start = start_layers(st)
    w_ref, l_ref, c_ref = reference(st)
    loss_gap = max(float(np.max(np.abs(l - l_ref) / np.abs(l_ref))) for l, _ in results)
    count_gap = max(float(np.max(np.abs(c.astype(np.int64) - c_ref))) for _, c in results)
    w_gap = 0.0
    for out in outs:
        for l, (s, r) in enumerate(zip(start, w_ref)):
            for i, member in enumerate(out):
                p = np.asarray(member[l], dtype=np.float64)
                w_gap = max(w_gap, float(np.abs(p - r[i]).max()
                                         / max(np.abs(r[i] - s[i]).max(), 1e-300)))
    return {"w_gap": w_gap, "loss_gap": loss_gap, "count_gap": count_gap}


def check(st, limits):
    judged = dict(st["kept"])
    judged[st["last"][0]] = st["last"][1]
    got = judge(st, st["results"], [[k.weights for k in out] for out in judged.values()])
    got["failed_calls"] = float(st["failed"])
    return [(name, got[name], limits[name]) for name in limits]
