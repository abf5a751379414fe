"""The per-sample round: ``train_nn`` rounds back to back, in-process.

Set-up writes the round's sample files, the starting kernel (a kernel
file named by the conf's ``[init]``, as a tutorial's continuation round
reads ``kernel.opt``) and the conf, then warms up on one round of the
traffic's ``warm_samples`` files.  A timed call is one
``hpnn_tpu_torch.cli.train_nn.main(["-v", "-v", conf])`` with stdout in
a file: parse the conf and the kernel, list and shuffle the sample
files, parse them, train each to convergence (kernel #1, in chunks of
the program's default size), print the tokens, write ``kernel.opt``.
Every round does the same work from the same start.

The check replays a judged round in the plain reference
(``benchmark/reference/ann.py``, float64): the file order is drawn
again from the conf's seed, and each sample runs for the iterations the
round's ``N_ITER`` token reports, from the reference's own weights,
while every one of the round's decisions is judged against the
reference's own ``dEp`` and output (``decision_gap``).  Its tokens and
its ``kernel.opt`` are held to the reference's.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re

import numpy as np
import torch

from benchmark.frozen import data, draws
from benchmark.frozen import work as counts
from benchmark.reference import ann as ref

TOKEN = re.compile(r"TRAINING FILE: +(\S+)\t init= *(\S+) (OK|NO) N_ITER= *(\d+) "
                   r"final= *(\S+) (SUCCESS!|FAIL!)")
FAR = 1e9   # a gap no rounding explains: a token missing or out of place


def _program():
    from hpnn_tpu_torch.cli import train_nn

    return train_nn


def setup(cell):
    cfg, traffic, seed, dev = cell["config"], cell["traffic"], cell["seed"], cell["device"]
    wd = cell["workdir"]
    sizes = data.sizes(cfg)
    n = cfg["samples_per_round"]
    X, T = data.dataset(cfg).make(cfg, seed, dev, n)
    layers = [w.double().cpu().numpy()
              for w in data.weights(data.generator(seed + 1, dev), sizes, dev)]
    x_lines, Xp = data.text_rows(X.double().cpu().numpy(), cfg["input_format"])
    t_lines, Tp = data.text_rows(T.double().cpu().numpy(), "%.1f")
    samples, warm = os.path.join(wd, "samples"), os.path.join(wd, "warm")
    data.write_samples(samples, x_lines, t_lines, sizes[0], sizes[-1])
    k = traffic["warm_samples"]
    data.write_samples(warm, x_lines[:k], t_lines[:k], sizes[0], sizes[-1])
    kernel = os.path.join(wd, "start.kernel")
    start = data.write_kernel(kernel, cfg["name"], layers)
    conf_seed = 1 + int(seed) % 2147483646
    for name, sdir in (("round.conf", samples), ("warm.conf", warm)):
        data.write_conf(os.path.join(wd, name), name=cfg["name"], sizes=sizes,
                        train=cfg["train"], seed=conf_seed, init=kernel, sample_dir=sdir)
    for d in ("run", "out"):
        os.makedirs(os.path.join(wd, d))
    argv = ["-v"] * traffic["verbosity"]
    return {"cfg": cfg, "seed": int(seed), "device": dev, "wd": wd, "argv": argv,
            "X": Xp, "T": Tp, "start": start, "samples": samples, "conf_seed": conf_seed,
            "rounds": 0, "failed": 0, "n": n}


def _round(st, conf):
    """One ``train_nn`` round in the run directory; its exit code."""
    run = os.path.join(st["wd"], "run")
    os.chdir(run)
    args = ["--device", "cpu"] if st["device"] == "cpu" else []
    with open(os.path.join(run, "stdout.txt"), "w") as fp, contextlib.redirect_stdout(fp):
        return _program().main(args + st["argv"] + [os.path.join(st["wd"], conf)])


def warm(st):
    if _round(st, "warm.conf") != 0:
        raise RuntimeError("the warm-up round failed")


def call(st):
    rc = _round(st, "round.conf")
    k = st["rounds"]
    run, out = os.path.join(st["wd"], "run"), os.path.join(st["wd"], "out")
    # set the outputs aside by name only; they are read after the window
    os.replace(os.path.join(run, "stdout.txt"), os.path.join(out, f"{k}.txt"))
    if os.path.exists(os.path.join(run, "kernel.opt")):
        os.replace(os.path.join(run, "kernel.opt"), os.path.join(out, f"{k}.opt"))
    st["rounds"] += 1
    st["failed"] += rc != 0
    return st["n"]


def tokens(text):
    """The round's token lines: (file, init, first OK, N_ITER, final,
    SUCCESS) each."""
    return [(m[1], float(m[2]), m[3] == "OK", int(m[4]), float(m[5]), m[6] == "SUCCESS!")
            for m in TOKEN.finditer(text)]


def read_kernel(path, sizes):
    """The layers of a kernel text file, in float64."""
    with open(path) as fp:
        nums = " ".join(l for l in fp.read().split("\n") if l and not l.startswith("["))
    flat = np.array(nums.split(), dtype=np.float64)
    out, off = [], 0
    for i, o in zip(sizes[:-1], sizes[1:]):
        out.append(flat[off:off + o * i].reshape(o, i))
        off += o * i
    if off != flat.size:
        raise ValueError(f"{path}: {flat.size} values for {off} weights")
    return out


def outputs(st):
    out = os.path.join(st["wd"], "out")
    res = []
    for k in range(st["rounds"]):
        with open(os.path.join(out, f"{k}.txt")) as fp:
            text = fp.read()
        opt = os.path.join(out, f"{k}.opt")
        blob = open(opt, "rb").read() if os.path.exists(opt) else b""
        res.append((text, opt if blob else None,
                    hashlib.sha256(text.encode() + b"\0" + blob).hexdigest()))
    return res


def work(st):
    """Iterations and the convergence kernel's counted work, over every
    round of the window (one launch of #1 a round)."""
    shapes = [(o, i) for i, o in zip(data.sizes(st["cfg"])[:-1], data.sizes(st["cfg"])[1:])]
    momentum = st["cfg"]["train"] == "BPM"
    iters = samples = flops = bound = 0
    for text, _, _ in outputs(st):
        toks = tokens(text)
        it = sum(t[3] for t in toks)
        b, f = counts.work_of(shapes, len(toks), it, momentum, 4)
        iters, samples, flops = iters + it, samples + len(toks), flops + f
        bound += counts.bound_s(b, f, "float32")[0]
    return {"iters": iters, "samples": samples, "conv_bound_s": bound, "flops": flops}


def release(st):
    pass


def decision_gap(toks, dep, margin, p):
    """The widest gap by which one of the round's do-while decisions, or
    its OK and SUCCESS tokens, lies from the reference's: ``dep`` and
    ``margin`` hold every iteration of every sample in token order (the
    reference run for each sample's ``N_ITER``), ``p`` the loop's
    constants.  A gap in ``dEp`` counts in units of DELTA, one in the
    target's lead in units of the output."""
    delta = p["delta"]
    gaps, a = [0.0], 0
    for _, _, first_ok, n_iter, _, success in toks:
        d, m = dep[a:a + n_iter], margin[a:a + n_iter]
        a += n_iter
        it = np.arange(1, n_iter + 1)
        # the round went on after each iteration before the last: the
        # reference would have stopped where dEp <= DELTA, the target
        # leads and MIN_ITER is past, unless one of the first two moves
        going = (it < n_iter) & (it > p["min_iter"]) & (it <= p["max_iter"])
        stop = going & (d <= delta) & (m > 0)
        if stop.any():
            gaps.append(float(np.max(np.minimum((delta - d[stop]) / delta, m[stop]))))
        # it stopped after the last: the reference agrees once dEp <= DELTA
        # and the target leads, or at MAX_ITER
        if n_iter <= p["min_iter"]:
            gaps.append(FAR)
        elif n_iter <= p["max_iter"]:
            gaps.append(max(max(d[-1] - delta, 0.0) / delta, max(-m[-1], 0.0)))
        if first_ok != (m[0] > 0):
            gaps.append(abs(float(m[0])))
        if success != (m[-1] > 0 and n_iter > p["min_iter"]):
            gaps.append(abs(float(m[-1])) if n_iter > p["min_iter"] else FAR)
    return float(max(gaps))


def judge(st, text, opt):
    """The numbers compared for one round's output against the plain
    reference."""
    cfg = st["cfg"]
    momentum = cfg["train"] == "BPM"
    p = ref.BPM if momentum else ref.BP
    toks = tokens(text)
    listing = [e.name for e in os.scandir(st["samples"]) if not e.name.startswith(".")]
    order = [listing[i] for i in draws.shuffled_order(st["conf_seed"], len(listing))]
    if [t[0] for t in toks] != [f[:16] for f in order] or opt is None:
        return {"order": FAR, "w_gap": FAR, "init_gap": FAR, "final_gap": FAR,
                "decision_gap": FAR}
    dev = st["device"]
    loop = ref.SampleLoop(st["start"], momentum=momentum, device=dev)
    total = sum(t[3] for t in toks)
    dep = torch.empty(total, dtype=torch.float64, device=dev)
    margin = torch.empty(total, dtype=torch.float64, device=dev)
    ep0, off = [], 0
    for (_, _, _, n_iter, _, _), fname in zip(toks, order):
        row = int(fname[1:6])
        x, t = st["X"][row], st["T"][row]
        ep0.append(loop.start(x, t, ref.target_index(t)))
        loop.run(n_iter, dep[off:], margin[off:])
        off += n_iter
    ep0 = torch.stack(ep0).cpu().numpy()
    dep, margin = dep.cpu().numpy(), margin.cpu().numpy()
    w_ref = [w.cpu().numpy() for w in loop.W]
    w_prog = read_kernel(opt, data.sizes(cfg))
    w_gap = max(float(np.abs(a - b).max() / max(np.abs(b - s).max(), 1e-300))
                for a, b, s in zip(w_prog, w_ref, st["start"]))
    init = np.array([t[1] for t in toks])
    init_gap = float(np.max(np.abs(init - ep0) / np.maximum(np.abs(ep0), 1e-6)))
    delta = p["delta"]
    ends = np.cumsum([t[3] for t in toks]) - 1
    final = np.array([t[4] for t in toks])
    final_gap = float(np.max(np.abs(final - dep[ends]) / delta))
    return {"order": 0.0, "w_gap": w_gap, "init_gap": init_gap, "final_gap": final_gap,
            "decision_gap": decision_gap(toks, dep, margin, p)}


def stand_in(st, text, mode="tf32"):
    """The plain reference put in the program's place in ``mode`` (the
    control: "tf32"), each sample run for the iterations that the round
    ``text`` reports, as a served model's control reads the program's
    own tokens: its token text, with those counts, and the path of its
    ``kernel.opt``."""
    cfg = st["cfg"]
    momentum = cfg["train"] == "BPM"
    p = ref.BPM if momentum else ref.BP
    toks = tokens(text)
    loop = ref.SampleLoop(st["start"], momentum=momentum, device=st["device"], mode=mode)
    room = max(t[3] for t in toks)
    dep = torch.empty(room, dtype=loop.dtype, device=st["device"])
    margin = torch.empty(room, dtype=loop.dtype, device=st["device"])
    lines = []
    for fname, _, _, n, _, _ in toks:
        row = int(fname[1:6])
        t = st["T"][row]
        ep0 = float(loop.start(st["X"][row], t, ref.target_index(t)))
        loop.run(n, dep, margin)
        m0, mn, dn = (float(v) for v in (margin[0], margin[n - 1], dep[n - 1]))
        lines.append("NN: TRAINING FILE: %16.16s\t init=%15.10f %s N_ITER=%8i final=%15.10f %s\n"
                     % (fname, ep0, "OK" if m0 > 0 else "NO", n, dn,
                        "SUCCESS!" if mn > 0 and n > p["min_iter"] else "FAIL!"))
    opt = os.path.join(st["wd"], "stand_in.opt")
    data.write_kernel(opt, cfg["name"], [w.double().cpu().numpy() for w in loop.W])
    return "".join(lines), opt


def altered(text, k):
    """``text`` with the ``k``-th N_ITER token reporting half the
    iterations (a count taken at the wrong point of the do-while)."""
    lines = text.split("\n")
    at = [i for i, l in enumerate(lines) if TOKEN.search(l)][k]
    m = re.search(r"N_ITER= *(\d+)", lines[at])
    lines[at] = lines[at][:m.start()] + "N_ITER=%8i" % (int(m[1]) // 2) + lines[at][m.end():]
    return "\n".join(lines)


def judged_rounds(st, outs):
    """The rounds whose outputs are judged: one of each distinct output,
    at most two, drawn by the seed."""
    firsts = {}
    for k, (_, _, h) in enumerate(outs):
        firsts.setdefault(h, k)
    ks = sorted(firsts.values())
    rng = np.random.default_rng(st["seed"])
    return sorted(rng.choice(ks, size=min(2, len(ks)), replace=False).tolist())


def check(st, limits):
    outs = outputs(st)
    worst = {}
    for k in judged_rounds(st, outs):
        text, opt, _ = outs[k]
        for name, v in judge(st, text, opt).items():
            worst[name] = max(worst.get(name, 0.0), v)
    worst["failed_rounds"] = float(st["failed"])
    return [(name, worst[name], limits[name]) for name in limits]
