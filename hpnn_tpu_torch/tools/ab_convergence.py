"""Hold this checkout's convergence kernel (#1, ``csrc/convergence.cu``)
against another checkout's on one card: bitwise on the same inputs, and
timed in turns (parent, change, change, parent).

    git archive <parent> | tar -x -C .archive/parent
    python3 -m hpnn_tpu_torch.tools.ab_convergence --parent .archive/parent

Each turn is a process of its own that imports ``hpnn_tpu_torch`` from
one checkout and calls its ``ops.convergence.train_epoch``, so each side
is built from its own source and its host work a launch is in its
times.  Both sides are built (at once) before the first turn.

What a turn runs, on inputs made from one seed (``chip_smoke.py``'s
phases 3 and 6): 784-300-10, 4 samples pinned to K + 1 = 21 iterations
(delta = -1e30), ANN/SNN x BP/BPM, float and double, under every plan
(8 and 16 CTAs, the weight rows resident and streamed, the vectors in
device memory where the checkout's plan takes ``vectors_resident``, the
grid build forced where it takes ``grid``), each result kept by the
SHA-256 of its bytes; then each mode and type at its default plan, 4
samples x 200 iterations, timed with CUDA events after one untimed run.
Then the wide nets (``WIDE``: 784-[30000]-10 float32, 784-[15000]-10
float64, 784-[4000]-10 float32, and 784-[300]-1000 in both types, whose
loss sums more than one term a lane), ANN-BP, ANN-BPM and SNN-BP, 4 samples
pinned to 11 iterations at the default plan (and one cluster forced
where the checkout's plan takes ``grid``), hashed; and ANN-BP at each,
4 samples x 21 iterations, timed.  Prints one line per timed item and
one JSON object as its last line (also written to ``--out``); exits 1
when a result differs between the sides, between two turns, or between
two plans of a turn.

    python3 -m hpnn_tpu_torch.tools.ab_convergence --crossover

times this checkout's grid build against its one-cluster build (``grid``
forced each way) in turns (grid, cluster, cluster, grid) at
784-[H]-10 for each H of ``CROSSOVER`` and at 784-(300x19)-10, float
and double, ANN-BP, 4 samples x 21 iterations: where the plan's rule
(``ops/convergence.py``'s ``GRID_MIN_BYTES``) comes from.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# nothing of hpnn_tpu_torch at import: a turn imports its checkout's
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 10958
N_IN, N_HID, N_OUT = 784, 300, 10
S, PINNED_K, TIMED_ITERS = 4, 20, 200
CLUSTERS = (16, 8)
TURNS = ("parent", "change", "change", "parent")
# the wide nets, and two whose output layer is wider than a warp (the
# loss's lanes then sum more than one term each)
WIDE = (("float32", (N_IN, 30000, N_OUT)), ("float64", (N_IN, 15000, N_OUT)),
        ("float32", (N_IN, 4000, N_OUT)), ("float32", (N_IN, N_HID, 1000)),
        ("float64", (N_IN, N_HID, 1000)))
WIDE_PINNED_K, WIDE_TIMED_K = 10, 20
CROSSOVER = {"float32": (1100, 1500, 2000, 3000, 4000, 8000, 16000),
             "float64": (500, 750, 1000, 2000, 4000, 8000)}


def digest(tensors) -> list:
    return [hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for t in tensors]


def events_ms(fn) -> float:
    """``fn()``'s time on the card, after one untimed run."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def build(checkout: str) -> None:
    """The checkout's convergence library, built into its own build dir."""
    sys.path.insert(0, checkout)
    from hpnn_tpu_torch.ops import _build
    _build.build("convergence")


def turn(checkout: str) -> dict:
    """Every item of the module docstring through the ``hpnn_tpu_torch``
    of ``checkout``: {"hash": {item: [sha256, ...]}, "ms": {item: [ms]},
    "plans_differ": [item, ...]}."""
    sys.path.insert(0, checkout)
    import hpnn_tpu_torch
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import convergence
    if not os.path.abspath(hpnn_tpu_torch.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"imported {hpnn_tpu_torch.__file__}, not {checkout}'s package")
    dev = torch.device("cuda")
    # a checkout whose plan can put the vectors in device memory runs
    # that build too, held bitwise to its default plan
    device_build = "vectors_resident" in inspect.signature(convergence.plan).parameters
    k0, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    rng = np.random.default_rng(SEED)
    X0 = rng.random((S, N_IN))
    T0 = -np.ones((S, N_OUT))
    T0[np.arange(S), rng.integers(0, N_OUT, S)] = 1.0
    hashes, times, plans_differ = {}, {}, []
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                tag = f"{model}-{'BPM' if momentum else 'BP'} {str(dtype).split('.')[1]}"
                T = np.where(T0 > 0, 1.0, 0.0) if model == "snn" else T0
                X = torch.tensor(X0, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)
                w0 = km.to_torch(k0.weights, device=dev, dtype=dtype)[0]
                kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=PINNED_K)
                plans = [{}]
                for C in CLUSTERS:
                    plans.append(dict(cluster=C))
                    if convergence.plan(w0, dtype, momentum, cluster=C).weights_resident:
                        plans.append(dict(cluster=C, weights_resident=False))
                    if device_build:
                        plans.append(dict(cluster=C, vectors_resident=False))
                got = []
                for plan in plans:
                    w = tuple(t.clone() for t in w0)
                    st = convergence.train_epoch(w, X, Td, 0.2, -1e30, **kw, **plan)
                    got.append(digest(list(w) + list(st)))
                hashes[f"{tag} pinned"] = got[0]
                plans_differ += [f"{tag} {plan}" for plan, h in zip(plans, got) if h != got[0]]
                w = tuple(t.clone() for t in w0)
                kw["max_iter"] = TIMED_ITERS - 1
                times[f"{tag}, {S} samples x {TIMED_ITERS} iterations"] = [events_ms(
                    lambda: convergence.train_epoch(w, X, Td, 0.2, -1e30, **kw))]
    grid_build = "grid" in inspect.signature(convergence.plan).parameters
    for dname, dims in WIDE:
        dtype = getattr(torch, dname)
        w0, X, Tw = wide_inputs(dev, dtype, dims)
        shape = f"{dims[0]}-[{dims[1]}]-{dims[2]}"
        for model, momentum in (("ann", False), ("ann", True), ("snn", False)):
            tag = f"{model}-{'BPM' if momentum else 'BP'} {dname} {shape}"
            T = (Tw > 0).to(dtype) if model == "snn" else Tw
            kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=WIDE_PINNED_K)
            got = []
            for plan in [{}] + ([dict(grid=False)] if grid_build else []):
                w = tuple(t.clone() for t in w0)
                st = convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)
                got.append(digest(list(w) + list(st)))
            hashes[f"{tag} pinned"] = got[0]
            plans_differ += [f"{tag} grid=False" for h in got[1:] if h != got[0]]
        kw = dict(model="ann", min_iter=5, max_iter=WIDE_TIMED_K)
        times[f"ann-BP {dname} {shape}, {S} samples x {WIDE_TIMED_K + 1} "
              f"iterations"] = [events_ms(
                  lambda: convergence.train_epoch(w0, X, Tw, 0.2, -1e30, **kw))]
    print(f"[ab] {checkout}: " + "; ".join(
        f"{k} {', '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items()), flush=True)
    return dict(hash=hashes, ms=times, plans_differ=plans_differ)


def wide_inputs(dev, dtype, dims):
    """Seeded weights within 1/sqrt(fan-in) of the net of widths
    ``dims``, 4 samples and their ANN targets."""
    rng = np.random.default_rng(SEED + sum(dims))
    w = [torch.tensor(rng.uniform(-1, 1, (n, m)) / m ** 0.5, dtype=dtype, device=dev)
         for m, n in zip(dims[:-1], dims[1:])]
    X = torch.tensor(rng.random((S, dims[0])), dtype=dtype, device=dev)
    T = -np.ones((S, dims[-1]))
    T[np.arange(S), rng.integers(0, dims[-1], S)] = 1.0
    return w, X, torch.tensor(T, dtype=dtype, device=dev)


def crossover() -> dict:
    """The grid build against one cluster in this checkout (see the
    module docstring): {shape: {"grid": [ms, ms], "one cluster": [ms,
    ms], "iters": n}}."""
    from hpnn_tpu_torch.ops import convergence

    dev = torch.device("cuda")
    builds = {"grid": dict(grid=True), "one cluster": dict(grid=False)}
    nets = [(d, [h]) for d, hs in CROSSOVER.items() for h in hs]
    nets += [(d, [300] * 19) for d in CROSSOVER]
    out = {}
    for dname, hidden in nets:
        dtype = getattr(torch, dname)
        w0, X, T = wide_inputs(dev, dtype, (N_IN, *hidden, N_OUT))
        shape = f"{dname} {N_IN}-" + (f"[{hidden[0]}]" if len(hidden) == 1
                                      else f"({hidden[0]}x{len(hidden)})") + f"-{N_OUT}"
        kw = dict(model="ann", min_iter=5, max_iter=WIDE_TIMED_K)
        runs = {k: [] for k in builds}
        for k in list(builds) + list(builds)[::-1]:
            runs[k].append(events_ms(lambda k=k: convergence.train_epoch(
                w0, X, T, 0.2, -1e30, **kw, **builds[k])))
        iters = S * (WIDE_TIMED_K + 1)
        out[shape] = dict(runs, iters=iters, default_grid=convergence.plan(
            w0, dtype, False).grid)
        ratio = statistics.median(runs["one cluster"]) / statistics.median(runs["grid"])
        print(f"[crossover] {shape}: " + "; ".join(
            f"{k} {statistics.median(v) / iters * 1e3:.2f} us/iteration "
            f"({', '.join(f'{t:.3f}' for t in v)} ms)" for k, v in runs.items())
            + f"; one cluster / grid {ratio:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the parent's checkout")
    ap.add_argument("--crossover", action="store_true",
                    help="time this checkout's grid build against one cluster instead")
    ap.add_argument("--out", help="also write the result's JSON to this file")
    ap.add_argument("--build", help=argparse.SUPPRESS)  # one side's build process
    ap.add_argument("--turn", help=argparse.SUPPRESS)   # one turn's process ...
    ap.add_argument("--json", help=argparse.SUPPRESS)   # ... and its result file
    args = ap.parse_args(argv)
    if args.build:
        build(os.path.abspath(args.build))
        return 0
    if args.turn:
        with open(args.json, "w") as fp:
            json.dump(turn(os.path.abspath(args.turn)), fp)
        return 0
    if not args.parent and not args.crossover:
        ap.error("--parent or --crossover is required")
    if not torch.cuda.is_available():
        print("ab_convergence: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[ab] card: {card}", flush=True)
    if args.crossover:
        sys.path.insert(0, ROOT)
        result = dict(card=card, crossover=crossover())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fp:
                json.dump(result, fp, indent=1)
        print(json.dumps(result), flush=True)
        return 0
    sides = {"parent": os.path.abspath(args.parent), "change": ROOT}
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, me, "--build", d]) for d in sides.values()]
    if any(p.wait() != 0 for p in builds):
        print("ab_convergence: a build failed", file=sys.stderr)
        return 2
    work = os.path.join(ROOT, ".smoke", "ab_convergence")
    os.makedirs(work, exist_ok=True)
    res = []
    for i, side in enumerate(TURNS):
        path = os.path.join(work, f"turn{i}.json")
        subprocess.run([sys.executable, me, "--turn", sides[side], "--json", path], check=True)
        with open(path) as fp:
            res.append(json.load(fp))
    items = list(res[0]["hash"])
    differ = [k for k in items if any(r["hash"].get(k) != res[0]["hash"][k] for r in res)]
    differ += [f"{p} ({TURNS[i]}'s turn {i + 1})" for i, r in enumerate(res)
               for p in r["plans_differ"]]
    times = {}
    for k in res[0]["ms"]:
        times[k] = dict(parent_ms=res[0]["ms"][k] + res[3]["ms"][k],
                        change_ms=res[1]["ms"][k] + res[2]["ms"][k])
        p, c = (statistics.median(v) for v in times[k].values())
        print(f"[ab] {k}: parent {', '.join(f'{t:.4f}' for t in times[k]['parent_ms'])} ms; "
              f"change {', '.join(f'{t:.4f}' for t in times[k]['change_ms'])} ms "
              f"(parent / change {p / c:.3f})", flush=True)
    result = dict(card=card, bitwise_equal=len(items) - len([k for k in differ if k in items]),
                  items=len(items), differ=differ, times=times,
                  seconds=time.perf_counter() - t0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(result, fp, indent=1)
    print(f"[ab] {result['bitwise_equal']} of {len(items)} results bitwise equal in all four "
          f"turns, every plan of a turn alike" if not differ else
          f"[ab] DIFFER: {differ}", flush=True)
    print(json.dumps(result), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
