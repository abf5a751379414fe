"""Hold this checkout's batch-step kernels (#2-#6, ``csrc/batch_step.cu``)
against another checkout's on one card: bitwise on the same inputs, and
timed in turns (parent, change, change, parent).

    git archive <parent> | tar -x -C .archive/parent
    python3 -m hpnn_tpu_torch.tools.ab_batch_step --parent .archive/parent

Each turn is a process of its own that imports ``hpnn_tpu_torch`` from
one checkout, so each side is built from its own source and called
through its own entry points (``ops.batch_step``, ``train.fleet``): the
times hold each side's host work a launch, as a caller meets it.  Both
sides are built (at once) before the first turn.

What a turn runs, on inputs made from one seed:

* bitwise only: phase 10's shapes of ``chip_smoke.py`` (4 members,
  784-300-10 BP and 851-230-230 BPM, ANN/SNN, float and double, B =
  256, S = 8) through #6 as planned, #4 and #5 on member 0's bank, and
  #2 and #3 on its first block;
* bitwise and timed (CUDA events, after one untimed run): one 235-step
  epoch of a 60000-row bank, 784-300-10 ANN-BP float32, B = 256,
  through #2 and #3 (235 launches each), #4 and #5 (one launch), and #6
  for 8 and 32 members as planned; then the HPNN-sized fleet (64 x
  32-16-4, B = 1) through ``train.fleet.make_fleet_epoch_fn``, one
  launch of #6 a tick, 3 x 30 ticks timed on the host's clock, each
  tick synchronised, then 30 more under ``torch.profiler`` for the
  device time a tick spends in each kernel and copy, and 90 more for the
  median time the host spends in #6's entry point a tick.

Each result is compared by the SHA-256 of its bytes.  Prints one line
per timed item and one JSON object as its last line (also written to
``--out``); exits 1 when a result differs between the sides or between
two turns of one side.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 10958
N_IN, N_HID, N_OUT = 784, 300, 10
XRD = (851, 230, 230)
BATCH, PINNED_S, ROWS = 256, 8, 60000
FLEET_N = (8, 32)
PINNED_N = 4
HPNN_FLEET = (64, (32, 16, 4), 30)  # members, shape, ticks a timed run
TICK_RUNS = 3
TURNS = ("parent", "change", "change", "parent")


def digest(tensors) -> list:
    return [hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for t in tensors]


def events_ms(fn) -> float:
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def device_us(run, n: int) -> dict:
    """Device µs a call of ``run()`` spends in each kernel and copy it
    launches, over ``n`` calls (torch.profiler's CUDA activity); {} when
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def build(checkout: str) -> None:
    """The checkout's batch-step library, built into its own build dir."""
    sys.path.insert(0, checkout)
    from hpnn_tpu_torch.ops import _build
    _build.build("batch_step")


def turn(checkout: str) -> dict:
    """Every item of the module docstring through the ``hpnn_tpu_torch``
    of ``checkout``: {"hash": {item: [sha256, ...]}, "ms": {item: [ms]}}."""
    sys.path.insert(0, checkout)
    import hpnn_tpu_torch
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.train import fleet
    if not os.path.abspath(hpnn_tpu_torch.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"imported {hpnn_tpu_torch.__file__}, not {checkout}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    hashes, times = {}, {}

    # phase 10's shapes, bitwise only
    rng = np.random.default_rng(SEED + 10)
    for shape, momentum in (((N_IN, N_HID, N_OUT), False), (XRD, True)):
        ks = [km.generate(SEED + i, shape[0], [shape[1]], shape[2])[0] for i in range(PINNED_N)]
        W = [np.stack([k.weights[l] for k in ks]) for l in range(2)]
        dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W] if momentum else None
        X = rng.random((PINNED_N, PINNED_S * BATCH, shape[0]))
        T = -np.ones((PINNED_N, PINNED_S * BATCH, shape[2]))
        for i in range(PINNED_N):
            T[i, np.arange(PINNED_S * BATCH), rng.integers(0, shape[2], PINNED_S * BATCH)] = 1
        orders = np.stack([rng.permutation(PINNED_S) for _ in range(PINNED_N)])
        first = int(orders[0, 0])
        rows = slice(first * BATCH, (first + 1) * BATCH)
        for model in ("ann", "snn"):
            for dtype in (torch.float32, torch.float64):
                tag = (f"{model}-{'BPM' if momentum else 'BP'} {'-'.join(map(str, shape))} "
                       f"{str(dtype).split('.')[1]}")
                kw = dict(model=model, momentum=momentum)
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    w, dw = km.to_torch(W, dW, device=dev, dtype=dtype)
                    return list(w), list(dw)

                def member():
                    w, dw = fresh()
                    return [t[0].clone() for t in w], [t[0].clone() for t in dw]

                w, dw = fresh()
                loss = bs.train_fleet_epoch_dbuf_banked(w, dw, Xd, Td, orders, batch=BATCH,
                                                        **kw)[2]
                hashes[f"#6 pinned {tag}"] = digest([loss] + w + dw)
                for name, fn in (("#4", bs.train_epoch_grid_banked),
                                 ("#5", bs.train_epoch_dbuf_banked)):
                    w, dw = member()
                    loss = fn(w, dw, Xd[0], Td[0], orders[0], batch=BATCH, **kw)[2]
                    hashes[f"{name} pinned {tag}"] = digest([loss] + w + dw)
                w, dw = member()
                loss = bs.train_step_fused_batch(w, dw, Xd[0][rows].contiguous(),
                                                 Td[0][rows].contiguous(), **kw)[2]
                hashes[f"#2 pinned {tag}"] = digest([loss] + w + dw)
                w, dw = member()
                loss = bs.train_step_fused_banked(w, dw, Xd[0], Td[0], first, batch=BATCH,
                                                  **kw)[2]
                hashes[f"#3 pinned {tag}"] = digest([loss] + w + dw)
    print(f"[ab] {checkout}: {len(hashes)} pinned results", flush=True)

    # one 60000-row epoch, timed
    S = math.ceil(ROWS / BATCH)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    X = torch.rand((ROWS, N_IN), generator=g, device=dev)
    labels = torch.randint(0, N_OUT, (ROWS,), generator=g, device=dev)
    T = -torch.ones((ROWS, N_OUT), device=dev)
    T[torch.arange(ROWS, device=dev), labels] = 1.0
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(max(FLEET_N))]
    kw = dict(model="ann", momentum=False)
    perm = torch.from_numpy(np.resize(np.random.RandomState(SEED).permutation(ROWS),
                                      S * BATCH)).to(dev)
    Xp, Tp = X[perm], T[perm]
    order = np.random.RandomState(SEED + 1).permutation(S)
    w0 = list(km.to_torch(ks[0].weights, device=dev, dtype=torch.float32)[0])

    def rows(b):
        return slice(int(b) * BATCH, (int(b) + 1) * BATCH)

    epochs = {
        "#2 epoch (235 launches)": lambda w: torch.stack([bs.train_step_fused_batch(
            w, [], Xp[rows(b)], Tp[rows(b)], **kw)[2] for b in order]),
        "#3 epoch (235 launches)": lambda w: torch.stack([bs.train_step_fused_banked(
            w, [], Xp, Tp, int(b), batch=BATCH, **kw)[2] for b in order]),
        "#4 epoch": lambda w: bs.train_epoch_grid_banked(w, [], Xp, Tp, order, batch=BATCH,
                                                         **kw)[2],
        "#5 epoch": lambda w: bs.train_epoch_dbuf_banked(w, [], Xp, Tp, order, batch=BATCH,
                                                         **kw)[2],
    }
    for name, fn in epochs.items():
        w = [t.clone() for t in w0]
        hashes[name] = digest([fn(w)] + w)
        times[name] = [events_ms(lambda: fn(w))]
    del Xp, Tp
    for N in FLEET_N:
        perm = np.stack([np.resize(np.random.RandomState(SEED + i).permutation(ROWS), S * BATCH)
                         for i in range(N)])
        idx = torch.from_numpy(perm).to(dev)
        Xb, Tb = X[idx], T[idx]
        del idx
        orders = np.stack([np.random.RandomState(SEED + 100 + i).permutation(S)
                           for i in range(N)])
        w = [torch.tensor(np.stack([k.weights[l] for k in ks[:N]]), dtype=torch.float32,
                          device=dev) for l in range(2)]
        name = f"#6 epoch, {N} members"
        hashes[name] = digest([bs.train_fleet_epoch_dbuf_banked(
            w, [], Xb, Tb, orders, batch=BATCH, **kw)[2]] + w)
        times[name] = [events_ms(lambda: bs.train_fleet_epoch_dbuf_banked(
            w, [], Xb, Tb, orders, batch=BATCH, **kw))]
        del Xb, Tb
        torch.cuda.empty_cache()
    del X, T

    # the HPNN-sized fleet's tick through train.fleet
    n_m, (hi, hh, ho), ticks = HPNN_FLEET
    rng = np.random.default_rng(SEED + 11)
    hks = [km.generate(1000 + i, hi, [hh], ho)[0] for i in range(n_m)]
    Xh = torch.tensor(rng.normal(size=(1, hi)), dtype=torch.float32, device=dev)
    Th = -torch.ones((1, ho), dtype=torch.float32, device=dev)
    Th[0, int(rng.integers(0, ho))] = 1.0
    fperms, forders = fleet.fleet_plan(range(n_m), n_rows=1, batch=1, epochs=1)
    tick = fleet.make_fleet_epoch_fn(1, count=False)
    stacked = fleet.stack_kernels(hks, dtype=torch.float32)
    tick(stacked, (), Xh, Th, fperms, forders)
    name = f"HPNN-sized tick ({n_m} x {hi}-{hh}-{ho}, B = 1)"
    times[name] = []
    for _ in range(TICK_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            tick(stacked, (), Xh, Th, fperms, forders)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / ticks * 1e3)
    tick_device = device_us(lambda: tick(stacked, (), Xh, Th, fperms, forders), ticks)
    # the host's time in #6's entry point, the one call of a tick that
    # differs between the sides (train.fleet looks it up at each call)
    entry, spent = bs.train_fleet_epoch_dbuf_banked, []

    def timed_entry(*args, **kw):
        t0 = time.perf_counter()
        out = entry(*args, **kw)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    bs.train_fleet_epoch_dbuf_banked = timed_entry
    try:
        for _ in range(TICK_RUNS * ticks):
            tick(stacked, (), Xh, Th, fperms, forders)
    finally:
        bs.train_fleet_epoch_dbuf_banked = entry
    times[f"{name}, host in #6's entry point"] = [statistics.median(spent)]
    hashes[name] = digest(stacked)
    print(f"[ab] {checkout}: " + "; ".join(
        f"{k} {', '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items()), flush=True)
    return dict(hash=hashes, ms=times, tick_device_us=tick_device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the parent's checkout")
    ap.add_argument("--out", help="also write the result's JSON to this file")
    ap.add_argument("--build", help=argparse.SUPPRESS)  # one side's build process
    ap.add_argument("--turn", help=argparse.SUPPRESS)   # one turn's process ...
    ap.add_argument("--json", help=argparse.SUPPRESS)   # ... and its result file
    args = ap.parse_args(argv)
    if args.build:
        build(os.path.abspath(args.build))
        return 0
    if args.turn:
        result = turn(os.path.abspath(args.turn))
        with open(args.json, "w") as fp:
            json.dump(result, fp)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    if not torch.cuda.is_available():
        print("ab_batch_step: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[ab] card: {card}", flush=True)
    sides = {"parent": os.path.abspath(args.parent), "change": ROOT}
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, me, "--build", d]) for d in sides.values()]
    if any(p.wait() != 0 for p in builds):
        print("ab_batch_step: a build failed", file=sys.stderr)
        return 2
    print(f"[ab] built both sides in {time.perf_counter() - t0:.1f} s", flush=True)
    work = os.path.join(ROOT, ".smoke", "ab_batch_step")
    os.makedirs(work, exist_ok=True)
    res = []
    for i, side in enumerate(TURNS):
        path = os.path.join(work, f"turn{i}.json")
        subprocess.run([sys.executable, me, "--turn", sides[side], "--json", path], check=True)
        with open(path) as fp:
            res.append(json.load(fp))
    items = list(res[0]["hash"])
    differ = [k for k in items if any(r["hash"].get(k) != res[0]["hash"][k] for r in res)]
    times = {}
    for k in res[0]["ms"]:
        times[k] = dict(parent_ms=res[0]["ms"][k] + res[3]["ms"][k],
                        change_ms=res[1]["ms"][k] + res[2]["ms"][k])
        p, c = (statistics.median(v) for v in times[k].values())
        print(f"[ab] {k}: parent {', '.join(f'{t:.4f}' for t in times[k]['parent_ms'])} ms; "
              f"change {', '.join(f'{t:.4f}' for t in times[k]['change_ms'])} ms "
              f"(parent / change {p / c:.2f})", flush=True)
    tick_device = {}
    for i, side in enumerate(TURNS):
        us = res[i]["tick_device_us"]
        tick_device.setdefault(side, []).append(us)
        print(f"[ab] {side} (turn {i + 1}), device us a tick: {sum(us.values()):.2f} in all; "
              + "; ".join(f"{k[:60]} {v:.2f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1])),
              flush=True)
    result = dict(card=card, bitwise_equal=len(items) - len(differ), differ=differ,
                  times=times, tick_device_us=tick_device, seconds=time.perf_counter() - t0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(result, fp, indent=1)
    print(f"[ab] {len(items) - len(differ)} of {len(items)} results bitwise equal in all "
          f"four turns" + (f"; DIFFER: {differ}" if differ else ""), flush=True)
    print(json.dumps(result))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
