"""Hold this checkout's batch-step kernels (#2-#6, ``csrc/batch_step.cu``)
against another checkout's on one card: bitwise on the same inputs
(float and double; bf16 within a band), and timed in turns (parent,
change, change, parent).

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
* the same in bf16, and bf16 #6 over the 8-member epoch below (timed;
  a float32 #6 epoch right after it is timed as an item of its own):
  held to the other side within ``BF16_BAND`` (``chip_smoke.py``'s band
  of the bf16 build against its plain version), since a change of the
  bf16 body may round differently, and each side bitwise to its own
  other turn;
* bitwise and timed (CUDA events, after one untimed run): one 235-step
  epoch of a 60000-row bank, 784-300-10 ANN-BP float32, B = 256,
  through #2 and #3 (235 launches each), #4 and #5 (one launch), and #6
  for 8 (the ``mnist_ann.fleet8`` cell's shape, lr 0.001) and 32 members
  as planned; #6 on the ``rruff_ann.fleet8`` cell's call: 8 members of
  851-230-230 ANN-BPM (alpha 0.2, lr 0.4), B = 256, 16 launches of a
  14-step epoch over 3584-row banks; then the HPNN-sized fleet (64 x
  32-16-4, B = 1) through ``train.fleet.make_fleet_epoch_fn``, one
  launch of #6 a tick, 3 x 30 ticks timed on the host's clock, each
  tick synchronised, then 30 more under ``torch.profiler`` for the
  device time a tick spends in each kernel and copy, and 90 more for the
  median time the host spends in #6's entry point a tick.

Each result is compared by the SHA-256 of its bytes (a bf16 result
across the sides by its values too, kept in a ``.pt`` file beside the
turn's JSON); the bf16 results the sides share bitwise are counted.
Each turn also records the team of each #6 item's last launch
(``ops.batch_step.fleet_team``, None on a side without it).  Prints one
line per timed item and one JSON object as its last line (also written
to ``--out``); exits 1 when a float or double result differs between
the sides or between two turns of one side, or a bf16 result between
two turns of one side or out of the band between the sides.
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
# rruff_ann.fleet8's call: members, rows a bank, epochs, lr, alpha
RRUFF_FLEET = (8, 3584, 16, 0.4, 0.2)
PINNED_N = 4
HPNN_FLEET = (64, (32, 16, 4), 30)  # members, shape, ticks a timed run
TICK_RUNS = 3
TURNS = ("parent", "change", "change", "parent")
# chip_smoke.py's BF16_BAND: weights, each layer's change relative to
# the other's, losses relative
BF16_BAND = {"w": 2e-3, "update_rel": 0.25, "loss_rel": 2e-2}


def digest(tensors) -> list:
    def raw(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return [hashlib.sha256(raw(t).numpy().tobytes()).hexdigest() for t in tensors]


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


def bf16_gap(a, b) -> dict:
    """Two sides' bf16 results of one item, each (losses, w0, w, dw) as
    float32 CPU tensors: their distance in ``BF16_BAND``'s terms."""
    ([la], w0, wa, dwa), ([lb], _, wb, dwb) = a, b
    da = torch.cat([(x - z).flatten() for x, z in zip(wa, w0)])
    db = torch.cat([(y - z).flatten() for y, z in zip(wb, w0)])
    return dict(w=max(float((x - y).abs().max()) for x, y in zip(wa + dwa, wb + dwb)),
                update_rel=float((da - db).norm() / db.norm()),
                loss_rel=float(((la - lb).abs() / lb.abs()).max()))


def turn(checkout: str, keep: str | None = None) -> dict:
    """Every item of the module docstring through the ``hpnn_tpu_torch``
    of ``checkout``: {"hash": {item: [sha256, ...]}, "hash_bf16": {...},
    "ms": {item: [ms]}}; the bf16 results' tensors go to ``keep``."""
    sys.path.insert(0, checkout)
    import hpnn_tpu_torch
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.train import fleet
    if not os.path.abspath(hpnn_tpu_torch.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"imported {hpnn_tpu_torch.__file__}, not {checkout}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    hashes, times, hashes16, kept, teams = {}, {}, {}, {}, {}

    def held16(name, loss, w0, w, dw):
        hashes16[name] = digest([loss] + w + dw)
        kept[name] = tuple([t.float().cpu() for t in ts] for ts in ([loss], w0, w, dw))

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
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                tag = (f"{model}-{'BPM' if momentum else 'BP'} {'-'.join(map(str, shape))} "
                       f"{str(dtype).split('.')[1]}")
                kw = dict(model=model, momentum=momentum)
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    if dtype != torch.bfloat16:
                        w, dw = km.to_torch(W, dW, device=dev, dtype=dtype)
                        return list(w), list(dw)
                    w, dw = km.to_torch(W, dW, device=dev, dtype=torch.float32)
                    return [t.to(dtype) for t in w], [t.to(dtype) for t in dw]

                def member():
                    w, dw = fresh()
                    return [t[0].clone() for t in w], [t[0].clone() for t in dw]

                def result(name, loss, w, dw, stacked=False):
                    if dtype != torch.bfloat16:
                        hashes[name] = digest([loss] + w + dw)
                    else:
                        held16(name, loss, fresh()[0] if stacked else member()[0], w, dw)

                w, dw = fresh()
                loss = bs.train_fleet_epoch_dbuf_banked(w, dw, Xd, Td, orders, batch=BATCH,
                                                        **kw)[2]
                result(f"#6 pinned {tag}", loss, w, dw, stacked=True)
                for name, fn in (("#4", bs.train_epoch_grid_banked),
                                 ("#5", bs.train_epoch_dbuf_banked)):
                    w, dw = member()
                    loss = fn(w, dw, Xd[0], Td[0], orders[0], batch=BATCH, **kw)[2]
                    result(f"{name} pinned {tag}", loss, w, dw)
                w, dw = member()
                loss = bs.train_step_fused_batch(w, dw, Xd[0][rows].contiguous(),
                                                 Td[0][rows].contiguous(), **kw)[2]
                result(f"#2 pinned {tag}", loss.reshape(1), w, dw)
                w, dw = member()
                loss = bs.train_step_fused_banked(w, dw, Xd[0], Td[0], first, batch=BATCH,
                                                  **kw)[2]
                result(f"#3 pinned {tag}", loss.reshape(1), w, dw)
    print(f"[ab] {checkout}: {len(hashes)} pinned results, {len(hashes16)} of them bf16",
          flush=True)

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
        teams[name] = getattr(bs, "fleet_team", None)
        if N == FLEET_N[0]:
            # bf16 on the same banks, then float32 again: a float32 epoch
            # right after a bf16 one is timed apart from the float32 item
            # above, as it depends on the bf16 body that ran before it
            X16, T16 = Xb.to(torch.bfloat16), Tb.to(torch.bfloat16)
            w16 = [t.to(torch.bfloat16) for t in w]
            w0 = [t.clone() for t in w16]
            name16 = f"#6 epoch, {N} members, bf16"
            held16(name16, bs.train_fleet_epoch_dbuf_banked(
                w16, [], X16, T16, orders, batch=BATCH, **kw)[2], w0, w16, [])
            times[name16] = [events_ms(lambda: bs.train_fleet_epoch_dbuf_banked(
                w16, [], X16, T16, orders, batch=BATCH, **kw))]
            times[f"{name}, f32 after bf16"] = [events_ms(
                lambda: bs.train_fleet_epoch_dbuf_banked(w, [], Xb, Tb, orders, batch=BATCH,
                                                         **kw))]
            del X16, T16
        del Xb, Tb
        torch.cuda.empty_cache()
    del X, T

    # rruff_ann.fleet8's call: 8 x 851-230-230 BPM, 16 launches of a
    # 14-step epoch, each member on its own bank
    n_r, rows_r, epochs_r, lr_r, alpha_r = RRUFF_FLEET
    n_in, n_hid, n_out = XRD
    S_r = rows_r // BATCH
    rng = np.random.default_rng(SEED + 12)
    rks = [km.generate(SEED + 50 + i, n_in, [n_hid], n_out)[0] for i in range(n_r)]
    Xr = torch.tensor(rng.random((n_r, rows_r, n_in)), dtype=torch.float32, device=dev)
    Tr = -torch.ones((n_r, rows_r, n_out), dtype=torch.float32, device=dev)
    for i in range(n_r):
        Tr[i, torch.arange(rows_r), torch.from_numpy(rng.integers(0, n_out, rows_r))] = 1.0
    orders_r = [np.stack([rng.permutation(S_r) for _ in range(n_r)]) for _ in range(epochs_r)]
    kw_r = dict(batch=BATCH, model="ann", momentum=True, lr=lr_r, alpha=alpha_r)

    def rruff_call(w, dw):
        return torch.stack([bs.train_fleet_epoch_dbuf_banked(w, dw, Xr, Tr, o, **kw_r)[2]
                            for o in orders_r], dim=1)

    def rruff_fresh():
        w = [torch.tensor(np.stack([k.weights[l] for k in rks]), dtype=torch.float32,
                          device=dev) for l in range(2)]
        return w, [torch.zeros_like(t) for t in w]

    name = f"#6 call, {n_r} members x {epochs_r} epochs of {S_r} steps, 851-230-230 BPM"
    w, dw = rruff_fresh()
    hashes[name] = digest([rruff_call(w, dw)] + w + dw)
    w, dw = rruff_fresh()
    times[name] = [events_ms(lambda: rruff_call(w, dw))]
    teams[name] = getattr(bs, "fleet_team", None)
    del Xr, Tr

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
    teams[name] = getattr(bs, "fleet_team", None)
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
    if keep:
        torch.save(kept, keep)
    return dict(hash=hashes, hash_bf16=hashes16, ms=times, tick_device_us=tick_device,
                teams=teams)


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
        result = turn(os.path.abspath(args.turn), args.json + ".pt")
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
    # bf16: bitwise within each side, within the band across the sides
    items16 = list(res[0]["hash_bf16"])
    for a, b in ((0, 3), (1, 2)):
        differ += [f"{k} ({TURNS[a]}'s turns)" for k in items16
                   if res[a]["hash_bf16"][k] != res[b]["hash_bf16"].get(k)]
    bf16_same = [k for k in items16
                 if all(r["hash_bf16"].get(k) == res[0]["hash_bf16"][k] for r in res)]
    print(f"[ab] bf16: {len(bf16_same)} of {len(items16)} results bitwise equal in all four "
          f"turns", flush=True)
    for i, side in enumerate(TURNS):
        print(f"[ab] {side} (turn {i + 1}), #6's team: " + "; ".join(
            f"{k} {v}" for k, v in res[i].get("teams", {}).items()), flush=True)
    kept = [torch.load(os.path.join(work, f"turn{i}.json.pt")) for i in (0, 1)]
    gaps, out_of_band = {}, []
    for k in items16:
        gaps[k] = bf16_gap(kept[1][k], kept[0][k])
        if not all(math.isfinite(v) and v <= BF16_BAND[m] for m, v in gaps[k].items()):
            out_of_band.append(k)
        print(f"[ab] {k}: change against parent " + ", ".join(
            f"{m} {v:.3e}" for m, v in gaps[k].items()) + (
            " OUT OF BAND" if k in out_of_band else ""), flush=True)
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
    float_differ = [k for k in differ if k in items]
    result = dict(card=card, bitwise_equal=len(items) - len(float_differ), differ=differ,
                  bf16_bitwise_equal=len(bf16_same), teams=[r.get("teams") for r in res],
                  bf16_band=BF16_BAND, bf16_gaps=gaps, bf16_out_of_band=out_of_band,
                  times=times, tick_device_us=tick_device, seconds=time.perf_counter() - t0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(result, fp, indent=1)
    print(f"[ab] {len(items) - len(float_differ)} of {len(items)} float/double results "
          f"bitwise equal in all four turns; {len(items16) - len(out_of_band)} of "
          f"{len(items16)} bf16 results within the band of the parent's"
          + (f"; DIFFER: {differ}" if differ else "")
          + (f"; OUT OF BAND: {out_of_band}" if out_of_band else ""), flush=True)
    print(json.dumps(result))
    return 1 if differ or out_of_band else 0


if __name__ == "__main__":
    sys.exit(main())
