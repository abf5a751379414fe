"""Readings that set and prove the limits of ``correct``.

    python3 benchmark/control.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults 7,8,9]

For each of ``--seeds``: one run of the cell with a one-call window,
its numbers compared (the lower readings).  For each of
``--control-seeds``: the plain reference put in the program's place in
the nearest precision below float32, TF32 (the control), judged as the
program is (the upper readings); in a round cell it follows the
iteration counts of the program's own round on that seed.  For each of
``--faults``: the faults that the cell's program can have, planted in
the program's output (a round's N_ITER token, a fleet's loss) or in the
reference put in its place in float32 (a fleet step's mean over half
its rows).  One JSON line a reading on stdout; runs on the card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _cell(workload, seed, device, config):
    cell = harness.resolve(harness.spec(), workload)
    cell["config"].update(config)
    cell.update(seed=seed, device=device, workdir=tempfile.mkdtemp(prefix="hpnn-ctl-"))
    return cell


def stand_ins(workload, seed, device, kinds, config=None):
    """(kind, numbers) of each planted stand-in on one seed; ``config``
    replaces keys of the cell's configuration (the tests' sizes)."""
    cell = _cell(workload, seed, device, config or {})
    drv = cell["driver"]
    st = drv.setup(cell)
    out = []
    try:
        for kind in kinds:
            t0 = time.perf_counter()
            if cell["traffic"]["driver"] == "round":
                # the program's own round first: the stand-in follows its counts
                if not st["rounds"]:
                    drv.warm(st)
                    drv.call(st)
                text, opt, _ = drv.outputs(st)[0]
                if kind == "control":
                    text, opt = drv.stand_in(st, text, "tf32")
                else:  # token: one N_ITER altered where it is printed
                    text = drv.altered(text, cell["config"]["samples_per_round"] // 2)
                got = drv.judge(st, text, opt)
            else:
                if kind == "control":
                    w, l, c = drv.reference(st, "tf32")
                elif kind == "half":
                    w, l, c = drv.reference(st, "f32", rows_used=st["batch"] // 2)
                else:  # token: one loss of one member altered where it is produced
                    w, l, c = drv.reference(st, "f32")
                    l = l.copy()
                    l[0, 0, 0] *= 1.01
                members = [[layer[i] for layer in w] for i in range(w[0].shape[0])]
                got = drv.judge(st, [(l, c)], [members])
            got.update(kind=kind, seed=seed, seconds=time.perf_counter() - t0)
            out.append(got)
    finally:
        shutil.rmtree(cell["workdir"], ignore_errors=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    for seed in _seeds(args.seeds):
        r = harness.run_cell(args.workload, seed, 0.0, False)
        print(json.dumps({"kind": "program", "seed": seed, "correct": r["correct"],
                          **{k: v["value"] for k, v in r["checks"].items()}}), flush=True)
    for seed in _seeds(args.control_seeds):
        for got in stand_ins(args.workload, seed, "cuda", ["control"]):
            print(json.dumps(got), flush=True)
    traffic = harness.resolve(harness.spec(), args.workload)["traffic"]["driver"]
    kinds = ["token"] if traffic == "round" else ["half", "token"]
    for seed in _seeds(args.faults):
        for got in stand_ins(args.workload, seed, "cuda", kinds):
            print(json.dumps(got), flush=True)


if __name__ == "__main__":
    main()
