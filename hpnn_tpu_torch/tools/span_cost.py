"""What a span costs (obs/spans.py), in nanoseconds a span.

    python -m hpnn_tpu_torch.tools.span_cost [--n 100000] [--repeats 5]

Times ``n`` context-manager spans and ``n`` ``start``/``finish`` pairs in
three states: off (``HPNN_SPANS`` unset, no profiler: the shared null
span), the knob (``HPNN_SPANS`` set, no sink: real spans into the
table) and traced (a ``torch.profiler`` collecting the host and, where
there is a card, its activity, as a benchmark's traced run does: real
spans, each context-manager span a ``record_function`` range).  Prints
one JSON line: the best of ``repeats`` for each state and form, less
the empty loop's time.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.obs import spans


def _ns(fn, n, repeats):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, time.perf_counter_ns() - t0)
    return best / n


def _with(n):
    for _ in range(n):
        with spans.span("cost.x"):
            pass


def _start(n):
    for _ in range(n):
        spans.finish(spans.start("cost.x"))


def _empty(n):
    for _ in range(n):
        pass


def measure(n: int = 100_000, repeats: int = 5) -> dict:
    saved = os.environ.pop(spans.ENV_KNOB, None)
    out = {"n": n, "repeats": repeats, "torch": torch.__version__}
    try:
        loop = _ns(_empty, n, repeats)
        obs.reset()
        out["off"] = {"with": _ns(_with, n, repeats) - loop,
                      "start": _ns(_start, n, repeats) - loop}
        os.environ[spans.ENV_KNOB] = "1"
        obs.reset()
        out["knob"] = {"with": _ns(_with, n, repeats) - loop,
                       "start": _ns(_start, n, repeats) - loop}
        del os.environ[spans.ENV_KNOB]
        obs.reset()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out["activities"] = [str(a) for a in acts]
        with torch.profiler.profile(activities=acts):
            out["traced"] = {"with": _ns(_with, n, repeats) - loop,
                             "start": _ns(_start, n, repeats) - loop}
        out["counted"] = spans.totals()["cost.x"][0]
    finally:
        os.environ.pop(spans.ENV_KNOB, None)
        if saved is not None:
            os.environ[spans.ENV_KNOB] = saved
        obs.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="span_cost")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
