"""Microseconds of the convergence kernel's device time per iteration
it ran, over the window (trace; iterations from the tokens)."""

from benchmark.tracing import kernel_seconds

PATTERN = "convergence_"


def read(run):
    tr, w = run["trace"], run["work"]
    t = kernel_seconds(tr["kernels"], PATTERN) if tr else 0.0
    return t / w["iters"] * 1e6 if t and w.get("iters") else None
