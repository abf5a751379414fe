"""The convergence kernel's share of its roofline: the least time an
H100 needs for the work the window's iterations count
(``benchmark/frozen/work.py`` ``work_of``) over the kernel's device
time, in percent."""

from benchmark.tracing import kernel_seconds

PATTERN = "convergence_"


def read(run):
    tr, w = run["trace"], run["work"]
    t = kernel_seconds(tr["kernels"], PATTERN) if tr else 0.0
    return w["conv_bound_s"] / t * 100.0 if t and w.get("conv_bound_s") else None
