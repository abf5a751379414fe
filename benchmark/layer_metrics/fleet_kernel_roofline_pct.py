"""The fleet kernel's (#6) share of its roofline: members × epochs ×
calls times one member's epoch bound (``benchmark/frozen/work.py``
``batch_work``) over the kernel's device time, in percent."""

from benchmark.tracing import kernel_seconds

PATTERN = "cluster_train"


def read(run):
    tr, w = run["trace"], run["work"]
    t = kernel_seconds(tr["kernels"], PATTERN) if tr else 0.0
    return w["fleet_bound_s"] / t * 100.0 if t and w.get("fleet_bound_s") else None
