"""Host milliseconds of a round: its wall time less the convergence
kernel's device time in it, averaged over the window's rounds (the
parse, the shuffle, the tokens, the kernel files)."""

from benchmark.tracing import kernel_seconds

PATTERN = "convergence_"


def read(run):
    tr = run["trace"]
    if not tr or not tr["calls"] or not kernel_seconds(tr["kernels"], PATTERN):
        return None
    host = [c["wall_s"] - kernel_seconds(c["kernels"], PATTERN) for c in tr["calls"]]
    return sum(host) / len(host) * 1e3
