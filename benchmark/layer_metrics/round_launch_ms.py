"""Host milliseconds of a round's launches of #1: the ``train.chunk``
spans' seconds (the launch and the stats fetch that waits on it) less
the convergence kernel's device time in the trace, per
``train_nn.round`` span (the program's span table)."""

from benchmark.program_spans import per_root_s, table
from benchmark.tracing import kernel_seconds

PATTERN = "convergence_"


def read(run):
    chunks = per_root_s(run, "train_nn.round", ("train.chunk",))
    if chunks is None:
        return None
    rounds = table(run)["train_nn.round"][0]
    return (chunks - kernel_seconds(run["trace"]["kernels"], PATTERN) / rounds) * 1e3
