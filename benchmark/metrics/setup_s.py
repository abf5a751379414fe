"""Seconds from the process's start to the first timed call: imports,
data and weights from the seed, the files a round reads, the kernels'
build or load, the warm-up call, and in a traced run the tracer's
start-up."""


def read(run):
    return run["setup_s"]
