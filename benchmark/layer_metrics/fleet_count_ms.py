"""Host milliseconds of a fleet call's counts, each member after each
epoch: the clones, forwards and compares the host dispatches (the
``fleet.count`` spans), per ``train.fleet_round`` span (the program's
span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train.fleet_round", ("fleet.count",))
