"""Host milliseconds of a fleet call's launches of #6, one an epoch (the
``fleet.epoch`` spans), per ``train.fleet_round`` span (the program's
span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train.fleet_round", ("fleet.epoch",))
