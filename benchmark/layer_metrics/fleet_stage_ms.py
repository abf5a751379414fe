"""Milliseconds a fleet call spends putting its members and data on the
card: the ``fleet.stage`` span (the data as tensors, the members
stacked, the momentum buffers) and the ``fleet.gather`` spans (each
refresh group's bank gathers), per ``train.fleet_round`` span (the
program's span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train.fleet_round", ("fleet.stage", "fleet.gather"))
