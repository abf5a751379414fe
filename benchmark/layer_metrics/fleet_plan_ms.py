"""Milliseconds a fleet call spends drawing its members' permutations
and block orders (the ``fleet.plan`` span), per ``train.fleet_round``
span (the program's span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train.fleet_round", ("fleet.plan",))
