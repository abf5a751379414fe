"""Milliseconds a fleet call spends handing its result back: the copy to
the host, the members unstacked, the losses and counts as host arrays
(the ``fleet.result`` span), per ``train.fleet_round`` span (the
program's span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train.fleet_round", ("fleet.result",))
