"""Milliseconds a round spends on its kernel text: reading the conf and
its ``[init]`` kernel file (the ``io.conf_load`` span), then writing
``kernel.tmp`` and ``kernel.opt`` (the ``io.kernel_dump`` spans), per
``train_nn.round`` span (the program's span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_nn.round", ("io.conf_load", "io.kernel_dump"))
