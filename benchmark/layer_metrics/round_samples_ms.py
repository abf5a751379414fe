"""Milliseconds a round spends on its samples: the listing, the
shuffle, every file's parse, the stacked bank and its copy to the card
(the ``train.samples`` span), per ``train_nn.round`` span (the
program's span table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_nn.round", ("train.samples",))
