"""Milliseconds a round spends printing its tokens (the ``train.tokens``
spans, one a chunk), per ``train_nn.round`` span (the program's span
table)."""

from benchmark.program_spans import per_root_ms


def read(run):
    return per_root_ms(run, "train_nn.round", ("train.tokens",))
