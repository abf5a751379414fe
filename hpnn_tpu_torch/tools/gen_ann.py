"""``gen_ann`` — emit a random kernel file to stdout.

Replaces ``scripts/gen_ann.bash`` (ref: libhpnn scripts/
gen_ann.bash:38-47), which draws 16-bit words from /dev/urandom,
formats them as 5-digit zero-padded decimals and reads them back as
``0.ddddd`` — i.e. u = v/100000 with v ∈ [0,65535] (a quirky,
negatively-biased uniform) — then writes ``2·(u−0.5)/√width`` weights
as ``%7.5f`` with a trailing space per row.  Same math and format here,
with an optional ``--seed`` for reproducibility (the bash tool was
unseedable).

Scale quirk preserved: the awk call passes ``var="$param $WEIGHT"`` so
``list[1]`` is the CURRENT layer's neuron count, i.e. the divisor is
√(layer width) — NOT √(fan-in) as ``ann_generate`` uses
(ref: src/ann.c:677).  For non-square layers the two differ; this tool
reproduces the script, not the library.

usage: gen_ann [--seed N] num_input num_hid1 [... num_hidN] num_output
"""

from __future__ import annotations

import math
import os
import struct
import sys


def _u16_stream(seed: int | None):
    if seed is None:
        while True:
            yield from struct.unpack("<32H", os.urandom(64))
    else:
        import random

        rng = random.Random(seed)
        while True:
            yield rng.getrandbits(16)


def dump_help() -> None:
    w = sys.stdout.write
    w("usage: gen_ann [--seed N] num_input num_hid1_out ... num_hidN_out num_output\n")
    w("num_input: number of inputs\n")
    w("num_hid1_out: number of outputs for hidden layer 1\n")
    w("...\n")
    w("num_hidN_out: number of outputs for hidden layer N\n")
    w("num_output: number of outputs\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    seed = None
    if argv[:1] == ["--seed"]:
        if len(argv) < 2 or not argv[1].isdigit():
            dump_help()
            return 1
        seed = int(argv[1])
        argv = argv[2:]
    if len(argv) < 3:
        dump_help()
        return 1
    try:
        dims = [int(a) for a in argv]
    except ValueError:
        dump_help()
        return 1
    if dims[0] < 1:
        sys.stdout.write("ERROR: number of inputs < 1\n")
        return 1
    rng = _u16_stream(seed)
    w = sys.stdout.write
    w("[name] auto\n")
    w("[param] %s\n" % " ".join(str(d) for d in dims))
    w("[input] %i\n" % dims[0])
    prev = dims[0]
    for li, width in enumerate(dims[1:], start=1):
        if li == len(dims) - 1:
            w("[output] %i\n" % width)
        else:
            w("[hidden %i] %i\n" % (li, width))
        # the bash tool divides by sqrt(CURRENT width), not fan-in
        # (awk list[1] == $param, ref: scripts/gen_ann.bash:38-47)
        scale = 1.0 / math.sqrt(width)
        for j in range(1, width + 1):
            w("[neuron %i] %i\n" % (j, prev))
            row = (
                "%7.5f " % (2.0 * (next(rng) / 100000.0 - 0.5) * scale)
                for _ in range(prev)
            )
            w("".join(row))
            w("\n")
        prev = width
    return 0


if __name__ == "__main__":
    sys.exit(main())
