"""Verbosity-gated logging, matching the reference's stdout protocol.

The reference defines four log levels gated on a global verbosity
(ref: libhpnn include/libhpnn.h:95-122):

* ``NN_DBG``   — verbosity > 2, prefix ``NN(DBG): ``
* ``NN_OUT``   — verbosity > 1, prefix ``NN: ``
* ``NN_COUT``  — verbosity > 1, no prefix (continuation tokens)
* ``NN_WARN``  — verbosity > 0, prefix ``NN(WARN): ``
* ``NN_ERROR`` — always,        prefix ``NN(ERR): ``

The tutorial monitor scripts grep these exact tokens, so they are a
de-facto metrics API and must be byte-stable.  This package runs one
process, so every line is rank 0's.
"""

from __future__ import annotations

import sys

_verbosity = 0


def set_verbose(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def inc_verbose() -> None:
    global _verbosity
    if _verbosity > 2:  # capped at 3, like the reference (src/libhpnn.c:71)
        return
    _verbosity += 1
    # the reference reports the change at DBG level (fires at the 3rd -v)
    nn_dbg(sys.stdout, "verbosity set to %i.\n", _verbosity)


def dec_verbose() -> None:
    global _verbosity
    if _verbosity > 0:
        _verbosity -= 1


def get_verbose() -> int:
    return _verbosity


def _fmt(fmt: str, args) -> str:
    return fmt % args if args else fmt


def nn_dbg(fp, fmt: str, *args) -> None:
    if _verbosity > 2:
        fp.write("NN(DBG): " + _fmt(fmt, args))


def nn_out(fp, fmt: str, *args) -> None:
    if _verbosity > 1:
        fp.write("NN: " + _fmt(fmt, args))


def nn_cout(fp, fmt: str, *args) -> None:
    if _verbosity > 1:
        fp.write(_fmt(fmt, args))


def nn_warn(fp, fmt: str, *args) -> None:
    if _verbosity > 0:
        fp.write("NN(WARN): " + _fmt(fmt, args))


def nn_error(fp, fmt: str, *args) -> None:
    fp.write("NN(ERR): " + _fmt(fmt, args))


def nn_write(fp, fmt: str, *args) -> None:
    fp.write(_fmt(fmt, args))


def flush() -> None:
    # both streams: nn_error/nn_warn write to stderr, which is buffered
    # when redirected to a file (the tutorial-monitor case)
    sys.stdout.flush()
    sys.stderr.flush()
