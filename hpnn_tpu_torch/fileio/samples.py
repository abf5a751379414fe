"""Sample-file reader and directory listing.

Sample text format (ref parser: libhpnn src/libhpnn.c:1070-1145):

    [input] N        <- optional trailing comment tolerated
    v1 v2 ... vN     <- the line immediately after
    [output] M
    t1 t2 ... tM

Directory listing skips dotfiles and preserves readdir order — the
reference builds its file list straight from ``readdir`` (ref:
src/libhpnn.c:1190-1214), and the glibc-seeded shuffle indexes into
that order, so readdir order is part of the reproducibility contract.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from hpnn_tpu_torch import native
from hpnn_tpu_torch.utils import logging as log

# strtod: optional whitespace then a decimal number ("inf"/"nan"/hex
# floats parse in C but are never written by any converter).  Bytes
# pattern: the walk classifies RAW BYTES like the C side (UTF-8
# continuation bytes are non-graph -> blank).
_STRTOD = re.compile(rb"[ \t\n\r\f\v]*([-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)")

# Guard against absurd declared counts ([input] 999999999): the
# reference ALLOCs exactly that many doubles and walks garbage memory
# past the line's NUL; we reject instead.
_SANE_ROW = 1 << 22


def read_sample(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Read one sample file → (input vector, target vector), or None."""
    try:
        with open(path, "r") as fp:
            lines = fp.readlines()
    except OSError:
        return None
    vin = vout = None
    i = 0
    while i < len(lines):
        line = lines[i]
        if "[input" in line:
            n = _count_after(line, "[input")
            if n is None or n == 0 or i + 1 >= len(lines):
                return None
            vin = parse_row(lines[i + 1], n)
            if vin is None:
                return None
            i += 1
        elif "[output" in line:
            n = _count_after(line, "[output")
            if n is None or n == 0 or i + 1 >= len(lines):
                return None
            vout = parse_row(lines[i + 1], n)
            if vout is None:
                return None
            i += 1
        i += 1
    if vin is None or vout is None:
        return None
    return vin, vout


def parse_row(line: str, n: int) -> np.ndarray | None:
    """``n`` doubles from the line via the reference's GET_DOUBLE walk
    (ref: src/ann.c:438-444, src/libhpnn.c:1104-1110), shared by the
    sample reader and the kernel loader:

    * ``v = strtod(p, &end)`` — 0.0 when the token is junk, so a row
      is never rejected;
    * the cursor always advances ``end+1`` then SKIP_BLANK, so a junk
      token reads as 0.0 and a junk-suffixed token ("0.25x 0.5")
      salvages its prefix and scanning continues after it;
    * a line with fewer than ``n`` values yields 0.0 for the missing
      ones.

    The native library's walk (``native.parse_doubles``) gives the same
    values; this Python walk runs without it (``HPNN_NO_NATIVE=1``).

    Returns None only for an absurd ``n`` (see ``_SANE_ROW``)."""
    if n > max(len(line) // 2 + 1, _SANE_ROW):
        return None
    out = np.zeros(n, dtype=np.float64)
    row = native.parse_doubles(line, n)
    if row is not None:
        out[: row.size] = row
        return out
    raw = line.encode() if isinstance(line, str) else line
    pos, limit = 0, len(raw)
    # SKIP_BLANK runs once BEFORE the first GET_DOUBLE (ref:
    # src/ann.c:438, src/libhpnn.c:1104)
    pos = _skip_blank(raw, pos, limit)
    for k in range(n):
        if pos > limit:
            break  # past the "NUL": remaining values stay 0.0
        m = _STRTOD.match(raw, pos)
        if m:
            out[k] = float(m.group(1))
            pos = m.end() + 1
        else:
            pos += 1  # strtod failure: end == start, ptr = end+1
        pos = _skip_blank(raw, pos, limit)
    return out


def _skip_blank(raw: bytes, pos: int, limit: int) -> int:
    """SKIP_BLANK: advance over non-graph bytes except newline
    (common.h:250-251)."""
    while pos < limit and raw[pos] != 0x0A and not (0x20 < raw[pos] < 0x7F):
        pos += 1
    return pos


def read_dir(directory: str, files=None):
    """Read every sample in readdir order → (names, X, T) stacked arrays.

    The batch drivers' bulk loader: unreadable or malformed files are
    skipped, and so is a file whose dims differ from the first readable
    one (with a warning).  Pass the already-listed census as ``files``
    so that the census, the bulk read and a later shuffle all iterate
    one listing."""
    names, xs, ts = [], [], []
    for name in (list_sample_files(directory) if files is None else files):
        s = read_sample(os.path.join(directory, name))
        if s is None:
            continue
        if xs and (s[0].shape != xs[0].shape or s[1].shape != ts[0].shape):
            log.nn_warn(
                sys.stderr,
                "skipping %s: dims %ix%i != %ix%i\n",
                name, s[0].size, s[1].size, xs[0].size, ts[0].size,
            )
            continue
        names.append(name)
        xs.append(s[0])
        ts.append(s[1])
    if not names:
        return [], np.zeros((0, 0)), np.zeros((0, 0))
    return names, np.stack(xs), np.stack(ts)


def _count_after(line: str, tag: str) -> int | None:
    rest = line[line.find(tag) + len(tag) + 1 :].lstrip(" \t")
    if not rest or not rest[0].isdigit():
        return None
    digits = ""
    for ch in rest:
        if ch.isdigit():
            digits += ch
        else:
            break
    return int(digits)


def list_sample_files(directory: str) -> list[str]:
    """File names in readdir order, dotfiles skipped (no sorting!)."""
    with os.scandir(directory) as it:
        return [e.name for e in it if not e.name.startswith(".")]
