"""Per-round checksum ledger (the ``HPNN_LEDGER`` knob): the port of
``hpnn_tpu/obs/ledger.py``, with its frozen row schema, so
``tools/ledger_diff.py`` pairs a port ledger with a JAX package ledger
and a card run with a CPU run.

The reference library's acceptance criterion for a port is *numerical
consistency across backends*: absolute sums of every vector agreeing to
1e-14 and every weight matrix to 1e-12 (reference ChangeLog:33-38, the
CUDA-port validation note).  That check was offline and manual; the
ledger makes it a first-class reproducible artifact.  With
``HPNN_LEDGER=<path>`` set, every numerics check (obs/probes.py)
appends one JSONL row carrying the abs-sum of every weight tensor, so
two runs — card vs CPU, this package vs the JAX package, today vs
last week — can be compared under the reference tolerances with ``tools/ledger_diff.py``.

File format (one JSON object per line)::

    {"ts": ..., "ev": "ledger.open", "path": ..., "pid": ..., "rank": ...}
    {"ts": ..., "ev": "ledger.round", "row": 0, "step": ..., "where": ...,
     "rank": ..., "nan": 0, "inf": 0,
     "checksums": {"w0": <abs-sum>, ...},
     "shapes": {"w0": [5, 8], ...}}

``row`` auto-increments from 0 per ledger file, so two same-seed runs
produce row-aligned ledgers and the diff tool pairs rows by index, not
by timestamp.  Checksums are f64 values serialized by ``json`` (full
``repr`` precision — an f64 round-trips exactly, so "equal to 1e-14"
is decidable from the file).  A weight tensor holding NaN serializes
as JSON ``NaN`` (Python reads it back); the row's ``nan`` count marks
it unclean regardless.

Design rules (same as the metrics registry): zero overhead when unset
(env read once, memoized), stdout never written, stdlib-only imports,
``{rank}`` in the path expands to the process index (0: one process).  The ledger is deliberately **not** the metrics
sink: it is a comparison artifact with a frozen schema
(``tools/check_obs_catalog.py`` lints it), not a telemetry stream.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_LEDGER"


class _Ledger:
    __slots__ = ("fp", "path", "row", "lock")

    def __init__(self, fp, path):
        self.fp = fp
        self.path = path
        self.row = 0
        self.lock = threading.Lock()


# None = env not read yet; False = disabled; _Ledger = active file
_state: _Ledger | bool | None = None
_state_lock = threading.Lock()


def _init():
    global _state
    with _state_lock:
        if _state is not None:
            return _state
        path = os.environ.get(ENV_KNOB, "")
        if not path:
            _state = False
            return False
        if "{rank}" in path:
            path = path.replace("{rank}", str(registry._process_index()))
        try:
            fp = open(path, "a")
        except OSError as exc:
            sys.stderr.write(
                f"hpnn obs: cannot open ledger {path!r}: {exc}; "
                "ledger disabled\n")
            _state = False
            return False
        st = _Ledger(fp, path)
        _state = st
    header = {
        "ts": round(time.time(), 6),
        "ev": "ledger.open",
        "path": path,
        "pid": os.getpid(),
        "rank": registry._process_index(),
    }
    with st.lock:
        st.fp.write(json.dumps(header) + "\n")
        st.fp.flush()
    return st


def _active():
    st = _state
    if st is None:
        st = _init()
    return st or None


def enabled() -> bool:
    """True when ``HPNN_LEDGER`` points at a writable file (memoized)."""
    return _active() is not None


def path() -> str | None:
    """The (rank-expanded) ledger path, or None when disabled."""
    st = _active()
    return st.path if st else None


def last_row() -> int | None:
    """Index of the last row written by THIS process, or None when the
    ledger is disabled or still empty."""
    st = _active()
    if st is None or st.row == 0:
        return None
    return st.row - 1


def record(*, step, where: str, checksums: dict, shapes: dict,
           nan: int = 0, inf: int = 0) -> int | None:
    """Append one ``ledger.round`` row; returns its row index (or None
    when the ledger is disabled).  ``checksums`` maps tensor name →
    abs-sum; ``shapes`` maps the same names → shape lists (the diff
    tool picks the vector/matrix tolerance from them)."""
    st = _active()
    if st is None:
        return None
    with st.lock:
        row = st.row
        st.row += 1
        rec = {
            "ts": round(time.time(), 6),
            "ev": "ledger.round",
            "row": row,
            "step": step,
            "where": where,
            "rank": registry._process_index(),
            "nan": int(nan),
            "inf": int(inf),
            "checksums": {k: float(v) for k, v in checksums.items()},
            "shapes": {k: [int(d) for d in v] for k, v in shapes.items()},
        }
        st.fp.write(json.dumps(rec) + "\n")
        st.fp.flush()
    return row


def configure(new_path: str | None) -> None:
    """Programmatic twin of the env knob (the CLI ``--ledger`` flag):
    (re)point the ledger at ``new_path`` — or disable with None/"" —
    and forget any previously memoized state."""
    if new_path:
        os.environ[ENV_KNOB] = new_path
    else:
        os.environ.pop(ENV_KNOB, None)
    _reset_for_tests()


def _reset_for_tests() -> None:
    """Forget the memoized ledger (closing it if open) so the next call
    re-reads ``HPNN_LEDGER``.  Chained from registry._reset_for_tests
    so the conftest reset covers it."""
    global _state
    with _state_lock:
        st = _state
        _state = None
        if isinstance(st, _Ledger):
            try:
                st.fp.close()
            except (OSError, ValueError):
                pass  # already closed
