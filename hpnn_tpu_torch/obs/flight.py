"""Flight recorder: a bounded ring of the last N obs records (the port
of ``hpnn_tpu/obs/flight.py``).

The JSONL sink is append-and-flush, but a crash can still lose the
tail that explains it: the process may die between the event and the
flush, the sink may live on a network filesystem that truncates, or
metrics may simply be off.  The flight recorder keeps the last
``HPNN_FLIGHT_N`` records (default 256) in memory **regardless of sink
state** and dumps them atomically when something goes wrong:

* ``round.abort`` — the driver dumps before re-raising a dispatch
  crash (train/driver.py);
* unhandled exceptions — ``sys.excepthook`` is chained when the
  registry activates (obs/registry.py);
* SIGTERM / SIGINT — same chained handlers.

Arm it with ``HPNN_FLIGHT=<path>`` (``{rank}`` expands to the process
index, 0 in this one-process port, like the metrics sink).  Arming the recorder activates
the registry even when ``HPNN_METRICS`` is unset — events then
aggregate in memory and feed the ring without a JSONL file.  With both
knobs unset everything in this module is a memoized no-op.

The dump is one JSONL file: a ``flight.dump`` header line (reason,
capacity, pid) followed by the recorded lines oldest-first.  It is
written to a temp file and ``os.replace``d into place, so a reader
never sees a torn dump.  stdlib only; stdout is never written.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

ENV_KNOB = "HPNN_FLIGHT"
ENV_CAP = "HPNN_FLIGHT_N"
DEFAULT_CAP = 256

# None = env not read yet; False = disarmed; (path, cap) = armed
_cfg: tuple[str, int] | bool | None = None
_ring: collections.deque[str] | None = None
_lock = threading.Lock()


def _config():
    global _cfg, _ring
    cfg = _cfg
    if cfg is None:
        with _lock:
            if _cfg is None:
                path = os.environ.get(ENV_KNOB, "")
                if not path:
                    _cfg = False
                else:
                    if "{rank}" in path:
                        from hpnn_tpu_torch.obs import registry

                        path = path.replace(
                            "{rank}", str(registry._process_index()))
                    try:
                        cap = int(os.environ.get(ENV_CAP) or DEFAULT_CAP)
                    except ValueError:
                        cap = DEFAULT_CAP
                    cap = max(8, cap)
                    _ring = collections.deque(maxlen=cap)
                    _cfg = (path, cap)
            cfg = _cfg
    return cfg


def enabled() -> bool:
    """True when ``HPNN_FLIGHT`` is set (memoized, like the sink)."""
    return bool(_config())


def dump_path() -> str | None:
    """The (rank-expanded) dump target, or None when disarmed."""
    cfg = _config()
    return cfg[0] if cfg else None


def record(line: str) -> None:
    """Append one already-serialized JSONL record to the ring.  Called
    by ``registry._emit`` for every record; the deque drops the oldest
    entry once the ring is full."""
    cfg = _config()
    if not cfg:
        return
    with _lock:
        _ring.append(line)


def dump(reason: str) -> str | None:
    """Atomically write the ring to the dump path (header line +
    records oldest-first).  Returns the path, or None when disarmed or
    the write failed (one stderr warning, never a raise — this runs on
    crash paths)."""
    cfg = _config()
    if not cfg:
        return None
    path, cap = cfg
    with _lock:
        tail = list(_ring)
    header = {
        "ts": round(time.time(), 6),
        "ev": "flight.dump",
        "kind": "event",
        "reason": reason,
        "events": len(tail),
        "capacity": cap,
        "pid": os.getpid(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fp:
            fp.write(json.dumps(header) + "\n")
            for line in tail:
                fp.write(line + "\n")
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        sys.stderr.write(f"hpnn obs: flight dump failed: {exc}\n")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def _reset_for_tests() -> None:
    """Forget the memoized knob + ring (registry._reset_for_tests
    chains here, so the conftest reset covers both)."""
    global _cfg, _ring
    with _lock:
        _cfg = None
        _ring = None
