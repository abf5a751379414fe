"""Metrics registry + JSONL event sink (the ``HPNN_METRICS`` knob).

The port of ``hpnn_tpu/obs/registry.py``: the same record schema and
event names, so ``tools/obs_report.py`` and
``tools/check_obs_catalog.py`` read the port's files unchanged.

The reference's only observability is its byte-stable stdout token
protocol (``NN:`` lines and the ``#DBG: acc=`` traces).  This registry
is the structured side channel: when ``HPNN_METRICS=<path>`` is set,
every instrumented site appends one JSON object per line to ``<path>``
(launch latencies, chunk-size timelines, resume counters, per-round
``n_iter`` histograms).  stdout is never written to.

Design rules:

* **zero overhead when unset** — the env var is read once and memoized;
  every public entry point is a constant-time early return afterwards,
  and :func:`timer` hands back a shared no-op context manager so the
  hot loops never even call ``perf_counter``;
* **no device syncs of its own** — instrumentation sites only record
  host values they already hold;
* **stdlib only** at import (numpy lazily, for histograms).

Record schema (one JSON object per line):

    {"ts": <unix s>, "ev": <name>, "kind": <kind>, ...fields}

kinds: ``event``, ``count`` (with the running total), ``gauge``,
``timer`` (``dt`` seconds), ``hist`` (n/mean/min/max of one batch) and
``summary`` (cumulative aggregates, at round end and at exit).

One process: ``{rank}`` in the path expands to 0.  The registry also
runs **file-less** when the flight recorder (``HPNN_FLIGHT``), an
export server, ``HPNN_SPANS`` or ``HPNN_COST`` wants the records
without a sink.  On the first activation it chains SIGTERM/SIGINT
handlers and ``sys.excepthook``, so a killed or crashing run flushes
its sink, writes a final ``summary`` line and dumps the flight ring.

The JAX package's fleet-telemetry hooks (collector push, alert rules,
capture capsules) and the per-tenant meter are not ported; their knobs
are refused (``runtime.DEFERRED_ENV``).
"""

from __future__ import annotations

import atexit
import json
import math
import os
import signal
import sys
import threading
import time

from hpnn_tpu_torch.obs import flight

ENV_KNOB = "HPNN_METRICS"


class _NullCtx:
    """Shared no-op context manager for every disabled-path `timer`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def _bucket_of(v: float) -> int:
    """Power-of-two bucket key: value v falls in (2**(k-1), 2**k]."""
    if v <= 0:
        return 0
    return math.frexp(v)[1]


class _Agg:
    """Running aggregate (count/sum/min/max + log2 buckets) for one
    timer or histogram name."""

    __slots__ = ("n", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.buckets: dict[int, int] = {}

    def add(self, v: float) -> None:
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        b = _bucket_of(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def add_many(self, arr) -> None:
        import numpy as np

        a = np.asarray(arr, dtype=np.float64).ravel()
        if a.size == 0:
            return
        self.n += int(a.size)
        self.total += float(a.sum())
        lo, hi = float(a.min()), float(a.max())
        self.vmin = lo if self.vmin is None else min(self.vmin, lo)
        self.vmax = hi if self.vmax is None else max(self.vmax, hi)
        pos = a > 0
        exps = np.frexp(a[pos])[1]
        for b, c in zip(*np.unique(exps, return_counts=True)):
            b = int(b)
            self.buckets[b] = self.buckets.get(b, 0) + int(c)
        nz = int(a.size) - int(pos.sum())
        if nz:
            self.buckets[0] = self.buckets.get(0, 0) + nz

    def snapshot(self) -> dict:
        mean = self.total / self.n if self.n else 0.0
        return {
            "n": self.n,
            "total": round(self.total, 9),
            "mean": round(mean, 9),
            "min": self.vmin,
            "max": self.vmax,
            # JSON keys must be strings; "k" means bucket (2^(k-1), 2^k]
            "log2_buckets": {str(k): v for k, v in sorted(self.buckets.items())},
        }


class _State:
    __slots__ = ("fp", "path", "t0", "lock", "counters", "aggs", "gauges")

    def __init__(self, fp, path):
        self.fp = fp
        self.path = path
        self.t0 = time.time()
        self.lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.aggs: dict[str, _Agg] = {}
        self.gauges: dict[str, float] = {}


# None = env not read yet; False = disabled; _State = active sink
_state: _State | bool | None = None
_state_lock = threading.Lock()

# file-less activation requested (export server) — survives until a
# test reset; _init() then builds a _State with fp=None
_memory_requested = False

# crash handlers are chained once per process and never uninstalled;
# they check the live _state when they fire
_handlers_installed = False
_prev_excepthook = None

def _to_py(o):
    # numpy scalars and other array-likes carrying .item()
    if hasattr(o, "item"):
        return o.item()
    return str(o)


def _process_index() -> int:
    """This process's rank: 0, as the port runs one process."""
    return 0


def _init():
    global _state
    with _state_lock:
        if _state is not None:
            return _state
        path = os.environ.get(ENV_KNOB, "")
        fp = None
        if path:
            if "{rank}" in path:
                path = path.replace("{rank}", str(_process_index()))
            try:
                fp = open(path, "a")
            except OSError as exc:
                # never crash (or pollute stdout) over a broken sink
                sys.stderr.write(
                    f"hpnn obs: cannot open metrics sink {path!r}: "
                    f"{exc}; metrics disabled\n"
                )
                path = ""
                fp = None
        if fp is None:
            # file-less activation: the flight ring, the export
            # snapshot, and the performance-attribution knobs
            # (HPNN_SPANS / HPNN_COST feed the in-memory aggregates
            # that /metrics scrapes) still want the records even
            # without a sink
            if not (_memory_requested or flight.enabled()
                    or os.environ.get("HPNN_SPANS")
                    or os.environ.get("HPNN_COST")):
                _state = False
                return False
            path = None
        st = _State(fp, path)
        _state = st
        atexit.register(_at_exit)
    _install_crash_handlers()
    _emit(st, {"ev": "obs.open", "kind": "event", "pid": os.getpid(),
               "rank": _process_index()})
    return st


def _active():
    st = _state
    if st is None:
        st = _init()
    return st or None


def _emit(st: _State, rec: dict) -> None:
    rec.setdefault("ts", round(time.time(), 6))
    line = json.dumps(rec, default=_to_py)
    flight.record(line)
    if st.fp is not None:
        with st.lock:
            st.fp.write(line + "\n")
            st.fp.flush()


def enabled() -> bool:
    """True when the registry is active — a writable ``HPNN_METRICS``
    sink, an armed flight recorder, or a running export server.  First
    call reads the env; later calls are a memo hit."""
    return _active() is not None


def sink_path() -> str | None:
    """Path of the active JSONL sink, or None when disabled (or active
    file-less — flight/export only)."""
    st = _active()
    return st.path if st else None


def activate_memory() -> None:
    """Activate in-memory aggregation without a JSONL sink (used by the
    export server so ``--export-port`` works without ``--metrics``).
    A no-op when a sink is already active; a memoized "disabled" verdict
    is forgotten so the next call re-initializes."""
    global _memory_requested, _state
    _memory_requested = True
    with _state_lock:
        if _state is False:
            _state = None
    _active()


def snapshot_state() -> dict | None:
    """A consistent copy of the cumulative aggregates (the export
    server's read path), or None when the registry is inactive."""
    st = _active()
    if st is None:
        return None
    with st.lock:
        return {
            "uptime_s": round(time.time() - st.t0, 3),
            "path": st.path,
            "counters": dict(st.counters),
            "gauges": dict(st.gauges),
            "aggregates": {k: a.snapshot() for k, a in st.aggs.items()},
        }


def configure(path: str | None) -> None:
    """Programmatic twin of the env knob (the CLI ``--metrics`` flag):
    (re)point the sink at ``path`` — or disable with None/"" — and
    forget any previously memoized state."""
    if path:
        os.environ[ENV_KNOB] = path
    else:
        os.environ.pop(ENV_KNOB, None)
    _reset_for_tests()


def event(name: str, **fields) -> None:
    """Point event: one JSONL line, no aggregate."""
    st = _active()
    if st is None:
        return
    rec = {"ev": name, "kind": "event"}
    rec.update(fields)
    _emit(st, rec)


def count(name: str, n: int = 1, **fields) -> None:
    """Counter increment: emits one line carrying the increment and the
    running total, so event ORDER stays visible in the stream while the
    summary still carries exact totals."""
    st = _active()
    if st is None:
        return
    with st.lock:
        total = st.counters.get(name, 0) + n
        st.counters[name] = total
    rec = {"ev": name, "kind": "count", "n": n, "total": total}
    rec.update(fields)
    _emit(st, rec)


def gauge(name: str, value, **fields) -> None:
    st = _active()
    if st is None:
        return
    v = float(value)
    with st.lock:
        st.gauges[name] = v
    rec = {"ev": name, "kind": "gauge", "value": v}
    rec.update(fields)
    _emit(st, rec)


def observe(name: str, values, **fields) -> None:
    """Record one batch of observations into the named histogram (e.g.
    a chunk's per-sample ``n_iter`` array).  Emits ONE line summarizing
    the batch — never a line per element — and merges the values into
    the cumulative aggregate reported by :func:`summary`."""
    import numpy as np

    st = _active()
    if st is None:
        return
    a = np.asarray(values, dtype=np.float64).ravel()
    with st.lock:
        agg = st.aggs.get(name)
        if agg is None:
            agg = st.aggs[name] = _Agg()
        agg.add_many(a)
    rec = {"ev": name, "kind": "hist", "n": int(a.size)}
    if a.size:
        rec.update(
            mean=round(float(a.mean()), 6),
            min=float(a.min()),
            max=float(a.max()),
            sum=round(float(a.sum()), 6),
        )
    rec.update(fields)
    _emit(st, rec)


class _Timer:
    __slots__ = ("name", "fields", "t0")

    def __init__(self, name, fields):
        self.name = name
        self.fields = fields

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        st = _active()
        if st is not None:
            with st.lock:
                agg = st.aggs.get(self.name)
                if agg is None:
                    agg = st.aggs[self.name] = _Agg()
                agg.add(dt)
            rec = {"ev": self.name, "kind": "timer", "dt": round(dt, 6)}
            rec.update(self.fields)
            if exc_type is not None:
                rec["failed"] = exc_type.__name__
            _emit(st, rec)
        return False


def timer(name: str, **fields):
    """Context manager timing one block: emits a ``timer`` line with
    ``dt`` seconds (tagged ``failed`` if the block raised) and feeds the
    cumulative per-name aggregate.  A shared no-op object when the sink
    is disabled — the disabled path never touches the clock."""
    if _active() is None:
        return _NULL_CTX
    return _Timer(name, fields)


def summary() -> None:
    """Emit one ``summary`` line with the cumulative aggregates so far
    (counters, gauges, timer/histogram stats).  Drivers call this at
    round end; an atexit hook emits a final one.  Aggregates are
    cumulative across rounds — readers should use the LAST line."""
    st = _active()
    if st is None:
        return
    with st.lock:
        rec = {
            "ev": "obs.summary",
            "kind": "summary",
            "uptime_s": round(time.time() - st.t0, 3),
            "counters": dict(st.counters),
            "gauges": dict(st.gauges),
            "aggregates": {k: a.snapshot() for k, a in st.aggs.items()},
        }
    _emit(st, rec)


def flush() -> None:
    st = _active()
    if st is not None and st.fp is not None:
        with st.lock:
            st.fp.flush()


# Signal-path teardown runs at most once per process, whichever handler
# gets there first.
_signal_flushed = False


def _crash_flush(ev: str, detail: str, reason: str) -> None:
    """Shared teardown for signals and unhandled exceptions: one marker
    event, a final summary line, sink flush, flight dump.  Must never
    raise — it runs inside handlers on already-dying processes."""
    global _signal_flushed
    try:
        if reason in ("signal", "drain"):
            if _signal_flushed:
                return
            _signal_flushed = True
        if not isinstance(_state, _State):
            return
        event(ev, reason=detail)
        summary()
        flush()
        flight.dump(reason)
    # hpnnlint: ignore[swallow] -- crash path: obs must never mask
    except Exception:
        pass  # the original exception with one of its own


def _install_crash_handlers() -> None:
    """Chain SIGTERM/SIGINT handlers and ``sys.excepthook`` once per
    process (atexit only covers the clean-exit path).  The previous
    handler always runs afterwards, so a serve loop's KeyboardInterrupt
    shutdown — or pytest's own SIGINT handling — is preserved; a
    default-disposition SIGTERM is re-raised so the exit status stays
    honest."""
    global _handlers_installed, _prev_excepthook
    if _handlers_installed:
        return
    _handlers_installed = True

    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        _crash_flush("obs.crash", exc_type.__name__, "unhandled_exception")
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook

    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal only works from the main thread
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                _crash_flush("obs.signal",
                             signal.Signals(signum).name, "signal")
                if callable(_prev):
                    _prev(signum, frame)
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(sig, _handler)
        except (ValueError, OSError):
            pass


def _at_exit() -> None:
    st = _state
    if isinstance(st, _State):
        try:
            summary()
            if st.fp is not None:
                st.fp.close()
        # hpnnlint: ignore[swallow] -- atexit: interpreter teardown,
        except Exception:
            pass  # half-dead modules raise arbitrary errors here


def _reset_for_tests() -> None:
    """Forget the memoized sink (closing it if open) so the next call
    re-reads ``HPNN_METRICS``.  Also forgets the flight-recorder memo
    and any file-less activation.  Test-only — production code
    re-points the sink through :func:`configure`."""
    global _state, _memory_requested, _signal_flushed
    with _state_lock:
        st = _state
        _state = None
        _memory_requested = False
        _signal_flushed = False
        if isinstance(st, _State) and st.fp is not None:
            try:
                st.fp.close()
            except (OSError, ValueError):
                pass  # already closed
    flight._reset_for_tests()
    # chain the sibling memos; sys.modules.get avoids import cycles
    for name in ("hpnn_tpu_torch.obs.export", "hpnn_tpu_torch.obs.ledger",
                 "hpnn_tpu_torch.obs.probes", "hpnn_tpu_torch.obs.cost",
                 "hpnn_tpu_torch.obs.spans", "hpnn_tpu_torch.utils.trace"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod._reset_for_tests()
