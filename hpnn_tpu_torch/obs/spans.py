"""Span model for latency attribution (the ``HPNN_SPANS`` knob, and any
``torch.profiler``): the port of ``hpnn_tpu/obs/spans.py``.

Timers (registry.py) answer "how long did this named block take, in
aggregate"; they cannot answer "where inside THIS request did the time
go" because the stream carries no causality.  A **span** is a timer
with identity: a process-unique id, an optional parent id, a name, and
a monotonic start/stop pair.  Every finished span emits exactly one
``span.end`` record::

    {"ev": "span.end", "kind": "event", "span": 7, "parent": 3,
     "name": "serve.dispatch", "t0": 12.345678, "dt": 0.000812, ...}

``span`` / ``parent`` reconstruct the tree, ``t0`` (a
``time.perf_counter`` reading — monotonic, comparable only within one
process) orders siblings, ``dt`` is the span's own wall time.  Span
*names* are data fields, not event names — the only literal event this
module emits is ``span.end``, so the catalog drift lint
(tools/check_obs_catalog.py) stays sound while span names stay
free-form.  ``tools/obs_report.py --spans`` renders the tree and a
slowest-N table.

Two usage shapes:

* **ambient nesting** (same thread)::

      with spans.span("train.round"):
          with spans.span("train.chunk", i=3):   # parent inferred
              ...

  the context-manager form keeps a thread-local stack, so an omitted
  ``parent`` defaults to the innermost open span on this thread.

* **explicit handoff**::

      sp = spans.start("train.round")
      child = spans.start("train.chunk", parent=sp)
      spans.finish(child)
      spans.finish(sp)

  ``start``/``finish`` never touch the ambient stack; the parent is
  whatever span object (or id) the caller threads through.

A span is real when ``HPNN_SPANS`` is set or while any
``torch.profiler`` collects in the process (``profiler.collecting()``:
the ``--profile`` trace, a capsule's window, a benchmark's profiler).
While one collects, a context-manager span also opens a
``record_function`` range of its own name on entry and closes it in
:func:`finish`, so the span lies on the device trace's clock beside the
kernels it launched; a :func:`start` span, which may be finished on
another thread, opens no range.  Every real span adds its wall seconds
to an in-process table, ``totals()`` ``{name: (count, seconds)}``,
which only ``_reset_for_tests`` clears.

Contract (same as every obs knob): ``HPNN_SPANS`` unset and no
profiler ⇒ one env read ever, then every call is a constant-time no-op
after one flag read, returning a shared null span — no clock reads, no
allocation, no stdout bytes.
Each ``span.end`` also feeds the cumulative ``span.<name>`` aggregate,
so per-name span summaries show up on ``/metrics`` next to the plain
timers.  stdlib-only; emission rides the registry, which the knob arms
file-less (registry._init) so spans work without ``HPNN_METRICS``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from hpnn_tpu_torch.obs import blame, profiler, registry
from hpnn_tpu_torch.obs.profiler import collecting as _collecting

ENV_KNOB = "HPNN_SPANS"

_enabled: bool | None = None
_ids = itertools.count(1)
_tls = threading.local()
# name -> [count, seconds] of every real span finished in the process
_totals: dict[str, list] = {}
_totals_lock = threading.Lock()


def enabled() -> bool:
    """True when ``HPNN_SPANS`` is set.  First call reads the env;
    later calls are a memo hit."""
    global _enabled
    if _enabled is None:
        _enabled = bool(os.environ.get(ENV_KNOB))
    return _enabled


class _NullSpan:
    """Shared no-op span for every disabled-path call.  Its ``id`` is
    None, so passing it as a parent parents nothing."""

    __slots__ = ()
    id = None
    parent = None
    name = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):   # no *args: no tuple to pack
        return False


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("id", "parent", "name", "fields", "t0", "_done", "_range")

    def __init__(self, name: str, parent: int | None, fields: dict):
        self.id = next(_ids)
        self.parent = parent
        self.name = name
        self.fields = fields
        self.t0 = time.perf_counter()
        self._done = False
        self._range = None

    # context-manager form: ambient nesting via the thread-local stack,
    # and the profiler's range while one collects
    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        if _collecting():
            self._range = profiler.open_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.fields.setdefault("failed", exc_type.__name__)
        finish(self)
        return False


def current() -> Span | None:
    """The innermost open context-manager span on this thread."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _parent_id(parent) -> int | None:
    if parent is None:
        cur = current()
        return cur.id if cur is not None else None
    if isinstance(parent, int):
        return parent
    return getattr(parent, "id", None)


def span(name: str, parent=None, **fields):
    """Context-manager span.  ``parent`` (a Span or id) overrides the
    ambient default; extra fields land on the ``span.end`` record.
    With ``HPNN_SPANS`` unset, a real (forced/sampled) parent span
    still gets a real child — that is how a sampled request's tree
    grows under ``HPNN_SAMPLE`` (obs/forensics.py)."""
    # real under the knob, a collecting profiler or a real parent; the
    # memo and the flag are read first, inline: with all three off this
    # test is the span's whole cost
    if not (_enabled or _collecting() or (_enabled is None and enabled())
            or (parent is not None and isinstance(parent, Span))):
        return _NULL_SPAN
    return Span(name, _parent_id(parent), dict(fields))


def start(name: str, parent=None, **fields):
    """Manually started span for cross-thread handoff — never enters
    the ambient stack; close it with :func:`finish` from any thread.
    Like :func:`span`, a real parent forces a real child even while
    ``HPNN_SPANS`` is unset (tail sampling, obs/forensics.py)."""
    # the gate of span(), inline for the same reason
    if not (_enabled or _collecting() or (_enabled is None and enabled())
            or (parent is not None and isinstance(parent, Span))):
        return _NULL_SPAN
    return Span(name, _parent_id(parent), dict(fields))


def force_start(name: str, parent=None, **fields):
    """A real span regardless of ``HPNN_SPANS`` — the tail sampler's
    mint (obs/forensics.py) for the sampled fraction of requests.
    ``finish`` emits whenever the registry is active, so forced spans
    record without the global knob.  Never call this on a hot path
    that has not already decided to sample."""
    return Span(name, _parent_id(parent), dict(fields))


def finish(sp, **fields) -> None:
    """Close a span: its range, its line of :func:`totals`, one
    ``span.end`` record + the ``span.<name>`` aggregate.  Idempotent; a
    None/null span is a no-op."""
    if sp is None or not isinstance(sp, Span) or sp._done:
        return
    sp._done = True
    dt = time.perf_counter() - sp.t0
    if sp._range is not None:
        profiler.close_range(sp._range)
        sp._range = None
    with _totals_lock:
        t = _totals.get(sp.name)
        if t is None:
            _totals[sp.name] = [1, dt]
        else:
            t[0] += 1
            t[1] += dt
    st = registry._active()
    if st is None:
        return
    with st.lock:
        agg = st.aggs.get("span." + sp.name)
        if agg is None:
            agg = st.aggs["span." + sp.name] = registry._Agg()
        agg.add(dt)
    rec = {"ev": "span.end", "kind": "event", "span": sp.id,
           "parent": sp.parent, "name": sp.name,
           "t0": round(sp.t0, 6), "dt": round(dt, 6)}
    rec.update(sp.fields)
    rec.update(fields)
    registry._emit(st, rec)
    # online blame tap (obs/blame.py): a memoized no-op unless
    # HPNN_BLAME is armed — descendants buffer, a closing request
    # root folds its per-phase split into the rolling window
    blame.note_record(rec)


def totals() -> dict:
    """``{name: (count, seconds)}``: every real span finished in this
    process, by name (a copy)."""
    with _totals_lock:
        return {name: (c, s) for name, (c, s) in _totals.items()}


def _reset_for_tests() -> None:
    global _enabled, _ids
    _enabled = None
    _ids = itertools.count(1)
    _tls.stack = []
    with _totals_lock:
        _totals.clear()
