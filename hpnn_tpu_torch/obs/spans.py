"""Span model for latency attribution (the ``HPNN_SPANS`` knob): the
port of ``hpnn_tpu/obs/spans.py``.

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

Contract (same as every obs knob): ``HPNN_SPANS`` unset ⇒ one env read
ever, then every call is a constant-time no-op returning a shared null
span — no clock reads, no allocation, no stdout bytes.
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

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_SPANS"

_enabled: bool | None = None
_ids = itertools.count(1)
_tls = threading.local()


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

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("id", "parent", "name", "fields", "t0", "_done")

    def __init__(self, name: str, parent: int | None, fields: dict):
        self.id = next(_ids)
        self.parent = parent
        self.name = name
        self.fields = fields
        self.t0 = time.perf_counter()
        self._done = False

    # context-manager form: ambient nesting via the thread-local stack
    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
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
    ambient default; extra fields land on the ``span.end`` record."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, _parent_id(parent), dict(fields))


def start(name: str, parent=None, **fields):
    """Manually started span for cross-thread handoff — never enters
    the ambient stack; close it with :func:`finish` from any thread."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, _parent_id(parent), dict(fields))


def finish(sp, **fields) -> None:
    """Close a span: one ``span.end`` record + the ``span.<name>``
    aggregate.  Idempotent; a None/null span is a no-op."""
    if sp is None or not isinstance(sp, Span) or sp._done:
        return
    sp._done = True
    dt = time.perf_counter() - sp.t0
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


def _reset_for_tests() -> None:
    global _enabled, _ids
    _enabled = None
    _ids = itertools.count(1)
    _tls.stack = []
