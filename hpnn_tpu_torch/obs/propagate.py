"""Cross-process trace-context propagation (rides ``HPNN_SPANS``): a
copy of ``hpnn_tpu/obs/propagate.py``, with the same headers and span
fields, so the port's serve edge and the JAX package's tools join one
trace.

Spans (obs/spans.py) carry process-unique integer ids, so a span tree
stops at every process boundary: the loadgen client, the serve edge,
and an online trainer each build their own forest.  This module is the
wire format that stitches them into ONE tree:

* a **trace id** — a random 16-hex token minted once per request at
  the outermost edge (loadgen, or the serve handler when the client
  sent none);
* a **global span ref** — ``"<pid hex>:<span id>"`` — which makes a
  span id unique across the fleet without coordination;
* two HTTP headers next to the existing ``X-Request-Id``::

      X-Trace-Id:     9f3c2a1b7e5d4c6a
      X-Parent-Span:  1a2f:17

  injected by ``tools/loadgen.py`` and the ``serve/server.py`` edge,
  honored by the ``serve/router.py`` → ``serve/replica.py`` fan-out
  and the ``POST /ingest`` → ``online/trainer.py`` →
  ``online/promote.py`` causal chain.

A propagated context lands on the receiving side as two extra *fields*
on the entry-point span — ``trace`` (the trace id) and
``remote_parent`` (the sender's global ref) — so the span model itself
is untouched: span names stay data, and the only literal event this
module emits is the ``trace.adopt`` counter (one increment per request
whose headers carried a foreign context).  ``tools/obs_report.py
--spans --req <id>`` re-keys every span by its global ref and resolves
``remote_parent`` across sinks, reconstructing the single
edge → router → replica dispatch tree from N processes' files.

The **slot** API (:func:`note` / :func:`peek`) carries a context
across an in-process asynchrony gap that headers cannot cross (the
JAX package's ingest → online trainer chain; the port has no online
trainer yet, so nothing reads a slot).

Contract (same as every obs knob): propagation is active iff
``HPNN_SPANS`` is set — one memoized check, then every call on the
disabled path is a constant-time no-op returning None/{} — no clock
reads, no allocation growth, no stdout bytes.  stdlib-only.
"""

from __future__ import annotations

import os
import threading

from hpnn_tpu_torch.obs import registry, spans

HDR_TRACE = "X-Trace-Id"
HDR_PARENT = "X-Parent-Span"

_slots: dict[str, "Ctx"] = {}
_slots_lock = threading.Lock()


def enabled() -> bool:
    """Propagation rides the spans knob — or the tail sampler
    (``HPNN_SAMPLE``, obs/forensics.py), whose sampled requests need
    trace ids on the wire just like fully-spanned ones."""
    if spans.enabled():
        return True
    from hpnn_tpu_torch.obs import forensics

    return forensics.enabled()


class Ctx:
    """An immutable wire context: trace id + sender's global span ref
    (either may be None — a trace with no parent is a root adopt)."""

    __slots__ = ("trace", "parent")

    def __init__(self, trace: str | None, parent: str | None = None):
        self.trace = trace
        self.parent = parent

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Ctx(trace={self.trace!r}, parent={self.parent!r})"


def new_trace() -> str:
    """Mint a fleet-unique trace id (16 hex chars)."""
    return os.urandom(8).hex()


def ref(sp) -> str | None:
    """Global ref of a live span: ``"<pid hex>:<span id>"``.  None for
    the null span (disabled path) or None input."""
    sid = getattr(sp, "id", None)
    if sid is None:
        return None
    return f"{os.getpid():x}:{sid}"


def ctx_from(sp, trace: str | None = None) -> Ctx | None:
    """Child context to hand to a downstream hop: the given span
    becomes the remote parent.  Mints a trace id when the caller has
    none yet.  None when propagation is disabled."""
    if not enabled():
        return None
    return Ctx(trace or new_trace(), ref(sp))


def inject(headers: dict, ctx: Ctx | None) -> dict:
    """Write the context into a headers dict (mutates + returns it).
    A no-op passthrough when ctx is None."""
    if ctx is not None:
        if ctx.trace:
            headers[HDR_TRACE] = ctx.trace
        if ctx.parent:
            headers[HDR_PARENT] = ctx.parent
    return headers


def extract(headers) -> Ctx | None:
    """Read a context from request headers (any mapping with ``.get``,
    including ``http.server`` message objects).  Counts one
    ``trace.adopt`` per foreign context adopted; returns None when
    propagation is disabled or no trace header is present."""
    if not enabled():
        return None
    trace = headers.get(HDR_TRACE)
    if not trace:
        return None
    ctx = Ctx(trace, headers.get(HDR_PARENT) or None)
    registry.count("trace.adopt")
    return ctx


def fields(ctx: Ctx | None) -> dict:
    """Span fields carrying the context — splat into the entry-point
    span: ``spans.start("serve.request", **propagate.fields(ctx))``."""
    if ctx is None:
        return {}
    out = {}
    if ctx.trace:
        out["trace"] = ctx.trace
    if ctx.parent:
        out["remote_parent"] = ctx.parent
    return out


def note(key: str, ctx: Ctx | None) -> None:
    """Stash the latest context under ``key`` for an in-process
    consumer on another thread (the ingest → trainer causal chain).
    Latest-wins by design: a training round is caused by the most
    recent feed that filled its buffer."""
    if ctx is None:
        return
    with _slots_lock:
        _slots[key] = ctx


def peek(key: str) -> Ctx | None:
    """Read (without consuming) the latest context noted under ``key``."""
    with _slots_lock:
        return _slots.get(key)


def _reset_for_tests() -> None:
    with _slots_lock:
        _slots.clear()
