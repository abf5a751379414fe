"""Dynamic micro-batching queue for the resident serving layer: a copy
of ``hpnn_tpu/serve/batcher.py``.

Concurrent callers each bring a few rows of inference work; the device
wants one big dispatch.  The batcher sits between them: requests park
in a bounded FIFO, a drain loop coalesces everything that arrived
within ``max_wait_ms`` (or as soon as ``max_batch`` rows are pending)
into one batch, hands it to a ``dispatch`` callable, and fans the
per-request results back out through per-request events.

Semantics, in order of precedence:

* **Backpressure** — the queue holds at most ``max_depth`` requests;
  a submit beyond that raises :class:`QueueFull` immediately
  (retriable — the caller should back off and resubmit, the HTTP
  front end maps it to 429).
* **SLO-driven shedding** — when the oldest queued request has aged
  past ``shed_age_ms`` (``HPNN_SHED_AGE_MS``), or the rolling-window
  p99 of served requests (obs/slo.py, requires ``HPNN_SLO_MS``) is
  past ``shed_p99_ms`` (``HPNN_SHED_P99_MS``), a submit is rejected
  up front with :class:`Shed` (a :class:`QueueFull` subclass, so the
  HTTP 429 + ``Retry-After`` mapping already applies) — saturation
  then degrades goodput gracefully instead of queueing work that is
  doomed to blow its deadline.  Either threshold at 0 disables it.
* **Deadlines** — every request carries an absolute deadline
  (``timeout_s`` from submit time).  The drain loop drops expired
  requests *before* dispatch and completes them with
  :class:`DeadlineExceeded`; a request can also time out while
  waiting on its event.
* **Coalescing** — the drain loop takes the oldest request, then
  greedily appends queued requests while the summed row count stays
  ≤ ``max_batch``.  A batch closes early when the oldest request has
  waited ``max_wait_ms``.

Everything here is stdlib-only and clock-injectable: tests drive a
stopped batcher with a fake ``clock`` and the public
:meth:`Batcher.drain_once`, so coalescing/deadline/backpressure are
asserted without sleeping.  obs instrumentation (queue-depth gauge,
batch-size / wait-time histograms) rides the existing ``HPNN_METRICS``
knob and never touches stdout.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Sequence

from hpnn_tpu_torch import chaos, obs


class QueueFull(RuntimeError):
    """Queue at max_depth — retriable, resubmit after backoff."""

    retriable = True


class Shed(QueueFull):
    """Request rejected by SLO-driven admission control before enqueue
    — retriable after ``retry_after_s`` (the HTTP layer turns it into
    the 429 ``Retry-After`` header).  ``reason`` says which threshold
    tripped (``queue_age`` | ``slo_p99`` here; the edge and tenant
    layers reuse the class with ``rate_cap`` / ``quota`` /
    ``no_worker`` / ``unready``)."""

    def __init__(self, msg: str, *, reason: str,
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(TimeoutError):
    """Request expired before (or while) being served — retriable."""

    retriable = True


class _Request:
    __slots__ = ("payload", "rows", "deadline", "submitted",
                 "event", "result", "error", "span", "qspan", "req_id")

    def __init__(self, payload, rows, deadline, submitted, span=None,
                 req_id=None):
        self.payload = payload
        self.rows = rows              # device cost: how many batch rows
        self.deadline = deadline      # absolute, in clock() units
        self.submitted = submitted
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.span = span              # caller's root span (HPNN_SPANS)
        self.qspan = None             # queue-wait span, closed on pop
        self.req_id = req_id          # edge-minted id (tracing)

    def finish(self, result=None, error: BaseException | None = None):
        self.result = result
        self.error = error
        self.event.set()


class Batcher:
    """Coalesce concurrent requests into bounded micro-batches.

    ``dispatch(payloads) -> results`` receives the payload list of one
    batch and must return one result per payload (same order).  It
    runs on the drain thread; an exception fails every request in the
    batch (the error propagates to each waiter).

    ``clock`` must be a monotonic float-seconds callable; tests inject
    a fake.  With ``start=False`` no thread runs — call
    :meth:`drain_once` manually.

    ``shed_age_ms`` / ``shed_p99_ms`` arm SLO-driven admission control
    (0 disables each; defaults read ``HPNN_SHED_AGE_MS`` /
    ``HPNN_SHED_P99_MS`` once at construction).  The p99 threshold
    compares against the rolling-window p99 published by obs/slo.py,
    so it only bites when ``HPNN_SLO_MS`` is tracking outcomes.
    """

    def __init__(
        self,
        dispatch: Callable[[list[Any]], Sequence[Any]],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_depth: int = 256,
        shed_age_ms: float | None = None,
        shed_p99_ms: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        name: str = "default",
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if shed_age_ms is None:
            shed_age_ms = float(os.environ.get("HPNN_SHED_AGE_MS", 0)
                                or 0)
        if shed_p99_ms is None:
            shed_p99_ms = float(os.environ.get("HPNN_SHED_P99_MS", 0)
                                or 0)
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_depth = int(max_depth)
        self.shed_age_ms = float(shed_age_ms)
        self.shed_p99_ms = float(shed_p99_ms)
        self._clock = clock
        self.name = name
        self._lock = obs.lockwatch.lock("serve.batcher")
        self._cond = threading.Condition(self._lock)
        self._queue: deque[_Request] = deque()  # guarded: _lock
        self._shed: dict[str, int] = {}   # guarded: _lock (per reason)
        self._expired = 0                 # guarded: _lock
        self._closed = False              # guarded: _lock
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._drain_loop, name=f"hpnn-batcher-{name}",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ submit
    def _shed_reason(self, now: float) -> str | None:
        """Admission-control check (caller holds the lock): the shed
        reason when a threshold has tripped, else None."""
        if (self.shed_age_ms > 0 and self._queue
                and (now - self._queue[0].submitted) * 1e3
                >= self.shed_age_ms):
            return "queue_age"
        if self.shed_p99_ms > 0:
            p99 = obs.slo.current_p99_ms()
            if p99 is not None and p99 >= self.shed_p99_ms:
                return "slo_p99"
        return None

    def submit(self, payload, *, rows: int = 1,
               timeout_s: float = 5.0, span=None,
               req_id=None) -> _Request:
        """Enqueue one request; returns its ticket (wait via
        :meth:`result`).  Raises :class:`QueueFull` when the queue is
        at ``max_depth`` and :class:`Shed` when admission control
        trips.  ``span`` (HPNN_SPANS) is the caller's root span: the
        queue-wait child opens here and closes when the drain loop
        pops (or expires) the request, so queue time is attributable
        separately from dispatch time.  ``req_id`` (edge-minted) rides
        the queue span so ``obs_report --spans --req`` can reconstruct
        one request's breakdown."""
        if rows < 1:
            raise ValueError("rows must be >= 1")
        chaos.inject("batcher.submit")  # seam: admission (pre-lock)
        now = self._clock()
        req = _Request(payload, int(rows), now + float(timeout_s), now,
                       span=span, req_id=req_id)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"batcher {self.name!r} is closed")
            reason = self._shed_reason(now)
            if reason is not None:
                self._shed[reason] = self._shed.get(reason, 0) + 1
                fields = {"batcher": self.name, "reason": reason}
                if req_id is not None:
                    fields["req_id"] = req_id
                obs.count("serve.shed", **fields)
                raise Shed(
                    f"batcher {self.name!r} shedding load "
                    f"({reason}); retry later", reason=reason)
            if len(self._queue) >= self.max_depth:
                self._shed["queue_full"] = (
                    self._shed.get("queue_full", 0) + 1)
                obs.count("serve.rejected", batcher=self.name,
                          reason="queue_full")
                raise QueueFull(
                    f"batcher {self.name!r} queue at max_depth="
                    f"{self.max_depth}; retry later")
            if obs.spans.enabled() or isinstance(span, obs.spans.Span):
                # inside the lock, before the append: the drain thread
                # cannot pop the request until we release, and
                # spans.start neither locks nor emits.  A real parent
                # without the global knob is a tail-sampled request
                # (obs/forensics.py) — its tree still grows
                qfields = {"batcher": self.name}
                if req_id is not None:
                    qfields["req_id"] = req_id
                req.qspan = obs.spans.start("serve.queue", parent=span,
                                            **qfields)
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify()
        obs.gauge("serve.queue_depth", depth, batcher=self.name)
        return req

    def result(self, req: _Request, *, timeout_s: float | None = None):
        """Block until ``req`` completes; returns its result or raises
        its error.  ``timeout_s`` bounds the wall-clock wait (real
        time, independent of the injected clock)."""
        if not req.event.wait(timeout_s):
            raise DeadlineExceeded(
                f"request not served within {timeout_s}s")
        if req.error is not None:
            raise req.error
        return req.result

    def infer(self, payload, *, rows: int = 1, timeout_s: float = 5.0,
              span=None, req_id=None):
        """submit + result in one call (the common embedding path)."""
        req = self.submit(payload, rows=rows, timeout_s=timeout_s,
                          span=span, req_id=req_id)
        # small slack past the request deadline: the drain loop is the
        # authority on expiry; this wait is just a liveness backstop
        return self.result(req, timeout_s=float(timeout_s) + 1.0)

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def oldest_age(self) -> float | None:
        """Age (clock seconds) of the oldest queued request, or None
        when the queue is empty — the /healthz staleness signal."""
        with self._lock:
            if not self._queue:
                return None
            submitted = self._queue[0].submitted
        return max(0.0, self._clock() - submitted)

    def shed_counts(self) -> dict[str, int]:
        """Cumulative rejected-submit counts per reason
        (``queue_age`` / ``slo_p99`` / ``queue_full``) — the /healthz
        shed section."""
        with self._lock:
            return dict(self._shed)

    def expired_total(self) -> int:
        """Cumulative requests dropped in-queue by deadline expiry."""
        with self._lock:
            return self._expired

    # ------------------------------------------------------------ drain
    def _take_batch(self, block: bool) -> list[_Request] | None:
        """Pop one coalesced batch (or None).  Expired requests are
        completed with DeadlineExceeded and never dispatched."""
        with self._cond:
            if block:
                while not self._queue and not self._closed:
                    self._cond.wait(timeout=self.max_wait)
            if not self._queue:
                return None
            now = self._clock()
            # the batch closes early once the oldest waiter has aged
            # max_wait; otherwise wait for more arrivals (blocking
            # mode only — drain_once never sleeps)
            if block:
                oldest = self._queue[0]
                pending = sum(r.rows for r in self._queue)
                while (pending < self.max_batch and not self._closed
                       and now - oldest.submitted < self.max_wait):
                    remaining = self.max_wait - (now - oldest.submitted)
                    self._cond.wait(timeout=max(remaining, 1e-4))
                    now = self._clock()
                    pending = sum(r.rows for r in self._queue)
            batch: list[_Request] = []
            expired: list[_Request] = []
            rows = 0
            while self._queue:
                req = self._queue[0]
                if req.deadline <= now:
                    expired.append(self._queue.popleft())
                    continue
                if batch and rows + req.rows > self.max_batch:
                    break
                batch.append(self._queue.popleft())
                rows += req.rows
            depth = len(self._queue)
            self._expired += len(expired)
        for req in expired:
            obs.count("serve.deadline_exceeded", batcher=self.name)
            obs.spans.finish(req.qspan, failed="DeadlineExceeded")
            req.finish(error=DeadlineExceeded(
                "request expired in queue before dispatch"))
        if expired:
            obs.gauge("serve.queue_depth", depth, batcher=self.name)
        for req in batch:
            obs.spans.finish(req.qspan)
        return batch or None

    def drain_once(self, *, block: bool = False) -> int:
        """Coalesce and dispatch one batch; returns the number of
        requests served (0 when the queue was empty/all-expired).
        Public so fake-clock tests can step the batcher
        deterministically without a drain thread."""
        batch = self._take_batch(block)
        if not batch:
            return 0
        now = self._clock()
        waits = [now - r.submitted for r in batch]
        obs.observe("serve.wait_ms", [w * 1e3 for w in waits],
                    batcher=self.name)
        if obs.meter.enabled():
            # attribute queue-wait to the owning tenant: fleet-mode
            # payloads carry their kernel name (serve/server.py), a
            # per-kernel batcher is named for its kernel
            for r, w in zip(batch, waits):
                p = r.payload
                owner = (p[0] if isinstance(p, tuple) and p
                         and isinstance(p[0], str) else self.name)
                obs.meter.note_queue(owner, w)
        obs.observe("serve.batch_size", [sum(r.rows for r in batch)],
                    batcher=self.name, requests=len(batch))
        # the dispatch span parents to the oldest request's root span —
        # a coalesced batch has one device dispatch but many roots, and
        # the oldest waiter is the one whose latency budget it spends
        dspan = obs.spans.start("serve.dispatch", parent=batch[0].span,
                                batcher=self.name,
                                rows=sum(r.rows for r in batch),
                                requests=len(batch))
        try:
            chaos.inject("batcher.drain")  # seam: fails just this batch
            results = self._dispatch([r.payload for r in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"dispatch returned {len(results)} results for "
                    f"{len(batch)} requests")
        except BaseException as exc:  # fail the whole batch
            obs.spans.finish(dspan, failed=type(exc).__name__)
            obs.count("serve.batch_failed", batcher=self.name,
                      requests=len(batch))
            for req in batch:
                req.finish(error=exc)
            return len(batch)
        obs.spans.finish(dspan)
        for req, res in zip(batch, results):
            req.finish(result=res)
        obs.gauge("serve.queue_depth", self.depth(), batcher=self.name)
        return len(batch)

    def _drain_loop(self):
        while True:
            with self._lock:
                if self._closed and not self._queue:
                    return
            try:
                self.drain_once(block=True)
            except Exception:
                # the loop must survive anything; per-request errors
                # were already delivered in drain_once
                obs.count("serve.drain_error", batcher=self.name)

    # ------------------------------------------------------------ close
    def close(self, *, timeout_s: float = 5.0):
        """Stop accepting work; drain what's queued, then join."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        # complete anything still parked (e.g. no drain thread)
        while True:
            with self._cond:
                if not self._queue:
                    break
                req = self._queue.popleft()
            req.finish(error=RuntimeError(
                f"batcher {self.name!r} closed"))
