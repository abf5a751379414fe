"""``WorkerHandle``: one serve worker process, seen from the fleet (the
port of ``hpnn_tpu/fleet/client.py``).

The handle speaks the serve HTTP wire protocol of the port's
``serve_nn`` / ``online_nn`` processes (``serve/server.py``) and
translates wire answers back into the *in-process* serve exception
types so :class:`~hpnn_tpu_torch.fleet.router.ClusterRouter` keeps the
in-process router's route-around semantics:

=====================  =============================================
wire answer            raised as
=====================  =============================================
429 + ``Retry-After``  :class:`~hpnn_tpu_torch.serve.batcher.Shed`
                       (``reason`` from the body, ``queue_full`` when
                       the body is a plain QueueFull rejection)
503 unready            ``Shed(reason="unready")`` — cool + route on
504 + ``Retry-After``  :class:`~hpnn_tpu_torch.serve.batcher.DeadlineExceeded`
404 unknown kernel     ``KeyError`` (the ``Session.infer`` contract)
400 malformed          ``ValueError`` / ``RegistryError`` (reload)
connect/read failure   :class:`WorkerGone` — the cross-process
                       analogue of a closed replica
=====================  =============================================

Outstanding work is accounted **client-side** (row-weighted
``begin_request``/``end_request``, the ``Replica`` shape): a remote
process cannot be polled per placement decision, so the router places
on what it has in flight.  One fresh connection per request — handles
are called from many router threads at once and loopback connection
setup is far below one dispatch.  stdlib + numpy only; never writes
stdout.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.serve.batcher import DeadlineExceeded, Shed
from hpnn_tpu_torch.serve.registry import RegistryError

# socket slack on top of the request's own timeout_s: the worker
# enforces the deadline itself (504 + Retry-After); the socket timeout
# only catches a hung process
_IO_SLACK_S = 3.0


class WorkerGone(RuntimeError):
    """The worker did not answer at the transport level (connection
    refused/reset, read timeout, torn response) — route around it and
    let the supervisor's reaper decide whether it crashed."""

    retriable = True


class WorkerHandle:
    """HTTP client for one worker at ``host:port`` (see module doc)."""

    def __init__(self, rank: int, host: str, port: int, *,
                 clock=time.monotonic):
        self.rank = int(rank)
        self.host = host
        self.port = int(port)
        self._clock = clock
        self._closed = False
        self._outstanding = 0
        self._lock = threading.Lock()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"WorkerHandle(rank={self.rank}, url={self.url!r})"

    # ------------------------------------------------------- outstanding
    def begin_request(self, rows: int) -> int:
        with self._lock:
            self._outstanding += rows
            return self._outstanding

    def end_request(self, rows: int) -> int:
        with self._lock:
            self._outstanding = max(0, self._outstanding - rows)
            return self._outstanding

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    # ------------------------------------------------------------- wire
    def _request(self, method: str, path: str, body: dict | None = None,
                 *, timeout_s: float = 5.0, headers: dict | None = None):
        """One HTTP round trip → ``(status, headers, doc)``; ``doc`` is
        the parsed JSON body (None when empty/unparseable, the raw text
        for non-JSON answers like ``/metrics``).  Transport failure of
        any kind raises :class:`WorkerGone`."""
        if self._closed:
            raise WorkerGone(f"worker r{self.rank} handle closed")
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=timeout_s + _IO_SLACK_S)
        try:
            payload = None
            hdrs = dict(headers or {})
            if body is not None:
                payload = json.dumps(body).encode()
                hdrs.setdefault("Content-Type", "application/json")
            conn.request(method, path, body=payload, headers=hdrs)
            resp = conn.getresponse()
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            if "json" in ctype:
                try:
                    doc = json.loads(raw) if raw else None
                except ValueError:
                    doc = None
            else:
                doc = raw.decode("utf-8", "replace") if raw else None
            return resp.status, resp.headers, doc
        except (OSError, http.client.HTTPException) as exc:
            raise WorkerGone(
                f"worker r{self.rank} ({self.url}) unreachable: "
                f"{type(exc).__name__}: {exc}") from exc
        finally:
            conn.close()

    @staticmethod
    def _retry_after(headers, default: float = 1.0) -> float:
        try:
            return float(headers.get("Retry-After", ""))
        except (TypeError, ValueError):
            return default

    # ---------------------------------------------------------- serving
    def infer(self, name: str, x, *, timeout_s: float = 5.0,
              req_id: str | None = None, trace=None) -> np.ndarray:
        """``Session.infer`` over the wire: 1-D in → 1-D out, 2-D in →
        2-D out, wire rejections re-raised as the serve exception types
        (module docstring table)."""
        arr = np.asarray(x)
        hdrs: dict = {}
        if req_id is not None:
            hdrs["X-Request-Id"] = req_id
        obs.propagate.inject(hdrs, trace)
        body = {"kernel": name, "inputs": arr.tolist(),
                "timeout_s": timeout_s}
        if req_id is not None:
            body["req_id"] = req_id
        status, rhdrs, doc = self._request(
            "POST", "/v1/infer", body, timeout_s=timeout_s, headers=hdrs)
        if status == 200:
            return np.asarray(doc["outputs"])
        msg = (doc or {}).get("error", "") if isinstance(doc, dict) else ""
        if status == 404:
            raise KeyError(name)
        if status == 400:
            raise ValueError(msg or "malformed infer request")
        if status == 429:
            reason = doc.get("reason") if isinstance(doc, dict) else None
            raise Shed(msg or "worker shed",
                       reason=reason or "queue_full",
                       retry_after_s=self._retry_after(rhdrs))
        if status == 503:
            reason = doc.get("reason") if isinstance(doc, dict) else None
            raise Shed(msg or "worker not ready",
                       reason=reason or "unready",
                       retry_after_s=self._retry_after(rhdrs))
        if status == 504:
            raise DeadlineExceeded(msg or "deadline exceeded")
        raise WorkerGone(
            f"worker r{self.rank} answered {status}: {msg or doc!r}")

    def ingest(self, kernel: str | None, inputs, targets, *,
               timeout_s: float = 5.0) -> dict:
        """``POST /v1/ingest`` — feed the worker's online-learning
        stream; 404 (a plain ``serve_nn`` worker) raises ``KeyError``
        so the router can report ingest unsupported."""
        body = {"inputs": np.asarray(inputs).tolist(),
                "targets": np.asarray(targets).tolist()}
        if kernel is not None:
            body["kernel"] = kernel
        status, rhdrs, doc = self._request(
            "POST", "/v1/ingest", body, timeout_s=timeout_s)
        if status == 200:
            return doc or {}
        msg = (doc or {}).get("error", "") if isinstance(doc, dict) else ""
        if status == 404:
            raise KeyError(msg or "online ingest not enabled")
        if status == 429:
            reason = doc.get("reason") if isinstance(doc, dict) else None
            raise Shed(msg or "ingest shed", reason=reason or "queue_full",
                       retry_after_s=self._retry_after(rhdrs))
        if status == 503:
            raise Shed(msg or "worker not ready", reason="unready",
                       retry_after_s=self._retry_after(rhdrs))
        raise WorkerGone(
            f"worker r{self.rank} ingest answered {status}: {msg}")

    def reload(self, name: str, *, timeout_s: float = 30.0) -> int:
        """``POST /v1/reload`` — re-read the kernel's backing
        checkpoint; returns the new version."""
        status, _rhdrs, doc = self._request(
            "POST", "/v1/reload", {"kernel": name}, timeout_s=timeout_s)
        if status == 200:
            return int(doc["version"])
        msg = (doc or {}).get("error", "") if isinstance(doc, dict) else ""
        if status == 404:
            raise KeyError(name)
        if status == 400:
            raise RegistryError(msg or "reload rejected")
        raise RuntimeError(
            f"worker r{self.rank} reload answered {status}: {msg}")

    # ------------------------------------------------------------ census
    def ready(self, *, timeout_s: float = 2.0) -> bool:
        """``GET /readyz`` is 200 — transport failure is simply not
        ready (the poll loops in worker.py call this pre-admission)."""
        try:
            status, _h, _d = self._request(
                "GET", "/readyz", timeout_s=timeout_s)
        except WorkerGone:
            return False
        return status == 200

    def ready_doc(self, *, timeout_s: float = 2.0) -> dict:
        try:
            status, _h, doc = self._request(
                "GET", "/readyz", timeout_s=timeout_s)
        except WorkerGone as exc:
            return {"ready": False, "reason": str(exc)}
        if isinstance(doc, dict):
            return doc
        return {"ready": status == 200, "reason": None}

    def health(self, *, timeout_s: float = 5.0) -> dict | None:
        """``GET /healthz`` parsed, or None when unreachable."""
        try:
            status, _h, doc = self._request(
                "GET", "/healthz", timeout_s=timeout_s)
        except WorkerGone:
            return None
        return doc if status == 200 and isinstance(doc, dict) else None

    def metrics(self, *, timeout_s: float = 5.0) -> str | None:
        """``GET /metrics`` Prometheus text, or None when unreachable."""
        try:
            status, _h, doc = self._request(
                "GET", "/metrics", timeout_s=timeout_s)
        except WorkerGone:
            return None
        return doc if status == 200 and isinstance(doc, str) else None

    def close(self) -> None:
        self._closed = True
