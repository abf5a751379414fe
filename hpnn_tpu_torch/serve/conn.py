"""Connection-plane telemetry and guards for the HTTP front ends: a
copy of ``hpnn_tpu/serve/conn.py``, the same knobs and record schema.

Every observability layer above this one — spans, SLOs, alerts,
capsules — begins *inside* the HTTP handler.  The socket beneath it is
where hostile networks actually act: a slow-loris client trickling
header bytes pins a handler thread forever, a torn upload leaves a
blocking ``rfile.read`` mid-body, and none of it produces an event, a
gauge, or a shed.  This module extends the telemetry one layer down to
the accepted connection and adds the guards that turn those hangs into
bounded, *counted* closes:

* **lifecycle accounting** — every accepted connection gets an id and
  a table entry; ``conn.open`` on accept, ``conn.close`` on teardown
  with bytes in/out, requests served, duration, and a close ``reason``
  from a frozen enum (``eof | timeout | reset | torn_body | fuzz |
  drain | guard``);
* **read deadlines** — ``HPNN_CONN_HDR_MS`` bounds the wait for
  request-line/header bytes (and keep-alive idle), ``HPNN_CONN_BODY_MS``
  bounds body reads (:func:`read_body`), both via plain socket
  timeouts, so a stalled read raises instead of blocking forever;
* **per-IP concurrent-connection cap** — ``HPNN_CONN_PER_IP``; the
  N+1th connection from one address is closed at accept
  (``conn.close`` reason ``guard``) before it can hold a thread;
* **slow-client guard** — ``HPNN_CONN_MIN_BPS`` arms a watchdog that
  kills connections whose inbound byte rate over a rolling window
  falls below the floor *while the server is waiting on them* (header
  or body phase): the classic slow-loris trickle defeats per-recv
  timeouts by always arriving just in time, but cannot defeat a rate
  floor.  Kills count ``conn.guard_kill`` with reason ``slowloris``
  (mid-header) or ``stall`` (mid-body) and feed the cumulative
  ``conn.guard_kills`` gauge — an alertable signal (``HPNN_ALERTS``),
  so a hostile burst triggers a capture capsule carrying this module's
  census as ``conn.json`` (obs/triggers.py);
* **bounded table + census** — at most ``HPNN_CONN_TABLE`` (default
  1024) live entries carry per-connection detail; beyond the bound,
  connections stay fully *counted* (open/close/guards) but drop their
  table row.  The table feeds the ``conn.active`` / ``conn.oldest_s``
  gauges and the ``GET /connz`` census on the serve AND collector
  servers.

Wiring: :func:`wrap_server` (called by ``serve.make_server`` and
``obs.collector.start_collector``) hooks the ``socketserver`` request
path, so a Router's front end inherits the layer for free;
:class:`ConnHandlerMixin` rides the handler classes and
converts handler-thread ``socket.timeout`` / ``ConnectionResetError``
into counted closes instead of stderr stack traces.

Knob contract (docs/observability.md): unset ⇒ one env read ever,
then the wrap is skipped entirely and the mixin's per-call cost is one
attribute miss — zero behavior change, zero stdout bytes either way.
Schema frozen by ``tools/check_obs_catalog.py --conn``.
"""

from __future__ import annotations

import io
import itertools
import os
import socket
import sys
import threading
import time
import weakref

from hpnn_tpu_torch import obs

ENV_HDR_MS = "HPNN_CONN_HDR_MS"
ENV_BODY_MS = "HPNN_CONN_BODY_MS"
ENV_PER_IP = "HPNN_CONN_PER_IP"
ENV_MIN_BPS = "HPNN_CONN_MIN_BPS"
ENV_TABLE = "HPNN_CONN_TABLE"

#: the frozen close-reason enum (tools/check_obs_catalog.py --conn)
CLOSE_REASONS = ("eof", "timeout", "reset", "torn_body", "fuzz",
                 "drain", "guard")
#: the frozen guard-kill reason enum
GUARD_KILL_REASONS = ("slowloris", "stall")

#: default socket timeout on accepted connections — even with every
#: knob unset, a dead peer can hold a handler thread at most this long
DEFAULT_TIMEOUT_S = 60.0

#: slow-client guard cadence: the watchdog ticks at TICK_S and judges
#: a connection only after a full WINDOW_S of continuous header/body
#: waiting, so clean request parsing (milliseconds) is never sampled
GUARD_WINDOW_S = 1.0
GUARD_TICK_S = 0.2

#: suppress SIGPIPE per-send on instrumented sockets (Linux): the CLIs
#: re-arm SIG_DFL for the token-pipe contract, and a fatal signal on a
#: write to a guard-yanked or peer-reset socket would kill the server
#: instead of raising the BrokenPipeError the mixin counts as a close
_NOSIGNAL = getattr(socket, "MSG_NOSIGNAL", 0)

_cfg: dict | bool | None = None
_lock = threading.Lock()
_ids = itertools.count(1)
_tables: "weakref.WeakSet[_Table]" = weakref.WeakSet()
_kills = {"slowloris": 0, "stall": 0}  # process-cumulative, under _lock


def _knob(env: str, default, convert=float):
    """One secondary knob: a malformed value warns on stderr and falls
    back to its documented default, leaving the plane armed."""
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return convert(raw)
    except ValueError:
        sys.stderr.write(f"hpnn conn: bad {env} value {raw!r}; "
                         f"using default {default}\n")
        return default


def _config() -> dict | None:
    """Memoized ``HPNN_CONN_*`` read: armed iff any knob is set."""
    global _cfg
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                armed = any(os.environ.get(k) for k in
                            (ENV_HDR_MS, ENV_BODY_MS, ENV_PER_IP,
                             ENV_MIN_BPS, ENV_TABLE))
                if not armed:
                    _cfg = False
                else:
                    hdr_ms = _knob(ENV_HDR_MS, 0.0)
                    body_ms = _knob(ENV_BODY_MS, 0.0)
                    per_ip = int(_knob(ENV_PER_IP, 0, int))
                    _cfg = {
                        "hdr_s": hdr_ms / 1e3 if hdr_ms > 0 else None,
                        "body_s": (body_ms / 1e3
                                   if body_ms > 0 else None),
                        "per_ip": per_ip if per_ip > 0 else None,
                        "min_bps": max(0.0, _knob(ENV_MIN_BPS, 0.0))
                                   or None,
                        "table": max(1, int(_knob(ENV_TABLE,
                                                  1024, int))),
                    }
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when any ``HPNN_CONN_*`` knob is armed (memo hit after
    the first call — the whole unarmed cost)."""
    return _config() is not None


def _reset_for_tests() -> None:
    global _cfg
    with _lock:
        _cfg = None
        _kills["slowloris"] = 0
        _kills["stall"] = 0


def _kill_count(reason: str) -> int:
    with _lock:
        _kills[reason] = _kills.get(reason, 0) + 1
        return sum(_kills.values())


# ------------------------------------------------------------------ entry

class _Entry:
    """One accepted connection's accounting.  Mutated by its handler
    thread and read (plus reason-marked) by the watchdog/drain — all
    fields are monotonic counters or idempotent marks, so torn reads
    are harmless and no lock rides the byte path."""

    __slots__ = ("id", "ip", "port", "plane", "opened", "bytes_in",
                 "bytes_out", "requests", "phase", "reason",
                 "guard_reason", "closed", "tracked", "window_t",
                 "window_bytes", "raw")

    def __init__(self, ip: str, port: int, plane: str, raw):
        self.id = f"{os.getpid()}-c{next(_ids)}"
        self.ip = ip
        self.port = port
        self.plane = plane
        self.opened = time.monotonic()
        self.bytes_in = 0
        self.bytes_out = 0
        self.requests = 0
        # idle → header → resp (→ body → resp per POST) → idle; the
        # bps guard judges only header/body — the phases where the
        # server is blocked waiting on the CLIENT's bytes
        self.phase = "idle"
        self.reason: str | None = None
        self.guard_reason: str | None = None
        self.closed = False
        self.tracked = True
        self.window_t = self.opened
        self.window_bytes = 0
        self.raw = raw  # the real socket, for guard/drain shutdown

    def mark(self, reason: str) -> None:
        """First mark wins: e.g. a torn body read marks ``torn_body``
        and the later broken-pipe reply keeps it."""
        if self.reason is None:
            self.reason = reason

    def set_phase(self, phase: str) -> None:
        # a marked (dying) connection keeps the phase it died in, so
        # the close record says WHERE — the unwind path's resets
        # (read_body's resp, handle_one_request's idle) no longer
        # overwrite it
        if self.reason is not None:
            return
        self.phase = phase
        self.window_t = time.monotonic()
        self.window_bytes = self.bytes_in

    def note_in(self, n: int) -> None:
        self.bytes_in += n
        if n > 0 and self.phase == "idle":
            # first bytes of a (next) request: the header clock starts
            self.set_phase("header")

    def row(self) -> dict:
        return {"id": self.id, "ip": self.ip, "phase": self.phase,
                "age_s": round(time.monotonic() - self.opened, 3),
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "requests": self.requests}


# ------------------------------------------------------------ byte taps

class _RawIn(io.RawIOBase):
    """Raw read end over the accepted socket: counts bytes *as they
    arrive* (a BufferedReader issues one raw read per chunk, so even a
    trickled header line feeds the rate window) and converts the two
    stall exceptions into reason marks before re-raising."""

    def __init__(self, sock, entry: _Entry):
        super().__init__()
        self._sock = sock
        self._entry = entry

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        try:
            n = self._sock.recv_into(b)
        except (socket.timeout, TimeoutError):
            self._entry.mark("timeout")
            raise
        except ConnectionResetError:
            self._entry.mark("reset")
            raise
        self._entry.note_in(n)
        return n


class _RawOut(io.RawIOBase):
    def __init__(self, sock, entry: _Entry):
        super().__init__()
        self._sock = sock
        self._entry = entry

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        try:
            n = self._sock.send(b, _NOSIGNAL)
        except (BrokenPipeError, ConnectionResetError):
            self._entry.mark("reset")
            raise
        except (socket.timeout, TimeoutError):
            self._entry.mark("timeout")
            raise
        self._entry.bytes_out += n
        return n


class _SockProxy:
    """The accepted socket, instrumented.  Delegates everything to the
    real socket except ``makefile`` (rebound to the counting raw ends
    above) and the direct send paths (``_SocketWriter`` on unbuffered
    handlers calls ``sendall``)."""

    def __init__(self, sock, entry: _Entry):
        self._hpnn_sock = sock
        self._hpnn_conn = entry

    def __getattr__(self, name):
        return getattr(self._hpnn_sock, name)

    def makefile(self, mode="r", buffering=None, **kw):
        if "r" in mode:
            return io.BufferedReader(
                _RawIn(self._hpnn_sock, self._hpnn_conn))
        return io.BufferedWriter(
            _RawOut(self._hpnn_sock, self._hpnn_conn))

    def sendall(self, data, *flags):
        entry = self._hpnn_conn
        try:
            out = self._hpnn_sock.sendall(
                data, *(flags or (_NOSIGNAL,)))
        except (BrokenPipeError, ConnectionResetError):
            entry.mark("reset")
            raise
        except (socket.timeout, TimeoutError):
            entry.mark("timeout")
            raise
        entry.bytes_out += len(data)
        return out


# ------------------------------------------------------------ the table

class _Table:
    """Bounded live-connection table for one server (one per wrapped
    listener; the module aggregates across tables for the capsule
    census)."""

    def __init__(self, plane: str, cfg: dict):
        self.plane = plane
        self.cfg = cfg
        self._lock = threading.Lock()
        self._conns: dict[str, _Entry] = {}   # guarded: _lock
        self._per_ip: dict[str, int] = {}     # guarded: _lock
        self._active = 0                      # guarded: _lock
        self._untracked = 0                   # guarded: _lock
        self._opened = 0                      # guarded: _lock
        self._closes: dict[str, int] = {}     # guarded: _lock
        self._guard: dict[str, int] = {}      # guarded: _lock
        self._down = False                    # server_close happened

    # ------------------------------------------------------ lifecycle
    def admit(self, sock, client_address):
        """Register one accepted connection; returns the instrumented
        socket, or ``None`` when the per-IP cap refuses it (the caller
        closes the raw socket; the refusal is a fully counted
        open/close pair with reason ``guard``)."""
        ip = str(client_address[0]) if client_address else "?"
        port = int(client_address[1]) if len(client_address) > 1 else 0
        entry = _Entry(ip, port, self.plane, sock)
        cap = self.cfg["per_ip"]
        with self._lock:
            refused = cap is not None and self._per_ip.get(ip, 0) >= cap
            self._opened += 1
            if refused:
                self._closes["guard"] = self._closes.get("guard", 0) + 1
            else:
                self._per_ip[ip] = self._per_ip.get(ip, 0) + 1
                self._active += 1
                if len(self._conns) < self.cfg["table"]:
                    self._conns[entry.id] = entry
                else:
                    self._untracked += 1
                    entry.tracked = False
        obs.count("conn.open", id=entry.id, ip=ip, port=port,
                  plane=self.plane)
        if refused:
            obs.count("conn.close", id=entry.id, reason="guard",
                      detail="per_ip_cap", plane=self.plane,
                      bytes_in=0, bytes_out=0, requests=0,
                      duration_s=0.0, phase="admit")
            self._gauges()
            return None
        hdr_s = self.cfg["hdr_s"]
        if hdr_s is not None:
            try:
                sock.settimeout(hdr_s)
            except OSError:
                pass
        self._gauges()
        return _SockProxy(sock, entry)

    def finish(self, request) -> None:
        """Teardown accounting (idempotent): emit the ``conn.close``
        for this connection with its first-marked reason (``eof`` when
        nothing marked one) and any pending guard kill."""
        entry = getattr(request, "_hpnn_conn", None)
        if entry is None:
            return
        with self._lock:
            if entry.closed:
                return
            entry.closed = True
            reason = entry.reason or "eof"
            self._active -= 1
            left = self._per_ip.get(entry.ip, 1) - 1
            if left > 0:
                self._per_ip[entry.ip] = left
            else:
                self._per_ip.pop(entry.ip, None)
            self._conns.pop(entry.id, None)
            self._closes[reason] = self._closes.get(reason, 0) + 1
            if entry.guard_reason is not None:
                self._guard[entry.guard_reason] = \
                    self._guard.get(entry.guard_reason, 0) + 1
        if entry.guard_reason is not None:
            obs.count("conn.guard_kill", reason=entry.guard_reason,
                      id=entry.id, ip=entry.ip, plane=self.plane)
            obs.gauge("conn.guard_kills",
                      _kill_count(entry.guard_reason),
                      plane=self.plane)
        obs.count("conn.close", id=entry.id, reason=reason,
                  plane=self.plane, bytes_in=entry.bytes_in,
                  bytes_out=entry.bytes_out, requests=entry.requests,
                  duration_s=round(time.monotonic() - entry.opened, 4),
                  phase=entry.phase)
        self._gauges()

    def _gauges(self) -> None:
        with self._lock:
            active = self._active
            oldest = min((e.opened for e in self._conns.values()),
                         default=None)
        obs.gauge("conn.active", active, plane=self.plane)
        obs.gauge("conn.oldest_s",
                  round(time.monotonic() - oldest, 4)
                  if oldest is not None else 0.0, plane=self.plane)

    # ------------------------------------------------------ guards
    def _kill(self, entry: _Entry, guard_reason: str) -> None:
        """Slow-client offender: mark it and yank the socket — the
        blocked read in its handler thread returns/raises immediately,
        so the thread unwinds through :meth:`finish` (which emits the
        ``conn.guard_kill`` + ``conn.close`` pair) instead of hanging."""
        entry.guard_reason = guard_reason
        entry.mark("guard")
        try:
            entry.raw.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _watch(self) -> None:
        min_bps = self.cfg["min_bps"]
        while not self._down:
            time.sleep(GUARD_TICK_S)
            now = time.monotonic()
            with self._lock:
                entries = list(self._conns.values())
            for e in entries:
                # reason-marked connections are already unwinding (a
                # frozen phase no longer tracks the byte window) —
                # judging them again would double-kill
                if (e.closed or e.reason is not None
                        or e.phase not in ("header", "body")):
                    continue
                dt = now - e.window_t
                if dt < GUARD_WINDOW_S:
                    continue
                if (e.bytes_in - e.window_bytes) / dt < min_bps:
                    self._kill(e, "slowloris" if e.phase == "header"
                               else "stall")
                else:
                    e.window_t = now
                    e.window_bytes = e.bytes_in
            self._gauges()

    def start_watchdog(self) -> None:
        threading.Thread(target=self._watch, daemon=True,
                         name="hpnn-conn-watchdog").start()

    def drain(self) -> int:
        """Close every *idle* connection (keep-alive waiters, silent
        holds) with reason ``drain``; in-flight requests keep their
        sockets.  Returns the number closed."""
        with self._lock:
            idle = [e for e in self._conns.values()
                    if not e.closed and e.phase == "idle"]
        for e in idle:
            e.mark("drain")
            try:
                e.raw.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return len(idle)

    def close(self) -> None:
        """Server teardown: stop the watchdog and account any
        still-open connection as a ``drain`` close so a finished run's
        sink always pairs every open."""
        self._down = True
        with self._lock:
            leftovers = list(self._conns.values())
        for e in leftovers:
            e.mark("drain")
            try:
                e.raw.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            # finish() wants the proxy; at teardown we hold the entry
            self.finish(_Fin(e))

    # ------------------------------------------------------ census
    def doc(self) -> dict:
        with self._lock:
            conns = [e.row() for e in
                     list(self._conns.values())[:64]]
            oldest = min((e.opened for e in self._conns.values()),
                         default=None)
            doc = {
                "plane": self.plane,
                "active": self._active,
                "opened": self._opened,
                "closed": dict(self._closes),
                "guard_kill": dict(self._guard),
                "oldest_s": (round(time.monotonic() - oldest, 3)
                             if oldest is not None else 0.0),
                "per_ip": dict(sorted(
                    self._per_ip.items(),
                    key=lambda kv: kv[1], reverse=True)[:16]),
                "table": {"rows": len(self._conns),
                          "max": self.cfg["table"],
                          "untracked": self._untracked},
                "guards": {"hdr_ms": (self.cfg["hdr_s"] or 0) * 1e3,
                           "body_ms": (self.cfg["body_s"] or 0) * 1e3,
                           "per_ip": self.cfg["per_ip"],
                           "min_bps": self.cfg["min_bps"]},
                "conns": conns,
            }
        return doc


class _Fin:
    """Adapter so :meth:`_Table.close` can finish an entry it holds
    directly (no proxy in hand at teardown time)."""

    def __init__(self, entry: _Entry):
        self._hpnn_conn = entry


# ---------------------------------------------------------- server glue

def wrap_server(server, plane: str = "serve"):
    """Instrument one ``socketserver``-based HTTP server with the
    connection plane.  A no-op returning ``None`` when no
    ``HPNN_CONN_*`` knob is armed; otherwise hooks the accept path
    (admission + byte taps), the teardown path (close accounting), and
    ``server_close`` (drain accounting), and starts the slow-client
    watchdog when ``HPNN_CONN_MIN_BPS`` is set.  The table lands on
    ``server.conn_table`` for ``/connz``."""
    cfg = _config()
    if cfg is None:
        return None
    table = _Table(plane, cfg)
    server.conn_table = table
    _tables.add(table)
    orig_process = server.process_request
    orig_shutdown = server.shutdown_request
    orig_close = server.server_close

    def process_request(request, client_address):
        wrapped = table.admit(request, client_address)
        if wrapped is None:
            try:
                request.close()
            except OSError:
                pass
            return
        orig_process(wrapped, client_address)

    def shutdown_request(request):
        table.finish(request)
        orig_shutdown(request)

    def server_close():
        table.close()
        orig_close()

    server.process_request = process_request
    server.shutdown_request = shutdown_request
    server.server_close = server_close
    if cfg["min_bps"] is not None:
        table.start_watchdog()
    return table


def drain_server(server) -> int:
    """Close idle connections with reason ``drain`` (the SIGTERM path,
    ``serve.install_drain``).  0 when the plane is unarmed."""
    table = getattr(server, "conn_table", None)
    if table is None:
        return 0
    return table.drain()


def connz_doc(server) -> dict:
    """The ``GET /connz`` census for one server; ``{"mode": "off"}``
    when the plane is unarmed."""
    table = getattr(server, "conn_table", None)
    if table is None:
        return {"mode": "off"}
    return table.doc()


def read_body(handler, n: int) -> bytes:
    """Read an ``n``-byte request body under the body deadline
    (``HPNN_CONN_BODY_MS``) with torn-upload accounting: a short read
    (peer vanished mid-body) marks the connection ``torn_body``, a
    deadline marks it ``timeout`` — both become counted closes.  Drops
    back to a plain ``rfile.read`` when the plane is unarmed."""
    entry = getattr(handler.connection, "_hpnn_conn", None)
    if entry is None:
        return handler.rfile.read(n)
    cfg = _config()
    entry.set_phase("body")
    if cfg is not None and cfg["body_s"] is not None:
        try:
            handler.connection.settimeout(cfg["body_s"])
        except OSError:
            pass
    try:
        body = handler.rfile.read(n)
        if len(body) < n:
            # marked here (not after the finally) so the close
            # record's phase stays "body" — where the upload tore
            entry.mark("torn_body")
    except (socket.timeout, TimeoutError):
        entry.mark("timeout")
        raise
    finally:
        entry.set_phase("resp")
        try:
            handler.connection.settimeout(handler.timeout)
        except OSError:
            pass
    return body


class ConnHandlerMixin:
    """Handler-side half of the plane, shared by the serve and
    collector front ends.  Always safe to inherit: with the plane
    unarmed every hook is an attribute miss, but the exception
    conversion below still applies — a ``ConnectionResetError`` on a
    handler thread becomes a quiet counted close, never a stderr
    stack trace (the ``swallow``-rule remediation for the stdlib's
    silent ``handle_error`` traceback)."""

    #: default socket timeout on accepted connections (satellite of
    #: the connection plane): bounds how long a dead peer can pin a
    #: handler thread even with every HPNN_CONN_* knob unset
    timeout = DEFAULT_TIMEOUT_S

    def setup(self):
        cfg = _config()
        if (cfg is not None and cfg["hdr_s"] is not None
                and getattr(self.request, "_hpnn_conn", None)
                is not None):
            # instance attr beats the class default; StreamRequestHandler
            # applies self.timeout to the socket in its own setup()
            self.timeout = cfg["hdr_s"]
        super().setup()

    def handle_one_request(self):
        entry = getattr(self.connection, "_hpnn_conn", None)
        try:
            super().handle_one_request()
        except (socket.timeout, TimeoutError):
            if entry is not None:
                entry.mark("timeout")
            self.close_connection = True
        except (ConnectionResetError, BrokenPipeError,
                ConnectionAbortedError):
            if entry is not None:
                entry.mark("reset")
            self.close_connection = True
        else:
            if (entry is not None
                    and getattr(self, "raw_requestline", None)):
                if getattr(self, "command", None):
                    entry.requests += 1
                else:
                    # bytes arrived but no verb ever parsed — garbage
                    # (covers the silent parse_request False paths
                    # where send_error(400) is never reached, e.g. a
                    # junk payload whose first line is empty)
                    entry.mark("fuzz")
        finally:
            if entry is not None:
                entry.set_phase("idle")

    def finish(self):
        entry = getattr(self.connection, "_hpnn_conn", None)
        try:
            super().finish()
        except (BrokenPipeError, ConnectionResetError,
                socket.timeout, TimeoutError):
            # the final wfile flush hit a vanished peer: a counted
            # reset, not a handle_error traceback
            if entry is not None:
                entry.mark("reset")
            try:
                self.rfile.close()
            except OSError:
                pass

    def parse_request(self):
        ok = super().parse_request()
        entry = getattr(self.connection, "_hpnn_conn", None)
        if entry is not None and ok:
            # headers fully read: the server is working now, not
            # waiting on the client — leave the guarded phases
            entry.set_phase("resp")
        return ok

    def send_error(self, code, message=None, explain=None):
        if code == 400 and getattr(self, "command", None) is None:
            # the request line never parsed: fuzzed/garbage input
            entry = getattr(self.connection, "_hpnn_conn", None)
            if entry is not None:
                entry.mark("fuzz")
        super().send_error(code, message, explain)


# ------------------------------------------------------------- capsule

def sketch_doc() -> dict | None:
    """The process-wide connection census for a capture capsule's
    ``conn.json`` (obs/triggers.py) — every live table merged, plus
    the cumulative guard-kill counts.  ``None`` when the plane is
    unarmed (the capsule skips the artifact, same contract as
    drift/meter/blame)."""
    if _config() is None:
        return None
    with _lock:
        kills = dict(_kills)
        tables = list(_tables)
    return {
        "guard_kills": kills,
        "planes": [t.doc() for t in tables],
    }
