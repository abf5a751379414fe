"""``WorkerSupervisor``: fork/exec serve workers, admit them ready (the
port of ``hpnn_tpu/fleet/worker.py``).

A worker is an **unmodified** driver process of the port —
``python -m hpnn_tpu_torch.cli.serve_nn`` (plain serving) or
``...cli.online_nn`` (train-while-serve) — so everything those drivers
do (deferred warmup, WAL restore, SIGTERM drain, ``/readyz`` gating,
telemetry push) is inherited, not re-implemented.  The supervisor owns
the process lifecycle around them:

* **port allocation** — each worker binds an ephemeral port itself
  (``--port 0``) and the supervisor reads it from the worker's
  ``listening on HOST:PORT`` log line: a port picked here and bound
  there could be taken in between by any socket of the host (under
  load, by a client connection's source port);
* **importable workers** — the child's ``PYTHONPATH`` starts with the
  root of this checkout, so a worker started in its own directory finds
  ``hpnn_tpu_torch`` whether or not the package is installed;
* **no compile cache** — a CUDA graph cannot be written to disk, so
  every worker captures its bucket menus at boot (no warm boots), and
  ``HPNN_COMPILE_CACHE_DIR`` in the caller's environment, in ``env`` or
  as ``cache_dir`` is refused when the supervisor is built, with the
  port's refusal message (``runtime.DEFERRED_ENV``), rather than
  spawning workers that would each exit before ready;
* **the device** — a worker runs on ``cuda``, as every port entry point
  does, unless its ``args`` say otherwise (``("--device", "cpu")``);
* **readiness-gated admission** — a spawned worker joins the fleet
  only once ``/readyz`` answers 200; a worker that dies warming up is
  reported with its log tail;
* **telemetry fan-in** — ``HPNN_COLLECTOR`` / ``HPNN_ALERTS`` (and
  ``{rank}``-expanded ``HPNN_METRICS`` / ``HPNN_FLIGHT`` sink
  templates) are injected into every worker env, so one
  ``obs_report.py --merge`` timeline and one collector ``/metrics``
  page cover the whole fleet out of the box;
* **drain on scale-down** — SIGTERM first (the drivers' exactly-once
  drain path, serve/server.py ``install_drain``), SIGKILL escalation
  when the process hangs past the drain timeout.

Membership edges emit ``fleet.worker_up`` (with the spawn→ready
latency: on the card a worker's captures are in it) and
``fleet.worker_down`` (reason ``scale_down`` | ``crash`` | ``close`` |
caller-supplied); ``tools/check_obs_catalog.py --cluster`` lints the
pairing.  stdlib-only; never writes stdout.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import threading
import time

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.fleet.client import WorkerHandle

_KIND_MODULES = {
    "serve": "hpnn_tpu_torch.cli.serve_nn",
    "online": "hpnn_tpu_torch.cli.online_nn",
}

# the line serve_nn and online_nn write to stderr once their socket is bound
_LISTENING = re.compile(rb"listening on (\S+):(\d+)")

# the checkout whose hpnn_tpu_torch the workers import
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# env knobs the supervisor injects per worker; {rank} in the sink
# templates expands to the fleet rank (the cross-process twin of the
# registry's jax-process-index expansion, which is always 0 here)
_SINK_TEMPLATES = ("HPNN_METRICS", "HPNN_FLIGHT")


class WorkerProc:
    """One supervised worker: the OS process plus its fleet handle."""

    def __init__(self, rank: int, port: int, proc: subprocess.Popen,
                 handle: WorkerHandle, *, kind: str, log_path: str,
                 spawned_at: float):
        self.rank = rank
        self.port = port
        self.proc = proc
        self.handle = handle
        self.kind = kind
        self.log_path = log_path
        self.spawned_at = spawned_at

    @property
    def pid(self) -> int:
        return self.proc.pid

    def bound_port(self, offset: int = 0) -> int | None:
        """The port of the first ``listening on`` line the worker wrote
        to its log past ``offset``, or None before it has."""
        try:
            with open(self.log_path, "rb") as fp:
                fp.seek(offset)
                m = _LISTENING.search(fp.read())
        except OSError:
            return None
        return int(m.group(2)) if m else None

    def log_tail(self, n_bytes: int = 2048) -> str:
        try:
            with open(self.log_path, "rb") as fp:
                fp.seek(0, os.SEEK_END)
                fp.seek(max(0, fp.tell() - n_bytes))
                return fp.read().decode("utf-8", "replace")
        except OSError:
            return ""


class WorkerSupervisor:
    """Spawn / drain / reap a fleet of worker processes (module doc).

    ``conf_path`` is the ``.conf`` every worker serves; ``args`` are
    extra driver CLI flags (e.g. ``("--max-batch", "64")``); ``env``
    overlays the inherited environment; ``wal_dir`` arms
    ``HPNN_WAL_DIR`` (online workers sharing one promotion WAL is the
    fleet-wide hot-reload substrate, see router.py).  ``cache_dir`` (or
    ``HPNN_COMPILE_CACHE_DIR``) raises ``NotImplementedError``: the port
    has no compile cache (module doc)."""

    def __init__(self, conf_path: str, *, workdir: str,
                 kind: str = "serve", host: str = "127.0.0.1",
                 args: tuple = (), env: dict | None = None,
                 cache_dir: str | None = None, wal_dir: str | None = None,
                 collector: str | None = None, alerts: str | None = None,
                 ready_timeout_s: float = 120.0,
                 drain_timeout_s: float = 10.0, clock=time.monotonic):
        if kind not in _KIND_MODULES:
            raise ValueError(f"unknown worker kind {kind!r}")
        merged = dict(os.environ, **(env or {}))
        if cache_dir is not None:
            merged["HPNN_COMPILE_CACHE_DIR"] = cache_dir
        refusal = runtime.deferred_env_message("fleet.WorkerSupervisor", merged)
        if refusal:
            raise NotImplementedError(refusal)
        self.conf_path = os.path.abspath(conf_path)
        self.workdir = os.path.abspath(workdir)
        self.kind = kind
        self.host = host
        self.args = tuple(args)
        self.ready_timeout_s = float(ready_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._env = dict(env or {})
        self._wal_dir = wal_dir
        self._collector = collector
        self._alerts = alerts
        self._clock = clock
        os.makedirs(self.workdir, exist_ok=True)
        # spawns may run on several threads at once (an autoscaler's and
        # the caller's): ranks and membership change under this lock
        self._lock = threading.Lock()
        self.workers: dict[int, WorkerProc] = {}
        self._next_rank = 0

    # ------------------------------------------------------------- env
    def _worker_env(self, rank: int) -> dict:
        env = dict(os.environ)
        env.update(self._env)
        env["PYTHONUNBUFFERED"] = "1"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        if self._wal_dir is not None:
            env["HPNN_WAL_DIR"] = self._wal_dir
        if self._collector is not None:
            env["HPNN_COLLECTOR"] = self._collector
        if self._alerts is not None:
            env["HPNN_ALERTS"] = self._alerts
        for knob in _SINK_TEMPLATES:
            tpl = env.get(knob, "")
            if "{rank}" in tpl:
                env[knob] = tpl.replace("{rank}", str(rank))
        return env

    # ----------------------------------------------------------- spawn
    def spawn(self) -> WorkerProc:
        """Fork/exec one worker and admit it once ``/readyz`` answers
        200.  Emits ``fleet.worker_up`` with the spawn→ready latency;
        raises ``RuntimeError`` (with the worker's log tail) when the
        process dies or never becomes ready.  Safe to call from several
        threads at once."""
        with self._lock:
            rank = self._next_rank
            self._next_rank += 1
        module = _KIND_MODULES[self.kind]
        argv = [sys.executable, "-m", module, "--port", "0",
                "--host", self.host, *self.args, self.conf_path]
        log_path = os.path.join(self.workdir, f"worker-r{rank}.log")
        t0 = self._clock()
        with open(log_path, "ab") as log:
            offset = log.tell()
            proc = subprocess.Popen(
                argv, cwd=self.workdir, env=self._worker_env(rank),
                stdin=subprocess.DEVNULL, stdout=log, stderr=log)
        wp = WorkerProc(rank, None, proc, None, kind=self.kind,
                        log_path=log_path, spawned_at=t0)
        deadline = t0 + self.ready_timeout_s
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker r{rank} exited rc={proc.returncode} before "
                    f"ready; log tail:\n{wp.log_tail()}")
            if wp.handle is None:
                port = wp.bound_port(offset)
                if port is not None:
                    wp.port = port
                    wp.handle = WorkerHandle(rank, self.host, port, clock=self._clock)
            elif wp.handle.ready():
                break
            if self._clock() >= deadline:
                proc.kill()
                proc.wait()
                raise RuntimeError(
                    f"worker r{rank} not ready after "
                    f"{self.ready_timeout_s:.0f}s; log tail:\n"
                    f"{wp.log_tail()}")
            time.sleep(0.05)
        spawn_s = self._clock() - t0
        with self._lock:
            self.workers[rank] = wp
        obs.event("fleet.worker_up", rank=rank, port=wp.port, pid=wp.pid,
                  kind=self.kind, spawn_s=round(spawn_s, 3))
        self._emit_width()
        return wp

    # ----------------------------------------------------------- drain
    def drain_and_kill(self, rank: int, *, reason: str = "scale_down",
                       timeout_s: float | None = None) -> int | None:
        """SIGTERM the worker (its driver drains: unready → close →
        flush → exit 0), escalate to SIGKILL past the drain timeout.
        Emits ``fleet.worker_down``; returns the exit code."""
        with self._lock:
            wp = self.workers.pop(rank, None)
        if wp is None:
            return None
        timeout_s = self.drain_timeout_s if timeout_s is None else timeout_s
        escalated = False
        rc = wp.proc.poll()
        if rc is None:
            try:
                wp.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                rc = wp.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                escalated = True
                wp.proc.kill()
                rc = wp.proc.wait()
        wp.handle.close()
        obs.event("fleet.worker_down", rank=rank, pid=wp.pid,
                  reason=reason, returncode=rc, escalated=escalated,
                  alive_s=round(self._clock() - wp.spawned_at, 3))
        self._emit_width()
        return rc

    def kill9(self, rank: int) -> None:
        """SIGKILL without ceremony (chaos drills); the crash is
        observed and reported by :meth:`reap`, like any other death."""
        wp = self.workers.get(rank)
        if wp is not None:
            try:
                wp.proc.kill()
            except OSError:
                pass

    def reap(self) -> list[int]:
        """Notice workers that died underneath us; emit
        ``fleet.worker_down`` (reason ``crash``) and drop them.
        Returns the reaped ranks."""
        dead = []
        for rank, wp in list(self.workers.items()):
            rc = wp.proc.poll()
            if rc is None:
                continue
            with self._lock:
                if self.workers.pop(rank, None) is None:
                    continue
            wp.handle.close()
            obs.event("fleet.worker_down", rank=rank, pid=wp.pid,
                      reason="crash", returncode=rc, escalated=False,
                      alive_s=round(self._clock() - wp.spawned_at, 3))
            dead.append(rank)
        if dead:
            self._emit_width()
        return dead

    def replace_dead(self) -> list[WorkerProc]:
        """Reap + respawn one worker per death (the supervisor restart
        policy the worker drill proves)."""
        return [self.spawn() for _ in self.reap()]

    # ---------------------------------------------------------- census
    def width(self) -> int:
        return len(self.workers)

    def ranks(self) -> list[int]:
        with self._lock:
            return sorted(self.workers)

    def handles(self) -> list[WorkerHandle]:
        with self._lock:
            return [self.workers[r].handle for r in sorted(self.workers)]

    def _emit_width(self) -> None:
        n = len(self.workers)
        if n:
            obs.gauge("fleet.width", float(n))

    def close(self) -> None:
        for rank in list(self.workers):
            self.drain_and_kill(rank, reason="close")
