"""Background candidate training over the streaming buffer (the port of
``hpnn_tpu/online/trainer.py``).

Each round: snapshot a fixed-size training window from the
:class:`~hpnn_tpu_torch.online.ingest.SampleBuffer`, run banked epochs
on *candidate* weights starting from the resident version, then hand
every candidate to the promotion gate
(:class:`~hpnn_tpu_torch.online.promote.Promoter`).  Serving never
blocks: training runs on its own thread against copies, and promotion
is the registry's atomic entry swap.

The epoch engine is ``train/fleet.py``'s: a group of one kernel runs
:func:`~hpnn_tpu_torch.train.fleet.make_member_epoch_fn`, one launch of
kernel #4 (``train_epoch_grid_banked``) an epoch; two or more
same-topology kernels train **fleet-wise**, one launch of kernel #6
(``train_fleet_epoch_dbuf_banked``) an epoch for the whole group, each
member on its own RNG stream over the shared window.  With
``HPNN_ONLINE_SCAN_K`` = K > 1 a group runs K rounds at once through
``make_fleet_multi_round_fn`` on one window snapshot, and the round
counter advances by K, so the seeds (``seed + 7919*round + i``) match K
plain rounds.  On the CPU the same functions run the kernels' plain
versions.

Rules on the card (docs of ``serve/engine.py``):

* **One stream.**  A round's launches, copies and allocations run on
  the trainer's own CUDA stream (:attr:`OnlineTrainer.stream`), and the
  round waits on that stream only (reading its results back), never on
  the whole device, so graph replays on the serving threads' streams do
  not queue behind an epoch.
* **One capturing thread.**  Once :meth:`start` runs, the trainer
  thread is the session's only capturing thread: a promotion, the
  watch's rollback, a manual rollback (:meth:`call`, queued to the
  thread and awaited) and a registration after boot all install there.
* **Nothing first on a side thread.**  :meth:`warm` builds and loads
  the kernels, runs one round of each topology group on the trainer
  stream and the eval forward once, on the calling thread, before the
  trainer thread exists.
* **No fallback.**  A failed build, launch or capture raises; a round
  that raises is counted (``online.round_failed``).

Knobs (read once, at construction; args override):
``HPNN_ONLINE_ROWS`` (window, default 64), ``HPNN_ONLINE_BATCH``
(default 8, must divide rows), ``HPNN_ONLINE_EPOCHS`` (default 4),
``HPNN_ONLINE_INTERVAL_S`` (background cadence, default 1.0),
``HPNN_ONLINE_SCAN_K`` (default 1).

Observability as in the JAX package: ``online.round`` events,
``online.train_round`` spans, ``online.train_loss`` /
``online.staleness_s`` gauges, ``online.round_failed`` counts and, every
round, ``online.eval_resident``.  Catalog: docs/online.md.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import numpy as np
import torch

from hpnn_tpu_torch import chaos, obs, runtime
from hpnn_tpu_torch.online.ingest import _env_float, _env_int
from hpnn_tpu_torch.train import fleet


class OnlineTrainer:
    """Snapshot → train → gate, once per ``interval_s`` on a daemon
    thread (``start()``) or by hand (``round_once()``, the test
    path).  ``candidate_hook(name, weights) -> weights`` is a
    test/chaos seam applied to each candidate between training and
    the gate (e.g. NaN injection for the rejection drill).

    Training runs on the serve engine's device in
    ``runtime.compute_dtype`` (``HPNN_DTYPE``), read when the trainer is
    built; candidates come back as host arrays in the resident's own
    dtype."""

    def __init__(self, buffer, session, promoter, *,
                 rows: int | None = None, batch: int | None = None,
                 epochs: int | None = None,
                 interval_s: float | None = None,
                 scan_k: int | None = None,
                 momentum: bool = False, replay_frac: float = 0.25,
                 seed: int = 0, clock=time.monotonic):
        self.buffer = buffer
        self.session = session      # serve.Session
        self.promoter = promoter
        self.rows = int(rows if rows is not None
                        else _env_int("HPNN_ONLINE_ROWS", 64))
        self.batch = int(batch if batch is not None
                         else _env_int("HPNN_ONLINE_BATCH", 8))
        self.epochs = int(epochs if epochs is not None
                          else _env_int("HPNN_ONLINE_EPOCHS", 4))
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env_float("HPNN_ONLINE_INTERVAL_S", 1.0))
        self.scan_k = int(scan_k if scan_k is not None
                          else _env_int("HPNN_ONLINE_SCAN_K", 1))
        if self.rows % self.batch:
            raise ValueError(
                f"batch {self.batch} must divide rows {self.rows}")
        if self.scan_k < 1:
            raise ValueError(f"scan_k must be >= 1, got {self.scan_k}")
        self.momentum = bool(momentum)
        self.replay_frac = float(replay_frac)
        self.eval_set = None        # overrides the buffer's holdout
        self.candidate_hook = None
        self.device = promoter.device
        self.dtype = runtime.compute_dtype(self.device)
        # the trainer's own stream (None on the CPU)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._seed = int(seed)
        self._clock = clock
        self._names: list[str] = []
        self._fns: dict = {}        # (kind, n_steps, model, members)
        self._round = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._jobs: list = []       # guarded: _lock
        self._accepting = False     # guarded: _lock
        self._thread: threading.Thread | None = None
        self.stats = {"rounds": 0, "starved": 0, "trained": 0,
                      "failed": 0}

    # ----------------------------------------------------------- kernels
    def track(self, name: str) -> None:
        """Manage ``name`` (must already be resident in the serve
        registry): train candidates for it and gate promotions."""
        self.session.registry.get(name)     # KeyError when unknown
        with self._lock:
            if name not in self._names:
                self._names.append(name)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._names)

    # ---------------------------------------------------------- epoch fns
    def _fn(self, kind: str, n_steps: int, model: str, members: int):
        """One epoch function per (kind, model, member count), built
        once and reused every round."""
        key = (kind, n_steps, model, self.momentum, members)
        fn = self._fns.get(key)
        if fn is None:
            maker = {"fleet": fleet.make_fleet_epoch_fn,
                     "multi": fleet.make_fleet_multi_round_fn,
                     "member": fleet.make_member_epoch_fn}[kind]
            fn = maker(n_steps, model=model, momentum=self.momentum,
                       count=False)
            self._fns[key] = fn
        return fn

    def _zeros_dw(self, weights):
        if not self.momentum:
            return ()
        return tuple(torch.zeros_like(w) for w in weights)

    def _on_stream(self):
        """The trainer stream's context (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------------------- round
    def _train_group(self, entries, X, T):
        """Train one same-topology group on the window tensors ``X``,
        ``T``; returns ``{name: (weights, final_loss)}`` — fleet-stacked
        (#6) when the group has 2+ members, the single-member bank run
        (#4) otherwise."""
        n_steps = self.rows // self.batch
        model = entries[0].model
        host = np.asarray(entries[0].kernel.weights[0]).dtype
        n = len(entries)

        def cast(ws):
            return tuple(np.asarray(w).astype(host) for w in ws)

        seeds = [self._seed + 7919 * self._round + i for i in range(n)]
        if self.scan_k > 1 or n >= 2:
            stacked = fleet.stack_kernels([e.kernel for e in entries],
                                          device=self.device,
                                          dtype=self.dtype)
            if self.scan_k > 1:
                # K rounds per call: round r draws the seeds an
                # unscanned round self._round+r would (on this round's
                # window snapshot)
                seed_rounds = [
                    [self._seed + 7919 * (self._round + r) + i
                     for i in range(n)] for r in range(self.scan_k)]
                perms, orders = fleet.multi_round_plan(
                    seed_rounds, n_rows=self.rows, batch=self.batch,
                    epochs=self.epochs)
                fn = self._fn("multi", n_steps, model, n)
                with obs.spans.span("train.multi_round", members=n,
                                    k=self.scan_k, mode="online"):
                    w2, _dw, losses, _ = fn(stacked,
                                            self._zeros_dw(stacked),
                                            X, T, perms, orders)
                last = losses[:, -1, -1]        # (N, steps)
            else:
                perms, orders = fleet.fleet_plan(
                    seeds, n_rows=self.rows, batch=self.batch,
                    epochs=self.epochs)
                fn = self._fn("fleet", n_steps, model, n)
                w2, _dw, losses, _ = fn(stacked, self._zeros_dw(stacked),
                                        X, T, perms, orders)
                last = losses[:, -1]            # (N, steps)
            members = fleet.unstack_kernels(w2)
            last = last.cpu().numpy().astype(np.float64)
            return {
                e.name: (cast(members[i].weights), float(last[i].mean()))
                for i, e in enumerate(entries)
            }
        entry = entries[0]
        w = tuple(torch.tensor(np.asarray(wl), device=self.device,
                               dtype=self.dtype)
                  for wl in entry.kernel.weights)
        perms, orders = fleet.member_plan(
            seeds[0], n_rows=self.rows, batch=self.batch,
            epochs=self.epochs)
        fn = self._fn("member", n_steps, model, 1)
        w2, _dw, losses, _ = fn(w, self._zeros_dw(w), X, T, perms, orders)
        cand = cast(wl.cpu().numpy() for wl in w2)
        last = losses[-1].cpu().numpy().astype(np.float64)
        return {entry.name: (cand, float(last.mean()))}

    def _window(self, X, T):
        """The window as tensors on the trainer's device and dtype."""
        return (torch.as_tensor(X, device=self.device, dtype=self.dtype),
                torch.as_tensor(T, device=self.device, dtype=self.dtype))

    def _groups(self, names) -> dict:
        """Tracked entries by topology: 2+ members -> one stacked fleet
        call, singletons -> the member bank run."""
        groups: dict = {}
        for name in names:
            entry = self.session.registry.get(name)
            topo = (entry.model,
                    tuple(tuple(int(d) for d in np.shape(w))
                          for w in entry.kernel.weights))
            groups.setdefault(topo, []).append(entry)
        return groups

    def _eval_resident(self, names) -> None:
        """Score the *currently-serving* weights on the held-out set
        and record ``online.eval_resident`` — every round, starved
        rounds included (the drift plane's decay sentinel input)."""
        eval_set = (self.eval_set if self.eval_set is not None
                    else self.buffer.eval_snapshot())
        if eval_set is None or len(eval_set[0]) < 1:
            return
        from hpnn_tpu_torch.online import promote

        for name in names:
            try:
                entry = self.session.registry.get(name)
                loss = promote.eval_loss(entry.kernel.weights,
                                         eval_set[0], eval_set[1],
                                         model=entry.model,
                                         device=self.device)
            # hpnnlint: ignore[swallow] -- counted; one bad eval must
            except Exception as exc:  # not kill the trainer round
                obs.count("online.eval_resident_failed", kernel=name,
                          error=type(exc).__name__)
                continue
            obs.gauge("online.eval_resident", round(float(loss), 9),
                      kernel=name)
            if obs.drift.enabled():
                obs.drift.note_eval(name, loss)

    def warm(self) -> None:
        """On the calling thread: build and load the kernels, run one
        round of each topology group on a zero window on the trainer
        stream (its candidates are dropped; no state moves), and run
        the eval forward once.  :meth:`start` calls it before the
        trainer thread exists."""
        names = self.names()
        groups = self._groups(names)
        with self._on_stream():
            for entries in groups.values():
                e = entries[0]
                X, T = self._window(np.zeros((self.rows, e.n_inputs)),
                                    np.zeros((self.rows, e.n_outputs)))
                self._train_group(entries, X, T)
        from hpnn_tpu_torch.online import promote

        for entries in groups.values():
            e = entries[0]
            promote.eval_loss(e.kernel.weights, np.zeros((1, e.n_inputs)),
                              np.zeros((1, e.n_outputs)), model=e.model,
                              device=self.device)

    def round_once(self) -> dict:
        """One trainer round; returns its summary (also emitted as the
        ``online.round`` event)."""
        with self._on_stream():
            return self._round_once()

    def _round_once(self) -> dict:
        names = self.names()
        staleness = self.buffer.staleness_s()
        if staleness is not None:
            obs.gauge("online.staleness_s", round(staleness, 6))
        obs.gauge("online.buffer_depth", self.buffer.depth())
        self._eval_resident(names)
        summary = {"round": self._round, "trained": 0, "promoted": 0,
                   "rejected": 0, "rolled_back": 0,
                   "outcomes": {}}
        if not names or self.buffer.depth() < self.rows:
            self.stats["starved"] += 1
            summary["starved"] = True
            summary["rolled_back"] = len(self.promoter.check_watch())
            return summary
        t0 = self._clock()
        X, T, meta = self.buffer.snapshot(self.rows,
                                          replay_frac=self.replay_frac)
        groups = self._groups(names)
        candidates: dict = {}
        # the ingest → trainer → promote causal chain (obs/propagate.py)
        ictx = obs.propagate.peek("ingest")
        with obs.spans.span("online.train_round", round=self._round,
                            members=len(names), rows=self.rows,
                            replay=meta["replay"],
                            **obs.propagate.fields(ictx)) as rspan:
            Xd, Td = self._window(X, T)
            for entries in groups.values():
                candidates.update(self._train_group(entries, Xd, Td))
        rctx = obs.propagate.ctx_from(
            rspan, trace=getattr(ictx, "trace", None))
        train_s = self._clock() - t0
        eval_set = (self.eval_set if self.eval_set is not None
                    else self.buffer.eval_snapshot())
        for name, (cand, loss) in candidates.items():
            obs.gauge("online.train_loss", loss, kernel=name)
            # seam: nan@train.round corrupts the candidate (the gate
            # must reject it); raise/kill/delay also land here
            corrupted = chaos.inject("train.round", arrays=cand)
            if corrupted is not None:
                cand = corrupted
            if self.candidate_hook is not None:
                hooked = self.candidate_hook(name, cand)
                if hooked is not None:
                    cand = hooked
            outcome = self.promoter.consider(name, cand, eval_set,
                                             step=self._round,
                                             trace=rctx)
            summary["outcomes"][name] = outcome
            if outcome == "promoted":
                summary["promoted"] += 1
            else:
                summary["rejected"] += 1
        summary["trained"] = len(candidates)
        summary["rolled_back"] = len(self.promoter.check_watch())
        obs.event("online.round", round=self._round, rows=self.rows,
                  members=len(names), groups=len(groups),
                  replay=meta["replay"], promoted=summary["promoted"],
                  rejected=summary["rejected"],
                  rolled_back=summary["rolled_back"],
                  train_s=round(train_s, 6))
        self.stats["rounds"] += 1
        self.stats["trained"] += len(candidates)
        # scan_k rounds were consumed in one call: advance the counter
        # by K so the next round's seeds don't replay streams
        self._round += self.scan_k
        return summary

    # ------------------------------------------------------- thread loop
    def call(self, fn):
        """``fn()`` on the trainer thread while it runs (queued, woken
        and awaited; its exception re-raised here), else on the calling
        thread; on the trainer stream either way.  The session routes
        every install through here, so after :meth:`start` one thread
        captures."""
        if threading.current_thread() is not self._thread:
            job = {"fn": fn, "done": threading.Event()}
            with self._lock:
                queued = self._accepting
                if queued:
                    self._jobs.append(job)
            if queued:
                self._wake.set()
                job["done"].wait()
                if "error" in job:
                    raise job["error"]
                return job["result"]
        with self._on_stream():
            return fn()

    def _run_jobs(self) -> None:
        with self._lock:
            jobs, self._jobs = self._jobs, []
        for job in jobs:
            try:
                with self._on_stream():
                    job["result"] = job["fn"]()
            except BaseException as exc:  # hpnnlint: ignore[swallow] -- call() re-raises it
                job["error"] = exc
            job["done"].set()

    def start(self) -> None:
        """Run rounds every ``interval_s`` on a daemon thread (no-op
        when already running).  The caller warms first (:meth:`warm`);
        the serve engine's captures are pinned to the new thread."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="hpnn-online-trainer")
            self._accepting = True
        self.session.engine.pin_captures(self._thread)
        self._thread.start()

    def _loop(self) -> None:
        next_at = time.monotonic() + self.interval_s
        while True:
            self._wake.wait(max(0.0, next_at - time.monotonic()))
            self._wake.clear()
            if self._stop.is_set():
                break
            self._run_jobs()
            if time.monotonic() < next_at:
                continue
            try:
                self.round_once()
            except Exception as exc:   # the loop must survive a round
                self.stats["failed"] += 1
                obs.count("online.round_failed",
                          error=type(exc).__name__)
                sys.stderr.write(f"online: round failed: {exc}\n")
            next_at = time.monotonic() + self.interval_s
        # stop taking jobs, then run any already queued (their callers
        # are waiting) before the thread ends
        with self._lock:
            self._accepting = False
        self._run_jobs()

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def close(self, *, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if not t.is_alive():
                self.session.engine.pin_captures(None)
        self._thread = None
