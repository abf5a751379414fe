"""The train-while-serve facade: one resident process that serves,
ingests, trains, and promotes (the port of ``hpnn_tpu/online/session.py``).

:class:`OnlineSession` wires a :class:`~hpnn_tpu_torch.serve.server.Session`
(owned or adopted) to the streaming buffer, the background trainer,
and the promotion gate, and registers itself on the serve session so
the HTTP front end grows two behaviors with zero new plumbing:

* ``POST /ingest`` — the server's ingest route calls
  ``session.ingest_hook`` (set here) to feed the buffer;
* ``GET /healthz`` — the health document gains an ``online`` section
  (buffer depth/staleness, rounds, promotions/rollbacks, per-kernel
  versions + watch state) via ``session.online_health``.

Typical use (``cli/online_nn.py`` does exactly this)::

    osess = OnlineSession(eval_set=None, interval_s=0.5)
    osess.add_kernel("mnist", kernel)
    server = serve.make_server(osess.serve, port=8700)
    osess.start()                       # background trainer
    ...
    osess.feed(x, t)                    # or POST /ingest
    osess.infer("mnist", x)

Tests drive the loop deterministically: ``start=False`` (default) and
``tick()`` per round.  Knobs: docs/online.md.

On the card (``serve/engine.py`` names the rules): :meth:`start` warms
the trainer on the calling thread (kernels built and loaded, one round
of each topology group on the trainer's stream, the eval forward once)
and then starts the trainer thread, which from then on is the only
thread that captures: :meth:`rollback`, :meth:`add_kernel` and
:meth:`reload` (``POST /v1/reload``) called from any other thread are
queued to it and awaited.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.online import wal as wal_mod
from hpnn_tpu_torch.online.ingest import SampleBuffer
from hpnn_tpu_torch.online.promote import Gate, Promoter
from hpnn_tpu_torch.online.trainer import OnlineTrainer


class OnlineSession:
    """Serve + ingest + train + promote behind one object.

    ``session=None`` builds an owned ``serve.Session`` from
    ``serve_kwargs`` (closed by :meth:`close`); pass an existing
    session to adopt it (the caller keeps ownership).  All tracked
    kernels learn from ONE shared stream — the ensemble-on-a-stream
    shape; same-topology kernels train as one fleet dispatch.

    Training and the gate's eval run on the serve engine's device in
    ``runtime.compute_dtype`` (``HPNN_DTYPE``)."""

    def __init__(self, *, session=None, serve_kwargs: dict | None = None,
                 eval_set=None, gate: Gate | None = None,
                 capacity: int | None = None,
                 reservoir: int | None = None,
                 holdout: int | None = None,
                 rows: int | None = None, batch: int | None = None,
                 epochs: int | None = None,
                 interval_s: float | None = None,
                 momentum: bool = False, replay_frac: float = 0.25,
                 seed: int = 0, clock=time.monotonic,
                 start: bool = False, wal=None):
        from hpnn_tpu_torch import serve

        self._own_serve = session is None
        self.serve = session or serve.Session(**(serve_kwargs or {}))
        self.buffer = SampleBuffer(capacity=capacity,
                                   reservoir=reservoir,
                                   holdout=holdout, clock=clock,
                                   seed=seed)
        # promotion durability (online/wal.py): explicit wal= wins,
        # else the HPNN_WAL_DIR knob, else None (no disk, no cost)
        self.wal = wal if wal is not None else wal_mod.from_env()
        self.restored: dict[str, int] = {}  # name -> WAL version
        self.promoter = Promoter(self.serve, gate=gate, clock=clock,
                                 wal=self.wal)
        self.trainer = OnlineTrainer(
            self.buffer, self.serve, self.promoter, rows=rows,
            batch=batch, epochs=epochs, interval_s=interval_s,
            momentum=momentum, replay_frac=replay_frac, seed=seed,
            clock=clock)
        if eval_set is not None:
            X, T = eval_set
            self.trainer.eval_set = (
                np.asarray(X, dtype=np.float64),
                np.asarray(T, dtype=np.float64))
        # grow the HTTP front end: POST /ingest + /healthz "online"
        self.serve.ingest_hook = self._ingest
        self.serve.online_health = self.health_doc
        # POST /v1/reload: the re-read version is captured on the
        # trainer thread once it runs
        self.serve.reload_hook = self.reload
        if start:
            self.start()

    # ----------------------------------------------------------- kernels
    def add_kernel(self, name: str, kernel, *, model: str = "ann",
                   warmup: bool = True):
        """See :meth:`_add_kernel`; once the trainer thread runs, the
        registration (and its captures) runs there."""
        return self.trainer.call(
            lambda: self._add_kernel(name, kernel, model=model,
                                     warmup=warmup))

    def _add_kernel(self, name: str, kernel, *, model: str = "ann",
                    warmup: bool = True):
        """Register ``kernel`` in the serve registry AND track it for
        online training/promotion.

        With a promotion WAL attached, the WAL is replayed first: when
        it holds a committed version of ``name``, *those* weights (the
        last promoted before the previous process died) are installed
        instead of the caller's — bitwise, from the checkpoint — and
        the entry carries the checkpoint's path + ``(st_mtime_ns,
        st_size)`` signature so the registry's hot-reload staleness
        machinery treats it like any file-backed kernel."""
        restored = (self.wal.restore(name)
                    if self.wal is not None else None)
        if restored is not None:
            ws, rec = restored
            ckpt = os.path.join(self.wal.dir, rec["ckpt"])
            st = os.stat(ckpt)
            # the serve-level call (not raw registry+engine) so a
            # multi-replica Router fans the restore to every replica
            entry = self.serve.register_kernel(
                name, kernel_mod.Kernel(weights=ws),
                model=rec.get("model", model), warmup=warmup,
                path=ckpt, mtime=st.st_mtime,
                sig=(st.st_mtime_ns, st.st_size))
            self.restored[name] = int(rec.get("version", 0))
            obs.event("online.restore", kernel=name,
                      wal_version=int(rec.get("version", 0)),
                      version=entry.version, ckpt=rec["ckpt"])
        else:
            entry = self.serve.register_kernel(name, kernel,
                                               model=model,
                                               warmup=warmup)
        self.trainer.track(name)
        return entry

    def kernels(self) -> list[str]:
        return self.trainer.names()

    # ------------------------------------------------------------ stream
    def feed(self, x, t) -> int:
        """Push sample(s) into the training stream."""
        return self.buffer.feed(x, t)

    def _ingest(self, kernel: str | None, X, T) -> dict:
        """The serve server's ``POST /ingest`` hook.  ``kernel`` is
        advisory (the stream is shared): when given it must name a
        tracked kernel."""
        if kernel is not None and kernel not in self.trainer.names():
            raise KeyError(kernel)
        accepted = self.buffer.feed(X, T)
        return {"accepted": accepted, "depth": self.buffer.depth()}

    # ------------------------------------------------------------- serve
    def infer(self, name: str, x, **kwargs):
        return self.serve.infer(name, x, **kwargs)

    # ------------------------------------------------------------- train
    def tick(self) -> dict:
        """One synchronous trainer round (the deterministic test
        path); returns the round summary."""
        return self.trainer.round_once()

    def start(self) -> None:
        """Warm the trainer on this thread, then start its thread (a
        no-op when it runs already)."""
        if not self.trainer.running():
            self.trainer.warm()
        self.trainer.start()

    def reload(self, name: str):
        """Re-read ``name``'s backing file as a new version (the
        ``POST /v1/reload`` of a fleet's install fan-out), on the
        trainer thread while it runs."""
        return self.trainer.call(lambda: self.serve.reload(name))

    def rollback(self, name: str, *, reason: str = "manual"):
        """Re-install ``name``'s pre-promotion weights (see
        ``Promoter.rollback``), on the trainer thread while it runs."""
        return self.trainer.call(
            lambda: self.promoter.rollback(name, reason=reason))

    # ------------------------------------------------------------ health
    def health_doc(self) -> dict:
        staleness = self.buffer.staleness_s()
        kernels = {}
        for name in self.trainer.names():
            entry = self.serve.registry.get(name)
            doc = {"version": entry.version,
                   "watch": self.promoter.watching(name)}
            # bitwise identity of the resident weights — the handle
            # the chaos drills use to prove restart == resume
            sha = hashlib.sha256()
            for w in entry.kernel.weights:
                sha.update(np.ascontiguousarray(np.asarray(w))
                           .tobytes())
            doc["weights_sha"] = sha.hexdigest()[:16]
            losses = self.promoter.last_losses.get(name)
            if losses is not None:
                doc["candidate_loss"], doc["resident_loss"] = losses
            kernels[name] = doc
        out = {
            "buffer": {
                "depth": self.buffer.depth(),
                "capacity": self.buffer.capacity,
                "holdout": self.buffer.holdout_depth(),
                "fed": self.buffer.total_fed(),
                "dropped": self.buffer.dropped_total(),
                "staleness_s": (None if staleness is None
                                else round(staleness, 6)),
            },
            "trainer": dict(self.trainer.stats,
                            running=self.trainer.running(),
                            rows=self.trainer.rows,
                            interval_s=self.trainer.interval_s),
            "promoter": dict(self.promoter.stats),
            "kernels": kernels,
        }
        if self.wal is not None:
            out["wal"] = dict(self.wal.doc(),
                              restored=dict(self.restored))
        return out

    # ------------------------------------------------------------- close
    def close(self) -> None:
        self.trainer.close()
        if self._own_serve:
            self.serve.close()
