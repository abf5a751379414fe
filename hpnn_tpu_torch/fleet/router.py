"""``ClusterRouter``: the Session-ish front end over a worker fleet (the
port of ``hpnn_tpu/fleet/router.py``).

The cross-process twin of ``serve.Router``: the same least-outstanding
placement, the same shed-and-route-around cool-off, the same
fence-serialized mutation fan-out — but each backend is a
:class:`~hpnn_tpu_torch.fleet.client.WorkerHandle` over an unmodified
port ``serve_nn`` / ``online_nn`` process instead of an in-process
``Replica``.  Because the surface matches ``Session`` (``infer`` /
``reload`` / ``health`` / readiness / ``ingest_hook``), the port's
``serve.make_server`` binds it as the fleet edge.  That handler reads
more of a session than ``infer``: on a ``ClusterRouter`` edge
``/tenantz`` answers 404 (no ``tenant_doc``), ``X-Tenant`` is ignored
(no ``infer_for``), ``POST /v1/reload`` fans out (no ``reload_hook``),
and ``/meterz``, ``/tunez`` and ``POST /v1/capture`` answer from this
process's own planes (404 unless their knobs are armed here), as on a
JAX ``ClusterRouter`` edge.

**Promotion fence.**  The wire protocol has no install endpoint —
workers own their registries — so fleet-wide promotion goes through
the file system, the way the online WAL already does it inside one
host: a *publisher* rewrites the checkpoint every worker watches, then
``/v1/reload`` fans out under one fence lock, serialized against any
other mutation.  Each worker's own reload is atomic and captures the
new version before publishing it (on an online worker, on its trainer
thread), so every concurrent infer answers bitwise old-or-new weights
fleet-wide — never torn — the in-process router's guarantee, one
process boundary further out.
:class:`CheckpointPublisher` is the standard publisher for online
workers sharing one ``HPNN_WAL_DIR``.

Routing emits ``cluster.route`` / ``cluster.shed_around`` /
``cluster.outstanding`` / ``cluster.fence`` (the ``router.*`` twins,
docs/serving.md "Cross-host fleet") and records edge outcomes into the
SLO tracker (obs/slo.py) — the burn-rate signal the autoscaler rides.
stdlib + numpy only; never writes stdout.
"""

from __future__ import annotations

import os
import threading
import time
from collections import namedtuple

import numpy as np

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.fleet.client import WorkerGone, WorkerHandle
from hpnn_tpu_torch.serve.batcher import DeadlineExceeded, Shed
from hpnn_tpu_torch.serve.registry import RegistryError

ClusterEntry = namedtuple("ClusterEntry", ("name", "version"))
# seconds a ready answer from the workers holds at the edge
READY_TTL_S = 1.0


class CheckpointPublisher:
    """Publish a kernel by rewriting the checkpoint file(s) the
    workers watch, bumping the version monotonically.

    Two modes, exactly one armed:

    * ``paths={name: ckpt_path}`` — rewrite that one file in place
      (workers that ``load_kernel``-ed it reload the new weights).
    * ``wal_dir=...`` — the shared-``HPNN_WAL_DIR`` fleet: each
      publish is a real :class:`~hpnn_tpu_torch.online.wal.PromotionWAL`
      commit (new per-version checkpoint + fsync'd record), so a
      worker spawned *later* replays the latest install, not the
      seed; every older ``<name>.v*.ckpt`` is then rewritten in
      place so workers whose registry entries still point at an
      older version's path pick the new weights up on ``/v1/reload``
      too.  (A worker booting mid-publish can, in a narrow race,
      restore conf weights; the next fenced fan-out converges it.)
    """

    def __init__(self, paths: dict[str, str] | None = None, *,
                 versions: dict[str, int] | None = None,
                 wal_dir: str | None = None, keep: int = 64):
        if (paths is None) == (wal_dir is None):
            raise ValueError("pass exactly one of paths= or wal_dir=")
        self._paths = dict(paths) if paths is not None else None
        self._lock = obs.lockwatch.lock("fleet.publisher")
        self._versions = dict(versions or {})  # guarded: _lock
        if wal_dir is not None:
            from hpnn_tpu_torch.online import wal as wal_mod

            self._wal = wal_mod.PromotionWAL(wal_dir, keep=keep)
        else:
            self._wal = None

    def __call__(self, name: str, kernel) -> int:
        from hpnn_tpu_torch.fileio import checkpoint as ckpt_mod

        if self._wal is not None:
            wal = self._wal
            with self._lock:
                version = max(
                    (int(r.get("version", 0)) for r in wal.records()
                     if r.get("kernel") == name),
                    default=self._versions.get(name, 0)) + 1
                self._versions[name] = version
                prefix = f"{name}.v"
                older = [
                    os.path.join(wal.dir, fn)
                    for fn in os.listdir(wal.dir)
                    if fn.startswith(prefix) and fn.endswith(".ckpt")
                ]
                # commit first: the newest record is always intact, so
                # replay lands on it even while the older files below
                # are being invalidated
                wal.commit(name, kernel.weights, version=version,
                           reason="fleet_install")
                for path in older:
                    ckpt_mod.dump_checkpoint(
                        path, name, kernel.weights, version=version,
                        meta={"reason": "fleet_install"})
            return version
        path = self._paths.get(name)
        if path is None:
            raise RegistryError(f"no publish path for kernel {name!r}")
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
        ckpt_mod.dump_checkpoint(path, name, kernel.weights,
                                 version=version,
                                 meta={"reason": "fleet_install"})
        return version


class ClusterRouter:
    """Fan one serving surface over N worker processes (module doc).

    Backends come from ``supervisor.handles()`` (live membership: the
    autoscaler's spawns and drains are visible immediately) or from a
    static ``workers`` list (tests, fixed fleets).  ``publisher`` is
    the install path — ``publisher(name, kernel) -> version`` must
    rewrite the checkpoint every worker reloads from."""

    def __init__(self, workers: list[WorkerHandle] | None = None, *,
                 supervisor=None, publisher=None, clock=time.monotonic):
        if (workers is None) == (supervisor is None):
            raise ValueError(
                "pass exactly one of workers= or supervisor=")
        self._static = list(workers) if workers is not None else None
        self._sup = supervisor
        self._publisher = publisher
        self._clock = clock
        self._fence = obs.lockwatch.lock("fleet.router.fence")
        # rank -> monotonic instant its cool-off expires
        self._cool_lock = obs.lockwatch.lock("fleet.router.cool")
        self._cool: dict[int, float] = {}      # guarded: _cool_lock
        self._versions: dict[str, int] = {}    # guarded: _fence
        self._stat_lock = obs.lockwatch.lock("fleet.router.stat")
        self._routed = 0                       # guarded: _stat_lock
        self._shed = 0                         # guarded: _stat_lock
        self._ready = True                     # guarded: _stat_lock
        self._closed = False                   # guarded: _stat_lock
        self._ready_at = None                  # guarded: _stat_lock
        # the Session plug points make_server consumes
        self.ingest_hook = self._ingest
        self.online_health = None
        self.registry = None
        self.engine = None

    # ------------------------------------------------------------ fleet
    def _handles(self) -> list[WorkerHandle]:
        if self._sup is not None:
            return self._sup.handles()
        return [h for h in self._static if not h._closed]

    def workers(self) -> list[WorkerHandle]:
        """The live backend handles, rank order."""
        return self._handles()

    def _cooling(self, rank: int) -> bool:
        with self._cool_lock:
            until = self._cool.get(rank, 0.0)
        return self._clock() < until

    def _cool_down(self, rank: int, for_s: float) -> None:
        with self._cool_lock:
            self._cool[rank] = self._clock() + float(for_s)

    def _candidates(self) -> list[WorkerHandle]:
        """Non-cooling workers first, fewest outstanding rows, rank as
        tie-break; when everything cools, cooling workers are still
        offered (better a 429 than dropping work on the floor)."""
        live = self._handles()
        warm = [h for h in live if not self._cooling(h.rank)]
        pool = warm or live
        return sorted(pool, key=lambda h: (h.outstanding(), h.rank))

    # ---------------------------------------------------------- serving
    def infer(self, name: str, x, *, timeout_s: float = 5.0,
              req_id: str | None = None, trace=None) -> np.ndarray:
        """Route one request (the ``Session.infer`` contract over the
        fleet).  A 429/503 answer cools that worker and retries the
        next-best one; a transport-dead worker is routed around the
        same way (the supervisor's reaper replaces it).  Raises the
        last worker's rejection when all refuse, and
        ``Shed(reason="no_worker")`` when none answered."""
        if self._closed:
            raise RuntimeError("cluster router closed")
        arr = np.asarray(x)
        n_rows = 1 if arr.ndim == 1 else int(np.atleast_2d(arr).shape[0])
        rfields = {"kernel": name, "rows": n_rows}
        if req_id is not None:
            rfields["req_id"] = req_id
        rfields.update(obs.propagate.fields(trace))
        # real span under HPNN_SPANS, sampled/promotable under
        # HPNN_SAMPLE, shared null span otherwise (obs/forensics.py)
        rspan = obs.forensics.request_span("cluster.request", **rfields)
        sub = obs.propagate.ctx_from(
            rspan, trace=getattr(trace, "trace", None))
        t0 = self._clock()
        try:
            last_exc: Exception | None = None
            for h in self._candidates():
                depth = h.begin_request(n_rows)
                obs.count("cluster.route", rank=h.rank, kernel=name,
                          rows=n_rows)
                obs.gauge("cluster.outstanding", float(depth),
                          rank=h.rank)
                try:
                    out = h.infer(name, arr, timeout_s=timeout_s,
                                  req_id=req_id, trace=sub)
                    with self._stat_lock:
                        self._routed += 1
                    obs.slo.record("ok", self._clock() - t0)
                    obs.forensics.finish(rspan, rank=h.rank)
                    return out
                except Shed as exc:
                    if exc.reason == "quota":
                        # a quota shed is the TENANT's budget, not
                        # this worker's capacity: every worker would
                        # answer the same, and routing around would
                        # let one tenant launder its quota across the
                        # fleet (docs/tenancy.md).  Propagate, and do
                        # not cool the (healthy) worker.
                        with self._stat_lock:
                            self._shed += 1
                        obs.slo.record("shed")
                        raise
                    self._cool_down(h.rank, exc.retry_after_s)
                    obs.count("cluster.shed_around", rank=h.rank,
                              kernel=name, reason=exc.reason)
                    last_exc = exc
                except WorkerGone as exc:
                    self._cool_down(h.rank, 1.0)
                    obs.count("cluster.shed_around", rank=h.rank,
                              kernel=name, reason="gone")
                    last_exc = exc
                except DeadlineExceeded:
                    obs.slo.record("expired")
                    raise
                finally:
                    h.end_request(n_rows)
            with self._stat_lock:
                self._shed += 1
            obs.slo.record("shed")
            if isinstance(last_exc, Shed):
                raise last_exc
            # no worker answered at all: a retriable 429 at the edge,
            # where the JAX router lets the last WorkerGone escape
            raise Shed("no ready worker" if last_exc is None
                       else f"no live worker ({last_exc})",
                       reason="no_worker", retry_after_s=1.0)
        except BaseException as exc:
            obs.forensics.finish(rspan, failed=type(exc).__name__)
            raise

    def _ingest(self, kernel: str | None, inputs, targets) -> dict:
        """The ``ingest_hook`` plug point: place the row block on the
        least-loaded worker's online stream (``POST /v1/ingest``);
        workers without an online layer make the whole fleet answer
        404, same as a plain ``serve_nn`` process."""
        last_exc: Exception | None = None
        for h in self._candidates():
            try:
                return h.ingest(kernel, inputs, targets)
            except (Shed, WorkerGone) as exc:
                self._cool_down(h.rank, getattr(exc, "retry_after_s", 1.0))
                last_exc = exc
        raise last_exc or KeyError("online ingest not enabled")

    # ---------------------------------------------------------- kernels
    def _fan(self, op: str, fn, name: str, *, prepare=None):
        """Run ``fn(handle)`` on every worker, rank order, under the
        fence (``prepare()`` runs first, inside the same critical
        section — the publish step of an install); emits
        ``cluster.fence`` with the version edge so the fleet-wide
        old-or-new guarantee is observable."""
        with self._fence:
            handles = self._handles()
            if not handles:
                raise RuntimeError("cluster router has no live workers")
            if prepare is not None:
                prepare()
            prev = self._versions.get(name)
            results = [fn(h) for h in handles]
            now = max((v for v in results if v is not None),
                      default=prev)
            if now is not None:
                self._versions[name] = now
            obs.event("cluster.fence", op=op, kernel=name,
                      from_version=prev, to_version=now,
                      workers=len(handles))
            return ClusterEntry(name, now)

    def reload(self, name: str, *, warmup: bool = True) -> ClusterEntry:
        """Fan ``/v1/reload`` fence-ordered: every worker re-reads the
        published checkpoint, converging on one version."""
        return self._fan("reload", lambda h: h.reload(name), name)

    def install_kernel(self, name: str, kernel, *,
                       warmup: bool = True) -> ClusterEntry:
        """Publish new weights (checkpoint rewrite) and fan the reload
        under the same fence — the fleet-wide promotion."""
        if self._publisher is None:
            raise RegistryError(
                "cluster workers own their registries; install needs a "
                "publisher= (e.g. CheckpointPublisher)")
        return self._fan("install", lambda h: h.reload(name), name,
                         prepare=lambda: self._publisher(name, kernel))

    def register_kernel(self, name: str, kernel, **kwargs):
        raise RegistryError(
            "cluster workers register kernels from their own conf; "
            "use install_kernel with a publisher for new weights")

    def load_kernel(self, name: str, path: str, **kwargs):
        raise RegistryError(
            "cluster workers load kernels from their own conf")

    def maybe_reload(self, name: str) -> bool:
        return False

    def kernels(self) -> list[str]:
        for h in self._handles():
            doc = h.health()
            if doc is not None:
                return list(doc.get("kernels", []))
        return []

    # -------------------------------------------------------- readiness
    def mark_unready(self, reason: str) -> None:
        with self._stat_lock:
            self._ready = False
            self._unready_reason = reason

    def mark_ready(self) -> None:
        with self._stat_lock:
            self._ready = True

    def is_ready(self) -> bool:
        """Ready iff the edge is not draining AND any worker answers
        ``/readyz`` — one live worker keeps the fleet serving.  A ready
        answer holds for ``READY_TTL_S``, so an edge request (which asks
        first) does not poll every worker over HTTP; a not-ready one is
        asked again each time.  A worker lost inside the window is
        routed around like any other (``infer``)."""
        with self._stat_lock:
            if not self._ready:
                return False
            at = self._ready_at
        if at is not None and self._clock() - at < READY_TTL_S:
            return True
        ok = any(h.ready() for h in self._handles())
        with self._stat_lock:
            self._ready_at = self._clock() if ok else None
        return ok

    def ready_doc(self) -> dict:
        if not self._ready:
            return {"ready": False,
                    "reason": getattr(self, "_unready_reason", "unready")}
        docs = {f"w{h.rank}": h.ready_doc() for h in self._handles()}
        ready = any(d.get("ready") for d in docs.values())
        reason = None
        if not ready:
            reasons = {str(d.get("reason")) for d in docs.values()
                       if d.get("reason")}
            reason = " | ".join(sorted(reasons)) or "no ready worker"
        return {"ready": ready, "reason": reason, "workers": docs}

    # ----------------------------------------------------------- health
    def stats(self) -> dict:
        """The router-local load signals the autoscaler consumes —
        client-side outstanding rows per worker plus routed/shed
        totals (no HTTP round trips, safe at control-loop rate)."""
        outs = {h.rank: h.outstanding() for h in self._handles()}
        width = len(outs)
        with self._stat_lock:
            routed, shed = self._routed, self._shed
        return {
            "width": width,
            "outstanding": outs,
            "outstanding_total": sum(outs.values()),
            "outstanding_per_worker": (
                sum(outs.values()) / width if width else 0.0),
            "routed_total": routed,
            "shed_total": shed,
        }

    def health(self) -> dict:
        """One merged ``/healthz``: the Session document shape with
        per-worker sections keyed ``w{rank}`` and their batchers
        prefixed ``w{rank}/`` (the ``obs_report --merge`` shape)."""
        handles = self._handles()
        workers: dict = {}
        batchers: dict = {}
        kernels: list = []
        for h in handles:
            doc = h.health()
            if doc is None:
                workers[f"w{h.rank}"] = {
                    "status": "unreachable", "live": False,
                    "ready": False, "outstanding": h.outstanding(),
                    "cooling": self._cooling(h.rank)}
                continue
            if not kernels:
                kernels = list(doc.get("kernels", []))
            workers[f"w{h.rank}"] = {
                "status": doc.get("status"),
                "ready": doc.get("ready"),
                "ready_reason": doc.get("ready_reason"),
                "outstanding": h.outstanding(),
                "cooling": self._cooling(h.rank),
                "compiled": doc.get("compiled", 0),
                "port": h.port,
            }
            for bname, bdoc in doc.get("batchers", {}).items():
                batchers[f"w{h.rank}/{bname}"] = bdoc
        ready = self.is_ready()
        doc = {
            "status": "ok" if ready else "degraded",
            "live": True,
            "ready": ready,
            "ready_reason": self.ready_doc().get("reason"),
            "kernels": kernels,
            "batchers": batchers,
            "cluster": {
                "n_workers": len(handles),
                "stats": self.stats(),
                "versions": dict(self._versions),
            },
            "workers": workers,
        }
        doc["obs"] = obs.export.health()
        doc["slo"] = obs.slo.health_doc()
        doc["alerts"] = obs.alerts.health_doc()
        doc["sampler"] = obs.forensics.health_doc()
        doc["capsules"] = obs.triggers.health_doc()
        doc["drift"] = obs.drift.health_doc()
        if self.online_health is not None:
            doc["online"] = self.online_health()
        return doc

    def close(self) -> None:
        """Close the edge (handles stay open when a supervisor owns
        them — draining processes is the supervisor's job)."""
        with self._stat_lock:
            self._closed = True
            self._ready = False
        if self._static is not None:
            for h in self._static:
                h.close()
