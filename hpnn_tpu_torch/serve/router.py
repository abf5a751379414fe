"""Data-parallel serving scale-out: a request router over N replicas
(the port of ``hpnn_tpu/serve/router.py``).

A :class:`Router` owns N
:class:`~hpnn_tpu_torch.serve.replica.Replica` instances — each a full
Session (registry + bucketed engine + batchers) pinned to
``cuda:(rank % device_count)``, or an independent drain-thread stack on
the CPU — and presents the SAME
surface as a single Session, so ``make_server``, the online-learning
layer, and every embedding caller work unchanged against a fleet.

Placement: least outstanding work.  Each routed request picks the
ready replica with the fewest in-flight ROWS (row-weighted, so one
resident 512-row block does not count like a 1-row probe — light
traffic routes around heavy dispatch chains); a replica that sheds
(:class:`~hpnn_tpu.serve.batcher.Shed`) or is unready is routed
*around* — the shed replica cools off for its own ``retry_after_s``
and the request retries on the next-best replica, so one saturated
device degrades capacity instead of availability.  Only when every
replica has refused does the caller see the rejection.

TP spill-over: with ``spill=True`` (``HPNN_SERVE_SPILL=1``) a row block
larger than the bucket menu skips the replicas and runs through the
tensor-parallel batched forward (``parallel/tp.make_spill_forward``):
the kernel's rows split one block a local device, the activations
gathered in process after each layer.  ``spill_devices`` names the
devices (default: every local CUDA card on ``cuda``, the CPU once on
the CPU); a CPU test can split one kernel into several blocks on the
CPU.  Without the spill an oversized block chunks through one
replica's largest bucket.

Promotion fence: ``install_kernel`` (and load/register/reload) fan out
to replicas one at a time under a single fence lock, and each replica's
install is atomic (registry entry swap; in-flight batches finish on
the entry they dispatched with).  Because a request is answered by
exactly ONE replica, every answer is bitwise old-version or
new-version — never a torn mix — even while the fan-out is mid-flight.
The fence serializes concurrent promotions so replicas also never see
two promotions interleaved (``router.fence`` event per fan-out).

Spin-up: ``spawn_replica`` clones the registry (versions pinned, so
graph identities ``serve.<kernel>.v<V>.b<B>`` agree fleet-wide) and
captures the whole bucket menu.  (A CUDA graph cannot be written to
disk, so there is no warm boot from ``HPNN_COMPILE_CACHE_DIR``.)

Everything here is stdlib + numpy at import.  Architecture:
docs/serving.md#scale-out.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.serve import compile_cache
from hpnn_tpu_torch.serve.batcher import QueueFull, Shed
from hpnn_tpu_torch.serve.replica import Replica

ENV_REPLICAS = "HPNN_SERVE_REPLICAS"
ENV_SPILL = "HPNN_SERVE_SPILL"


class _FanRegistry:
    """Registry facade over the fleet: reads answer from replica 0
    (every replica holds the same entries, fence-ordered), writes fan
    out through the router so the online layer's direct
    ``session.registry.register(...)`` calls reach every replica."""

    def __init__(self, router: "Router"):
        self._router = router

    # reads — any replica would do; rank 0 is the convention
    def get(self, name):
        return self._router._primary().registry.get(name)

    def names(self):
        return self._router._primary().registry.names()

    # writes — fence-serialized fan-outs
    def register(self, name, kernel, **kwargs):
        return self._router._fan(
            "register", lambda rep: rep.registry.register(
                name, kernel, **kwargs), name)

    def install(self, name, kernel, **kwargs):
        return self._router._fan(
            "install", lambda rep: rep.registry.install(
                name, kernel, **kwargs), name)

    def load(self, name, path, **kwargs):
        return self._router._fan(
            "load", lambda rep: rep.registry.load(name, path, **kwargs),
            name)

    def unregister(self, name):
        return self._router._fan(
            "unregister", lambda rep: rep.registry.unregister(name),
            name, versioned=False)

    def reload(self, name):
        return self._router.reload(name)

    def maybe_reload(self, name):
        return self._router.maybe_reload(name)


class _FanEngine:
    """Engine facade: warmup/evict fan out, census reads aggregate."""

    def __init__(self, router: "Router"):
        self._router = router

    @property
    def buckets(self):
        return self._router._primary().engine.buckets

    @property
    def max_batch(self):
        return self._router._primary().engine.max_batch

    @property
    def mode(self):
        return self._router._primary().engine.mode

    @property
    def device(self):
        return self._router._primary().engine.device

    def pin_captures(self, thread) -> None:
        for rep in self._router.replicas:
            rep.engine.pin_captures(thread)

    def warmup(self, names=None, *, dtype=None) -> int:
        return sum(rep.engine.warmup(names, dtype=dtype)
                   for rep in self._router.replicas if not rep._closed)

    def evict(self, name, *, keep_version=None):
        for rep in self._router.replicas:
            if not rep._closed:
                rep.engine.evict(name, keep_version=keep_version)

    def compiled_count(self) -> int:
        return sum(rep.engine.compiled_count()
                   for rep in self._router.replicas)

    def cache_stats(self) -> dict:
        # replica-prefixed keys, the same "r{rank}/" shape
        # obs_report --merge gives cross-rank training sinks
        out: dict = {}
        for rep in self._router.replicas:
            for key, stat in rep.engine.cache_stats().items():
                out[f"r{rep.rank}/{key}"] = stat
        return out


class Router:
    """Session-compatible front end over N serving replicas (see
    module docstring).  ``n_replicas`` defaults to
    ``HPNN_SERVE_REPLICAS`` (else 1); every other kwarg is forwarded
    verbatim to each :class:`Replica`'s Session constructor."""

    def __init__(self, n_replicas: int | None = None, *,
                 spill: bool | None = None, spill_devices=None,
                 clock=time.monotonic, **session_kwargs):
        if n_replicas is None:
            n_replicas = int(os.environ.get(ENV_REPLICAS, "0") or 0) or 1
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        runtime.refuse_deferred("serve.Router")
        if spill is None:
            spill = os.environ.get(ENV_SPILL, "") == "1"
        self.spill = bool(spill)
        self._spill_devices = spill_devices
        self._clock = clock
        self._session_kwargs = dict(session_kwargs)
        self.replicas = [Replica(rank, clock=clock, **session_kwargs)
                         for rank in range(n_replicas)]  # guarded: _fence
        # one fence for every mutation fan-out: replicas see
        # promotions in the same order, and a spawning replica never
        # races a half-applied install
        self._fence = obs.lockwatch.lock("serve.router.fence")
        # rank -> monotonic instant its shed cool-off expires
        self._cool_lock = obs.lockwatch.lock("serve.router.cool")
        self._cool: dict[int, float] = {}  # guarded: _cool_lock
        # (name, version) -> (spill forward, n_out)
        self._tp_lock = obs.lockwatch.lock("serve.router.tp")
        self._tp_cache: dict = {}          # guarded: _tp_lock
        # the online-learning layer plugs in exactly as on a Session
        self.ingest_hook = None
        self.online_health = None
        self._emit_ready_gauge()

    # ------------------------------------------------------------ plumbing
    def _primary(self) -> Replica:
        """The read replica: lowest-rank LIVE one (a killed rank 0
        must not answer census reads with its frozen registry)."""
        for rep in self.replicas:
            if not rep._closed:
                return rep
        return self.replicas[0]

    @property
    def registry(self):
        return _FanRegistry(self)

    @property
    def engine(self):
        return _FanEngine(self)

    @property
    def fleet(self) -> bool:
        return self._primary().fleet

    def _live(self) -> list[Replica]:
        return [rep for rep in self.replicas if not rep._closed]

    def _emit_ready_gauge(self) -> None:
        """``router.ready_replicas``: live AND ready replica count,
        re-emitted on every membership edge (init, kill, spawn) — the
        gauge the replica-loss alert rule watches
        (docs/observability.md "Fleet telemetry")."""
        n = sum(1 for rep in self.replicas
                if not rep._closed and rep.is_ready())
        obs.gauge("router.ready_replicas", float(n),
                  total=len(self.replicas))

    def _fan(self, op: str, fn, name: str, *, versioned: bool = True):
        """Run ``fn(replica)`` on every live replica, rank order,
        under the fence.  Returns replica 0's result (the Entry most
        callers want).  Emits ``router.fence`` with the version edge
        so the old-or-new promotion guarantee is observable."""
        with self._fence:
            live = self._live()
            if not live:
                raise RuntimeError("router has no live replicas")
            try:
                prev = live[0].registry.get(name).version
            except KeyError:
                prev = None
            results = [fn(rep) for rep in live]
            try:
                now = live[0].registry.get(name).version
            except KeyError:
                now = None
            obs.event("router.fence", op=op, kernel=name,
                      from_version=prev, to_version=now,
                      replicas=len(live))
            return results[0]

    # ------------------------------------------------------------ kernels
    # the Session mutation surface, fanned out fence-ordered so every
    # replica converges on the same (name, version) map
    def load_kernel(self, name: str, path: str, *, model: str = "ann",
                    warmup: bool = True):
        return self._fan(
            "load", lambda rep: rep.load_kernel(
                name, path, model=model, warmup=warmup), name)

    def register_kernel(self, name: str, kernel: kernel_mod.Kernel, *,
                        model: str = "ann", warmup: bool = True,
                        path: str | None = None,
                        mtime: float | None = None,
                        sig: tuple | None = None):
        return self._fan(
            "register", lambda rep: rep.register_kernel(
                name, kernel, model=model, warmup=warmup, path=path,
                mtime=mtime, sig=sig), name)

    def install_kernel(self, name: str, kernel: kernel_mod.Kernel, *,
                       warmup: bool = True):
        return self._fan(
            "install", lambda rep: rep.install_kernel(
                name, kernel, warmup=warmup), name)

    def reload(self, name: str, *, warmup: bool = True):
        return self._fan(
            "reload", lambda rep: rep.reload(name, warmup=warmup), name)

    def maybe_reload(self, name: str) -> bool:
        return bool(self._fan(
            "maybe_reload", lambda rep: rep.maybe_reload(name), name))

    def kernels(self) -> list[str]:
        return self._primary().registry.names()

    # ------------------------------------------------------------ readiness
    def mark_unready(self, reason: str) -> None:
        for rep in self._live():
            rep.mark_unready(reason)

    def mark_ready(self) -> None:
        for rep in self._live():
            rep.mark_ready()

    def is_ready(self) -> bool:
        """Ready iff ANY replica can answer — one live replica keeps
        the edge serving (degraded capacity, full availability)."""
        return any(rep.is_ready() and not rep._closed
                   for rep in self.replicas)

    def ready_doc(self) -> dict:
        docs = {f"r{rep.rank}": rep.ready_doc() for rep in self.replicas}
        reason = None
        if not self.is_ready():
            reasons = {d["reason"] for d in docs.values()
                       if d.get("reason")}
            reason = " | ".join(sorted(reasons)) or "no ready replica"
        return {"ready": self.is_ready(), "reason": reason,
                "replicas": docs}

    # ------------------------------------------------------------ health
    def health(self) -> dict:
        """One merged /healthz: the Session document shape (so every
        existing consumer parses it) with per-replica sections keyed
        ``r{rank}`` — the same rank-keyed merge ``obs_report --merge``
        applies to training sinks."""
        primary = self._primary()
        cache = self.engine.cache_stats()
        cache["graphs"] = compile_cache.stats()
        batchers: dict = {}
        replicas: dict = {}
        for rep in self.replicas:
            rdoc = rep.health() if not rep._closed else {
                "status": "closed", "live": False, "ready": False}
            replicas[f"r{rep.rank}"] = {
                "status": rdoc.get("status"),
                "ready": rdoc.get("ready"),
                "ready_reason": rdoc.get("ready_reason"),
                "outstanding": rep.outstanding(),
                "cooling": self._cooling(rep.rank),
                "compiled": rdoc.get("compiled", 0),
            }
            for bname, bdoc in rdoc.get("batchers", {}).items():
                batchers[f"r{rep.rank}/{bname}"] = bdoc
        doc = {
            "status": "ok" if self.is_ready() else "degraded",
            "live": True,
            "ready": self.is_ready(),
            "ready_reason": self.ready_doc()["reason"],
            "kernels": primary.registry.names(),
            "buckets": list(primary.engine.buckets),
            "compiled": self.engine.compiled_count(),
            "compile_cache": cache,
            "batchers": batchers,
            "router": {
                "n_replicas": len(self.replicas),
                "live_replicas": len(self._live()),
                "spill": self.spill,
                "spilled_kernels": sorted({k[0] for k in self._tp_cache}),
            },
            "replicas": replicas,
        }
        doc["numerics"] = obs.probes.health_doc(primary.registry.names())
        doc["obs"] = obs.export.health()
        doc["slo"] = obs.slo.health_doc()
        doc["alerts"] = obs.alerts.health_doc()
        if self.online_health is not None:
            doc["online"] = self.online_health()
        return doc

    # ------------------------------------------------------------ routing
    def _cooling(self, rank: int) -> bool:
        with self._cool_lock:
            until = self._cool.get(rank, 0.0)
        return self._clock() < until

    def _candidates(self) -> list[Replica]:
        """Ready, live, non-cooling replicas, best placement first:
        fewest outstanding rows, rank as tie-break.  When every
        ready replica is cooling, cooling ones are still offered
        (better a 429 from a saturated replica than dropping work on
        the floor while capacity recovers)."""
        live = [rep for rep in self.replicas
                if not rep._closed and rep.is_ready()]
        warm = [rep for rep in live if not self._cooling(rep.rank)]
        pool = warm or live
        return sorted(pool, key=lambda rep: (rep.outstanding(),
                                             rep.rank))

    def infer(self, name: str, x, *, timeout_s: float = 5.0,
              req_id: str | None = None, trace=None):
        """Route one request (same contract as ``Session.infer``).

        Placement is least-outstanding over ready replicas; a
        :class:`Shed`/:class:`QueueFull` answer cools that replica and
        retries the next-best one.  Raises ``KeyError`` for unknown
        kernels, the last replica's rejection when all refuse.

        With spans armed the routing hop is its own ``router.request``
        span parented to the caller's ``trace`` context, and each
        replica dispatch parents under it — the edge → router →
        replica chain in one tree (docs/observability.md)."""
        arr = np.asarray(x)
        single = arr.ndim == 1
        n_rows = 1 if single else int(np.atleast_2d(arr).shape[0])
        entry = self._primary().registry.get(name)   # KeyError: unknown
        rfields = {"kernel": name, "rows": n_rows}
        if req_id is not None:
            rfields["req_id"] = req_id
        rfields.update(obs.propagate.fields(trace))
        rspan = obs.spans.start("router.request", **rfields)
        sub = obs.propagate.ctx_from(
            rspan, trace=getattr(trace, "trace", None))
        try:
            if (self.spill and not single
                    and n_rows > self._primary().engine.buckets[-1]):
                out = self._spill_infer(entry, np.atleast_2d(arr))
                obs.spans.finish(rspan, spilled=True)
                return out
            last_exc: Exception | None = None
            for rep in self._candidates():
                depth = rep.begin_request(n_rows)
                obs.count("router.route", rank=rep.rank, kernel=name,
                          rows=n_rows)
                obs.gauge("replica.outstanding", float(depth),
                          rank=rep.rank)
                try:
                    out = rep.infer(name, arr, timeout_s=timeout_s,
                                    req_id=req_id, trace=sub)
                    obs.spans.finish(rspan, rank=rep.rank)
                    return out
                except Shed as exc:
                    with self._cool_lock:
                        self._cool[rep.rank] = (self._clock()
                                                + exc.retry_after_s)
                    obs.count("router.shed_around", rank=rep.rank,
                              kernel=name, reason=exc.reason)
                    last_exc = exc
                except QueueFull as exc:
                    obs.count("router.shed_around", rank=rep.rank,
                              kernel=name, reason="queue_full")
                    last_exc = exc
                except RuntimeError as exc:
                    # a replica closed mid-route (kill_replica racing
                    # the candidate snapshot): route around it like a
                    # shed
                    if "closed" not in str(exc):
                        raise
                    obs.count("router.shed_around", rank=rep.rank,
                              kernel=name, reason="closed")
                    last_exc = exc
                finally:
                    rep.end_request(n_rows)
            if last_exc is not None:
                raise last_exc
            raise Shed("no ready replica", reason="no_replica",
                       retry_after_s=1.0)
        except BaseException as exc:
            # idempotent: a success path already finished the span
            obs.spans.finish(rspan, failed=type(exc).__name__)
            raise

    # ------------------------------------------------------------ TP spill
    def _tp_forward(self, entry):
        """The cached spill forward of ``entry`` (its rows split one
        block a spill device, ``parallel/tp.make_spill_forward``)."""
        key = (entry.name, entry.version)
        with self._tp_lock:
            cached = self._tp_cache.get(key)
        if cached is not None:
            return cached
        from hpnn_tpu_torch.parallel import tp

        engine = self._primary().engine
        devices = self._spill_devices
        if devices is None:
            devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                       if engine.device.type == "cuda" else ["cpu"])
        dtype = np.dtype(str(engine.native_dtype(entry)).replace("torch.", ""))
        fwd = tp.make_spill_forward(
            tuple(np.asarray(w, dtype=dtype) for w in entry.kernel.weights), devices,
            model=entry.model, n_out=entry.n_outputs)
        cached = (fwd, entry.n_outputs)
        with self._tp_lock:
            self._tp_cache[key] = cached
        return cached

    def _spill_infer(self, entry, rows: np.ndarray) -> np.ndarray:
        fwd, _n_out = self._tp_forward(entry)
        obs.count("router.spill", kernel=entry.name, rows=int(rows.shape[0]))
        with obs.timer("router.spill_time", kernel=entry.name,
                       rows=int(rows.shape[0])):
            return fwd(rows)

    # ------------------------------------------------------------ fleet ops
    def kill_replica(self, rank: int) -> None:
        """Take replica ``rank`` out of rotation (drill primitive and
        ops API): unready first so no new request is placed there,
        then close its batchers.  In-flight requests on the victim
        fail; everything after the unready flip lands on survivors."""
        rep = self.replicas[rank]
        rep.mark_unready("killed")
        rep.close()
        obs.event("router.replica_down", rank=rank,
                  survivors=len(self._live()))
        self._emit_ready_gauge()

    def spawn_replica(self) -> Replica:
        """Pre-warmed spin-up: a new replica cloning the current
        registry with versions PINNED (executable identities agree
        fleet-wide) and the full bucket menu warmed — against a warm
        ``HPNN_COMPILE_CACHE_DIR`` the warmup is disk reads, not
        compiles.  Joins the rotation atomically under the fence."""
        with self._fence:
            rank = len(self.replicas)
            rep = Replica(rank, clock=self._clock,
                          **self._session_kwargs)
            src = self._primary().registry
            for name in src.names():
                e = src.get(name)
                rep.registry.register(
                    name, e.kernel, model=e.model, path=e.path,
                    mtime=e.mtime, sig=e.sig, version=e.version)
                rep.engine.warmup([name])
            self.replicas.append(rep)
        obs.event("router.replica_up", rank=rank,
                  kernels=len(rep.registry.names()))
        self._emit_ready_gauge()
        return rep

    # ------------------------------------------------------------ close
    def close(self) -> None:
        for rep in self.replicas:
            if not rep._closed:
                rep.close()
