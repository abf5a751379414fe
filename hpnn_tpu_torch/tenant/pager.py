"""Cold-kernel paging: a bounded resident set over the registry.

A copy of ``hpnn_tpu/tenant/pager.py`` over the port's engine.  On the
card a resident kernel holds device memory — its weights and one
captured CUDA graph per bucket, each graph with its own memory pool —
so the resident set bounds device memory, not only host memory.

10k registered kernels cannot all stay hot — weights, per-bucket
graphs, and batcher state per kernel make memory linear in the
namespace.  The :class:`Pager` bounds it: at most ``resident_max``
kernels are *resident* (registered + captured); the rest live as
**paged** entries — their weights in a content-addressed checkpoint
store (``fileio/checkpoint.py`` format).  A page-out drops the kernel's
graphs and device weights (``Engine.evict``), which returns their
memory.  A request for a paged kernel blocks while the pager loads the
checkpoint back, re-registers it under its **pinned version** (so
graph identities — ``serve.<kernel>.v<V>.b<B>`` — line up), copies the
weights to the device and captures the bucket menu anew (a CUDA graph
cannot be written to disk, so where the JAX pager reads executables
back from the persistent compile cache the port captures them again:
that is its cold-hit cost, split into checkpoint read, host-to-device
copy and captures by :meth:`Pager.cold_split`), and evicts the
least-recently-used idle kernel to make room.  Unlike the JAX pager,
a page-in runs outside the pager's lock: its captures take tens of
milliseconds on the card, and requests for resident kernels must not
queue behind them.  Page-ins run one at a time, on the requesting
thread, under a second lock, the load lock; a request that gets it
looks again whether its kernel is still paged (another thread may have
paged it in meanwhile).  A registration takes the load lock too
(:meth:`Pager.adopting`), so it never lands in the middle of a page-in
of the same name.  A capture that fails on page-in raises to the
request that caused it, and the kernel stays paged.  On ``cuda`` every
page-in captures the bucket menu: a lazy capture would run on the
kernel's batcher thread, and cuBLAS keeps a workspace for every
capturing thread for the process's life, so device memory would grow
with every kernel ever touched, not with the resident set.

Store layout (``HPNN_TENANT_PAGE_DIR``), object-store style::

    <dir>/objects/<sha[:2]>/<sha>.ckpt   # content-addressed weights
    <dir>/index/<digest>.json            # name -> {sha, version, ...}

Objects are addressed by a digest of the weight *bytes* (+ shapes /
dtypes), so identical weights dedupe across versions and tenants and
the index metadata — not the checkpoint header — is authoritative for
name/version on page-in.  The index mirrors the *paged-out* set
exactly: page-in and promotion drop the entry (a warm boot must never
adopt weights a live host has since superseded), page-out rewrites
it.  Because the object store is a plain shared directory, a **fresh
worker boots warm on any host**: :meth:`preload_index` adopts every
indexed kernel as paged, and the first request pages it in off the
shared store (docs/tenancy.md "Paging lifecycle").

Correctness contract (the paging tests): a paged-out-then-paged-in
kernel answers **bitwise** identically to one never evicted (parity
mode — checkpoints round-trip exact bytes, versions are pinned); a
promotion landing on a paged-out kernel pages it in first; an infer
racing a page-out blocks on the pager lock and pages back in — never
a 404.  In-flight kernels are pin-counted and never evicted.

Page transitions emit ``tenant.page_out`` / ``tenant.page_in``
(counts), ``tenant.page_in_ms`` (the measured cold-hit latency
histogram the bench gates p99 on), and the ``tenant.resident`` gauge
carrying its ``cap`` — the bounded-RSS invariant, lintable per record
(``check_obs_catalog --tenant``).  stdlib + numpy only.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import numpy as np

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.fileio.checkpoint import (CheckpointError, dump_checkpoint,
                                        load_checkpoint)
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.serve import compile_cache

ENV_RESIDENT = "HPNN_TENANT_RESIDENT"
ENV_PAGE_DIR = "HPNN_TENANT_PAGE_DIR"


class PagingError(RuntimeError):
    pass


def _resident_from_env() -> int:
    raw = os.environ.get(ENV_RESIDENT, "").strip()
    if not raw:
        return 0
    n = int(raw)  # junk raises: a silently ignored cap is a lie
    if n < 0:
        raise ValueError(f"{ENV_RESIDENT} must be >= 0, got {n}")
    return n


def _weights_digest(weights) -> str:
    """Content address: sha256 over the raw weight bytes plus shapes/
    dtypes (two kernels with coincidentally equal bytes but different
    layer shapes must not collide)."""
    h = hashlib.sha256()
    for w in weights:
        a = np.ascontiguousarray(np.asarray(w))
        h.update(repr((tuple(a.shape), a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _index_key(name: str) -> str:
    """Index filename for ``name`` — hashed, because kernel names
    carry tenant scopes (``tenant:kernel``) and arbitrary bytes that
    must not leak into filesystem semantics."""
    return hashlib.sha256(name.encode("utf-8",
                                      "surrogatepass")).hexdigest()[:32]


def _tenant_of(name: str) -> str | None:
    """The tenant scope of a ``tenant:kernel`` name, for event tags."""
    return name.split(":", 1)[0] if ":" in name else None


class _Pin:
    """Context manager from :meth:`Pager.pin`: holds the kernel
    resident for the duration; ``cold_ms`` is the measured page-in
    latency, or None on a warm hit."""

    __slots__ = ("_pager", "name", "cold_ms")

    def __init__(self, pager: "Pager", name: str):
        self._pager = pager
        self.name = name
        self.cold_ms: float | None = None

    def __enter__(self) -> "_Pin":
        self.cold_ms = self._pager._acquire(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._pager._release(self.name)
        return False


class Pager:
    """LRU resident-set manager over a (sharded) registry + engine.

    ``resident_max`` 0 disables eviction (everything stays resident);
    ``page_dir`` None disables paging entirely — eviction would lose
    weights, so a cap without a store raises.  ``warmup`` captures the
    bucket menu on page-in (the cold-hit cost is then *measured*);
    without it a paged-in kernel captures each bucket at its first
    dispatch, on its batcher's thread, which ``cuda`` refuses (see the
    module docstring)."""

    def __init__(self, registry, engine, *,
                 resident_max: int | None = None,
                 page_dir: str | None = None, warmup: bool = True,
                 clock=time.monotonic):
        if resident_max is None:
            resident_max = _resident_from_env()
        if page_dir is None:
            page_dir = os.environ.get(ENV_PAGE_DIR) or None
        if resident_max and not page_dir:
            raise PagingError(
                f"{ENV_RESIDENT}={resident_max} needs "
                f"{ENV_PAGE_DIR}: evicting without a page store "
                "would drop weights")
        if not warmup and engine.device.type == "cuda":
            raise PagingError(
                "lazy captures on cuda would keep a cuBLAS workspace "
                "for every kernel's batcher thread: page in with "
                "warmup")
        self.registry = registry
        self.engine = engine
        self.resident_max = int(resident_max)
        self.page_dir = page_dir
        self.warmup = bool(warmup)
        self._clock = clock
        self._lock = obs.lockwatch.lock("tenant.pager")
        # all three below are guarded by _lock; annotations omitted
        # because helper methods mutate them with the lock held by
        # their callers (the engine._stat pattern)
        self._resident: dict[str, float] = {}   # name -> last touch
        self._paged: dict[str, dict] = {}       # name -> index entry
        self._pins: dict[str, int] = {}         # name -> inflight
        # page-ins run one at a time: at once they would contend for
        # the card and the engine lock, each one slower.  Every change
        # of a paged name (page-in, registration over it) holds it;
        # taken before _lock, never after
        self._load_lock = obs.lockwatch.lock("tenant.pager.load")
        self._cold_ms: list[float] = []         # page-in latencies
        # per page-in: (read ms, host-to-device ms, capture ms, captures)
        self._cold_split: list[tuple] = []
        self._page_ins = 0
        self._page_outs = 0

    # ------------------------------------------------------------ store
    def _object_path(self, sha: str) -> str:
        return os.path.join(self.page_dir, "objects", sha[:2],
                            f"{sha}.ckpt")

    def _index_path(self, name: str) -> str:
        return os.path.join(self.page_dir, "index",
                            f"{_index_key(name)}.json")

    def _write_index(self, name: str, idx: dict) -> None:
        path = self._index_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fp:
            json.dump(idx, fp, sort_keys=True)
        os.replace(tmp, path)

    def _drop_index(self, name: str) -> None:
        """The on-disk index mirrors the *paged-out* set exactly: a
        kernel paged (or promoted) back to resident must drop its
        entry, or a later warm boot would adopt stale weights."""
        try:
            os.unlink(self._index_path(name))
        except OSError:
            pass  # never indexed (fresh register), or already gone

    def preload_index(self) -> int:
        """Adopt every indexed kernel as paged — the warm-boot path: a
        fresh worker pointed at a shared store serves the whole
        namespace, paying only a page-in per first touch.  Returns the
        number adopted (already-resident names are skipped)."""
        if not self.page_dir:
            return 0
        idx_dir = os.path.join(self.page_dir, "index")
        if not os.path.isdir(idx_dir):
            return 0
        adopted = 0
        for fname in os.listdir(idx_dir):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(idx_dir, fname),
                          encoding="utf-8") as fp:
                    idx = json.load(fp)
                name = idx["kernel"]
            except (OSError, ValueError, KeyError):
                continue  # torn index entry: skip, never crash a boot
            with self._lock:
                if name in self._resident or name in self._paged:
                    continue
                self._paged[name] = idx
                adopted += 1
        obs.event("tenant.preload", adopted=adopted)
        return adopted

    # ------------------------------------------------------------ paging
    def _page_out_locked(self, name: str) -> None:
        # caller holds _lock
        entry = self.registry.get(name)
        sha = _weights_digest(entry.kernel.weights)
        obj = self._object_path(sha)
        if not os.path.exists(obj):
            os.makedirs(os.path.dirname(obj), exist_ok=True)
            dump_checkpoint(obj, name, entry.kernel.weights,
                            version=entry.version, model=entry.model,
                            meta={"precision": entry.precision})
        idx = {"kernel": name, "sha": sha,
               "version": entry.version, "model": entry.model,
               "precision": entry.precision}
        self._write_index(name, idx)
        self.registry.unregister(name)
        self.engine.evict(name)
        del self._resident[name]
        self._paged[name] = idx
        self._page_outs += 1
        obs.count("tenant.page_out", kernel=name,
                  tenant=_tenant_of(name))
        self._gauge_resident_locked()

    def _load(self, name: str, idx: dict) -> tuple:
        """Page ``name`` in outside the pager lock: read its checkpoint,
        register it under its pinned version, copy its weights to the
        device and capture its bucket menu.  Returns ``(cold ms,
        (read ms, copy ms, capture ms, captures))``.  On a failure the
        kernel is unregistered again and the error raised: no eager or
        CPU fallback."""
        t0 = time.perf_counter()
        obj = self._object_path(idx["sha"])
        try:
            _cname, arrays, _header = load_checkpoint(obj)
        except CheckpointError as exc:
            raise PagingError(
                f"page-in of {name!r} failed: {exc}") from exc
        read_s = time.perf_counter() - t0
        kernel = kernel_mod.Kernel(tuple(arrays))
        # the version pin: graph identities must match the
        # pre-eviction ones
        self.registry.register(name, kernel, model=idx["model"],
                               version=idx["version"],
                               precision=idx.get("precision"))
        h2d_s = cap_s = 0.0
        captures = 0
        if self.warmup:
            try:
                h2d_s = self.engine.upload(name)
                t_cap = time.perf_counter()
                self.engine.warmup([name])
                cap_s = time.perf_counter() - t_cap
                # the page-out dropped every forward of ``name``, and no
                # request reaches it before it is resident
                captures = sum(1 for k in list(self.engine._compiled)
                               if k[0] == name)
            except BaseException:
                self.registry.unregister(name)
                self.engine.evict(name)
                raise
        cold_ms = (time.perf_counter() - t0) * 1000.0
        return cold_ms, (read_s * 1e3, h2d_s * 1e3, cap_s * 1e3, captures)

    def _evict_over_cap_locked(self) -> None:
        # caller holds _lock
        if not self.resident_max:
            return
        while len(self._resident) > self.resident_max:
            victim = None
            for cand, _t in sorted(self._resident.items(),
                                   key=lambda kv: kv[1]):
                if not self._pins.get(cand):
                    victim = cand
                    break
            if victim is None:
                return  # everything is in flight; cap yields to pins
            self._page_out_locked(victim)

    def _gauge_resident_locked(self) -> None:
        # pinned rides along because pins legitimately hold the set
        # over cap (the cap yields to in-flight requests): the
        # lintable invariant is value <= cap + pinned
        obs.gauge("tenant.resident", float(len(self._resident)),
                  cap=self.resident_max, paged=len(self._paged),
                  pinned=len(self._pins))

    # ------------------------------------------------------------ surface
    def track(self, name: str) -> None:
        """Adopt a freshly registered kernel into the resident set,
        evicting over-cap idle kernels to make room.  A registration
        over a name that may be paged runs in :meth:`adopting`, which
        calls this."""
        with self._lock:
            if self._paged.pop(name, None) is not None:
                # re-registered over a paged entry (a promotion): the
                # on-disk index would now point at stale weights
                self._drop_index(name)
            self._resident[name] = self._clock()
            self._evict_over_cap_locked()
            self._gauge_resident_locked()

    @contextlib.contextmanager
    def adopting(self, name: str):
        """Wrap a registration of ``name``, then :meth:`track` it.  The
        load lock keeps a page-in of ``name`` from publishing its old
        weights over the new ones, and a pin keeps a page-out from
        taking ``name`` between the registration and the track."""
        with self._load_lock:
            with self._lock:
                self._pins[name] = self._pins.get(name, 0) + 1
            try:
                yield
                self.track(name)
            finally:
                self._release(name)

    def pin(self, name: str) -> _Pin:
        """Hold ``name`` resident for a ``with`` block (pages it in
        first when cold).  Unknown names pass through untouched — the
        registry's own KeyError stays the 404 authority."""
        return _Pin(self, name)

    def _pin_locked(self, name: str) -> None:
        # caller holds _lock
        if name in self._resident:
            self._resident[name] = self._clock()
            self._pins[name] = self._pins.get(name, 0) + 1

    def _acquire(self, name: str) -> float | None:
        with self._lock:
            if name not in self._paged:
                self._pin_locked(name)
                return None
        # the slow part — read, copy, captures — holds no pager lock, so
        # requests for resident kernels keep flowing meanwhile
        with self._load_lock:
            with self._lock:
                idx = self._paged.get(name)
                if idx is None:     # paged in while this thread waited
                    self._pin_locked(name)
                    return None
            cold_ms, split = self._load(name, idx)
            with self._lock:
                del self._paged[name]
                self._drop_index(name)
                self._resident[name] = self._clock()
                self._pins[name] = self._pins.get(name, 0) + 1
                self._cold_ms.append(cold_ms)
                self._cold_split.append(split)
                if len(self._cold_ms) > 4096:
                    del self._cold_ms[:2048]
                    del self._cold_split[:2048]
                self._page_ins += 1
                obs.count("tenant.page_in", kernel=name,
                          tenant=_tenant_of(name))
                obs.observe("tenant.page_in_ms", cold_ms, kernel=name)
                # evict only after the pin above: when every other
                # resident is pinned, the LRU would otherwise pick the
                # kernel just paged in and the caller's infer would 404
                # on a name it holds a pin for
                self._evict_over_cap_locked()
                self._gauge_resident_locked()
        return cold_ms

    def _release(self, name: str) -> None:
        with self._lock:
            n = self._pins.get(name, 0)
            if n > 1:
                self._pins[name] = n - 1
                return
            self._pins.pop(name, None)
            if (self.resident_max
                    and len(self._resident) > self.resident_max):
                # a pin-forced over-cap episode ends with its last
                # pin: re-assert the residency bound here, not at the
                # next (possibly distant) acquire
                self._evict_over_cap_locked()
                self._gauge_resident_locked()

    def is_resident(self, name: str) -> bool:
        with self._lock:
            return name in self._resident

    def is_paged(self, name: str) -> bool:
        with self._lock:
            return name in self._paged

    # ------------------------------------------------------------ GC
    def gc_objects(self) -> tuple[int, int]:
        """Sweep version-churn remainders: delete store objects no
        index entry references (a promotion on a paged kernel strands
        its old weights object).  Returns ``(files, bytes)`` removed.
        ``compile_cache.gc`` is called as in the JAX pager and frees
        nothing: the port keeps no executable cache on disk."""
        removed = freed = 0
        if self.page_dir:
            live: set[str] = set()
            idx_dir = os.path.join(self.page_dir, "index")
            if os.path.isdir(idx_dir):
                for fname in os.listdir(idx_dir):
                    try:
                        with open(os.path.join(idx_dir, fname),
                                  encoding="utf-8") as fp:
                            live.add(json.load(fp)["sha"])
                    except (OSError, ValueError, KeyError):
                        continue
            obj_dir = os.path.join(self.page_dir, "objects")
            if os.path.isdir(obj_dir):
                for sub in os.listdir(obj_dir):
                    subdir = os.path.join(obj_dir, sub)
                    if not os.path.isdir(subdir):
                        continue
                    for fname in os.listdir(subdir):
                        sha = fname.rsplit(".", 1)[0]
                        if sha in live:
                            continue
                        path = os.path.join(subdir, fname)
                        try:
                            size = os.path.getsize(path)
                            os.unlink(path)
                        except OSError:
                            continue
                        removed += 1
                        freed += size
        cc_removed, cc_freed = compile_cache.gc()
        if removed or cc_removed:
            obs.event("tenant.gc", objects=removed, bytes=freed,
                      cache_entries=cc_removed, cache_bytes=cc_freed)
        return removed + cc_removed, freed + cc_freed

    # ------------------------------------------------------------ health
    def cold_hit_ms(self) -> list[float]:
        with self._lock:
            return list(self._cold_ms)

    def cold_split(self) -> list[dict]:
        """Each kept page-in's cold-hit time split into checkpoint read,
        host-to-device copy and captures (ms, the last two 0 without
        ``warmup``), with the captures it made."""
        with self._lock:
            return [{"read_ms": r, "h2d_ms": h, "capture_ms": c,
                     "captures": n} for r, h, c, n in self._cold_split]

    def health_doc(self) -> dict:
        with self._lock:
            cold = sorted(self._cold_ms)
            doc = {
                "resident": len(self._resident),
                "cap": self.resident_max,
                "paged": len(self._paged),
                "pinned": sum(1 for v in self._pins.values() if v),
                "page_ins": self._page_ins,
                "page_outs": self._page_outs,
                "store": self.page_dir,
            }
        if cold:
            doc["cold_p50_ms"] = round(cold[len(cold) // 2], 3)
            doc["cold_p99_ms"] = round(
                cold[min(len(cold) - 1, int(0.99 * len(cold)))], 3)
        return doc
