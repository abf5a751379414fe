"""Lock-striped kernel registry for the multi-tenant host.

A copy of ``hpnn_tpu/tenant/shards.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

One ``serve.Registry`` guards every entry with a single lock — the
right shape for a handful of resident kernels, and a serialization
point at 10k: every register/get/reload from every tenant queues on
one mutex, and a slow path holding it (a reload's file read) stalls
the whole namespace.  :class:`ShardedRegistry` partitions the
namespace into N independent ``Registry`` shards routed by a stable
hash of the kernel name, so registrations and lookups for different
names proceed in parallel and a stall is confined to 1/N of the
keyspace.

Each shard is a full, unmodified :class:`~hpnn_tpu_torch.serve.registry.
Registry` with its own ``obs.lockwatch``-watched lock
(``serve.registry.s<i>``) — the lock-order watchdog sees the stripes
as distinct locks, and the hpnnlint lock-discipline rule applies to
each shard's guarded fields unchanged.  The hash is ``zlib.crc32``
(stable across processes and runs, unlike ``hash(str)`` under
PYTHONHASHSEED) so a replica mirroring a registry shards identically.

The surface mirrors ``Registry`` (the engine and session duck-type
against it); the additions are the O(1) summaries the health path
needs at 10k entries: :meth:`count`, :meth:`sample`, and
:meth:`census` (total + shard balance).  stdlib + numpy only.
"""

from __future__ import annotations

import os
import zlib

from hpnn_tpu_torch.serve.registry import Registry

ENV_SHARDS = "HPNN_TENANT_SHARDS"
DEFAULT_SHARDS = 16


def shards_from_env() -> int:
    raw = os.environ.get(ENV_SHARDS, "").strip()
    if not raw:
        return DEFAULT_SHARDS
    n = int(raw)  # junk raises: a silently ignored knob is a lie
    if n < 1:
        raise ValueError(f"{ENV_SHARDS} must be >= 1, got {n}")
    return n


def shard_of(name: str, n_shards: int) -> int:
    """Stable shard index for ``name`` (crc32, not ``hash``: replicas
    must agree across processes)."""
    return zlib.crc32(name.encode("utf-8", "surrogatepass")) % n_shards


class ShardedRegistry:
    """Name → Entry map striped over N independent ``Registry``
    shards.  Per-name operations delegate to the owning shard; the
    cross-shard reads (``names``, ``census``) merge without ever
    holding two shard locks at once — no lock-order edges between
    stripes, by construction."""

    def __init__(self, n_shards: int | None = None):
        if n_shards is None:
            n_shards = shards_from_env()
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.shards = tuple(
            Registry(lock_name=f"serve.registry.s{i}")
            for i in range(self.n_shards))

    def _shard(self, name: str) -> Registry:
        return self.shards[shard_of(name, self.n_shards)]

    # ------------------------------------------------------------ install
    def register(self, name: str, kernel, **kw):
        return self._shard(name).register(name, kernel, **kw)

    def load(self, name: str, path: str, **kw):
        return self._shard(name).load(name, path, **kw)

    def install(self, name: str, kernel, **kw):
        return self._shard(name).install(name, kernel, **kw)

    def set_precision(self, name: str, precision):
        return self._shard(name).set_precision(name, precision)

    # ------------------------------------------------------------ lookup
    def get(self, name: str):
        return self._shard(name).get(name)

    def unregister(self, name: str) -> None:
        self._shard(name).unregister(name)

    def names(self) -> list[str]:
        """Every name, sorted — kept for Registry-surface compat; the
        health path must prefer :meth:`count`/:meth:`sample` (this is
        the O(n log n) full scan a 10k host cannot afford per
        scrape)."""
        out: list[str] = []
        for s in self.shards:
            out.extend(s.names())
        out.sort()
        return out

    def count(self) -> int:
        return sum(s.count() for s in self.shards)

    def sample(self, k: int = 16) -> list[str]:
        out: list[str] = []
        for s in self.shards:
            if len(out) >= k:
                break
            out.extend(s.sample(k - len(out)))
        return out

    def census(self) -> dict:
        """Total + shard balance for the health document: a hot
        imbalance (max ≫ min) means the name distribution defeated
        the hash and registration cost re-serializes."""
        per = [s.count() for s in self.shards]
        return {"count": sum(per), "shards": self.n_shards,
                "shard_min": min(per), "shard_max": max(per)}

    # ------------------------------------------------------------ reload
    def reread(self, name: str):
        return self._shard(name).reread(name)

    def publish(self, entry):
        return self._shard(entry.name).publish(entry)

    def stale(self, name: str):
        return self._shard(name).stale(name)
