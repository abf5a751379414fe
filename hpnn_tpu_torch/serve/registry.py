"""Named multi-kernel registry for the resident serving layer: a copy
of ``hpnn_tpu/serve/registry.py`` over the port's ``models/kernel.py``.

The reference libhpnn is built to be *embedded*: a host scientific
code keeps one trained kernel resident and queries it "on the fly"
(ref: libhpnn README.md:10-34).  A serving process generalizes
that to N named kernels, loaded once and kept hot, with an explicit
hot-reload path so a trainer can overwrite ``kernel.opt`` on disk and
the server picks the new weights up without a restart — the serving
twin of the tutorials' dump-then-``[init] kernel.opt`` resume cycle.

Entries are immutable snapshots (``Entry``); a reload produces a NEW
entry with a bumped ``version``, so the engine's compile cache — keyed
by ``(name, version, bucket, dtype)`` — naturally compiles fresh
executables for the new weights while in-flight batches finish on the
old ones.  An entry holds the kernel's host numpy weights — which is
also how weights cross from a JAX ``Kernel`` to the port: the engine
turns them into tensors (``models.kernel.to_torch``).  stdlib + numpy
only; torch stays out of this module.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

from hpnn_tpu_torch import chaos, obs
from hpnn_tpu_torch.models import kernel as kernel_mod


class RegistryError(ValueError):
    pass


# Serve compute policies an Entry (or HPNN_SERVE_DTYPE) may name:
# bf16/f32/f64 compute dtypes, or int8 weights with bf16 activations.
PRECISIONS = ("bf16", "f32", "f64", "int8")


class Entry(NamedTuple):
    """One resident kernel: an immutable snapshot of (weights, type).

    ``version`` increments on every (re)load of the same name —
    the engine keys compiled executables on it.  ``path``/``mtime``
    are None for kernels registered from memory (no reload source).
    ``sig`` is the file's staleness signature ``(st_mtime_ns,
    st_size)``: float mtime alone cannot see a same-second rewrite on
    coarse-timestamp filesystems, a race the online trainer's rapid
    promote cadence makes realistic (docs/online.md).
    ``precision`` is the per-entry serve compute policy
    (``bf16|f32|f64|int8``, or None = the process default from
    ``HPNN_SERVE_DTYPE``, or full native precision when that is unset
    too) — the engine compiles this entry's forwards in that dtype
    (docs/performance.md); it survives reloads/installs like
    ``path``/``sig`` do.
    """

    name: str
    kernel: kernel_mod.Kernel
    model: str               # "ann" | "snn" (the forward dispatch)
    version: int
    path: str | None
    mtime: float | None
    sig: tuple | None = None
    precision: str | None = None

    @property
    def n_inputs(self) -> int:
        return self.kernel.n_inputs

    @property
    def n_outputs(self) -> int:
        return self.kernel.n_outputs


def _check_model(model: str) -> str:
    if model not in ("ann", "snn"):
        raise RegistryError(f"unknown model type {model!r} (want ann|snn)")
    return model


class Registry:
    """Thread-safe name → :class:`Entry` map.

    ``register`` installs in-memory weights; ``load`` reads a kernel
    text file through the standard loader (``models.kernel.load`` →
    ``fileio.kernel_format``) and remembers the path + mtime so
    ``maybe_reload``/``reload`` can refresh it.  Every install runs
    ``kernel.validate`` — a serving process must never hold a kernel
    whose layer chain is inconsistent.
    """

    def __init__(self, *, lock_name: str = "serve.registry"):
        # ``lock_name`` gives each lock-striped shard of a
        # tenant.ShardedRegistry its own watched identity
        # (``serve.registry.s<i>``) so the lockwatch order graph can
        # tell the stripes apart (docs/tenancy.md).
        self._lock = obs.lockwatch.lock(lock_name)
        self._entries: dict[str, Entry] = {}  # guarded: _lock

    # ------------------------------------------------------------ install
    def register(
        self, name: str, kernel: kernel_mod.Kernel, *, model: str = "ann",
        path: str | None = None, mtime: float | None = None,
        sig: tuple | None = None, version: int | None = None,
        precision: str | None = None,
    ) -> Entry:
        """Install (or replace) ``name`` with in-memory weights.

        ``version`` pins the entry's version instead of auto-bumping —
        a freshly spun-up serving replica mirrors another registry and
        must agree on versions so the engines' executable identities
        (``serve.<kernel>.v<V>.b<B>``) line up across the fleet
        (serve/router.py)."""
        _check_model(model)
        if precision is not None and precision not in PRECISIONS:
            raise RegistryError(
                f"unknown precision {precision!r} "
                f"(want {'|'.join(PRECISIONS)})")
        if not kernel_mod.validate(kernel):
            raise RegistryError(f"kernel {name!r} failed validation")
        with self._lock:
            prev = self._entries.get(name)
            if version is None:
                version = prev.version + 1 if prev is not None else 0
            if precision is None and prev is not None:
                # the policy sticks across reloads/installs, like
                # path/sig: a hot-reload must not silently dequantize
                precision = prev.precision
            entry = Entry(name, kernel, model, int(version), path,
                          mtime, sig, precision)
            self._entries[name] = entry
        obs.count("serve.kernel_load", kernel=name, version=version,
                  source="file" if path else "memory")
        return entry

    def load(self, name: str, path: str, *, model: str = "ann") -> Entry:
        """Load a kernel text file and install it under ``name``."""
        _check_model(model)
        try:
            st = os.stat(path)
            _fname, kernel = kernel_mod.load(path)
        except OSError as exc:
            raise RegistryError(f"cannot read kernel file {path}: {exc}")
        return self.register(name, kernel, model=model, path=path,
                             mtime=st.st_mtime,
                             sig=(st.st_mtime_ns, st.st_size))

    def install(self, name: str, kernel: kernel_mod.Kernel, *,
                model: str | None = None) -> Entry:
        """Install new weights for an EXISTING name as a new version,
        entirely in memory — the online promotion path (no disk
        round-trip; docs/online.md).  The prior entry's ``path`` /
        ``mtime`` / ``sig`` carry forward, so a later *file* rewrite
        still hot-reloads over the promoted weights (disk wins)."""
        try:
            prev = self.get(name)
        except KeyError:
            raise RegistryError(
                f"cannot install over unknown kernel {name!r}; "
                "register/load it first")
        entry = self.register(name, kernel,
                              model=prev.model if model is None
                              else model,
                              path=prev.path, mtime=prev.mtime,
                              sig=prev.sig)
        obs.count("serve.install", kernel=name, version=entry.version)
        return entry

    def set_precision(self, name: str, precision: str | None) -> Entry:
        """Retag ``name``'s serve compute policy as a NEW version (the
        engine's cache keys carry the version, so fresh executables
        compile under the new policy while in-flight batches finish on
        the old ones).  ``None`` clears the per-entry override back to
        the process default.  Emits the ``serve.precision`` event."""
        if precision is not None and precision not in PRECISIONS:
            raise RegistryError(
                f"unknown precision {precision!r} "
                f"(want {'|'.join(PRECISIONS)})")
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(name)
            entry = entry._replace(version=entry.version + 1,
                                   precision=precision)
            self._entries[name] = entry
        obs.event("serve.precision", kernel=name,
                  precision=precision or "native",
                  version=entry.version, source="set")
        return entry

    # ------------------------------------------------------------ lookup
    def get(self, name: str) -> Entry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(name)
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def count(self) -> int:
        """O(1) kernel count — the list/health paths must not pay an
        ``names()`` sort-and-copy just to know how many entries exist
        (a 10k-kernel host asks this on every /healthz scrape)."""
        with self._lock:
            return len(self._entries)

    def sample(self, k: int = 16) -> list[str]:
        """Up to ``k`` kernel names, cheaply — dict order, no full
        sort.  The summarized health document shows these instead of
        enumerating thousands of entries (docs/tenancy.md)."""
        out: list[str] = []
        with self._lock:
            for name in self._entries:
                out.append(name)
                if len(out) >= max(0, int(k)):
                    break
        return out

    def census(self) -> dict:
        """Summary stats for the health document: count only here;
        ``tenant.ShardedRegistry`` overrides with shard balance."""
        return {"count": self.count()}

    def unregister(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    # ------------------------------------------------------------ reload
    def reload(self, name: str) -> Entry:
        """Force a re-read of ``name``'s kernel file (new version)."""
        entry = self.get(name)
        if entry.path is None:
            raise RegistryError(
                f"kernel {name!r} was registered from memory; "
                "nothing to reload")
        chaos.inject("registry.reload")  # seam: forced reload
        new = self.load(name, entry.path, model=entry.model)
        obs.count("serve.reload", kernel=name, version=new.version)
        return new

    def maybe_reload(self, name: str) -> bool:
        """Hot-reload ``name`` if its file changed since the last
        (re)load.  Staleness compares ``(st_mtime_ns, st_size)`` —
        float mtime misses a same-second rewrite on coarse-timestamp
        filesystems (and two rewrites within the double's ~200 ns
        resolution), while the size catches even an equal-timestamp
        overwrite.  Returns True when a new version was installed.
        A vanished or unreadable file keeps the resident version (a
        serving process must not drop a kernel over a torn overwrite);
        the failed probe is counted, not raised."""
        entry = self.get(name)
        if entry.path is None:
            return False
        try:
            st = os.stat(entry.path)
        except OSError:
            obs.count("serve.reload_failed", kernel=name, reason="stat")
            return False
        if entry.sig is not None:
            if (st.st_mtime_ns, st.st_size) == tuple(entry.sig):
                return False
        elif entry.mtime is not None and st.st_mtime == entry.mtime:
            return False  # pre-sig entry (registered with mtime only)
        try:
            # seam inside the guard: an injected fault degrades to a
            # counted failed probe, resident version kept — the same
            # contract as a torn file overwrite
            chaos.inject("registry.reload")
            self.load(name, entry.path, model=entry.model)
        except Exception:
            obs.count("serve.reload_failed", kernel=name, reason="load")
            return False
        obs.count("serve.reload", kernel=name,
                  version=self.get(name).version)
        return True
