"""Process-wide census of the serve engines' captured forwards.

The JAX package's module of this name arms XLA's persistent executable
cache (``HPNN_COMPILE_CACHE_DIR``), so a replica boots its bucket menu
off disk.  A CUDA graph cannot be written to disk: every process
captures its graphs anew, into its engine's memory pool, and the knob
is refused (``runtime.DEFERRED_ENV``).  What stays is the module's
counter surface, over the engines' pools of captured forwards:

* a **hit** is a lookup that found its forward already captured (every
  steady-state dispatch);
* a **miss** is a lookup that had to capture (or, in parity mode and
  on the CPU, build) the forward — warmup's, and any after it, which is
  the cold-start regression the ``serve.compile`` counter catches.

:func:`counters`, :func:`hit_rate` and :func:`stats` read them (the
``/healthz`` ``compile_cache.graphs`` section); :func:`gc` keeps the JAX
module's signature for the tenant pager and frees nothing.  stdlib
only.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_hits = 0
_misses = 0


def note(hit: bool) -> None:
    """Count one lookup of a serve engine's forward cache."""
    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1


def counters() -> tuple[int, int]:
    """(hits, misses) of this process's forward lookups."""
    with _lock:
        return _hits, _misses


def hit_rate() -> float | None:
    """Hit rate in [0, 1]; None before any lookup."""
    h, m = counters()
    return (h / (h + m)) if (h + m) else None


def stats() -> dict:
    """The ``/healthz compile_cache.graphs`` section."""
    h, m = counters()
    return {"persistent": False, "hits": h, "misses": m,
            "hit_rate": hit_rate()}


def gc(max_mb: float | None = None) -> tuple[int, int]:
    """The JAX package's size sweep of its on-disk executable cache,
    which the tenant pager calls after page-outs: here there is no disk
    cache to sweep (a CUDA graph lives in its engine's memory pool and
    dies with its forward, which ``Engine.evict`` drops), so nothing is
    removed.  Returns ``(files, bytes)`` removed: ``(0, 0)``."""
    return (0, 0)


def _reset_for_tests() -> None:
    """Zero the counters."""
    global _hits, _misses
    with _lock:
        _hits = 0
        _misses = 0
