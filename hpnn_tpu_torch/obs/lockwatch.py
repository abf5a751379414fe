"""Lock-order watchdog: named locks + a global acquisition graph (a
copy of ``hpnn_tpu/obs/lockwatch.py``; the port's serve locks carry
the same role names).

The static side of the locking contract lives in tools/hpnnlint
(``lock-discipline``: annotated fields only change under their lock).
This module is the dynamic side: **order**.  Two locks each taken
under the other is a deadlock waiting for the right interleaving —
a property no single test run trips, because both orders work alone.

Armed with ``HPNN_LOCKWATCH=1``, :func:`lock` returns a watched
wrapper that records, per thread, the stack of watched locks it
holds.  Acquiring ``b`` while holding ``a`` adds the edge ``a -> b``
to a process-global graph, together with *both* acquisition stacks
(where ``a`` was taken, where ``b`` was taken).  :func:`check` — run
after every serve test of the port when armed — DFS-walks the
graph and raises :class:`LockOrderError` with the full evidence on
any cycle, plus a flight-ring dump (``HPNN_FLIGHT``) and a
``lockwatch.cycle`` event so the report survives the crash.

Unarmed (the default), :func:`lock` hands back a plain
``threading.Lock`` after one memoized env read: zero overhead, and
``threading.Condition(lockwatch.lock("x"))`` works in both modes —
the wrapper delegates ``acquire``/``release``/``locked``, which is
the whole protocol Condition needs.

Cycle detection is order-based, not wait-based: a single thread that
ever takes ``a`` then ``b`` and elsewhere ``b`` then ``a`` is enough
evidence — no actual deadlock (and no second thread) required.

Wired through the port's long-lived serve locks under the JAX
package's role names: ``serve.router.fence`` / ``.cool`` / ``.tp``,
``serve.batcher``, ``serve.registry``.

stdlib-only.
"""

from __future__ import annotations

import os
import threading
import traceback

ENV_KNOB = "HPNN_LOCKWATCH"

_armed: bool | None = None
_graph_lock = threading.Lock()
# (holder, acquired) -> (stack where holder was taken,
#                        stack where acquired was taken)
_edges: dict[tuple[str, str], tuple[str, str]] = {}
_tls = threading.local()


class LockOrderError(RuntimeError):
    """A cycle exists in the observed lock-acquisition order."""


def enabled() -> bool:
    """True when HPNN_LOCKWATCH armed (memoized; see _reset_for_tests)."""
    global _armed
    if _armed is None:
        _armed = os.environ.get(ENV_KNOB, "") not in ("", "0")
    return _armed


def _held() -> list[tuple[str, str]]:
    """This thread's stack of (name, acquisition stack) pairs."""
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class _WatchedLock:
    """threading.Lock delegate that feeds the order graph."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record()
        return got

    def _record(self) -> None:
        stack = "".join(traceback.format_stack(limit=16)[:-2])
        held = _held()
        with _graph_lock:
            for prior, prior_stack in held:
                if prior != self.name:  # re-entry is not an ordering
                    _edges.setdefault((prior, self.name),
                                      (prior_stack, stack))
        held.append((self.name, stack))

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockwatch lock {self.name!r} at {id(self):#x}>"


def lock(name: str):
    """A lock for the named role: watched when armed, plain when not."""
    if enabled():
        return _WatchedLock(name)
    return threading.Lock()


def edges() -> dict[tuple[str, str], tuple[str, str]]:
    with _graph_lock:
        return dict(_edges)


def cycles() -> list[list[str]]:
    """Every elementary cycle in the observed order graph, as node
    lists (first node repeated last)."""
    graph: dict[str, set[str]] = {}
    with _graph_lock:
        for a, b in _edges:
            graph.setdefault(a, set()).add(b)
    out: list[list[str]] = []
    seen_keys: set[frozenset[str]] = set()

    def dfs(node: str, path: list[str], on_path: set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_keys:
                    seen_keys.add(key)
                    out.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return out


def report() -> str:
    """Human-readable cycle evidence: each offending edge with both
    acquisition stacks."""
    cycs = cycles()
    if not cycs:
        return "lockwatch: no cycles in %d observed edge(s)" % len(
            edges())
    all_edges = edges()
    lines = ["lockwatch: %d lock-order cycle(s)" % len(cycs)]
    for cyc in cycs:
        lines.append("  cycle: " + " -> ".join(cyc))
        for a, b in zip(cyc, cyc[1:]):
            sa, sb = all_edges[(a, b)]
            lines.append(f"  edge {a} -> {b}:")
            lines.append(f"    [{a} acquired at]\n" + _indent(sa, 6))
            lines.append(f"    [{b} acquired at]\n" + _indent(sb, 6))
    return "\n".join(lines)


def _indent(text: str, n: int) -> str:
    pad = " " * n
    return "\n".join(pad + ln for ln in text.rstrip().splitlines())


def check() -> None:
    """Raise LockOrderError (with obs event + flight dump) on any
    cycle in the graph observed so far."""
    if not cycles():
        return
    text = report()
    from hpnn_tpu_torch.obs import flight, registry
    registry.event("lockwatch.cycle", cycles=len(cycles()))
    flight.dump("lockwatch-cycle")
    raise LockOrderError(text)


def _reset_for_tests() -> None:
    """Forget the graph and the env memo (mirrors registry/flight)."""
    global _armed
    with _graph_lock:
        _edges.clear()
    _armed = None
    _tls.held = []
