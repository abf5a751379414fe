"""The draw orders the port derives from a seed, frozen for the reference.

* :func:`shuffled_order`: the per-sample round's file order, glibc's
  ``srandom``/``random`` TYPE_3 generator and the reference library's
  draw-with-rejection (a copy of ``hpnn_tpu_torch/utils/glibc_random.py``
  ``GlibcRandom`` at :36 and ``shuffled_order`` at :88, without the
  native shortcut; libhpnn src/libhpnn.c:1218-1229).
* :func:`fleet_plan`: each fleet member's bank permutations and block
  orders (a copy of ``hpnn_tpu_torch/train/fleet.py`` ``member_plan``
  at :139 and ``fleet_plan`` after it): numpy's ``RandomState(seed)``,
  one permutation of the rows per refresh group, then that group's
  per-epoch permutations of the blocks.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647
_DEG, _SEP = 31, 3


class GlibcRandom:
    """glibc ``srandom(seed)`` / ``random()``, TYPE_3 (degree 31,
    separation 3, 310 warm-up draws)."""

    def __init__(self, seed: int):
        seed &= 0xFFFFFFFF
        s = seed - (1 << 32) if seed >= (1 << 31) else seed
        if s == 0:
            s = 1
        r = [0] * _DEG
        r[0] = s & 0xFFFFFFFF
        for i in range(1, _DEG):
            # Schrage's method on int32 with C's truncating division
            hi = int(abs(s) // 127773) * (1 if s >= 0 else -1)
            lo = s - hi * 127773
            s = 16807 * lo - 2836 * hi
            if s < 0:
                s += 2147483647
            r[i] = s & 0xFFFFFFFF
        self._r, self._f, self._p = r, _SEP, 0
        for _ in range(10 * _DEG):
            self.random()

    def random(self) -> int:
        r, f, p = self._r, self._f, self._p
        v = (r[f] + r[p]) & 0xFFFFFFFF
        r[f] = v
        self._f = f + 1 if f + 1 < _DEG else 0
        self._p = p + 1 if p + 1 < _DEG else 0
        return v >> 1

    def draw_index(self, n: int) -> int:
        idx = int(self.random() * n / RAND_MAX)
        return n - 1 if idx >= n else idx


def shuffled_order(seed: int, n: int) -> list[int]:
    """The order in which a round visits the ``n`` files of its
    directory listing: random slots, already drawn ones drawn again."""
    rng = GlibcRandom(seed)
    taken = [False] * n
    order = []
    for _ in range(n):
        idx = rng.draw_index(n)
        while taken[idx]:
            idx = rng.draw_index(n)
        taken[idx] = True
        order.append(idx)
    return order


def member_plan(seed: int, *, n_rows: int, batch: int, epochs: int, refresh: int = 8):
    """perms ``(G, n_rows)`` and orders ``(G, R, S)``, ``G·R == epochs``;
    ``refresh`` falls back to 1 where it does not divide ``epochs``."""
    n_steps = n_rows // batch
    if epochs % refresh:
        refresh = 1
    groups = epochs // refresh
    rng = np.random.RandomState(seed)
    perms = np.stack([rng.permutation(n_rows) for _ in range(groups)])
    orders = np.stack([np.stack([rng.permutation(n_steps) for _ in range(refresh)])
                       for _ in range(groups)])
    return perms.astype(np.int64), orders.astype(np.int64)


def fleet_plan(seeds, *, n_rows: int, batch: int, epochs: int, refresh: int = 8):
    """:func:`member_plan` stacked over members: ``(N, G, n_rows)`` and
    ``(N, G, R, S)``."""
    plans = [member_plan(int(s), n_rows=n_rows, batch=batch, epochs=epochs,
                         refresh=refresh) for s in seeds]
    return np.stack([p for p, _ in plans]), np.stack([o for _, o in plans])
