"""glibc ``random()``-compatible PRNG (TYPE_3 additive-feedback generator).

The reference library seeds glibc's ``srandom()`` and consumes ``random()``
for two observable behaviors that must reproduce seed-for-seed:

* weight initialization ``w = 2*(random()/RAND_MAX - 0.5)/sqrt(M)``
  (ref: libhpnn src/ann.c:653-677), and
* the sample-file shuffle draw ``idx = (UINT)((DOUBLE)random()*n/RAND_MAX)``
  with rejection of already-drawn slots
  (ref: libhpnn src/libhpnn.c:1218-1229).

glibc's default TYPE_3 generator (degree 31, separation 3,
310 warm-up discards), with Python integers making the int32/uint32
wrap semantics explicit.
"""

from __future__ import annotations

from hpnn_tpu_torch import native

RAND_MAX = 2147483647

_DEG = 31
_SEP = 3
_WARMUP = 10 * _DEG  # glibc discards 10*deg outputs after seeding


def _c_div(a: int, b: int) -> tuple[int, int]:
    """C truncation-toward-zero division and remainder."""
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q, a - q * b


class GlibcRandom:
    """Stateful clone of glibc ``srandom(seed)`` / ``random()``."""

    __slots__ = ("_r", "_f", "_p")

    def __init__(self, seed: int):
        seed &= 0xFFFFFFFF
        # glibc stores the seed into int32 state; 0 is mapped to 1.
        s = seed - (1 << 32) if seed >= (1 << 31) else seed
        if s == 0:
            s = 1
        r = [0] * _DEG
        r[0] = s & 0xFFFFFFFF
        for i in range(1, _DEG):
            # s_{i} = 16807 * s_{i-1} mod 2147483647, computed the way
            # glibc does (Schrage's method on int32 with C division).
            hi, lo = _c_div(s, 127773)
            s = 16807 * lo - 2836 * hi
            if s < 0:
                s += 2147483647
            r[i] = s & 0xFFFFFFFF
        self._r = r
        self._f = _SEP
        self._p = 0
        for _ in range(_WARMUP):
            self.random()

    def random(self) -> int:
        """Next value in [0, 2**31-1], exactly as glibc ``random()``."""
        r = self._r
        f, p = self._f, self._p
        v = (r[f] + r[p]) & 0xFFFFFFFF
        r[f] = v
        self._f = f + 1 if f + 1 < _DEG else 0
        self._p = p + 1 if p + 1 < _DEG else 0
        return v >> 1

    def uniform(self) -> float:
        """``(DOUBLE)random() / RAND_MAX`` as the reference computes it."""
        return self.random() / RAND_MAX

    def draw_index(self, n: int) -> int:
        """``(UINT)((DOUBLE)random()*n/RAND_MAX)``: the shuffle draw.

        The reference formula can (with probability 2**-31) yield ``n``
        itself, which would read out of bounds in the C code; we clamp
        instead of faulting.
        """
        idx = int(self.random() * n / RAND_MAX)
        return n - 1 if idx >= n else idx


def shuffled_order(seed: int, n: int) -> list[int]:
    """The exact file-visit order of the reference's training/eval loop.

    Draw random slots in [0, n) with rejection of already-drawn slots
    until all n are drawn (ref: libhpnn src/libhpnn.c:1218-1229).
    The native library draws the same order at C speed (the rejection
    loop draws O(n log n) slots); the Python loop runs without it.
    """
    arr = native.glibc_shuffle(seed, n)
    if arr is not None:
        return [int(i) for i in arr]
    rng = GlibcRandom(seed)
    taken = [False] * n
    order: list[int] = []
    for _ in range(n):
        idx = rng.draw_index(n)
        while taken[idx]:
            idx = rng.draw_index(n)
        taken[idx] = True
        order.append(idx)
    return order
