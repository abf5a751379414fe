"""Bounded streaming sample buffer for the train-while-serve loop (a
copy of ``hpnn_tpu/online/ingest.py``: its RNG draws match draw for
draw).

The host calculation (or the ``POST /ingest`` route) pushes
``(input, target)`` pairs as they are produced; the background
trainer snapshots a fixed-size training window from the other end.
Three stores, all bounded:

* **ring** — the newest ``capacity`` training samples (a deque; the
  oldest sample is dropped, and counted, when full);
* **reservoir** — optional uniform sample over the *whole* stream
  history (classic reservoir sampling), mixed into snapshots as
  replay so the candidate does not catastrophically forget the early
  distribution while the ring chases the newest samples;
* **holdout** — every ``holdout``-th sample is *diverted* (never
  trained on) into a bounded eval set: the held-out data the
  promotion gate scores candidates against (docs/online.md).

stdlib + numpy only; the clock is injectable so staleness math is
testable with a fake clock.  Knobs (read once, at construction):
``HPNN_ONLINE_BUFFER`` (ring capacity, default 1024),
``HPNN_ONLINE_RESERVOIR`` (reservoir size, default 0 = off),
``HPNN_ONLINE_HOLDOUT`` (divert every k-th sample, default 8;
0 = off).
"""

from __future__ import annotations

import collections
import os
import threading
import time

import numpy as np

from hpnn_tpu_torch import obs


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SampleBuffer:
    """Thread-safe bounded store of streaming ``(x, t)`` pairs.

    ``feed`` accepts one sample (``(n_in,)`` vectors) or a row block
    (``(R, n_in)``); the first feed pins the stream's (n_in, n_out)
    and later mismatches raise ``ValueError``.  ``snapshot`` returns
    the training window (newest ring samples, oldest portion replaced
    by reservoir replay when armed) as float64 arrays — copies, so
    training never races the stream.
    """

    def __init__(self, *, capacity: int | None = None,
                 reservoir: int | None = None,
                 holdout: int | None = None, holdout_cap: int = 256,
                 clock=time.monotonic, seed: int = 0):
        self.capacity = int(capacity if capacity is not None
                            else _env_int("HPNN_ONLINE_BUFFER", 1024))
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.reservoir = int(reservoir if reservoir is not None
                             else _env_int("HPNN_ONLINE_RESERVOIR", 0))
        self.holdout = int(holdout if holdout is not None
                           else _env_int("HPNN_ONLINE_HOLDOUT", 8))
        self._clock = clock
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)           # (x, t, ts)
        self._res: list[tuple] = []          # reservoir over train stream
        self._res_seen = 0
        self._hold: collections.deque = collections.deque(
            maxlen=max(1, int(holdout_cap)))
        self._n_in: int | None = None
        self._n_out: int | None = None
        self._fed = 0
        self._dropped = 0

    # ------------------------------------------------------------- feed
    def _check_widths(self, X: np.ndarray, T: np.ndarray) -> None:
        if self._n_in is None:
            self._n_in, self._n_out = X.shape[1], T.shape[1]
        elif (X.shape[1], T.shape[1]) != (self._n_in, self._n_out):
            raise ValueError(
                f"sample widths ({X.shape[1]}, {T.shape[1]}) do not "
                f"match the stream ({self._n_in}, {self._n_out})")

    def feed(self, x, t) -> int:
        """Append sample(s); returns the number accepted (all of
        them — a full ring evicts its oldest, counted as a drop)."""
        X = np.atleast_2d(np.asarray(x, dtype=np.float64))
        T = np.atleast_2d(np.asarray(t, dtype=np.float64))
        if X.ndim != 2 or T.ndim != 2:
            raise ValueError("samples must be vectors or row blocks")
        if X.shape[0] != T.shape[0]:
            raise ValueError(
                f"{X.shape[0]} inputs vs {T.shape[0]} targets")
        now = self._clock()
        dropped = 0
        with self._lock:
            self._check_widths(X, T)
            for i in range(X.shape[0]):
                row = (X[i].copy(), T[i].copy(), now)
                self._fed += 1
                if self.holdout > 0 and self._fed % self.holdout == 0:
                    self._hold.append(row)
                    continue
                if len(self._ring) == self._ring.maxlen:
                    dropped += 1
                self._ring.append(row)
                if self.reservoir > 0:
                    self._res_seen += 1
                    if len(self._res) < self.reservoir:
                        self._res.append(row)
                    else:
                        j = int(self._rng.randint(self._res_seen))
                        if j < self.reservoir:
                            self._res[j] = row
            self._dropped += dropped
            depth = len(self._ring)
        accepted = int(X.shape[0])
        obs.count("online.ingest", accepted)
        if dropped:
            obs.count("online.drop", dropped)
        obs.gauge("online.buffer_depth", depth)
        if obs.drift.enabled():
            # ingest-sketch tap (obs/drift.py): outside the lock —
            # scoring fans into the alert engine on breach
            obs.drift.note_ingest(X)
        return accepted

    # ------------------------------------------------------------ census
    def depth(self) -> int:
        with self._lock:
            return len(self._ring)

    def holdout_depth(self) -> int:
        with self._lock:
            return len(self._hold)

    def total_fed(self) -> int:
        with self._lock:
            return self._fed

    def dropped_total(self) -> int:
        with self._lock:
            return self._dropped

    def widths(self) -> tuple[int, int] | None:
        with self._lock:
            if self._n_in is None:
                return None
            return (self._n_in, self._n_out)

    def staleness_s(self) -> float | None:
        """Seconds since the newest training sample arrived (None
        before the first feed) — the 'is the stream alive' gauge."""
        with self._lock:
            if not self._ring:
                return None
            newest = self._ring[-1][2]
        return max(0.0, self._clock() - newest)

    # --------------------------------------------------------- snapshots
    def snapshot(self, rows: int, *, replay_frac: float = 0.25):
        """``(X, T, meta)`` for one training round: the newest
        ``rows`` ring samples as float64 ``(rows, n)`` copies, with
        the *oldest* ``replay_frac`` of the window swapped for
        reservoir draws when the reservoir is armed.  Raises
        ``ValueError`` when the ring holds fewer than ``rows``."""
        now = self._clock()
        with self._lock:
            if len(self._ring) < rows:
                raise ValueError(
                    f"buffer holds {len(self._ring)} < {rows} samples")
            window = list(self._ring)[-rows:]
            res = list(self._res)
        n_replay = 0
        if res and replay_frac > 0:
            n_replay = min(int(rows * replay_frac), len(res), rows)
            if n_replay:
                picks = self._rng.choice(len(res), n_replay,
                                         replace=False)
                for i, j in enumerate(picks):
                    window[i] = res[int(j)]
        X = np.stack([w[0] for w in window])
        T = np.stack([w[1] for w in window])
        ages = [now - w[2] for w in window]
        meta = {
            "rows": rows,
            "replay": n_replay,
            "staleness_s": max(0.0, now - window[-1][2]),
            "window_age_s": max(0.0, max(ages)),
        }
        return X, T, meta

    def eval_snapshot(self):
        """The held-out eval set ``(X, T)`` (copies), or None when the
        holdout store is empty/disabled."""
        with self._lock:
            hold = list(self._hold)
        if not hold:
            return None
        return (np.stack([h[0] for h in hold]),
                np.stack([h[1] for h in hold]))
