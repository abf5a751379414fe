"""Streaming drift detection: ingest/prediction sketches and the
held-out decay sentinel (the ``HPNN_DRIFT`` knob).

A copy of ``hpnn_tpu/obs/drift.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

The online loop (docs/online.md) is promote-gated: every quality
signal it emits rides a candidate judgement, so a drifting stream
that degrades the resident kernel *without* producing a winning
candidate is invisible.  This module watches the data and the model
directly, with three detector families:

* **ingest sketches** — per-feature running mean/var plus
  bounded-bin quantile histograms of the ingest stream.  The first
  ``HPNN_DRIFT_WINDOW`` rows freeze a *reference* window (per-feature
  quantile bin edges + bin counts); a sliding *live* window of the
  same size is binned against those frozen edges and scored with a
  Population-Stability-Index statistic.  Fed from the
  ``SampleBuffer.feed`` tap (online/ingest.py).
* **prediction drift** — per-kernel winning-class frequency and
  winning-value ("confidence") histograms on the serve path, tapped
  at engine dispatch on the host-side outputs (serve/engine.py) —
  the compiled graph is never touched.  Same frozen-reference /
  sliding-live PSI.
* **decay sentinel** — an EWMA mean/variance of the *resident*
  kernel's held-out eval loss (online/trainer.py feeds it every
  round, starved rounds included); the signed z-score of each fresh
  eval against the stats from *before* it is the "model is rotting"
  signal, breaching at ``HPNN_DRIFT_Z`` sigmas.

Every detector publishes a normalized ``drift.score`` gauge (1.0 =
its breach bound: PSI 0.25 for the sketches, ``HPNN_DRIFT_Z`` sigmas
for the sentinel), tagged ``detector=``/``kernel=``; the raw
statistics ride ``drift.pred_shift`` (prediction PSI) and
``drift.eval_decay`` (sentinel z).  Crossing 1.0 emits one
``online.drift`` event per (detector, kernel) rising edge.  Because
the scores are ordinary gauges, the ``HPNN_ALERTS`` grammar alerts
on them with no engine changes (``shift@drift.score>1``), and an
armed ``HPNN_CAPSULE_DIR`` capsule then bundles :func:`sketch_doc`
as ``drift.json`` — the distribution at the moment it moved.
``health_doc()`` is the drift census on ``/healthz``; schema lint:
``tools/check_obs_catalog.py --drift``; E2E drill:
``tools/chaos_drill.py --drill drift``; overhead gate:
``bench.py`` ``drift_overhead_pct``.

Contract (the usual obs rules, proven by tools/check_tokens.py):
``HPNN_DRIFT`` unset ⇒ one env read ever, then every tap is a
constant-time early return; never a stdout byte; stdlib at import —
numpy is imported lazily and only on armed paths whose callers
already hold numpy arrays.
"""

from __future__ import annotations

import math
import os
import threading

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_DRIFT"
ENV_WINDOW = "HPNN_DRIFT_WINDOW"
ENV_Z = "HPNN_DRIFT_Z"

DEFAULT_WINDOW = 128
WINDOW_FLOOR = 16
DEFAULT_Z = 3.0
PSI_BREACH = 0.25     # classic "significant shift" PSI bound
_BINS = 8             # quantile-histogram bins
_STRIDE = 16          # rows staged per sketch fold: the PSI recompute
                      # and gauge publish are amortized over this many
                      # rows so single-row serve dispatches pay only a
                      # list append most calls (the overhead bench
                      # holds drift_overhead_pct under the 5% bar)
# Sentinel EWMA weight (matches the alert engine's z rule,
# obs/alerts.py).  Note the statistic's shape: against a *sustained*
# ramp — what a drifting stream actually produces once holdout
# turnover smears the step — the z asymptotes at sqrt((1-a)/a) ~= 2,
# so deployments watching slow decay should arm HPNN_DRIFT_Z below
# the step-change default of 3 (the drift drill uses 1.2).
_ALPHA = 0.2
_WARMUP = 10          # sentinel evals before the z-score speaks
_MAX_KERNELS = 64     # per-kernel sketch cap (fleets are small)

# None = env not read yet; False = disabled; dict = armed config
_cfg: dict | bool | None = None
_lock = threading.Lock()

_ingest = None                 # _IngestSketch (one shared stream)
_pred: dict[str, object] = {}  # kernel -> _PredSketch
_eval: dict[str, object] = {}  # kernel -> _EvalEwma
_over: dict[tuple, bool] = {}  # (detector, kernel) -> above bound?


def _knob(env: str, default, convert=float):
    """Parse one secondary knob; a malformed value warns on stderr and
    falls back to its documented default, leaving detection armed."""
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return convert(raw)
    except ValueError:
        import sys

        sys.stderr.write(f"hpnn obs: bad {env} value {raw!r}; "
                         f"using default {default}\n")
        return default


def _config() -> dict | None:
    global _cfg
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                raw = os.environ.get(ENV_KNOB, "")
                if not raw or raw == "0":
                    _cfg = False
                else:
                    window = max(WINDOW_FLOOR,
                                 int(_knob(ENV_WINDOW,
                                           DEFAULT_WINDOW, int)))
                    z = float(_knob(ENV_Z, DEFAULT_Z))
                    _cfg = {"window": window,
                            "z": z if z > 0 else DEFAULT_Z,
                            "min_rows": max(8, window // 4)}
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when ``HPNN_DRIFT`` is armed.  First call reads the env;
    later calls are a memo hit — the taps' whole unarmed cost."""
    return _config() is not None


def _rl(a) -> list:
    import numpy as np

    return np.round(np.asarray(a, dtype=np.float64), 5).tolist()


def _psi(ref_counts, live_counts) -> float:
    """Mean-over-features Population Stability Index between two
    bin-count histograms (eps-smoothed so empty bins stay finite).
    Accepts ``(bins,)`` vectors or ``(bins, features)`` matrices.
    Debiased by the chi-square null expectation — finite windows
    inflate raw PSI by ~``(k-1)(1/n_ref + 1/n_live)`` even when
    nothing moved, which at window 32 already exceeds the 0.25
    breach bound — so small-window scores are conservative rather
    than false-positive factories."""
    import numpy as np

    eps = 0.5
    p0 = np.asarray(ref_counts, dtype=np.float64)
    q0 = np.asarray(live_counts, dtype=np.float64)
    n_p = p0.sum(axis=0)
    n_q = q0.sum(axis=0)
    k = p0.shape[0]
    p = (p0 + eps) / (n_p + k * eps)
    q = (q0 + eps) / (n_q + k * eps)
    psi = np.sum((q - p) * np.log(q / p), axis=0)
    bias = (k - 1) * (1.0 / np.maximum(n_p, 1.0)
                      + 1.0 / np.maximum(n_q, 1.0))
    return float(np.mean(np.maximum(psi - bias, 0.0)))


class _IngestSketch:
    """Frozen-reference / sliding-live quantile histograms over the
    ingest stream.  The first ``window`` rows become the reference
    (per-feature quantile bin edges + counts, mean/std); after the
    freeze a ring of the last ``window`` rows is binned against the
    frozen edges with incrementally-maintained counts, and the PSI is
    recomputed per ``_STRIDE``-row fold once ``min_rows`` live
    samples exist."""

    def __init__(self, window: int, min_rows: int):
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.n_features: int | None = None
        self.seen = 0
        self._pending: list = []   # staged row blocks (push)
        self._npend = 0
        self._fill: list = []      # reference rows until frozen
        self.ref_mean = None
        self.ref_std = None
        self.edges = None          # (_BINS-1, F) frozen quantiles
        self.ref_counts = None     # (_BINS, F)
        self._vals = None          # (window, F) live value ring
        self._bins = None          # (window, F) live bin-id ring
        self.live_counts = None    # (_BINS, F)
        self.live_n = 0
        self._pos = 0
        self._cols = None          # np.arange(F) scatter index
        self.psi: float | None = None

    def _binify(self, X):
        import numpy as np

        return (X[:, None, :] > self.edges[None, :, :]).sum(
            axis=1, dtype=np.int64)

    def _freeze(self) -> None:
        import numpy as np

        R = np.stack(self._fill)
        self._fill = []
        n_f = R.shape[1]
        self.ref_mean = R.mean(axis=0)
        self.ref_std = R.std(axis=0)
        qs = np.linspace(0.0, 1.0, _BINS + 1)[1:-1]
        self.edges = np.quantile(R, qs, axis=0)
        bins = self._binify(R)
        self.ref_counts = np.zeros((_BINS, n_f), dtype=np.int64)
        for b in range(_BINS):
            self.ref_counts[b] = (bins == b).sum(axis=0)
        self._vals = np.zeros((self.window, n_f))
        self._bins = np.zeros((self.window, n_f), dtype=np.int64)
        self.live_counts = np.zeros((_BINS, n_f), dtype=np.int64)
        self._cols = np.arange(n_f)

    def push(self, X) -> float | None:
        """Cheap tap entry: stage the block and fold every
        ``_STRIDE`` rows (blocks that size or larger fold
        immediately, so the drill's per-round feeds score per call).
        """
        if self.n_features is None:
            self.n_features = int(X.shape[1])
        self._pending.append(X)
        self._npend += int(X.shape[0])
        if self._npend < _STRIDE:
            return None
        import numpy as np

        blk = (self._pending[0] if len(self._pending) == 1
               else np.concatenate(self._pending))
        self._pending = []
        self._npend = 0
        return self.add(blk)

    def add(self, X) -> float | None:
        import numpy as np

        if self.n_features is None:
            self.n_features = int(X.shape[1])
        self.seen += int(X.shape[0])
        if self.edges is None:
            need = self.window - len(self._fill)
            self._fill.extend(np.asarray(r) for r in X[:need])
            X = X[need:]
            if len(self._fill) >= self.window:
                self._freeze()
            if X.shape[0] == 0:
                return None
        bins = self._binify(X)
        for i in range(X.shape[0]):
            if self.live_n == self.window:
                self.live_counts[self._bins[self._pos],
                                 self._cols] -= 1
            else:
                self.live_n += 1
            self._vals[self._pos] = X[i]
            self._bins[self._pos] = bins[i]
            self.live_counts[bins[i], self._cols] += 1
            self._pos = (self._pos + 1) % self.window
        if self.live_n < self.min_rows:
            return None
        self.psi = _psi(self.ref_counts, self.live_counts)
        return self.psi

    def dump(self) -> dict:
        import numpy as np

        out = {"rows_seen": self.seen, "window": self.window,
               "frozen": self.edges is not None, "psi": self.psi,
               "reference": None, "live": None}
        if self.edges is not None:
            out["reference"] = {
                "rows": self.window,
                "mean": _rl(self.ref_mean), "std": _rl(self.ref_std),
                "edges": _rl(self.edges),
                "counts": self.ref_counts.tolist()}
            if self.live_n:
                vals = self._vals[:self.live_n]
                out["live"] = {
                    "rows": self.live_n,
                    "mean": _rl(vals.mean(axis=0)),
                    "std": _rl(vals.std(axis=0)),
                    "counts": self.live_counts.tolist()}
        elif self._fill:
            R = np.stack(self._fill)
            out["reference"] = {"rows": len(R), "partial": True,
                                "mean": _rl(R.mean(axis=0)),
                                "std": _rl(R.std(axis=0))}
        return out


class _PredSketch:
    """Frozen-reference / sliding-live sketch of one kernel's serve
    outputs: winning-class frequencies (``n_out`` bins) + winning
    output value ("confidence") quantile histogram.  The PSI is the
    max of the two components — a pure class-mix move and a pure
    confidence collapse are both visible."""

    def __init__(self, window: int, min_rows: int, n_out: int):
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.n_out = int(n_out)
        self.seen = 0
        self._pending: list = []   # staged output blocks (push)
        self._npend = 0
        self._fill_cls: list = []
        self._fill_conf: list = []
        self.ref_cls = None       # (n_out,) reference class counts
        self.conf_edges = None    # (_BINS-1,) frozen quantiles
        self.ref_conf = None      # (_BINS,) reference conf counts
        self._cls = None          # (window,) live class ring
        self._conf = None         # (window,) live conf-bin ring
        self.live_cls = None
        self.live_conf = None
        self.live_n = 0
        self._pos = 0
        self.psi: float | None = None

    def _conf_bins(self, conf):
        return (conf[:, None] > self.conf_edges[None, :]).sum(axis=1)

    def _freeze(self) -> None:
        import numpy as np

        cls = np.asarray(self._fill_cls, dtype=np.int64)
        conf = np.asarray(self._fill_conf, dtype=np.float64)
        self._fill_cls = []
        self._fill_conf = []
        self.ref_cls = np.bincount(cls, minlength=self.n_out)
        qs = np.linspace(0.0, 1.0, _BINS + 1)[1:-1]
        self.conf_edges = np.quantile(conf, qs)
        self.ref_conf = np.bincount(self._conf_bins(conf),
                                    minlength=_BINS)
        self._cls = np.zeros(self.window, dtype=np.int64)
        self._conf = np.zeros(self.window, dtype=np.int64)
        self.live_cls = np.zeros(self.n_out, dtype=np.int64)
        self.live_conf = np.zeros(_BINS, dtype=np.int64)

    def push(self, O) -> float | None:
        """Cheap tap entry: stage the block and fold every
        ``_STRIDE`` rows — the argmax/PSI/publish cost is amortized
        so per-request dispatch stays hot-path affordable."""
        self._pending.append(O)
        self._npend += int(O.shape[0])
        if self._npend < _STRIDE:
            return None
        import numpy as np

        blk = (self._pending[0] if len(self._pending) == 1
               else np.concatenate(self._pending))
        self._pending = []
        self._npend = 0
        return self.add(blk)

    def add(self, O) -> float | None:
        import numpy as np

        cls = np.argmax(O, axis=1).astype(np.int64)
        conf = np.max(O, axis=1).astype(np.float64)
        self.seen += int(O.shape[0])
        if self.conf_edges is None:
            need = self.window - len(self._fill_cls)
            self._fill_cls.extend(int(c) for c in cls[:need])
            self._fill_conf.extend(float(c) for c in conf[:need])
            cls, conf = cls[need:], conf[need:]
            if len(self._fill_cls) >= self.window:
                self._freeze()
            if cls.shape[0] == 0:
                return None
        cbins = self._conf_bins(conf)
        for i in range(cls.shape[0]):
            if self.live_n == self.window:
                self.live_cls[self._cls[self._pos]] -= 1
                self.live_conf[self._conf[self._pos]] -= 1
            else:
                self.live_n += 1
            self._cls[self._pos] = cls[i]
            self._conf[self._pos] = cbins[i]
            self.live_cls[cls[i]] += 1
            self.live_conf[cbins[i]] += 1
            self._pos = (self._pos + 1) % self.window
        if self.live_n < self.min_rows:
            return None
        self.psi = max(_psi(self.ref_cls, self.live_cls),
                       _psi(self.ref_conf, self.live_conf))
        return self.psi

    def dump(self) -> dict:
        out = {"rows_seen": self.seen, "window": self.window,
               "frozen": self.conf_edges is not None, "psi": self.psi,
               "reference": None, "live": None}
        if self.conf_edges is not None:
            out["reference"] = {
                "rows": self.window,
                "class_counts": self.ref_cls.tolist(),
                "conf_edges": _rl(self.conf_edges),
                "conf_counts": self.ref_conf.tolist()}
            if self.live_n:
                out["live"] = {"rows": self.live_n,
                               "class_counts": self.live_cls.tolist(),
                               "conf_counts": self.live_conf.tolist()}
        return out


class _EvalEwma:
    """EWMA mean/variance of one kernel's resident held-out loss —
    same judge-before-fold math as the alert engine's z rule
    (obs/alerts.py): an anomaly must not hide inside its own
    statistics.  The z is *signed* — only decay (loss above the
    mean) drives the score."""

    __slots__ = ("n", "mean", "var", "z")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self.z = 0.0

    def add(self, v: float) -> float:
        std = math.sqrt(self.var) if self.var > 0 else 0.0
        if self.n < _WARMUP:
            z = 0.0
        elif std > 0:
            # capped so the record stays JSON-finite for the lint
            z = max(-1e9, min((v - self.mean) / std, 1e9))
        else:
            z = 1e9 if v > self.mean else 0.0
        self.n += 1
        if self.n == 1:
            self.mean = v
        else:
            d = v - self.mean
            self.mean += _ALPHA * d
            self.var = (1 - _ALPHA) * (self.var + _ALPHA * d * d)
        self.z = z
        return z

    def dump(self) -> dict:
        return {"n": self.n, "ewma_mean": round(self.mean, 9),
                "ewma_var": round(self.var, 9), "z": round(self.z, 3)}


def _publish(detector: str, kernel: str, score: float, cfg: dict, *,
             raw: float, gauge: str | None = None, **extra) -> None:
    """Emit the detector's gauges and, on the rising edge of its
    normalized score crossing 1.0, one ``online.drift`` event.  Runs
    outside the state lock — the gauge path fans into the alert
    engine (and from there the capsule trigger), which must never
    nest under it."""
    score = float(min(score, 1e9))
    registry.gauge("drift.score", round(score, 6),
                   detector=detector, kernel=kernel)
    if gauge is not None:
        registry.gauge(gauge, raw, kernel=kernel)
    key = (detector, kernel)
    with _lock:
        was = _over.get(key, False)
        over = score >= 1.0
        _over[key] = over
    if over and not was:
        registry.event("online.drift", detector=detector,
                       kernel=kernel, score=round(score, 6),
                       window=cfg["window"], raw=raw, **extra)


def note_ingest(x) -> None:
    """Ingest tap (online/ingest.py:SampleBuffer.feed): fold one
    ``(R, n_in)`` sample block into the stream sketch (staged; the
    sketch folds and scores every ``_STRIDE`` rows).  Constant-time
    no-op when unarmed."""
    cfg = _config()
    if cfg is None:
        return
    import numpy as np

    X = np.atleast_2d(np.asarray(x, dtype=np.float64))
    if X.ndim != 2 or X.shape[0] == 0:
        return
    global _ingest
    with _lock:
        sk = _ingest
        if sk is None or sk.n_features not in (None, X.shape[1]):
            sk = _ingest = _IngestSketch(cfg["window"],
                                         cfg["min_rows"])
        psi = sk.push(X)
        if psi is None:
            return
        n_live = sk.live_n
    _publish("ingest", "stream", psi / PSI_BREACH, cfg,
             raw=round(psi, 6), n_live=n_live)


def note_pred(kernel: str, out) -> None:
    """Serve tap (serve/engine.py dispatch): fold one host-side
    ``(R, n_out)`` output block into the kernel's prediction sketch
    (staged; the sketch folds and scores every ``_STRIDE`` rows).
    Constant-time no-op when unarmed."""
    cfg = _config()
    if cfg is None:
        return
    import numpy as np

    O = np.atleast_2d(np.asarray(out, dtype=np.float64))
    if O.ndim != 2 or O.shape[0] == 0 or O.shape[1] < 2:
        return
    with _lock:
        sk = _pred.get(kernel)
        if sk is None or sk.n_out != O.shape[1]:
            if sk is None and len(_pred) >= _MAX_KERNELS:
                return
            sk = _pred[kernel] = _PredSketch(
                cfg["window"], cfg["min_rows"], O.shape[1])
        psi = sk.push(O)
        if psi is None:
            return
        n_live = sk.live_n
    _publish("pred", kernel, psi / PSI_BREACH, cfg,
             raw=round(psi, 6), gauge="drift.pred_shift",
             n_live=n_live)


def note_eval(kernel: str, loss) -> None:
    """Trainer tap (online/trainer.py): fold one resident held-out
    eval loss into the kernel's decay sentinel.  Constant-time no-op
    when unarmed."""
    cfg = _config()
    if cfg is None:
        return
    v = float(loss)
    if not math.isfinite(v):
        return
    with _lock:
        ew = _eval.get(kernel)
        if ew is None:
            if len(_eval) >= _MAX_KERNELS:
                return
            ew = _eval[kernel] = _EvalEwma()
        z = ew.add(v)
        n = ew.n
    _publish("eval", kernel, max(z, 0.0) / cfg["z"], cfg,
             raw=round(z, 6), gauge="drift.eval_decay", n=n)


def sketch_doc() -> dict | None:
    """The ``drift.json`` capsule artifact (obs/triggers.py): full
    reference + live sketch dump, scores, and window bounds — the
    forensic record of the distribution at capture time.  None when
    unarmed."""
    cfg = _config()
    if cfg is None:
        return None
    with _lock:
        return {
            "window": cfg["window"],
            "z_limit": cfg["z"],
            "psi_breach": PSI_BREACH,
            "ingest": _ingest.dump() if _ingest is not None else None,
            "pred": {k: s.dump() for k, s in sorted(_pred.items())},
            "eval": {k: e.dump() for k, e in sorted(_eval.items())},
            "over": sorted(f"{d}:{k}" for (d, k), o in _over.items()
                           if o),
        }


def health_doc() -> dict:
    """The drift census for ``/healthz``."""
    cfg = _config()
    if cfg is None:
        return {"armed": False}
    with _lock:
        doc = {"armed": True, "window": cfg["window"],
               "z_limit": cfg["z"], "psi_breach": PSI_BREACH,
               "over": sorted(f"{d}:{k}" for (d, k), o in _over.items()
                              if o)}
        if _ingest is not None:
            doc["ingest"] = {"rows_seen": _ingest.seen,
                             "frozen": _ingest.edges is not None,
                             "live_rows": _ingest.live_n,
                             "psi": _ingest.psi}
        doc["pred"] = {k: {"rows_seen": s.seen, "psi": s.psi}
                       for k, s in sorted(_pred.items())}
        doc["eval"] = {k: e.dump() for k, e in sorted(_eval.items())}
    return doc


def configure(value, *, window=None, z=None) -> None:
    """Programmatic twin of the env knobs: arm drift detection with
    any truthy ``value`` — or disarm with None/""/0, which also
    clears the secondary knobs — optionally pinning the window / z,
    and forget the memo.  Callers re-running ``obs.configure``
    afterwards also refresh the registry's file-less activation."""
    if not value or value == "0":
        for env in (ENV_KNOB, ENV_WINDOW, ENV_Z):
            os.environ.pop(env, None)
    else:
        os.environ[ENV_KNOB] = str(value)
        if window is not None:
            os.environ[ENV_WINDOW] = str(int(window))
        if z is not None:
            os.environ[ENV_Z] = str(float(z))
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _ingest
    with _lock:
        _cfg = None
        _ingest = None
        _pred.clear()
        _eval.clear()
        _over.clear()
