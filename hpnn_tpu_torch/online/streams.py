"""Demo stream generators for the train-while-serve loop (a copy of
``hpnn_tpu/online/streams.py`` over the port's copies of the data
tools: the same seed gives the same samples, byte for byte).

Two infinite generators of ``(x, t)`` float64 pairs, built on the
deterministic synthetic data tools so the online demo needs no
downloads and replays bit-identically per seed:

* :func:`mnist_stream` — randomized 28x28 digit renders
  (``tools/synth_mnist.py``) flattened to 784 pixels in [0, 1] with
  10-way one-hot targets: the paper's classic embedded-training
  workload at streaming cadence.
* :func:`xrd_stream` — synthetic powder-diffraction spectra
  (``tools/synth_rruff.py``'s peak/render model) mean-pooled from the
  fixed 2θ grid down to ``n_in`` bins, max-normalized, with a
  ``classes``-way one-hot over deterministic per-class peak sets:
  the pdif story as a stream.

``take(stream, n)`` collects a block — handy for seeding eval sets.

Nonstationary wrappers (the drift drill's traffic source,
``tools/chaos_drill.py --drill drift``, and the ROADMAP item 4
scenario-suite seed): :func:`label_shift` remaps the one-hot targets
after ``at`` samples (annotation / class-prior shift — the inputs
keep flowing unchanged, the labels lie, and only a held-out decay
sentinel can see it); :func:`rotate` rotates the *inputs* after
``at`` samples (covariate shift — square images rotate about their
centre, 1-D spectra phase-roll), which moves the ingest sketches and
the prediction histograms (obs/drift.py).  Both are deterministic,
pure functions of the underlying stream: same seed, same shifted
replay.
"""

from __future__ import annotations

import numpy as np

MNIST_N_IN = 28 * 28
MNIST_N_OUT = 10


def _one_hot(i: int, n: int) -> np.ndarray:
    t = np.zeros(n, dtype=np.float64)
    t[int(i)] = 1.0
    return t


def mnist_stream(seed: int = 0):
    """Infinite ``(x[784] in [0,1], one-hot t[10])`` generator of
    randomized digit renders (deterministic per seed)."""
    from hpnn_tpu_torch.tools import synth_mnist

    rng = np.random.RandomState(seed)
    while True:
        digit = int(rng.randint(10))
        img = synth_mnist.render(digit, rng)
        x = img.reshape(-1).astype(np.float64) / 255.0
        yield x, _one_hot(digit, MNIST_N_OUT)


def xrd_stream(seed: int = 0, *, n_in: int = 128, classes: int = 8):
    """Infinite ``(x[n_in], one-hot t[classes])`` generator of noisy
    synthetic diffraction spectra.  Each class is a deterministic
    space-group peak set (``class_peaks``); every draw renders a fresh
    noisy spectrum of one class, pooled to ``n_in`` bins and
    max-normalized."""
    from hpnn_tpu_torch.tools import synth_rruff

    rng = np.random.RandomState(seed)
    # stable per-class characteristic peaks (class i -> space group)
    peaks = [synth_rruff.class_peaks(1 + 3 * i, seed)
             for i in range(int(classes))]
    while True:
        cls = int(rng.randint(classes))
        pos, inten = peaks[cls]
        _grid, y, _jp, _ji = synth_rruff.render_spectrum(pos, inten,
                                                         rng)
        # mean-pool the fixed grid down to n_in bins (truncate the
        # remainder so the pooling is exact)
        k = y.shape[0] // n_in
        x = y[:k * n_in].reshape(n_in, k).mean(axis=1)
        peak = x.max()
        if peak > 0:
            x = x / peak
        yield x.astype(np.float64), _one_hot(cls, int(classes))


def label_shift(stream, at: int, mapping):
    """Wrap ``stream`` so that from sample ``at`` onwards every
    one-hot target's class ``c`` is remapped to ``mapping[c]``
    (dict or sequence; classes absent from a dict mapping pass
    through).  The inputs are untouched — this is annotation /
    class-prior shift, the drift mode only a held-out quality signal
    can catch.  Deterministic: a pure function of the wrapped
    stream."""
    at = int(at)
    remap = (dict(mapping) if isinstance(mapping, dict)
             else {i: m for i, m in enumerate(mapping)})
    remap = {int(k): int(v) for k, v in remap.items()}

    def _gen():
        for i, (x, t) in enumerate(stream):
            if i >= at:
                cls = int(np.argmax(t))
                t = _one_hot(remap.get(cls, cls), t.shape[0])
            yield x, t

    return _gen()


def _rotate_square(x: np.ndarray, side: int, angle: float):
    """Nearest-neighbour rotation of a flattened ``side x side``
    image about its centre (pixels mapped from outside the frame are
    zero) — no scipy, bit-stable across runs."""
    img = x.reshape(side, side)
    th = np.deg2rad(float(angle))
    c, s = np.cos(th), np.sin(th)
    ctr = (side - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(side), np.arange(side),
                         indexing="ij")
    # inverse map: source coordinates for each destination pixel
    ys = c * (yy - ctr) + s * (xx - ctr) + ctr
    xs = -s * (yy - ctr) + c * (xx - ctr) + ctr
    yi = np.rint(ys).astype(np.int64)
    xi = np.rint(xs).astype(np.int64)
    ok = (yi >= 0) & (yi < side) & (xi >= 0) & (xi < side)
    out = np.zeros_like(img)
    out[yy[ok], xx[ok]] = img[yi[ok], xi[ok]]
    return out.reshape(-1)


def rotate(stream, at: int, angle: float):
    """Wrap ``stream`` so that from sample ``at`` onwards every input
    is rotated by ``angle`` degrees: flattened square images (e.g.
    :func:`mnist_stream`'s 784 = 28x28 pixels) rotate about the image
    centre with nearest-neighbour resampling; non-square vectors
    (e.g. :func:`xrd_stream` spectra) circular-shift by
    ``angle/360`` of their length — a phase roll.  Targets are
    untouched — this is covariate shift, visible to the ingest
    sketches and the prediction histograms.  Deterministic: a pure
    function of the wrapped stream."""
    at = int(at)

    def _gen():
        for i, (x, t) in enumerate(stream):
            if i >= at:
                side = int(round(np.sqrt(x.shape[0])))
                if side * side == x.shape[0] and side >= 2:
                    x = _rotate_square(x, side, angle)
                else:
                    x = np.roll(
                        x, int(round(x.shape[0] * angle / 360.0)))
            yield x, t

    return _gen()


def take(stream, n: int):
    """Collect ``n`` samples from a stream: ``(X (n, n_in),
    T (n, n_out))`` float64 blocks."""
    xs, ts = [], []
    for _ in range(int(n)):
        x, t = next(stream)
        xs.append(x)
        ts.append(t)
    return np.stack(xs), np.stack(ts)
