"""Work catalog + MFU gauges (the ``HPNN_COST`` knob): the port of
``hpnn_tpu/obs/cost.py``.

torch has no counterpart of XLA's ``cost_analysis``, so the port counts
the work of each kernel launch from its shapes, with one FLOPs/bytes
count per kernel family that ``chip_smoke.py``'s bound column uses too:

* :func:`work_of` — a launch of the convergence kernel (#1): its bytes
  and operations given the iterations the launch ran;
* :func:`batch_work` — S batch steps of one member (#2-#5; #6 is N
  members' worth);
* :func:`forward_work` — one batched forward of a serve bucket.

:func:`bound_ms` turns a count into the least time an H100 could take,
and :func:`record_dispatch` turns a count and a measured launch time
into the ``perf.flops_per_s`` / ``perf.mfu`` / ``perf.bytes_per_s``
gauges, after one ``compile.cost`` catalog event per entry point (the
JAX package's record schema, so ``tools/check_obs_catalog.py --perf``
reads it).

The peaks are the NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM3,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor
cores, and 989 TFLOP/s dense in bfloat16 on them (the serve engine's
bf16 and int8 policies), at the 700 W power limit.  ``HPNN_PEAK_FLOPS`` (FLOP/s) overrides
the MFU denominator; on the CPU the default is a nominal 100 GFLOP/s,
an indicative trend, not a utilization.

Contract: ``HPNN_COST`` unset ⇒ one env read ever, then constant-time
no-ops, and no launch is synchronized for timing (:func:`synchronize`
waits for the card only when the knob is set); no stdout bytes.
"""

from __future__ import annotations

import os
import threading
import time

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_COST"
PEAK_ENV = "HPNN_PEAK_FLOPS"

# NVIDIA H100 SXM data sheet, dense rates outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
CPU_PEAK_FLOPS = 100e9  # nominal, indicative only

_enabled: bool | None = None
_lock = threading.Lock()
# entry-point name -> its first launch's {"flops", "bytes", "units"}
_catalog: dict[str, dict] = {}


def enabled() -> bool:
    """True when ``HPNN_COST`` is set.  First call reads the env;
    later calls are a memo hit."""
    global _enabled
    if _enabled is None:
        _enabled = bool(os.environ.get(ENV_KNOB))
    return _enabled


# ------------------------------------------------------------ work counts
def work_of(weights, S, iters, momentum, dtype_bytes):
    """(bytes, flops) one launch of the convergence kernel must move and
    compute: weights read and written once, samples read once, stats
    and outputs written once; per iteration 2|W| (forward) + 2|W_1:|
    (hidden deltas) + 3|W| (BP update) or 5|W| (BPM update) flops, plus
    a forward per sample.  ``iters`` is the iterations the launch ran,
    summed over its ``S`` samples."""
    sizes = [int(w.numel()) for w in weights]
    n_w, n_tail = sum(sizes), sum(sizes[1:])
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = (2 * n_w + S * (n_in + 2 * n_out + 2)) * dtype_bytes + 12 * S
    flops = 2 * n_w * S + iters * ((7 if momentum else 5) * n_w + 2 * n_tail)
    return nbytes, flops


def batch_work(weights_shapes, S, momentum, dtype_bytes, batch):
    """(bytes, flops) of S batch steps of ``batch`` rows: each block of
    X and T read once, the weights (and dw) read and written once, the
    order and losses; per step three matrix passes of 2·B·Σ in·out
    (forward, update, re-forward), the hidden deltas 2·B·Σ_{l>0} in·out,
    and the update's elementwise triad (2 flops a weight, 4 with
    momentum)."""
    sizes = [o * i for o, i in weights_shapes]
    n_w, n_tail = sum(sizes), sum(sizes[1:])
    n_in, n_out = weights_shapes[0][1], weights_shapes[-1][0]
    nbytes = ((S * batch * (n_in + n_out) + 2 * n_w * (2 if momentum else 1) + S)
              * dtype_bytes + 4 * S)
    flops = S * (6 * batch * n_w + 2 * batch * n_tail + (4 if momentum else 2) * n_w)
    return nbytes, flops


def forward_work(weights_shapes, rows, dtype_bytes, io_bytes=None):
    """(bytes, flops) of one batched forward of ``rows`` rows (a serve
    bucket): the weights read once in ``dtype_bytes``, the input block
    read and the output block written once in ``io_bytes`` (default
    ``dtype_bytes``); 2·rows·Σ in·out flops of matrix products (the
    activations' elementwise work is not counted)."""
    n_w = sum(o * i for o, i in weights_shapes)
    n_in, n_out = weights_shapes[0][1], weights_shapes[-1][0]
    io = dtype_bytes if io_bytes is None else io_bytes
    return n_w * dtype_bytes + rows * (n_in + n_out) * io, 2 * rows * n_w


def bound_ms(nbytes, flops, dtype_name):
    """(ms, "bytes" or "operations"): the least time an H100 takes for
    this work, the larger of bytes over its memory rate and operations
    over its peak for ``dtype_name``."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_flops(dtype_name: str, device_type: str) -> float:
    """The MFU denominator: ``HPNN_PEAK_FLOPS``, else the H100 peak for
    ``dtype_name`` on ``cuda`` and the nominal CPU rate on ``cpu``."""
    try:
        v = float(os.environ.get(PEAK_ENV, ""))
    except ValueError:
        v = 0.0
    if v > 0.0:
        return v
    if device_type == "cuda":
        return PEAK_FLOPS[dtype_name]
    return CPU_PEAK_FLOPS


# ------------------------------------------------------------ recording
def synchronize(device) -> None:
    """Wait for ``device``'s queued work when ``HPNN_COST`` is set and
    it is a card; a no-op otherwise, so an unset knob times nothing."""
    if enabled() and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)


def catalog() -> dict[str, dict]:
    """A copy of the catalog built so far (test/report surface)."""
    with _lock:
        return {k: dict(v) for k, v in _catalog.items()}


def lookup(name: str) -> dict | None:
    """The cataloged work of one entry point — ``{"flops", "bytes",
    "units"}`` — or None when uncataloged.  The per-tenant meter's
    dispatch join point (obs/meter.py): lock-free, entries are never
    removed outside test resets."""
    return _catalog.get(name)


def record_dispatch(name: str, dt: float, *, nbytes, flops, dtype,
                    device, units: int = 1, **meta) -> None:
    """One launch of entry point ``name``: ``dt`` seconds (synchronized
    on both sides) for ``nbytes`` and ``flops`` of work in ``dtype`` on
    ``device``.  The first launch of a name catalogs it (one
    ``compile.cost`` event); every launch emits the ``perf.*`` gauges.
    A no-op when the knob is unset or ``dt`` is not positive."""
    if not enabled() or not dt or dt <= 0.0:
        return
    dtype_name = str(dtype).split(".")[-1]
    dev_type = getattr(device, "type", str(device))
    with _lock:
        first = name not in _catalog
        if first:
            _catalog[name] = {"flops": float(flops), "bytes": float(nbytes),
                              "units": max(int(units), 1)}
    if first:
        st = registry._active()
        if st is not None:
            rec = {"ev": "compile.cost", "kind": "event", "exe": name,
                   "units": max(int(units), 1), "flops": float(flops),
                   "bytes_accessed": float(nbytes), "dtype": dtype_name,
                   "device": dev_type}
            rec.update(meta)
            registry._emit(st, rec)
    fps = float(flops) / dt
    registry.gauge("perf.flops_per_s", fps, exe=name, **meta)
    registry.gauge("perf.mfu", fps / peak_flops(dtype_name, dev_type),
                   exe=name, **meta)
    registry.gauge("perf.bytes_per_s", float(nbytes) / dt, exe=name, **meta)


def timed_launch(name: str, fn, *, nbytes, flops, dtype, device, **meta):
    """``fn()`` (one launch); under ``HPNN_COST`` synchronized on both
    sides and recorded with :func:`record_dispatch`.  Returns what
    ``fn`` returns."""
    if not enabled():
        return fn()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    record_dispatch(name, time.perf_counter() - t0, nbytes=nbytes, flops=flops,
                    dtype=dtype, device=device, **meta)
    return out


def _reset_for_tests() -> None:
    global _enabled
    with _lock:
        _enabled = None
        _catalog.clear()
