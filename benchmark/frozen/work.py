"""Work counts and peaks of the yardstick.

A frozen copy of ``hpnn_tpu_torch/obs/cost.py`` (``PEAK_BYTES`` and
``PEAK_FLOPS`` at :45-46, ``work_of`` at :65, ``batch_work`` at :80,
``forward_work`` at :96, ``bound_ms`` at :108), kept here so that a
change to the program cannot change what its work is counted as.

The peaks are the NVIDIA H100 SXM data sheet's, dense, outside the
tensor cores for float32 and float64: 3.35 TB/s of HBM3, 67 TFLOP/s in
float32, 34 TFLOP/s in float64, 989 TFLOP/s in bfloat16.  They assume
the card's full 700 W power limit; the harness prints the card's own
limit beside every reading.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}


def work_of(shapes, S, iters, momentum, dtype_bytes):
    """(bytes, flops) one launch of the convergence kernel must move and
    compute: weights read and written once, samples read once, stats
    and outputs written once; per iteration 2|W| (forward) + 2|W_1:|
    (hidden deltas) + 3|W| (BP update) or 5|W| (BPM update) flops, plus
    a forward per sample.  ``shapes`` are the layers' ``(out, in)``;
    ``iters`` is the iterations the launch ran, summed over its ``S``
    samples."""
    sizes = [o * i for o, i in shapes]
    n_w, n_tail = sum(sizes), sum(sizes[1:])
    n_in, n_out = shapes[0][1], shapes[-1][0]
    nbytes = (2 * n_w + S * (n_in + 2 * n_out + 2)) * dtype_bytes + 12 * S
    flops = 2 * n_w * S + iters * ((7 if momentum else 5) * n_w + 2 * n_tail)
    return nbytes, flops


def batch_work(shapes, S, momentum, dtype_bytes, batch):
    """(bytes, flops) of S batch steps of ``batch`` rows of one member:
    each block of X and T read once, the weights (and dw) read and
    written once, the order and losses; per step three matrix passes of
    2·B·Σ in·out (forward, update, re-forward), the hidden deltas
    2·B·Σ_{l>0} in·out, and the update's elementwise triad (2 flops a
    weight, 4 with momentum)."""
    sizes = [o * i for o, i in shapes]
    n_w, n_tail = sum(sizes), sum(sizes[1:])
    n_in, n_out = shapes[0][1], shapes[-1][0]
    nbytes = ((S * batch * (n_in + n_out) + 2 * n_w * (2 if momentum else 1) + S)
              * dtype_bytes + 4 * S)
    flops = S * (6 * batch * n_w + 2 * batch * n_tail + (4 if momentum else 2) * n_w)
    return nbytes, flops


def forward_work(shapes, rows, dtype_bytes):
    """(bytes, flops) of one batched forward of ``rows`` rows: the
    weights read once, the input block read and the output block
    written once; 2·rows·Σ in·out flops."""
    n_w = sum(o * i for o, i in shapes)
    n_in, n_out = shapes[0][1], shapes[-1][0]
    return (n_w + rows * (n_in + n_out)) * dtype_bytes, 2 * rows * n_w


def bound_s(nbytes, flops, dtype_name):
    """(seconds, "bytes" or "operations"): the least time an H100 takes
    for this work, the larger of bytes over its memory rate and
    operations over its peak for ``dtype_name``."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
