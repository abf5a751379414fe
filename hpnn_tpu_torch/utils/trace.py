"""DBG_TRACE twin — the reference's cross-backend numeric oracle (the
port of ``hpnn_tpu/utils/trace.py``, the same lines from the same call
sites).

The reference instruments its kernels with abs-sum traces to compare
backends (``DBG_TRACE`` sum-print `#DBG: acc=%.15f`,
ref: include/libhpnn/ann.h:29-33; CUDA ``cublasDasum`` variant,
ref: include/libhpnn/common.h:486-490), and its ChangeLog pins the
cross-backend agreement bars with them (≤1e-14 data vectors, ≤1e-12
weight matrices).  Set ``HPNN_TRACE=1`` and every driver emits

    #DBG: acc[<tag>/<layer>]=<abs-sum>

lines to stdout — per sample (streaming per-sample path), per fused
chunk, per batch dispatch block, and per eval output vector — on any
device and dtype, so a card run can be diffed line for line against a
CPU run of the same protocol, or against the JAX package's.

Abs-sum (the CUDA variant's reduction), not the plain sum of the CPU
macro: sign cancellations can hide real drift.  The traces are
unconditional once enabled — the env var IS the -vvv-style knob, so
parity scripts don't have to thread verbosity through.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from hpnn_tpu_torch.utils import logging as log


# HPNN_TRACE is read ONCE and memoized: enabled() sits inside the
# per-sample token loops (driver streaming path calls trace() per
# sample), and a getenv per call is a dict lookup + string compare paid
# 60k times per round for a knob that cannot meaningfully change
# mid-process.  Tests flip the env var, so they reset the memo through
# _reset_for_tests().
_enabled_memo: bool | None = None


def enabled() -> bool:
    global _enabled_memo
    e = _enabled_memo
    if e is None:
        e = os.environ.get("HPNN_TRACE", "") not in ("", "0")
        _enabled_memo = e
    return e


def _reset_for_tests() -> None:
    """Forget the memoized HPNN_TRACE reading (chained from the obs
    registry's reset)."""
    global _enabled_memo
    _enabled_memo = None


def trace(tag: str, arrays) -> None:
    """Emit one ``#DBG`` line per array in ``arrays`` (tensors or host
    arrays; card tensors are fetched — only pay that when the knob is
    on).  The abs-sum runs on the host in the array's own dtype."""
    if not enabled():
        return
    for l, a in enumerate(arrays):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        acc = float(np.abs(np.asarray(a)).sum())
        log.nn_write(sys.stdout, "#DBG: acc[%s/%i]=%.15f\n", tag, l, acc)
    log.flush()
