"""Memory-accounting aids: the device half of the reference's
``ALLOC_REPORT`` (the port of ``hpnn_tpu/utils/debug.py``'s
``device_alloc_report``).

The host line, ``[CPU] ANN total allocation``, prints where the
reference prints it, at kernel generate/load (``config.py``); the device
line prints from the drivers once the tensors are placed, the
reference's ``[GPU] ANN total allocation`` from ``scuda_ann_allocate``
(ref: libhpnn src/ann.c:199).
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch.utils import logging as log


def device_alloc_report(tensors) -> int:
    """Print ``[GPU] ANN total allocation: N (bytes)`` for ``tensors``
    on a card; nothing when they live on the host (the CPU line covers
    them).  Returns the bytes reported."""
    if not tensors or tensors[0].device.type != "cuda":
        return 0
    total = sum(t.numel() * t.element_size() for t in tensors)
    log.nn_out(sys.stdout, "[GPU] ANN total allocation: %i (bytes)\n", total)
    return total
