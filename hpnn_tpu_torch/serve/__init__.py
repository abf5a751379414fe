"""Resident inference serving (``hpnn_tpu_torch.serve``): the port of
``hpnn_tpu/serve``, with the same exports.

The reference embeds a trained kernel in a host program and queries it
"on the fly"; this package keeps that kernel (or several) *resident*
behind a micro-batching queue and a bucketed cache of captured
forwards, so many concurrent small queries amortize into batches on the
card with zero steady-state captures.  Layers, bottom up:

* :mod:`~hpnn_tpu_torch.serve.registry` — named kernels, validation,
  hot-reload (version-bumped immutable entries);
* :mod:`~hpnn_tpu_torch.serve.engine` — power-of-two shape buckets, one
  cached forward per (kernel, version, bucket, dtype, policy): one CUDA
  graph of the batched forward on the card, the bitwise per-row path in
  CPU parity mode;
* :mod:`~hpnn_tpu_torch.serve.batcher` — bounded coalescing queue with
  deadlines, explicit backpressure, and SLO-driven load shedding;
* :mod:`~hpnn_tpu_torch.serve.server` — :class:`Session` (the
  in-process embedding API) and the stdlib HTTP front end;
* :mod:`~hpnn_tpu_torch.serve.conn` — connection-plane telemetry and
  guards under the HTTP front end (``HPNN_CONN_*``);
* :mod:`~hpnn_tpu_torch.serve.replica` /
  :mod:`~hpnn_tpu_torch.serve.router` — N device-pinned Session
  replicas behind a least-outstanding-requests router with
  shed/unready awareness and fence-ordered promotion fan-out;
* :mod:`~hpnn_tpu_torch.serve.compile_cache` — the process's hit/miss
  census of captured forwards.

``import hpnn_tpu_torch.serve`` pulls in neither jax nor the JAX
package.  Architecture and semantics: docs/serving.md.
"""

from hpnn_tpu_torch.serve import compile_cache, conn
from hpnn_tpu_torch.serve.batcher import Batcher, DeadlineExceeded, QueueFull, Shed
from hpnn_tpu_torch.serve.engine import Engine, bucket_for, bucket_menu
from hpnn_tpu_torch.serve.registry import Entry, Registry, RegistryError
from hpnn_tpu_torch.serve.replica import Replica
from hpnn_tpu_torch.serve.router import Router
from hpnn_tpu_torch.serve.server import Session, install_drain, make_server

__all__ = [
    "Batcher",
    "DeadlineExceeded",
    "QueueFull",
    "Shed",
    "Engine",
    "bucket_menu",
    "bucket_for",
    "Entry",
    "Registry",
    "RegistryError",
    "Replica",
    "Router",
    "Session",
    "compile_cache",
    "conn",
    "install_drain",
    "make_server",
]
