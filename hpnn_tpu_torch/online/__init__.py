"""Train-while-serve: continuous online learning in one resident
process (the port of ``hpnn_tpu/online/``; PAPER.md §0's "trained on
the fly" story).

The pieces, each its own module:

* :mod:`~hpnn_tpu_torch.online.ingest` — :class:`SampleBuffer`, the bounded
  streaming sample store (ring + optional reservoir replay + held-out
  eval diversion), fed by ``OnlineSession.feed()`` and the serve
  server's ``POST /ingest`` route.
* :mod:`~hpnn_tpu_torch.online.trainer` — :class:`OnlineTrainer`, the
  background thread that snapshots the buffer and trains candidate
  weights on the scan-ordered bank (``train/fleet.py``): kernel #4 for a
  kernel alone, one launch of kernel #6 an epoch when several
  same-topology kernels ride the same stream, on the trainer's own CUDA
  stream.
* :mod:`~hpnn_tpu_torch.online.promote` — the sentinel + eval gate and the
  atomic in-memory promotion (``Registry.install``) with rollback.
* :mod:`~hpnn_tpu_torch.online.session` — :class:`OnlineSession`, the
  facade wiring all of it onto a ``serve.Session``.
* :mod:`~hpnn_tpu_torch.online.streams` — the demo stream generators
  (MNIST-stream, synthetic XRD-stream).
* :mod:`~hpnn_tpu_torch.online.wal` — crash-safe promotion durability: the
  append-only promotion WAL + atomic bitwise weight checkpoints
  (``HPNN_WAL_DIR``), replayed by ``OnlineSession.add_kernel`` so a
  restarted process resumes the last promoted weights
  (docs/resilience.md).

Knobs (``HPNN_ONLINE_*``) are read once at construction time and
nothing outside this package touches them — an unset knob costs
nothing anywhere (proved for the JAX package in
``tools/check_tokens.py``).  Catalog and
architecture: docs/online.md.
"""

from hpnn_tpu_torch.online.ingest import SampleBuffer
from hpnn_tpu_torch.online.promote import Gate, Promoter, eval_loss
from hpnn_tpu_torch.online.session import OnlineSession
from hpnn_tpu_torch.online.trainer import OnlineTrainer
from hpnn_tpu_torch.online.wal import PromotionWAL

__all__ = [
    "SampleBuffer",
    "Gate",
    "Promoter",
    "eval_loss",
    "OnlineSession",
    "OnlineTrainer",
    "PromotionWAL",
]
