"""hpnn_tpu_torch — the PyTorch/CUDA port of hpnn_tpu.

The faithful per-sample path of libhpnn: ``.conf`` parsing, glibc-seeded
kernel generation and sample shuffling, the BP/BPM convergence
do-while (one hand-written CUDA kernel per chunk of samples on the
GPU, ``ops/convergence.py``), and the ``train_nn``/``run_nn`` token
protocol.  Entry points run on ``cuda`` unless the caller asks for the
CPU (``--device cpu`` on the CLIs, ``device=`` in the library).

Beside it: minibatch training (``train/batch.py``) and the fleet
(``train/fleet.py``) on the batch-step kernels (``ops/batch_step.py``),
crash-resume and the streaming loop (``train/driver.py``), and the obs
core (``obs/``: metrics, the checksum ledger, probes, spans, cost).

The library surface is the JAX package's: ``runtime``, ``NNConf``,
``load_conf``, ``generate_kernel``, ``dump_kernel``, ... at import, and
the execute-ops ``train_kernel``, ``run_kernel``,
``train_kernel_batched``, ``run_kernel_batched``, ``read_sample`` and
``serve`` on first touch (docs/api.md's embedding flow, with
``hpnn_tpu_torch`` in place of ``hpnn_tpu``).  Nets of any depth train
on every path.

The package imports ``torch``, ``numpy`` and the standard library only;
it keeps its own copies of the host modules it shares with the JAX
package (file formats, the glibc stream, logging, the native host
library ``csrc/hpnn_native.cpp``, obs).
"""

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.config import (
    NNConf, NNType, NNTrain, load_conf, dump_conf,
    generate_kernel, load_kernel, dump_kernel,
)
from hpnn_tpu_torch.models.kernel import Kernel

__version__ = "0.1.0"

__all__ = [
    "runtime",
    "NNConf",
    "NNType",
    "NNTrain",
    "load_conf",
    "dump_conf",
    "Kernel",
    "generate_kernel",
    "load_kernel",
    "dump_kernel",
    # lazy exports, see __getattr__
    "train_kernel",
    "run_kernel",
    "train_kernel_batched",
    "run_kernel_batched",
    "read_sample",
    "serve",
]

# The execute-ops (`_NN(train,kernel)` / `_NN(run,kernel)`, the
# reference's libhpnn.h:210-215) pull in the training stack; they
# resolve lazily, as in the JAX package, so ``import hpnn_tpu_torch``
# stays light for host programs that only handle confs and kernels.
# They run on ``cuda`` unless given ``device="cpu"``.  The _NN(a,b) ->
# Python map is docs/api.md (with ``hpnn_tpu_torch`` for ``hpnn_tpu``).
_LAZY = {
    "train_kernel": ("hpnn_tpu_torch.train.driver", "train_kernel"),
    "run_kernel": ("hpnn_tpu_torch.train.driver", "run_kernel"),
    "train_kernel_batched": ("hpnn_tpu_torch.train.batch", "train_kernel_batched"),
    "run_kernel_batched": ("hpnn_tpu_torch.train.batch", "run_kernel_batched"),
    "read_sample": ("hpnn_tpu_torch.fileio.samples", "read_sample"),
}


def __getattr__(name):
    import importlib

    if name == "serve":
        # the serving subsystem (serve/), resolved lazily like the
        # execute-ops
        return importlib.import_module("hpnn_tpu_torch.serve")
    if name in _LAZY:
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'hpnn_tpu_torch' has no attribute {name!r}")
