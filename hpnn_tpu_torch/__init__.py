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

The package imports ``torch``, ``numpy`` and the standard library only;
it keeps its own copies of the host modules it shares with the JAX
package (file formats, the glibc stream, logging, the native host
library ``csrc/hpnn_native.cpp``, obs).
"""

__version__ = "0.1.0"
