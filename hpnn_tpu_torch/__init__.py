"""hpnn_tpu_torch — the PyTorch/CUDA port of hpnn_tpu.

The faithful per-sample path of libhpnn: ``.conf`` parsing, glibc-seeded
kernel generation and sample shuffling, the BP/BPM convergence
do-while (one hand-written CUDA kernel per chunk of samples on the
GPU, ``ops/convergence.py``), and the ``train_nn``/``run_nn`` token
protocol.  Entry points run on ``cuda`` unless the caller asks for the
CPU (``--device cpu`` on the CLIs, ``device=`` in the library).

The package imports ``torch``, ``numpy`` and the standard library only;
it keeps its own copies of the host modules it shares with the JAX
package (file formats, the glibc stream, logging).
"""

__version__ = "0.1.0"
