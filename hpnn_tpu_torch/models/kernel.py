"""The ``Kernel``: the network's weights as host numpy arrays, and the
bridge to torch tensors.

Replaces the reference's ``kernel_ann`` struct
(ref: libhpnn include/libhpnn/ann.h:35-55) — flat row-major
weight matrices per layer — with a tuple of ``(N, M)`` numpy arrays.
The JAX package's parameters are the same plain arrays, so
:func:`to_torch` / :func:`to_numpy` are the whole conversion between
the two packages.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from hpnn_tpu_torch.fileio import checkpoint, kernel_format
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.utils.glibc_random import RAND_MAX, GlibcRandom


class Kernel(NamedTuple):
    """weights[l] has shape (n_neurons_l, n_inputs_l), row-major.

    Layers 0..n-2 are the hidden layers, layer n-1 is the output layer
    (the reference's ``hiddens[]`` + ``output``).
    """

    weights: tuple

    @property
    def n_inputs(self) -> int:
        return self.weights[0].shape[1]

    @property
    def n_outputs(self) -> int:
        return self.weights[-1].shape[0]

    @property
    def n_hiddens(self) -> int:
        return len(self.weights) - 1

    @property
    def hidden_sizes(self) -> tuple[int, ...]:
        return tuple(w.shape[0] for w in self.weights[:-1])


def generate(
    seed: int,
    n_inputs: int,
    hiddens: Sequence[int],
    n_outputs: int,
) -> tuple[Kernel, int]:
    """Seeded random f64 kernel, bit-identical to ``ann_generate``.

    Weights are drawn layer by layer (hiddens first, then output) in
    row-major order from the glibc stream:
    ``w = 2*(random()/RAND_MAX - 0.5)/sqrt(M)``
    (ref: libhpnn src/ann.c:653-677,700-706).

    Returns (kernel, effective_seed) — seed 0 is replaced by current
    time, as the reference does (ref: src/ann.c:653).
    """
    if seed == 0:
        seed = int(time.time())
    sizes = list(hiddens) + [n_outputs]
    inputs = [n_inputs] + list(hiddens)
    rng = GlibcRandom(seed)
    weights = []
    for n, m in zip(sizes, inputs):
        # division (not multiply-by-reciprocal): bit-identical to the
        # reference's 2*(u-0.5)/sqrt(M) (ref: src/ann.c:677)
        sqrt_m = np.sqrt(float(m))
        vals = np.empty(n * m, dtype=np.float64)
        for j in range(n * m):
            vals[j] = 2.0 * (rng.random() / RAND_MAX - 0.5) / sqrt_m
        weights.append(vals.reshape(n, m))
    return Kernel(tuple(weights)), seed


def zeros_like_momentum(kernel: Kernel) -> Kernel:
    """Momentum ``dw`` arrays (ref: ``ann_momentum_init``, src/ann.c:1876)."""
    return Kernel(tuple(np.zeros_like(np.asarray(w)) for w in kernel.weights))


def validate(kernel: Kernel) -> bool:
    """Shape chain check (ref: ``ann_validate_kernel``, src/ann.c:862-879)."""
    if len(kernel.weights) < 2:
        return False
    for a, b in zip(kernel.weights[:-1], kernel.weights[1:]):
        if b.shape[1] != a.shape[0]:
            return False
    return all(w.shape[0] >= 1 and w.shape[1] >= 1 for w in kernel.weights)


def load(path: str) -> tuple[str, Kernel]:
    """Kernel file (reference text grammar) or promotion checkpoint."""
    if checkpoint.is_checkpoint(path):
        name, ws, _ = checkpoint.load_checkpoint(path)
    else:
        name, ws = kernel_format.load_kernel(path)
    k = Kernel(tuple(ws))
    if not validate(k):
        raise kernel_format.KernelFormatError(f"inconsistent kernel file {path}")
    return name, k


def dump(name: str, kernel: Kernel, fp) -> None:
    kernel_format.dump_kernel(
        name, [np.asarray(w, dtype=np.float64) for w in kernel.weights], fp
    )


def to_torch(weights_np, dw_np=None, *, device, dtype):
    """Host arrays -> ``(weights, dw)`` tuples of contiguous tensors on
    ``device`` in ``dtype``; ``dw`` is ``()`` when ``dw_np`` is None.
    The tensors are copies, never views of the arrays, so the kernels'
    in-place updates leave the host arrays as they were."""

    def conv(arrs):
        return tuple(
            torch.tensor(np.asarray(a), device=device, dtype=dtype) for a in arrs
        )

    return conv(weights_np), (conv(dw_np) if dw_np is not None else ())


def to_numpy(weights, dw=()):
    """Inverse of :func:`to_torch`: ``(weights_np, dw_np)`` host arrays
    in the tensors' own dtype."""

    def conv(ts):
        return tuple(t.detach().cpu().numpy() for t in ts)

    return conv(weights), conv(dw)


class KernelModule(torch.nn.Module):
    """A kernel's weights held as buffers, for evaluation: ``forward``
    maps a ``(B, n_in)`` batch to the ``(B, n_out)`` outputs."""

    def __init__(self, weights, *, model: str = "ann"):
        super().__init__()
        self.model = model
        self.n_layers = len(weights)
        for i, w in enumerate(weights):
            self.register_buffer(f"w{i}", w)

    def weights(self) -> tuple:
        return tuple(getattr(self, f"w{i}") for i in range(self.n_layers))

    def forward(self, X):
        mod = snn if self.model == "snn" else ann
        return mod.run_batch(self.weights(), X)
