"""The ``(data, model)`` mesh of a ``torch.distributed`` world, and
layer-dim padding.

The reference's distributed mode is an MPI row split with the
remainder rows computed redundantly by every rank (ref: libhpnn
src/ann.c:912-936).  The JAX package lays its devices out as a
``jax.sharding.Mesh``; here one process drives one device, so a mesh is
this rank's place in a world of ``n_data * n_model`` ranks, laid out
data-major as the JAX mesh reshapes its devices: rank ``d * n_model +
m`` holds row block ``m`` of every layer for data shard ``d``.  The
collectives of an axis run over that axis' process group: one group a
data row (the ranks of one model axis) and one a model column (the
ranks of one data axis).

Instead of redundant remainder rows each layer's neuron count is padded
up to a multiple of the model axis: padded weight rows and columns are
zero, a fixed point of the forward/backward/update math (act(0) = 0,
zero columns drop out of the transposed products, zero deltas keep the
pad rows zero), so training a padded kernel and stripping the padding
afterwards is the unpadded training.  The padding helpers are copies of
``hpnn_tpu/parallel/mesh.py``'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from hpnn_tpu_torch import runtime

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in a ``(data, model)`` world.

    ``shape[DATA_AXIS]``/``shape[MODEL_AXIS]`` are the axis sizes,
    ``index[axis]`` this rank's coordinate on each, ``device`` the
    torch device its tensors live on (default ``cuda``, by
    ``runtime.resolve_device``: no CPU fallback).  ``group(axis)`` is the process
    group of the ranks that share this rank's other coordinate, or
    None when the mesh was built without a process group (a world of
    one: every collective is the identity).  Build it with
    :func:`parallel.dist.hybrid_mesh` inside a world, or directly for
    a world of one."""

    def __init__(self, n_data: int = 1, n_model: int = 1, *, rank: int = 0,
                 device=None, groups=None):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"mesh {n_data}x{n_model}: both axes need >= 1 rank")
        self.shape = {DATA_AXIS: int(n_data), MODEL_AXIS: int(n_model)}
        self.size = int(n_data) * int(n_model)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a {n_data}x{n_model} mesh")
        self.rank = int(rank)
        self.index = {DATA_AXIS: self.rank // n_model, MODEL_AXIS: self.rank % n_model}
        self.device = runtime.resolve_device(device)
        self._groups = dict(groups or {})

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device})")


def parse_spec(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``; raises ``ValueError`` on anything else."""
    parts = str(spec).lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) >= 1 for p in parts):
        raise ValueError(f"bad mesh spec {spec!r} (want DxM)")
    return int(parts[0]), int(parts[1])


def pad_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def pad_kernel(weights: Sequence, k: int):
    """Zero-pad every layer's row dim (and the next layer's column dim)
    to a multiple of ``k``.  Returns (padded_weights, orig_row_sizes).

    The input dim (columns of layer 0) is never padded: only rows are
    sharded, exactly like the reference splits neurons, not inputs.
    """
    orig = tuple(int(w.shape[0]) for w in weights)
    padded = []
    prev_pad = 0  # column padding owed from the previous layer's rows
    for w in weights:
        w = np.asarray(w)
        n, m = w.shape
        np_rows = pad_up(n, k) - n
        out = np.zeros((n + np_rows, m + prev_pad), dtype=w.dtype)
        out[:n, :m] = w
        padded.append(out)
        prev_pad = np_rows
    return tuple(padded), orig


def unpad_kernel(weights: Sequence, orig_rows: Sequence[int]):
    """Inverse of :func:`pad_kernel`."""
    out = []
    prev = None
    for w, n in zip(weights, orig_rows):
        w = np.asarray(w)
        m = w.shape[1] if prev is None else prev
        out.append(np.ascontiguousarray(w[:n, :m]))
        prev = n
    return tuple(out)


def pad_vector(v, k: int):
    v = np.asarray(v)
    n = v.shape[0]
    out = np.zeros((pad_up(n, k),), dtype=v.dtype)
    out[:n] = v
    return out
