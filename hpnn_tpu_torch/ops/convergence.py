"""The per-sample convergence loop over a chunk of samples: the CUDA
kernel (``csrc/convergence.cu``) and its plain PyTorch version.

Replaces ``hpnn_tpu/ops/pallas_train.py::train_sample_fused`` as
``train_epoch_fused`` scans it: one launch trains the whole chunk, the
weights carried from sample to sample and updated in place, the
momentum zeroed at every sample start.  The per-sample statistics are
the JAX ``train_epoch_lax`` contract (ep0, n_iter, dep, first_ok,
final_ok), plus each sample's final output vector.

:func:`train_epoch` launches the kernel for CUDA tensors and calls
:func:`train_epoch_plain` for CPU tensors; there is no other route.
``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.ops import _build
from hpnn_tpu_torch.train import loop

launches = 0

MAX_LAYERS = 16          # HPNN_MAX_LAYERS in csrc/convergence.cu
MAX_SHARED_BYTES = 232448  # dynamic shared memory one H100 block can use
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


class EpochStats(NamedTuple):
    ep0: torch.Tensor       # (S,) error after the initial forward
    n_iter: torch.Tensor    # (S,) int32 iterations run
    dep: torch.Tensor       # (S,) last Ep - Epr
    first_ok: torch.Tensor  # (S,) int32 argmax match after iteration 1
    final_ok: torch.Tensor  # (S,) int32 ok & it > min_iter
    out: torch.Tensor       # (S, n_out) final output vectors


def learn_rate(model: str, momentum: bool) -> float:
    if model == "snn":
        return snn.SNN_LEARN_RATE
    return ann.BPM_LEARN_RATE if momentum else ann.BP_LEARN_RATE


def shared_bytes(weights, dtype) -> int:
    """Dynamic shared memory of one launch: input, target, and the
    activations and deltas of every layer."""
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    total = sum(int(w.shape[0]) for w in weights)
    return (n_in + n_out + 2 * total) * torch.empty((), dtype=dtype).element_size()


def _library():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as ``c_void_p``)."""
    lib = _build.load("convergence")
    fn = lib.hpnn_convergence_train_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double]
        + [ctypes.c_void_p] * 7
    )
    lib.hpnn_cuda_error_string.restype = ctypes.c_char_p
    lib.hpnn_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(weights, X, T, model):
    if model not in ("ann", "snn"):
        raise ValueError(f"model must be 'ann' or 'snn', got {model!r}")
    if X.dim() != 2 or T.dim() != 2 or X.shape[0] != T.shape[0]:
        raise ValueError(f"want X (S, n_in) and T (S, n_out), got "
                         f"{tuple(X.shape)} and {tuple(T.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{len(weights)} layers: the kernel takes 1..{MAX_LAYERS}")
    if weights[0].shape[1] != X.shape[1] or weights[-1].shape[0] != T.shape[1]:
        raise ValueError("sample widths do not match the kernel's input/output")
    for a, b in zip(weights[:-1], weights[1:]):
        if b.shape[1] != a.shape[0]:
            raise ValueError("weight shapes do not chain")
    for t in (X, T, *weights):
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError("weights, X and T must share one dtype and device")
        if not t.is_contiguous():
            raise ValueError("weights, X and T must be contiguous")


def train_epoch(
    weights,
    X,
    T,
    alpha,
    delta,
    *,
    model: str = "ann",
    momentum: bool = False,
    min_iter: int,
    max_iter: int,
) -> EpochStats:
    """Train the rows of ``(X, T)`` to convergence, one after the other.

    ``weights``: tuple of ``(n_l, m_l)`` tensors, updated in place.
    CUDA tensors: one kernel launch on the current stream (float32 or
    float64; anything else raises).  CPU tensors: the plain version."""
    global launches
    _check(weights, X, T, model)
    if X.device.type == "cpu":
        return train_epoch_plain(
            weights, X, T, alpha, delta, model=model, momentum=momentum,
            min_iter=min_iter, max_iter=max_iter)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel is built for float32 and float64, not {X.dtype}")
    smem = shared_bytes(weights, X.dtype)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"activations and deltas need {smem} bytes of shared memory; "
            f"one block has {MAX_SHARED_BYTES}")
    lib = _library()
    S, n_out = T.shape
    n_layers = len(weights)
    dev = X.device
    dw = tuple(torch.empty_like(w) for w in weights) if momentum else ()
    ep0 = torch.empty(S, dtype=X.dtype, device=dev)
    dep = torch.empty(S, dtype=X.dtype, device=dev)
    n_iter = torch.empty(S, dtype=torch.int32, device=dev)
    first_ok = torch.empty(S, dtype=torch.int32, device=dev)
    final_ok = torch.empty(S, dtype=torch.int32, device=dev)
    out = torch.empty((S, n_out), dtype=X.dtype, device=dev)
    dims = (ctypes.c_int * (n_layers + 1))(
        weights[0].shape[1], *(int(w.shape[0]) for w in weights))
    w_ptrs = (ctypes.c_void_p * n_layers)(*(w.data_ptr() for w in weights))
    dw_ptrs = (ctypes.c_void_p * n_layers)(*(m.data_ptr() for m in dw))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hpnn_convergence_train_epoch(
            _DTYPE_CODE[X.dtype], int(model == "snn"), int(bool(momentum)),
            n_layers, ctypes.addressof(dims), ctypes.addressof(w_ptrs),
            ctypes.addressof(dw_ptrs), X.data_ptr(), T.data_ptr(), S,
            float(alpha), float(delta), int(min_iter), int(max_iter),
            learn_rate(model, momentum),
            ep0.data_ptr(), n_iter.data_ptr(), dep.data_ptr(),
            first_ok.data_ptr(), final_ok.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"convergence kernel launch failed: {rc} "
            f"({lib.hpnn_cuda_error_string(rc).decode()})")
    launches += 1
    return EpochStats(ep0, n_iter, dep, first_ok, final_ok, out)


def train_epoch_plain(
    weights,
    X,
    T,
    alpha,
    delta,
    *,
    model: str = "ann",
    momentum: bool = False,
    min_iter: int,
    max_iter: int,
) -> EpochStats:
    """The same function with plain tensor operations on the inputs'
    device (``loop.train_sample`` per row); weights updated in place."""
    _check(weights, X, T, model)
    dw0 = tuple(torch.zeros_like(w) for w in weights) if momentum else ()
    w = tuple(weights)
    rows = []
    for s in range(X.shape[0]):
        res = loop.train_sample(
            w, dw0, X[s], T[s], alpha, delta, model=model, momentum=momentum,
            min_iter=min_iter, max_iter=max_iter)
        w = res.weights
        rows.append(res)
    with torch.no_grad():
        for dst, src in zip(weights, w):
            dst.copy_(src)
    dev = X.device

    def ints(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int32, device=dev)

    return EpochStats(
        torch.stack([r.ep0 for r in rows]),
        ints(r.n_iter for r in rows),
        torch.stack([r.dep for r in rows]),
        ints(r.first_ok for r in rows),
        ints(r.final_ok for r in rows),
        torch.stack([r.out for r in rows]),
    )
