"""The per-sample convergence loop over a chunk of samples: the CUDA
kernel (``csrc/convergence.cu``) and its plain PyTorch version.

Replaces ``hpnn_tpu/ops/pallas_train.py::train_sample_fused`` as
``train_epoch_fused`` scans it: one launch trains the whole chunk, the
weights carried from sample to sample and updated in place, the
momentum zeroed at every sample start.  The per-sample statistics are
the JAX ``train_epoch_lax`` contract (ep0, n_iter, dep, first_ok,
final_ok), plus each sample's final output vector.

:func:`train_epoch` launches the kernel, one thread-block cluster laid
out by :func:`plan`, for CUDA tensors and calls
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
CLUSTER = 16             # CTAs a cluster: the non-portable size, faster than 8 (PERF.md)
STAGE = 2048             # values in the staging tile of the hidden deltas
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# C parameter types of hpnn_convergence_train_epoch, in order: every
# pointer and the stream as c_void_p (ctypes would cut a pointer to 32
# bits as c_int)
ARGTYPES = {
    "hpnn_convergence_train_epoch": (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


class EpochStats(NamedTuple):
    ep0: torch.Tensor       # (S,) error after the initial forward
    n_iter: torch.Tensor    # (S,) int32 iterations run
    dep: torch.Tensor       # (S,) last Ep - Epr
    first_ok: torch.Tensor  # (S,) int32 argmax match after iteration 1
    final_ok: torch.Tensor  # (S,) int32 ok & it > min_iter
    out: torch.Tensor       # (S, n_out) final output vectors


class Plan(NamedTuple):
    """How one launch lays a net out over a cluster (the layout of
    csrc/convergence.cu's ``convergence_cluster``)."""
    cluster: int            # CTAs in the cluster
    row_starts: tuple       # per layer: C + 1 row bounds, CTA r owns [s[r], s[r+1])
    dbuf: bool              # activations double-buffered by parity
    stage: int              # values in the staging tile (0: none)
    weights_resident: bool  # owned rows of W in shared memory (else device memory)
    dw_resident: bool       # owned rows of dw in shared memory (momentum only)
    smem_bytes: int         # dynamic shared memory of one CTA


def learn_rate(model: str, momentum: bool) -> float:
    if model == "snn":
        return snn.SNN_LEARN_RATE
    return ann.BPM_LEARN_RATE if momentum else ann.BP_LEARN_RATE


def _shapes(weights):
    return [(int(w.shape[0]), int(w.shape[1])) for w in weights]


def shared_bytes(weights, dtype) -> int:
    """Shared memory a CTA needs at the least: the loss, the softmax
    denominator and two ints, the input, the target, one copy of every
    layer's activations and one of its deltas."""
    shapes = _shapes(weights)
    b = torch.empty((), dtype=dtype).element_size()
    total = sum(n for n, _ in shapes)
    return 2 * b + 8 + b * (shapes[0][1] + shapes[-1][0] + 2 * total)


def plan(weights, dtype, momentum: bool, *, cluster: int | None = None,
         weights_resident: bool | None = None) -> Plan:
    """The launch's plan for a cluster of ``CLUSTER`` CTAs (or
    ``cluster``, 1..16, the same result bitwise).  Into the shared
    memory left beside one copy of the activations and deltas go, in
    this order: the second activation buffer, the staging tile, the
    owned rows of W, those of dw; W's rows are streamed from device
    memory where they do not fit.  ``weights_resident`` forces W in
    (raising if it does not fit) or out.  Raises if one copy of the
    activations and deltas does not fit."""
    C = CLUSTER if cluster is None else cluster
    if not 1 <= C <= CLUSTER:
        raise ValueError(f"cluster size {C}: the kernel takes 1..{CLUSTER}")
    shapes = _shapes(weights)
    b = torch.empty((), dtype=dtype).element_size()
    used = shared_bytes(weights, dtype)
    if used > MAX_SHARED_BYTES:
        raise ValueError(
            f"activations and deltas need {used} bytes of shared memory; "
            f"one block has {MAX_SHARED_BYTES}")
    total = sum(n for n, _ in shapes)
    dbuf = used + b * total <= MAX_SHARED_BYTES
    used += b * total if dbuf else 0
    stage = max(0, min(STAGE, (MAX_SHARED_BYTES - used) // b))
    used += b * stage
    wtot = b * sum(-(-n // C) * m for n, m in shapes)
    w_res = used + wtot <= MAX_SHARED_BYTES if weights_resident is None else weights_resident
    if w_res and used + wtot > MAX_SHARED_BYTES:
        raise ValueError(f"the owned weight rows of a {C}-CTA cluster need "
                         f"{used + wtot} bytes of shared memory")
    used += wtot if w_res else 0
    dw_res = bool(momentum) and w_res and used + wtot <= MAX_SHARED_BYTES
    used += wtot if dw_res else 0
    starts = tuple(tuple(r * n // C for r in range(C + 1)) for n, _ in shapes)
    return Plan(C, starts, dbuf, stage, w_res, dw_res, used)


# the phases of csrc/convergence.cu's `enum Phase`, in order
PHASES = ("hidden deltas", "update (one activation buffer)", "update and forward rows",
          "cluster barrier", "gather", "softmax", "loss, exit test, output deltas",
          "sample start and end")


def _library(define: str | None = None):
    """The built kernel library (or its ``-D<define>`` variant) with its
    C signatures declared."""
    lib = _build.load("convergence", define)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.hpnn_cuda_error_string.restype = ctypes.c_char_p
    lib.hpnn_cuda_error_string.argtypes = [ctypes.c_int]
    if define == "HPNN_PHASE_CLOCKS":
        lib.hpnn_convergence_phase_clocks.restype = ctypes.c_int
        lib.hpnn_convergence_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
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
    cluster: int | None = None,
    weights_resident: bool | None = None,
) -> EpochStats:
    """Train the rows of ``(X, T)`` to convergence, one after the other.

    ``weights``: tuple of ``(n_l, m_l)`` tensors, updated in place.
    CUDA tensors: one cluster launch on the current stream (float32 or
    float64; anything else raises), laid out by :func:`plan`, whose
    ``cluster`` and ``weights_resident`` can be forced here (the result
    is the same bitwise).  CPU tensors: the plain version."""
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
    p = plan(weights, X.dtype, momentum, cluster=cluster,
             weights_resident=weights_resident)
    stats = _launch(_library(), p, weights, X, T, alpha, delta, model, momentum,
                    min_iter, max_iter)
    launches += 1
    return stats


def _launch(lib, p, weights, X, T, alpha, delta, model, momentum, min_iter, max_iter):
    """One launch of ``lib``'s kernel under plan ``p``; raises if the
    launch is refused."""
    S, n_out = T.shape
    n_layers = len(weights)
    dev = X.device
    # dw is scratch the kernel zeroes; device memory only where the plan
    # keeps it out of shared memory
    dw = (tuple(torch.empty_like(w) for w in weights)
          if momentum and not p.dw_resident else ())
    ep0 = torch.empty(S, dtype=X.dtype, device=dev)
    dep = torch.empty(S, dtype=X.dtype, device=dev)
    n_iter = torch.empty(S, dtype=torch.int32, device=dev)
    first_ok = torch.empty(S, dtype=torch.int32, device=dev)
    final_ok = torch.empty(S, dtype=torch.int32, device=dev)
    out = torch.empty((S, n_out), dtype=X.dtype, device=dev)
    dims = (ctypes.c_int * (n_layers + 1))(
        weights[0].shape[1], *(int(w.shape[0]) for w in weights))
    w_ptrs = (ctypes.c_void_p * n_layers)(*(w.data_ptr() for w in weights))
    dw_ptrs = (ctypes.c_void_p * n_layers)(*(m.data_ptr() for m in dw) if dw else ())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hpnn_convergence_train_epoch(
            _DTYPE_CODE[X.dtype], int(model == "snn"), int(bool(momentum)),
            n_layers, ctypes.addressof(dims), ctypes.addressof(w_ptrs),
            ctypes.addressof(dw_ptrs), X.data_ptr(), T.data_ptr(), S,
            float(alpha), float(delta), int(min_iter), int(max_iter),
            learn_rate(model, momentum),
            ep0.data_ptr(), n_iter.data_ptr(), dep.data_ptr(),
            first_ok.data_ptr(), final_ok.data_ptr(), out.data_ptr(),
            p.cluster, int(p.dbuf), p.stage, int(p.weights_resident),
            int(p.dw_resident), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"convergence kernel launch failed ({p.cluster}-CTA cluster, "
            f"{p.smem_bytes} bytes of shared memory a CTA): {rc} "
            f"({lib.hpnn_cuda_error_string(rc).decode()})")
    return EpochStats(ep0, n_iter, dep, first_ok, final_ok, out)


def phase_clocks(weights, X, T, alpha, delta, *, model="ann", momentum=False,
                 min_iter, max_iter, cluster=None, weights_resident=None):
    """``train_epoch`` on CUDA tensors through the kernel's phase-clock
    build (``-DHPNN_PHASE_CLOCKS``): returns its stats and the SM cycles
    that rank 0's thread 0 spent in each of ``PHASES``, barrier waits
    included.  A measuring tool: it does not count in ``launches``."""
    _check(weights, X, T, model)
    if X.device.type != "cuda" or X.dtype not in _DTYPE_CODE:
        raise ValueError("phase clocks need float32 or float64 CUDA tensors")
    p = plan(weights, X.dtype, momentum, cluster=cluster,
             weights_resident=weights_resident)
    lib = _library("HPNN_PHASE_CLOCKS")
    clocks = (ctypes.c_ulonglong * len(PHASES))()

    def read_and_zero():
        rc = lib.hpnn_convergence_phase_clocks(ctypes.addressof(clocks), 1)
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks failed: {rc}")

    torch.cuda.synchronize(X.device)
    read_and_zero()
    stats = _launch(lib, p, weights, X, T, alpha, delta, model, momentum,
                    min_iter, max_iter)
    torch.cuda.synchronize(X.device)
    read_and_zero()
    return stats, dict(zip(PHASES, (int(v) for v in clocks)))


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
