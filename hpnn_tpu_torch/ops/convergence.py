"""The per-sample convergence loop over a chunk of samples: the CUDA
kernel (``csrc/convergence.cu``) and its plain PyTorch version.

Replaces ``hpnn_tpu/ops/pallas_train.py::train_sample_fused`` as
``train_epoch_fused`` scans it: one launch trains the whole chunk, the
weights carried from sample to sample and updated in place, the
momentum zeroed at every sample start.  The per-sample statistics are
the JAX ``train_epoch_lax`` contract (ep0, n_iter, dep, first_ok,
final_ok), plus each sample's final output vector.

:func:`train_epoch` launches the kernel as :func:`plan` lays it out
for CUDA tensors and calls :func:`train_epoch_plain` for CPU tensors;
there is no other route.  ``launches`` counts the kernel launches of
this process.  The plan takes one thread-block cluster where the owned
rows of W fit its shared memory, and the grid build (one cooperative
CTA an SM, W streamed through rings in shared memory, the vectors
published once in device memory) where they do not and W is past the
measured crossover (``GRID_MIN_BYTES``): the same bits.

A net of any depth: the layers reach the kernel as one table of
records (:func:`_layer_table`, kept by ``ops/_table.py``: its values by
value in the kernel parameters up to 16 layers, its copy in device
memory past them).  A net of any width: where one CTA's copy of the
input, the target, the activations and the deltas does not fit its
shared memory, :func:`plan` puts the C copies in a scratch of device
memory (kept by ``ops/_table.py`` too), the same bits as the shared
build wherever both fit.  The limits left are the card's memory and
the kernel's row arithmetic (``MAX_ROWS`` rows a layer), each raising
with what it needs.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.ops import _build, _table
from hpnn_tpu_torch.train import loop

launches = 0
tables = _table.Tables()  # the launches' layer tables (csrc/convergence.cu's Layer)
scratch = _table.Scratch()  # the launches' vectors in device memory, when not in shared

MAX_SHARED_BYTES = 232448  # dynamic shared memory one H100 block can use
CLUSTER = 16             # CTAs a cluster: the non-portable size, faster than 8 (PERF.md)
STAGE = 2048             # values in the staging tile of the hidden deltas
MAX_ROWS = 1 << 18       # rows a layer: csrc/convergence.cu's owner() is exact up to it
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# the grid build (csrc/convergence.cu's convergence_grid)
GRID_THREADS = 512       # HPNN_GRID_THREADS
GRID_SMEM = 229376       # HPNN_GRID_SMEM: dynamic shared memory of a grid CTA
GRID_OUT_SMEM = 16384    # HPNN_GRID_OUT_SMEM: output deltas up to these bytes stay in it
GRID_CTAS = 132          # the grid's CTAs where no card is asked: an H100's SMs
MAX_GRID = 1024          # CTAs at which row_start's 40-bit division stays exact at MAX_ROWS
# W's bytes from which the plan takes the grid where W overflows 16 CTAs:
# the crossover lies between 4.28 MB (784-300-1000 float64: the grid 7%
# slower) and 4.76 MB (784-[1500]-10 float32 and 784-[750]-10 float64: the
# grid 15% and 7.5% faster) on an H100 (PERF.md)
GRID_MIN_BYTES = 4_500_000
_capacity: dict = {}     # (dtype, device index) -> CTAs of the grid the card holds at once

# C parameter types of hpnn_convergence_train_epoch, in order: every
# pointer and the stream as c_void_p (ctypes would cut a pointer to 32
# bits as c_int)
ARGTYPES = {
    # dtype snn momentum n_layers | table host_table dw vectors X Tg | S |
    # alpha delta | min_iter max_iter | lr | outputs | plan | stream
    "hpnn_convergence_train_epoch": (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    # the same up to the outputs, then | ctas | stream
    "hpnn_convergence_train_epoch_grid": (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p]),
    # dtype | int* ctas
    "hpnn_convergence_grid_ctas": [ctypes.c_int, ctypes.c_void_p],
}
# one record of the table: csrc/convergence.cu's `struct Layer` (w, the
# offset of layer l's dw in the dw scratch, ceil(2^40 / n), m, n, the
# layer's offset in the activations, its owned rows' offset in a
# weight block)
LAYER = struct.Struct("<QqQiiii")


class EpochStats(NamedTuple):
    ep0: torch.Tensor       # (S,) error after the initial forward
    n_iter: torch.Tensor    # (S,) int32 iterations run
    dep: torch.Tensor       # (S,) last Ep - Epr
    first_ok: torch.Tensor  # (S,) int32 argmax match after iteration 1
    final_ok: torch.Tensor  # (S,) int32 ok & it > min_iter
    out: torch.Tensor       # (S, n_out) final output vectors


class Plan(NamedTuple):
    """How one launch lays a net out over its CTAs: one cluster
    (csrc/convergence.cu's ``convergence_cluster``) or, ``grid``, a
    cooperative grid of one CTA an SM (``convergence_grid``)."""
    cluster: int            # CTAs of the cluster (of the grid)
    row_starts: tuple       # per layer: C + 1 row bounds, CTA r owns [s[r], s[r+1])
    dbuf: bool              # activations double-buffered by parity
    stage: int              # values in the staging tile (0: none)
    weights_resident: bool  # owned rows of W in shared memory (else device memory)
    dw_resident: bool       # owned rows of dw in shared memory (momentum only)
    smem_bytes: int         # dynamic shared memory of one CTA
    vectors_resident: bool  # input, target, activations, deltas in shared memory
    scratch_bytes: int      # else in device memory: C copies (see vector_values), or
                            # the grid's published vectors (see grid_scratch_bytes)
    grid: bool = False      # the grid build: W and dw streamed through rings


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


def vector_values(weights) -> int:
    """Values in one CTA's copy of the vectors in device memory: the
    input, the target, both activation buffers and the deltas."""
    shapes = _shapes(weights)
    return shapes[0][1] + shapes[-1][0] + 3 * sum(n for n, _ in shapes)


def grid_scratch_bytes(weights, dtype, ctas: int) -> int:
    """Device memory of the grid build's vectors: the barrier's word (16
    bytes), both activation buffers (each padded to a multiple of 4
    values, csrc/convergence.cu's grid_abuf) and the hidden deltas,
    published once for every CTA, and each CTA's output deltas where
    they overflow ``GRID_OUT_SMEM`` bytes of its shared memory."""
    shapes = _shapes(weights)
    b = torch.empty((), dtype=dtype).element_size()
    n_out, total = shapes[-1][0], sum(n for n, _ in shapes)
    private = 0 if n_out * b <= GRID_OUT_SMEM else ctas * n_out
    return 16 + b * (2 * (-(-total // 4) * 4) + total + private)


def plan(weights, dtype, momentum: bool, *, cluster: int | None = None,
         weights_resident: bool | None = None,
         vectors_resident: bool | None = None, grid: bool | None = None,
         capacity: int | None = None) -> Plan:
    """The launch's plan.  Where the owned rows of W fit a cluster of
    ``CLUSTER`` CTAs' shared memory, or fall short of ``GRID_MIN_BYTES``,
    one cluster of ``CLUSTER`` CTAs (or ``cluster``, 1..16); else the
    grid build, a cooperative grid of ``capacity`` CTAs (the CTAs the
    card holds at once, ``GRID_CTAS`` where no card is asked; or
    ``cluster`` of them) that streams W through rings in shared memory
    and keeps the vectors in device memory.  Every plan gives the same
    bits.  ``grid`` forces the grid (True) or one cluster (False).

    One cluster: the vectors (input, target, activations, deltas) live
    in shared memory where one copy fits a CTA, else in a device-memory
    scratch of C copies (``scratch_bytes``).  Into the shared memory
    left go, in this order: the second activation buffer (always there
    with the vectors in device memory), the staging tile, the owned rows
    of W, those of dw; W's rows are streamed from device memory where
    they do not fit.  ``weights_resident`` and ``vectors_resident``
    force W or the vectors in (raising with the bytes if they do not
    fit) or out, and forcing either in keeps one cluster."""
    shapes = _shapes(weights)
    if max(n for n, _ in shapes) > MAX_ROWS:
        raise ValueError(f"a layer of {max(n for n, _ in shapes)} rows: the kernel's "
                         f"row arithmetic takes at most {MAX_ROWS}")
    b = torch.empty((), dtype=dtype).element_size()
    if grid is None:
        grid = (not weights_resident and not vectors_resident
                and b * sum(n * m for n, m in shapes) >= GRID_MIN_BYTES
                and not _cluster_plan(weights, dtype, momentum, CLUSTER).weights_resident)
    if not grid:
        return _cluster_plan(weights, dtype, momentum, CLUSTER if cluster is None else cluster,
                             weights_resident, vectors_resident)
    if weights_resident or vectors_resident:
        raise ValueError("the grid build keeps W and the vectors in device memory")
    top = min(GRID_CTAS if capacity is None else capacity, MAX_GRID)
    G = top if cluster is None else cluster
    if not 1 <= G <= top:
        raise ValueError(f"a grid of {G} CTAs: the card holds {top} of the grid build's "
                         f"CTAs at once ({GRID_THREADS} threads, {GRID_SMEM} bytes of shared "
                         f"memory each)")
    starts = tuple(tuple(r * n // G for r in range(G + 1)) for n, _ in shapes)
    return Plan(G, starts, True, 0, False, False, GRID_SMEM, False,
                grid_scratch_bytes(weights, dtype, G), True)


def _cluster_plan(weights, dtype, momentum: bool, C: int, weights_resident=None,
                  vectors_resident=None) -> Plan:
    """``plan`` for one cluster of C CTAs."""
    if not 1 <= C <= CLUSTER:
        raise ValueError(f"cluster size {C}: the kernel takes 1..{CLUSTER}")
    shapes = _shapes(weights)
    b = torch.empty((), dtype=dtype).element_size()
    total = sum(n for n, _ in shapes)
    need = shared_bytes(weights, dtype)
    v_res = need <= MAX_SHARED_BYTES if vectors_resident is None else bool(vectors_resident)
    if v_res and need > MAX_SHARED_BYTES:
        raise ValueError(
            f"activations and deltas need {need} bytes of shared memory; "
            f"one block has {MAX_SHARED_BYTES}")
    if v_res:
        used = need
        dbuf = used + b * total <= MAX_SHARED_BYTES
        used += b * total if dbuf else 0
    else:
        used, dbuf = 2 * b + 8, True   # the scalars; both buffers in the scratch
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
    return Plan(C, starts, dbuf, stage, w_res, dw_res, used, v_res,
                0 if v_res else C * b * vector_values(weights))


# the phases of csrc/convergence.cu's `enum Phase`, in order
PHASES = ("hidden deltas", "update (one activation buffer)", "update and forward rows",
          "cluster barrier", "gather", "softmax", "loss, exit test, output deltas",
          "sample start and end", "output layer's rows", "output layer's barrier",
          "output layer's gather", "waiting on a ring slot's fill")


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
        lib.hpnn_convergence_clock_cta.restype = ctypes.c_int
        lib.hpnn_convergence_clock_cta.argtypes = [ctypes.c_int]
    return lib


def _check(weights, X, T, model):
    if model not in ("ann", "snn"):
        raise ValueError(f"model must be 'ann' or 'snn', got {model!r}")
    if X.dim() != 2 or T.dim() != 2 or X.shape[0] != T.shape[0]:
        raise ValueError(f"want X (S, n_in) and T (S, n_out), got "
                         f"{tuple(X.shape)} and {tuple(T.shape)}")
    if not weights:
        raise ValueError("want at least one layer")
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
    vectors_resident: bool | None = None,
    grid: bool | None = None,
) -> EpochStats:
    """Train the rows of ``(X, T)`` to convergence, one after the other.

    ``weights``: tuple of ``(n_l, m_l)`` tensors, updated in place.
    CUDA tensors: one launch on the current stream (float32 or float64;
    anything else raises), one cluster or the grid as :func:`plan` lays
    it out for this card, whose ``cluster``, ``weights_resident``,
    ``vectors_resident`` and ``grid`` can be forced here (the result is
    the same bitwise; a grid the card cannot hold at once raises).  CPU
    tensors: the plain version."""
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
             weights_resident=weights_resident, vectors_resident=vectors_resident,
             grid=grid, capacity=grid_capacity(X.dtype, X.device))
    stats = _launch(_library(), p, weights, X, T, alpha, delta, model, momentum,
                    min_iter, max_iter)
    launches += 1
    return stats


def grid_capacity(dtype, device) -> int:
    """CTAs of the grid build that ``device`` holds at once: its SMs
    times the blocks an SM holds (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``), asked once per type and device."""
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (dtype, idx)
    if key not in _capacity:
        lib = _library()
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = lib.hpnn_convergence_grid_ctas(_DTYPE_CODE[dtype], ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"asking the grid build's occupancy failed: {rc} "
                               f"({lib.hpnn_cuda_error_string(rc).decode()})")
        _capacity[key] = n.value
    return _capacity[key]


def _inv40(d: int) -> int:
    """ceil(2^40 / d): csrc/convergence.cu's inv40."""
    return ((1 << 40) + d - 1) // d


def _layer_table(weights, cluster: int, stream: int, device):
    """The launch's layer table (its copy on ``device`` for a net deeper
    than ``_table.PARAM_LAYERS``, else None) and its host copy (a ctypes
    buffer): one ``LAYER`` record a layer, made once for these weights,
    this cluster size and this stream."""
    key = (stream, weights[0].dtype, cluster,
           tuple((w.data_ptr(), w.shape[0], w.shape[1]) for w in weights))

    def pack():
        recs, off, wblk, dwo = [], 0, 0, 0
        for w in weights:
            n, m = int(w.shape[0]), int(w.shape[1])
            recs.append(LAYER.pack(w.data_ptr(), dwo, _inv40(n), m, n, off, wblk))
            off += n
            wblk += -(-n // cluster) * m
            dwo += n * m
        blob = b"".join(recs)
        return blob, ctypes.create_string_buffer(blob, len(blob))

    return tables.get(key, pack, _table.device_copy(len(weights), device))


def _launch(lib, p, weights, X, T, alpha, delta, model, momentum, min_iter, max_iter):
    """One launch of ``lib``'s kernel under plan ``p``; raises if the
    launch is refused."""
    S, n_out = T.shape
    dev = X.device
    # dw is scratch the kernel zeroes, one buffer of every layer's dw;
    # device memory only where the plan keeps it out of shared memory
    dw = (torch.empty(sum(w.numel() for w in weights), dtype=X.dtype, device=dev)
          if momentum and not p.dw_resident else None)
    ep0 = torch.empty(S, dtype=X.dtype, device=dev)
    dep = torch.empty(S, dtype=X.dtype, device=dev)
    n_iter = torch.empty(S, dtype=torch.int32, device=dev)
    first_ok = torch.empty(S, dtype=torch.int32, device=dev)
    final_ok = torch.empty(S, dtype=torch.int32, device=dev)
    out = torch.empty((S, n_out), dtype=X.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        table, host = _layer_table(weights, p.cluster, stream, dev)
        # the vectors in device memory (the cluster's C copies, or the
        # grid's published ones): kept for this stream, type, build, CTA
        # count and net, so a round of chunks allocates once
        vec = None if p.vectors_resident else scratch.get(
            (stream, X.dtype, p.grid, p.cluster, tuple(_shapes(weights))),
            p.scratch_bytes, dev)
        head = (_DTYPE_CODE[X.dtype], int(model == "snn"), int(bool(momentum)),
                len(weights), None if table is None else table.data_ptr(),
                ctypes.addressof(host), None if dw is None else dw.data_ptr(),
                None if vec is None else vec.data_ptr(), X.data_ptr(),
                T.data_ptr(), S, float(alpha), float(delta), int(min_iter), int(max_iter),
                learn_rate(model, momentum),
                ep0.data_ptr(), n_iter.data_ptr(), dep.data_ptr(),
                first_ok.data_ptr(), final_ok.data_ptr(), out.data_ptr())
        if p.grid:
            rc = lib.hpnn_convergence_train_epoch_grid(*head, p.cluster, stream)
        else:
            rc = lib.hpnn_convergence_train_epoch(
                *head, p.cluster, int(p.dbuf), p.stage, int(p.weights_resident),
                int(p.dw_resident), stream)
    if rc != 0:
        raise RuntimeError(
            f"convergence kernel launch failed ({p.cluster}-CTA "
            f"{'cooperative grid' if p.grid else 'cluster'}, "
            f"{p.smem_bytes} bytes of shared memory a CTA, "
            f"{p.scratch_bytes} of vectors in device memory): {rc} "
            f"({lib.hpnn_cuda_error_string(rc).decode()})")
    return EpochStats(ep0, n_iter, dep, first_ok, final_ok, out)


def phase_clocks(weights, X, T, alpha, delta, *, model="ann", momentum=False,
                 min_iter, max_iter, cluster=None, weights_resident=None,
                 vectors_resident=None, grid=None, cta=0):
    """``train_epoch`` on CUDA tensors through the kernel's phase-clock
    build (``-DHPNN_PHASE_CLOCKS``): returns its stats and the SM cycles
    that rank 0's thread 0 (in the grid build, CTA ``cta``'s) spent in
    each of ``PHASES``, barrier waits included.  A measuring tool: it
    does not count in ``launches``."""
    _check(weights, X, T, model)
    if X.device.type != "cuda" or X.dtype not in _DTYPE_CODE:
        raise ValueError("phase clocks need float32 or float64 CUDA tensors")
    p = plan(weights, X.dtype, momentum, cluster=cluster,
             weights_resident=weights_resident, vectors_resident=vectors_resident,
             grid=grid, capacity=grid_capacity(X.dtype, X.device))
    lib = _library("HPNN_PHASE_CLOCKS")
    clocks = (ctypes.c_ulonglong * len(PHASES))()

    def read_and_zero():
        rc = lib.hpnn_convergence_phase_clocks(ctypes.addressof(clocks), 1)
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks failed: {rc}")

    torch.cuda.synchronize(X.device)
    if lib.hpnn_convergence_clock_cta(int(cta)) != 0:
        raise RuntimeError("setting the phase clocks' CTA failed")
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
