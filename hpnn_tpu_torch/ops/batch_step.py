"""Minibatch training steps of the batch and fleet paths: the CUDA
kernels of ``csrc/batch_step.cu`` behind five entry points, and their
plain PyTorch versions.

Replaces the five kernels of ``hpnn_tpu/ops/pallas_train.py`` that
share ``_batch_step_math`` (one step: forward over the B rows, deltas,
the mean-gradient SGD or BPM update at ``lr/B``, a re-forward, and the
loss):

* :func:`train_step_fused_batch` — one step on a ``(B, n)`` block;
* :func:`train_step_fused_banked` — one step on block ``k`` of a
  ``(blocks·B, n)`` bank;
* :func:`train_epoch_grid_banked` — ``S`` steps on the bank's blocks in
  the order ``order[S]``, one launch, ``losses[S]`` out;
* :func:`train_epoch_dbuf_banked` — the same epoch, each step first
  starting the copy of the next step's block into L2;
* :func:`train_fleet_epoch_dbuf_banked` — N members' dbuf epochs in one
  launch: stacked ``(N, out, in)`` weights, ``(N, S·B, n)`` banks,
  ``orders (N, S)``, ``losses (N, S)``.

All five return ``(weights, dw, loss | losses)`` and update ``weights``
(and ``dw`` with momentum) IN PLACE.  A CUDA tensor goes through the
kernel, one launch on the current stream (float32 or float64; anything
else raises); a CPU tensor takes the ``*_plain`` twin, which runs
``parallel.dp.train_step_math`` once per step (per member and step for
the fleet).  There is no other route.  ``launches`` counts each entry
point's kernel launches in this process.

The launch's *team*: #2-#5 run on the cooperative grid (one block per
SM); #6 runs one cluster of :func:`fleet_cluster` CTAs per member
(``cluster=`` forces the size).  Inside ``with _cluster_team(C):`` #2-#5
run their body on one cluster of C CTAs instead, for the tests and
``chip_smoke.py`` (the grid is the faster: PERF.md).  Every team gives
the same bits.  A launch the card cannot place raises; nothing falls
back to a smaller team.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from hpnn_tpu_torch.ops import _build
from hpnn_tpu_torch.parallel import dp

# the batch path's entry points, with the same (weights, dw, X, T, ...)
# signature; the fleet epoch takes stacked tensors
BATCH_ENTRY_POINTS = (
    "train_step_fused_batch",
    "train_step_fused_banked",
    "train_epoch_grid_banked",
    "train_epoch_dbuf_banked",
)
ENTRY_POINTS = BATCH_ENTRY_POINTS + ("train_fleet_epoch_dbuf_banked",)
launches = dict.fromkeys(ENTRY_POINTS, 0)

MAX_LAYERS = 16  # HPNN_MAX_LAYERS in csrc/batch_step.cu
TILE = 32        # HPNN_TILE: output tile edge and k-tile depth
WORKERS = 2      # HPNN_WORKERS: 128-thread tile workers a block
MAX_SHARED_BYTES = 232448  # dynamic shared memory one H100 block can use
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the cluster sizes the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_libs: dict = {}       # define (None: the shipped build) -> loaded library
_variant = None        # the build the entry points launch (phase_clocks sets it)
_team = 0              # #2-#5's team: 0 the grid, C one cluster (_cluster_team sets it)
# asked of the card once per build, type and device (the queries also opt
# the kernels in to their shared memory, so a launch sets nothing):
_grids: dict[tuple, int] = {}      # -> blocks of the cooperative grid
_capacity: dict[tuple, dict] = {}  # -> {C: clusters of C CTAs at once}
_plans: dict[tuple, int] = {}      # and members, shapes, B, forced size -> #6's C

# The C signatures of csrc/batch_step.cu's launch entries, argument by
# argument (every pointer and the stream as ``c_void_p``): a wrong entry
# passes garbage without an error, so a test holds each against the
# source's ``extern "C"`` declaration.
_INT, _PTR, _DBL = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
ARGTYPES = {
    # dtype blocks cluster snn momentum n_layers | dims w dw X Tg | B |
    # order | first S | lr_eff alpha inv_b | scratch losses | prefetch stream
    "hpnn_batch_train": (
        (_INT,) * 6 + (_PTR,) * 5 + (_INT,) + (_PTR,) + (_INT,) * 2
        + (_DBL,) * 3 + (_PTR,) * 2 + (_INT, _PTR)),
    # dtype members cluster snn momentum n_layers | dims w dw X Tg |
    # bank_rows | B | orders | S | lr_eff alpha inv_b | scratch losses stream
    "hpnn_fleet_train": (
        (_INT,) * 6 + (_PTR,) * 5 + (ctypes.c_longlong, _INT, _PTR, _INT)
        + (_DBL,) * 3 + (_PTR,) * 3),
}


def _library(define: str | None = None):
    """The built kernel library (or its ``-D<define>`` variant) with its
    C signatures declared."""
    if define not in _libs:
        lib = _build.load("batch_step", define)
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.hpnn_batch_grid_blocks.restype = ctypes.c_int
        lib.hpnn_batch_grid_blocks.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.hpnn_batch_smem_bytes.restype = ctypes.c_longlong
        lib.hpnn_batch_smem_bytes.argtypes = [ctypes.c_int]
        lib.hpnn_fleet_max_clusters.restype = ctypes.c_int
        lib.hpnn_fleet_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hpnn_batch_error_string.restype = ctypes.c_char_p
        lib.hpnn_batch_error_string.argtypes = [ctypes.c_int]
        if define == "HPNN_PHASE_CLOCKS":
            lib.hpnn_batch_phase_clocks.restype = ctypes.c_int
            lib.hpnn_batch_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _libs[define] = lib
    return _libs[define]


# the phases of csrc/batch_step.cu's `enum Phase`, in order
PHASES = ("forward tiles", "output rows apart", "hidden-delta tiles", "update tiles",
          "team syncs", "step start and loss")


def phase_clocks(run):
    """``run()`` (kernel launches through the entry points above, on CUDA
    tensors) with the kernel's phase-clock build (``-DHPNN_PHASE_CLOCKS``):
    returns ``run()``'s result and the SM cycles that rank 0's thread 0
    spent in each of ``PHASES``, waits at the team's syncs included.  A
    measuring tool: its launches do not count in ``launches``."""
    global _variant
    lib = _library("HPNN_PHASE_CLOCKS")
    clocks = (ctypes.c_ulonglong * len(PHASES))()

    def read_and_zero():
        rc = lib.hpnn_batch_phase_clocks(ctypes.addressof(clocks), 1)
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks failed: {rc}")

    counted = dict(launches)
    torch.cuda.synchronize()
    read_and_zero()
    _variant = "HPNN_PHASE_CLOCKS"
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        _variant = None
        launches.update(counted)
    read_and_zero()
    return out, dict(zip(PHASES, (int(v) for v in clocks)))


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"batch-step kernel {what} failed: {rc} "
            f"({lib.hpnn_batch_error_string(rc).decode()})")


def _key(dtype, device) -> tuple:
    return (_variant, dtype, torch.device(device).index or 0)


def grid_blocks(dtype, device) -> int:
    """Blocks of one cooperative launch on ``device``, all co-resident
    (asked of the card once per type and device).  This is the kernel's
    resource check: it raises when the card cannot hold even one block
    per SM, or does not take cooperative launches."""
    key = _key(dtype, device)
    if key not in _grids:
        lib = _library(_variant)
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.hpnn_batch_grid_blocks(_DTYPE_CODE[dtype], ctypes.byref(blocks))
        _raise_on(lib, rc, "occupancy query")
        if blocks.value < 1:
            raise RuntimeError("the batch-step kernel's blocks cannot all be co-resident")
        _grids[key] = blocks.value
    return _grids[key]


def shared_bytes(dtype) -> int:
    """Dynamic shared memory of one block of the kernel (the layout of
    csrc/batch_step.cu's ``smem_bytes``): per tile worker two stages of
    an A and a B k-tile, each TILE k-rows of TILE values plus a 16-byte
    pad, and a TILE x (TILE + 1) staged output tile."""
    b = torch.empty((), dtype=dtype).element_size()
    stage = TILE * (TILE + 16 // b)
    return WORKERS * (4 * stage + TILE * (TILE + 1)) * b


def largest_gemm_tiles(shapes, batch: int) -> int:
    """TILE x TILE output tiles of the largest matrix product of one
    step: a layer's forward (or its hidden deltas, the same shape) or its
    update.  ``shapes``: the layers' (out, in)."""
    def cdiv(a, b):
        return -(-a // b)
    return max(max(cdiv(batch, TILE), cdiv(n_in, TILE)) * cdiv(n_out, TILE)
               for n_out, n_in in shapes)


def _cluster_arg(cluster) -> int:
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster!r}: the kernel takes one of {CLUSTER_SIZES}")
    return cluster


def fleet_cluster(members: int, shapes, batch: int, capacity, *, cluster=None) -> int:
    """CTAs of each member's cluster in one launch of #6.  ``capacity``:
    {C: clusters of C CTAs the card holds at once} (:func:`cluster_capacity`).
    Clusters live inside one GPC, so the count is not the SM count over
    C.  The members run in ceil(members / capacity[C]) waves, and a
    member's step takes about 1/C of one CTA's time, so the plan is the C
    of CLUSTER_SIZES, at most :func:`largest_gemm_tiles` (or 1), with the
    fewest waves per CTA of a member; of equals, the smaller C (its
    barrier is cheaper).  Members that fill the card one CTA each take
    C = 1: a larger C adds barriers and no SM.  ``cluster`` forces a
    size (the same bits whatever C: tests and chip_smoke.py use it)."""
    if cluster is not None:
        return _cluster_arg(cluster)
    tiles = largest_gemm_tiles(shapes, batch)
    full = members >= capacity.get(1, 0)
    sizes = [C for C in CLUSTER_SIZES
             if (C == 1 or (C <= tiles and not full)) and capacity.get(C, 0) >= 1]
    if not sizes:
        raise RuntimeError("the card holds no cluster of the fleet kernel")
    return min(sizes, key=lambda C: (-(-members // capacity[C]) / C, C))


def cluster_capacity(dtype, device) -> dict:
    """{C: clusters of C CTAs of the fleet kernel the card holds at once},
    asked of the card once per type and device; raises if it cannot hold
    even one CTA."""
    key = _key(dtype, device)
    if key not in _capacity:
        lib = _library(_variant)
        cap = {}
        with torch.cuda.device(device):
            for C in CLUSTER_SIZES:
                n = ctypes.c_int(0)
                _raise_on(lib, lib.hpnn_fleet_max_clusters(_DTYPE_CODE[dtype], C,
                                                           ctypes.byref(n)),
                          f"cluster occupancy query ({C} CTAs)")
                cap[C] = n.value
        if cap[1] < 1:
            raise RuntimeError("the fleet kernel's CTA does not fit the card")
        _capacity[key] = cap
    return _capacity[key]


@contextlib.contextmanager
def _cluster_team(cluster: int):
    """Inside the block, #2-#5 launch their body on one cluster of
    ``cluster`` CTAs rather than the cooperative grid: the same bits, about
    3x slower at 784-300-10 (PERF.md).  For the tests and chip_smoke.py;
    the plain versions ignore it."""
    global _team
    _cluster_arg(cluster)
    _team = cluster
    try:
        yield
    finally:
        _team = 0


def _placed(cluster: int, dtype, device) -> int:
    """``cluster``, once the card is known to hold a cluster of that many
    CTAs of the kernel; raises if it holds none."""
    if cluster_capacity(dtype, device)[cluster] < 1:
        raise RuntimeError(f"the card cannot place a cluster of {cluster} CTAs of the "
                           f"batch-step kernel ({shared_bytes(dtype)} bytes of shared "
                           f"memory a CTA)")
    return cluster


def _check(weights, dw, X, T, batch, model, momentum):
    if model not in ("ann", "snn"):
        raise ValueError(f"model must be 'ann' or 'snn', got {model!r}")
    if X.dim() != 2 or T.dim() != 2 or X.shape[0] != T.shape[0]:
        raise ValueError(f"want X (rows, n_in) and T (rows, n_out), got "
                         f"{tuple(X.shape)} and {tuple(T.shape)}")
    if batch < 1 or X.shape[0] % batch or X.shape[0] == 0:
        raise ValueError(f"{X.shape[0]} rows are not whole blocks of {batch}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{len(weights)} layers: the kernel takes 1..{MAX_LAYERS}")
    if weights[0].shape[1] != X.shape[1] or weights[-1].shape[0] != T.shape[1]:
        raise ValueError("sample widths do not match the kernel's input/output")
    for a, b in zip(weights[:-1], weights[1:]):
        if b.shape[1] != a.shape[0]:
            raise ValueError("weight shapes do not chain")
    state = tuple(weights)
    if momentum:
        if len(dw) != len(weights) or any(m.shape != w.shape for m, w in zip(dw, weights)):
            raise ValueError("momentum needs one dw of each weight's shape")
        state += tuple(dw)
    for t in (X, T, *state):
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError("weights, dw, X and T must share one dtype and device")
        if not t.is_contiguous():
            raise ValueError("weights, dw, X and T must be contiguous")


def _order(order, n_blocks: int) -> torch.Tensor:
    """``order`` as a host int32 tensor of block ids, each in range."""
    o = torch.as_tensor(order).reshape(-1).cpu()
    if o.numel() == 0 or o.dtype.is_floating_point or o.dtype == torch.bool:
        raise ValueError("order must be a non-empty sequence of block ids")
    lo, hi = (int(v) for v in torch.aminmax(o))
    if lo < 0 or hi >= n_blocks:
        raise ValueError(f"block ids {lo}..{hi} outside the bank's {n_blocks} blocks")
    return o.to(torch.int32)


def _layers(weights, dw, momentum, batch):
    """One kernel's C arrays (the layer widths and the weight and dw
    pointers) and the values of its scratch: the activations and deltas
    of every layer for the B rows and the B row losses (the counterpart
    of the Pallas kernel's VMEM scratch)."""
    n_layers = len(weights)
    dims = (ctypes.c_int * (n_layers + 1))(
        weights[0].shape[1], *(int(w.shape[0]) for w in weights))
    w_ptrs = (ctypes.c_void_p * n_layers)(*(w.data_ptr() for w in weights))
    dw_ptrs = (ctypes.c_void_p * n_layers)(
        *((m.data_ptr() for m in dw) if momentum else [None] * n_layers))
    return dims, w_ptrs, dw_ptrs, (2 * sum(dims[1:]) + 1) * batch


def _launch(name, weights, dw, X, T, order, batch, *, model, momentum, lr,
            alpha, prefetch):
    """One launch of #2-#5 (``order``: a host int32 tensor) on the
    cooperative grid, or on one cluster of ``_team`` CTAs."""
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel is built for float32 and float64, not {X.dtype}")
    dev = X.device
    cluster = _team
    if cluster:
        blocks = 0
        _placed(cluster, X.dtype, dev)
    else:
        blocks = grid_blocks(X.dtype, dev)
    lib = _library(_variant)
    S = order.numel()
    # one step reads its block by index; an epoch's order goes to the card
    ord_dev = order.to(dev) if S > 1 else None
    first = 0 if S > 1 else int(order[0])
    dims, w_ptrs, dw_ptrs, n_scratch = _layers(weights, dw, momentum, batch)
    scratch = torch.empty(n_scratch, dtype=X.dtype, device=dev)
    losses = torch.empty(S, dtype=X.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # lr·(1/B) in double on the host, as the JAX Python-scalar product is
        rc = lib.hpnn_batch_train(
            _DTYPE_CODE[X.dtype], blocks, cluster, int(model == "snn"), int(bool(momentum)),
            len(weights), ctypes.addressof(dims), ctypes.addressof(w_ptrs),
            ctypes.addressof(dw_ptrs), X.data_ptr(), T.data_ptr(), int(batch),
            None if ord_dev is None else ord_dev.data_ptr(), first, S,
            float(lr) * (1.0 / batch), float(alpha), 1.0 / batch, scratch.data_ptr(),
            losses.data_ptr(), int(bool(prefetch)), stream,
        )
    if rc != 0:
        team = f"one {cluster}-CTA cluster" if cluster else f"a grid of {blocks} blocks"
        _raise_on(lib, rc, f"launch ({team}, {shared_bytes(X.dtype)} bytes of shared "
                           f"memory a block)")
    launches[name] += 1
    return losses


def _plain_epoch(weights, dw, X, T, order, batch, *, model, momentum, lr, alpha):
    """``dp.train_step_math`` on each block in ``order``; weights and dw
    updated in place; the (S,) losses."""
    losses = []
    state_w, state_dw = tuple(weights), tuple(dw) if momentum else ()
    for k in order.tolist():
        rows = slice(k * batch, (k + 1) * batch)
        state_w, state_dw, loss = dp.train_step_math(
            state_w, state_dw, X[rows], T[rows], model=model,
            momentum=momentum, lr=lr, alpha=alpha)
        losses.append(loss)
    with torch.no_grad():
        for dst, src in zip(tuple(weights) + tuple(dw if momentum else ()),
                            state_w + state_dw):
            dst.copy_(src)
    return torch.stack(losses)


def _run(name, weights, dw, X, T, order, batch, *, prefetch, model="ann",
         momentum=False, lr=None, alpha=0.2):
    """Check, then the kernel (``name`` given and CUDA tensors) or the
    plain version (``name`` None, or CPU tensors)."""
    _check(weights, dw, X, T, batch, model, momentum)
    order = _order(order, X.shape[0] // batch)
    if lr is None:
        lr = dp.default_lr(model, momentum)
    kw = dict(model=model, momentum=momentum, lr=lr, alpha=alpha)
    if name is None or X.device.type == "cpu":
        return _plain_epoch(weights, dw, X, T, order, batch, **kw)
    return _launch(name, weights, dw, X, T, order, batch, prefetch=prefetch, **kw)


# ------------------------------------------------------------------ fleet
def _check_fleet(weights, dw, X_banks, T_banks, orders, batch, model, momentum):
    """The stacked checks of #6; returns ``orders`` as a host ``(N, S)``
    int32 tensor of in-range block ids."""
    if X_banks.dim() != 3 or T_banks.dim() != 3:
        raise ValueError(f"want X_banks (N, rows, n_in) and T_banks (N, rows, n_out), "
                         f"got {tuple(X_banks.shape)} and {tuple(T_banks.shape)}")
    state = tuple(weights) + (tuple(dw) if momentum else ())
    if any(t.dim() != 3 for t in state):
        raise ValueError("stacked weights and dw must be (N, out, in)")
    o = torch.as_tensor(orders).cpu()
    if o.dim() != 2:
        raise ValueError(f"orders must be (N, S), got {tuple(o.shape)}")
    n = {int(t.shape[0]) for t in (X_banks, T_banks, o, *state)}
    if len(n) != 1:
        raise ValueError(f"member counts disagree across weights, dw, banks and "
                         f"orders: {sorted(n)}")
    for t in (X_banks, T_banks, *state):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"the kernel is built for float32 and float64, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("stacked weights, dw and banks must be contiguous")
    # one member's shapes, types and devices, as for #2-#5
    _check([w[0] for w in weights], [m[0] for m in dw] if momentum else dw,
           X_banks[0], T_banks[0], batch, model, momentum)
    return _order(o, X_banks.shape[1] // batch).reshape(o.shape)


def _launch_fleet(weights, dw, X_banks, T_banks, orders, batch, *, model,
                  momentum, lr, alpha, cluster):
    if X_banks.device.type != "cuda":
        raise ValueError(f"unsupported device {X_banks.device}")
    dev = X_banks.device
    lib = _library(_variant)
    N, S = (int(v) for v in orders.shape)
    shapes = tuple(tuple(w.shape[1:]) for w in weights)
    key = _key(X_banks.dtype, dev) + (N, shapes, batch, cluster)
    C = _plans.get(key)
    if C is None:
        cap = cluster_capacity(X_banks.dtype, dev)
        C = _plans[key] = _placed(fleet_cluster(N, shapes, batch, cap, cluster=cluster),
                                  X_banks.dtype, dev)
    ord_dev = orders.to(dev)
    # member 0's layers; the kernel steps to member i by the strides
    dims, w_ptrs, dw_ptrs, n_scratch = _layers(
        [w[0] for w in weights], [m[0] for m in dw] if momentum else (), momentum, batch)
    scratch = torch.empty(N * n_scratch, dtype=X_banks.dtype, device=dev)
    losses = torch.empty((N, S), dtype=X_banks.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # lr·(1/B) in double on the host, as the JAX Python-scalar product is
        rc = lib.hpnn_fleet_train(
            _DTYPE_CODE[X_banks.dtype], N, C, int(model == "snn"), int(bool(momentum)),
            len(weights), ctypes.addressof(dims), ctypes.addressof(w_ptrs),
            ctypes.addressof(dw_ptrs), X_banks.data_ptr(), T_banks.data_ptr(),
            int(X_banks.shape[1]), int(batch), ord_dev.data_ptr(), S,
            float(lr) * (1.0 / batch), float(alpha), 1.0 / batch,
            scratch.data_ptr(), losses.data_ptr(), stream,
        )
    if rc != 0:
        _raise_on(lib, rc, f"fleet launch ({N} clusters of {C} CTAs, "
                           f"{shared_bytes(X_banks.dtype)} bytes of shared memory a CTA)")
    launches["train_fleet_epoch_dbuf_banked"] += 1
    return losses


def _run_fleet(kernel, weights, dw, X_banks, T_banks, orders, *, batch,
               model="ann", momentum=False, lr=None, alpha=0.2, cluster=None):
    """Check, then the kernel (``kernel`` and CUDA tensors) or, per
    member, the plain epoch (``kernel`` False, or CPU tensors)."""
    orders = _check_fleet(weights, dw, X_banks, T_banks, orders, batch, model, momentum)
    if cluster is not None:
        _cluster_arg(cluster)
    if lr is None:
        lr = dp.default_lr(model, momentum)
    kw = dict(model=model, momentum=momentum, lr=lr, alpha=alpha)
    if not kernel or X_banks.device.type == "cpu":
        return torch.stack([
            _plain_epoch([w[i] for w in weights], [m[i] for m in dw] if momentum else (),
                         X_banks[i], T_banks[i], orders[i], batch, **kw)
            for i in range(orders.shape[0])])
    return _launch_fleet(weights, dw, X_banks, T_banks, orders, batch, cluster=cluster, **kw)


# ------------------------------------------------------------ entry points
# Each takes ``model`` ("ann" | "snn"), ``momentum``, ``lr`` (default
# ``dp.default_lr``) and ``alpha`` (0.2) by keyword; the fleet epoch also
# ``cluster``, the members' cluster size (default :func:`fleet_cluster`'s
# plan), which its plain version checks and ignores.
def _step_batch(name, weights, dw, X, T, **kw):
    losses = _run(name, weights, dw, X, T, [0], X.shape[0], prefetch=False, **kw)
    return weights, dw, losses[0]


def _step_banked(name, weights, dw, X_bank, T_bank, k, *, batch, **kw):
    if torch.as_tensor(k).numel() != 1:
        raise ValueError("k must be one block index")
    losses = _run(name, weights, dw, X_bank, T_bank, k, batch, prefetch=False, **kw)
    return weights, dw, losses[0]


def _epoch_banked(name, weights, dw, X_bank, T_bank, order, *, batch, **kw):
    return weights, dw, _run(name, weights, dw, X_bank, T_bank, order, batch,
                             prefetch=name == "train_epoch_dbuf_banked", **kw)


def train_step_fused_batch(weights, dw, X, T, **kw):
    """One minibatch step on the ``(B, n)`` block ``X``/``T``; the
    drop-in for ``dp.train_step_math``.  Returns (weights, dw, loss)."""
    return _step_batch("train_step_fused_batch", weights, dw, X, T, **kw)


def train_step_fused_banked(weights, dw, X_bank, T_bank, k, *, batch: int, **kw):
    """One step on rows ``[k·B, (k+1)·B)`` of the bank, read in place
    (no gather copy).  ``k``: an int or a one-element tensor.  Returns
    (weights, dw, loss)."""
    return _step_banked("train_step_fused_banked", weights, dw, X_bank, T_bank, k,
                        batch=batch, **kw)


def train_epoch_grid_banked(weights, dw, X_bank, T_bank, order, *, batch: int, **kw):
    """S banked steps in one launch, block ``order[s]`` at step ``s``;
    exactly S successive :func:`train_step_fused_banked` steps.
    Returns (weights, dw, losses[S])."""
    return _epoch_banked("train_epoch_grid_banked", weights, dw, X_bank, T_bank,
                         order, batch=batch, **kw)


def train_epoch_dbuf_banked(weights, dw, X_bank, T_bank, order, *, batch: int, **kw):
    """:func:`train_epoch_grid_banked` with each step first starting the
    copy of block ``order[s+1]`` into L2 (the double-buffered DMA epoch
    of the JAX package).  Returns (weights, dw, losses[S])."""
    return _epoch_banked("train_epoch_dbuf_banked", weights, dw, X_bank, T_bank,
                         order, batch=batch, **kw)


def train_fleet_epoch_dbuf_banked(weights, dw, X_banks, T_banks, orders, *,
                                  batch: int, **kw):
    """N members' :func:`train_epoch_dbuf_banked` epochs in ONE launch,
    cluster i of the grid on member i: member i's slice of the stacked
    ``(N, out, in)`` weights (and dw), its bank ``X_banks[i]``,
    ``T_banks[i]`` of ``(N, S·B, n)``, its block order ``orders[i]`` of
    ``(N, S)``.  Member i's result is bitwise that of
    :func:`train_epoch_dbuf_banked` on bank i with ``orders[i]``.
    Returns (weights, dw, losses[N, S])."""
    return weights, dw, _run_fleet(True, weights, dw, X_banks, T_banks, orders,
                                   batch=batch, **kw)


# ---------------------------------------------------- the plain versions
# The same functions in plain tensor operations on the inputs' device.
def train_step_fused_batch_plain(weights, dw, X, T, **kw):
    return _step_batch(None, weights, dw, X, T, **kw)


def train_step_fused_banked_plain(weights, dw, X_bank, T_bank, k, *, batch: int, **kw):
    return _step_banked(None, weights, dw, X_bank, T_bank, k, batch=batch, **kw)


def train_epoch_grid_banked_plain(weights, dw, X_bank, T_bank, order, *, batch: int, **kw):
    return _epoch_banked(None, weights, dw, X_bank, T_bank, order, batch=batch, **kw)


def train_epoch_dbuf_banked_plain(weights, dw, X_bank, T_bank, order, *, batch: int, **kw):
    """The same function as the grid epoch's: the prefetch moves no result."""
    return _epoch_banked(None, weights, dw, X_bank, T_bank, order, batch=batch, **kw)


def train_fleet_epoch_dbuf_banked_plain(weights, dw, X_banks, T_banks, orders, *,
                                        batch: int, **kw):
    """The grid epoch's plain version, member by member."""
    return weights, dw, _run_fleet(False, weights, dw, X_banks, T_banks, orders,
                                   batch=batch, **kw)
