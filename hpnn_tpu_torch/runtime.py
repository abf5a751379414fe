"""Runtime / capability / device-probe layer.

Reimplements the reference's L1 runtime layer
(ref: libhpnn src/libhpnn.c:60-539): a capability registry, a
global runtime singleton, and per-backend init/deinit + setters.

* ``NNCap.CUDA`` is set when ``torch.cuda`` finds a card (the
  reference probes ``cudaGetDeviceCount``, src/libhpnn.c:201-305).
* Multi-process: the MPI task count is the ``torch.distributed``
  world's size (``parallel/dist.py`` joins the world the torchrun
  environment describes); :func:`process_index` is this process's
  rank, 0 outside a world.
* OMP/BLAS thread counts are recorded; ``-O`` also sets torch's
  intra-op thread count.  The CUDA stream count (``-S``) is advisory:
  every launch goes to PyTorch's current stream.
* :func:`resolve_device` is the entry points' device rule: ``cuda``
  unless the caller asks for the CPU, and never a silent CPU run when
  CUDA was asked for but is absent.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import sys

import numpy as np
import torch

from hpnn_tpu_torch.utils import logging as log


class NNCap(enum.IntFlag):
    """Capability bits (ref: libhpnn include/libhpnn.h:26-35)."""

    NONE = 0
    OMP = 1 << 0      # intra-host threading
    MPI = 1 << 1      # multi-process: a torch.distributed world of > 1
    CUDA = 1 << 2     # a CUDA card is present
    CUBLAS = 1 << 3   # kept for surface parity; never set
    # (1<<4) reserved for OCL in the reference
    PBLAS = 1 << 5    # whole-layer matmul path
    SBLAS = 1 << 6    # per-row path; never set


@dataclasses.dataclass
class NNRuntime:
    """Global runtime parameters (ref: include/libhpnn.h:39-47)."""

    capability: NNCap = NNCap.NONE
    nn_verbose: int = 0
    nn_dry: bool = False
    nn_num_threads: int = 1
    nn_num_blas: int = 1
    nn_num_tasks: int = 1
    nn_num_streams: int = 1   # advisory
    n_devices: int = 0        # CUDA device count
    platform: str = "cpu"


_runtime = NNRuntime()


def runtime() -> NNRuntime:
    return _runtime


# ---------------------------------------------------------------- verbosity
def set_verbose(v: int) -> None:
    _runtime.nn_verbose = v
    log.set_verbose(v)


def inc_verbose() -> None:
    log.inc_verbose()
    _runtime.nn_verbose = log.get_verbose()


def dec_verbose() -> None:
    log.dec_verbose()
    _runtime.nn_verbose = log.get_verbose()


def return_verbose() -> int:
    return log.get_verbose()


def toggle_dry() -> None:
    # The reference's toggle is a no-op bug (`x^=x`, ref:
    # src/libhpnn.c:88-90) and nn_dry is never read; we implement the
    # intended toggle but likewise never act on it.
    _runtime.nn_dry = not _runtime.nn_dry


# -------------------------------------------------------------- capabilities
def get_capabilities() -> NNCap:
    return _runtime.capability


def unset_capability(cap: NNCap) -> None:
    _runtime.capability &= ~cap


# ------------------------------------------------------------------- inits
def init_runtime() -> None:
    """A fresh runtime, verbosity 0."""
    global _runtime
    _runtime = NNRuntime()
    log.set_verbose(0)


def init_threads() -> bool:
    """Intra-host threading init (replaces ``_NN(init,OMP)``)."""
    n = int(os.environ.get("OMP_NUM_THREADS", 0) or 0)
    if n < 1:
        n = os.cpu_count() or 1
    _runtime.nn_num_threads = n
    _runtime.nn_num_blas = n
    _runtime.capability |= NNCap.OMP | NNCap.PBLAS
    return True


def init_cuda() -> bool:
    """Device probe (replaces ``_NN(init,CUDA)``'s ``cudaGetDeviceCount``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    _runtime.n_devices = n
    if n:
        _runtime.platform = "cuda"
        _runtime.capability |= NNCap.CUDA
    return True


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` world, 0 when
    no world was joined (the JAX package's ``jax.process_index()``)."""
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def process_count() -> int:
    """The world's size, 1 when no world was joined."""
    import torch.distributed as tdist

    return (tdist.get_world_size()
            if tdist.is_available() and tdist.is_initialized() else 1)


def init_dist() -> bool:
    """Record the joined world (replaces ``_NN(init,MPI)``'s task
    count): ``nn_num_tasks`` is its size, and ``NNCap.MPI`` is set when
    it holds more than one process.  ``parallel/dist.py`` joins the
    world and calls this."""
    n = process_count()
    _runtime.nn_num_tasks = n
    if n > 1:
        _runtime.capability |= NNCap.MPI
    return True


def init_all(init_verbose: int = 0) -> int:
    """``_NN(init,all)`` equivalent (ref: src/libhpnn.c:326-347).

    Like the reference, ``init_verbose`` applies only DURING init and is
    reset to 0 before returning (ref: src/libhpnn.c:344) — the CLIs'
    ``-v`` flags then raise it from 0.
    """
    global _runtime
    _runtime = NNRuntime()
    set_verbose(init_verbose)
    init_dist()
    init_threads()
    init_cuda()
    log.nn_out(
        sys.stdout,
        "runtime: platform=%s devices=%i tasks=%i threads=%i\n",
        _runtime.platform,
        _runtime.n_devices,
        _runtime.nn_num_tasks,
        _runtime.nn_num_threads,
    )
    set_verbose(0)
    return 0


def deinit_all() -> int:
    _runtime.capability = NNCap.NONE
    return 0


# ----------------------------------------------------------------- setters
def set_omp_threads(n: int) -> bool:
    _runtime.nn_num_threads = max(1, int(n))
    torch.set_num_threads(_runtime.nn_num_threads)
    return True


def get_omp_threads() -> int:
    return _runtime.nn_num_threads


def set_omp_blas(n: int) -> bool:
    _runtime.nn_num_blas = max(1, int(n))
    return True


def get_omp_blas() -> int:
    return _runtime.nn_num_blas


def set_cuda_streams(n: int) -> bool:
    # advisory: launches go to PyTorch's current stream
    _runtime.nn_num_streams = max(1, int(n))
    return True


def get_cuda_streams() -> int:
    return _runtime.nn_num_streams


def set_mpi_tasks(n: int) -> bool:
    # the task count is the torch.distributed world's, fixed at launch
    return False


def get_mpi_tasks() -> int:
    return _runtime.nn_num_tasks


def n_devices() -> int:
    return _runtime.n_devices


# ------------------------------------------------------------ device rules
class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (explicitly or by default) but is absent."""


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises
    :class:`DeviceUnavailable` rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "CUDA is not available; pass --device cpu (or device='cpu') "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def compute_dtype(device: torch.device) -> torch.dtype:
    """Training/eval dtype: ``HPNN_DTYPE`` wins, else float32 on cuda
    and float64 on the CPU (the parity mode, the counterpart of the JAX
    package's ``JAX_ENABLE_X64=1`` on the CPU)."""
    dt = os.environ.get("HPNN_DTYPE")
    if dt:
        name = np.dtype(dt).name
        if name not in ("float32", "float64"):
            raise ValueError(f"HPNN_DTYPE={dt}: want float32 or float64")
        return getattr(torch, name)
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


# ----------------------------------------------------- knobs of other paths
# environment knob -> (value that selects the missing path or None for
# any value, the path): XLA's persistent executable cache, which has no
# counterpart (a CUDA graph cannot be written to disk, so a serve
# engine captures its graphs anew in every process)
DEFERRED_ENV = {
    "HPNN_COMPILE_CACHE_DIR": (None, "XLA's persistent executable cache "
                               "(a CUDA graph cannot be written to disk)"),
}


def deferred_env_message(prog: str, env=None) -> str | None:
    """The refusal of the first set knob of :data:`DEFERRED_ENV` in
    ``env`` (default ``os.environ``), or None: the CLIs and the library
    entry points refuse such a knob, never ignore it."""
    env = os.environ if env is None else env
    for knob, (value, path) in DEFERRED_ENV.items():
        cur = env.get(knob)
        if cur and (value is None or cur == value):
            return (f"{prog}: {knob}={cur} selects {path}, which "
                    f"hpnn_tpu_torch does not have yet; unset it")
    return None


def refuse_deferred(prog: str) -> None:
    """Raise ``NotImplementedError`` with :func:`deferred_env_message`
    when a knob of :data:`DEFERRED_ENV` is set (the library entry
    points' refusal)."""
    msg = deferred_env_message(prog)
    if msg:
        raise NotImplementedError(msg)
