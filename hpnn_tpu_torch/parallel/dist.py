"""Multi-process worlds: joining one, starting one, and the rank-0
protocol (the port of ``hpnn_tpu/parallel/dist.py``).

The reference runs ``mpirun -np X train_nn`` (ref: libhpnn
src/libhpnn.c:182-200); the JAX package joins a ``jax.distributed``
cluster from ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
``JAX_PROCESS_ID`` and drives every local device from one process.
Here one process drives one device, as ``torchrun`` lays a world out:

* **The launcher contract** is the torchrun environment: ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.
  :func:`init_world` joins the world it describes, with a bounded
  ``timeout`` so that a rank that dies cannot hang its peers for long.
* **Starting a world here**: :func:`launch` starts the ranks of one
  command as local child processes (the CLIs' ``--mesh DxM`` without
  that environment starts its D×M ranks this way), relays rank 0's
  standard output and every rank's standard error, and kills the
  survivors as soon as one rank exits non-zero; :func:`run` calls a
  Python function on every rank of such a world and returns each
  rank's result.  Each child gets the package root on ``PYTHONPATH``.
* **Ranks and devices**: on ``cuda`` rank r drives ``cuda:{LOCAL_RANK}``
  over NCCL, on the CPU gloo; a caller may name both (``run(...,
  backend="gloo", device="cuda:0")`` runs two gloo ranks on one card).
  The device defaults to ``cuda`` (``runtime.resolve_device``: no CPU
  fallback), and a mesh built in a world lives on the device that world
  was joined with.
* **The rank-0 protocol**: rank 0 alone prints and writes files
  (``utils/logging.py``, the CLIs); :func:`sync_rank0_ok` gives every
  rank rank 0's outcome, :func:`resolve_time_seed` rank 0's clock,
  :func:`census_consistent` a verdict on every rank's sample listing,
  :func:`allgather_checksums` every rank's checksums.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as tdist

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
DEFAULT_TIMEOUT_S = 600.0   # a collective waits at most this long for its peers
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_device: torch.device | None = None        # the joined world's collective device
_rank_device: torch.device | None = None   # the device this rank computes on


# ------------------------------------------------------------------ worlds
def in_launched_world() -> bool:
    """True when the torchrun environment describes a world to join
    (``LOCAL_RANK`` defaults to ``RANK``)."""
    return all(os.environ.get(k) for k in ENV if k != "LOCAL_RANK")


def init_world(*, device=None, backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world of the torchrun environment; returns this rank's
    device.  ``device`` ``cuda`` (default) means ``cuda:{LOCAL_RANK}``,
    an indexed ``cuda:i`` that card, ``cpu`` the CPU (raises
    ``runtime.DeviceUnavailable`` for CUDA without a card: no rank moves
    to the CPU).  ``backend`` defaults to NCCL on cuda, gloo on the CPU.
    Every collective then waits at most ``timeout`` seconds."""
    global _device, _rank_device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = runtime.resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    # env://: MASTER_ADDR/MASTER_PORT name the rendezvous (under torchrun
    # its agent's store, which env:// joins instead of binding anew)
    tdist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    # host-level collectives (seed, census, checksums) ride tensors on
    # the backend's device: NCCL takes CUDA tensors only
    _device = dev if backend == "nccl" else torch.device("cpu")
    _rank_device = dev
    runtime.init_dist()
    return dev


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    global _device, _rank_device
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _device = _rank_device = None
    runtime.init_dist()


def hybrid_mesh(n_model: int = 1, *, device=None) -> Mesh:
    """This rank's ``(data, model)`` mesh over the joined world:
    ``world / n_model`` data shards of ``n_model`` row blocks, rank
    ``d * n_model + m`` at ``(d, m)``.  Every rank must call it (it
    creates the axes' process groups, one per data row and one per
    model column, in the same order on every rank).  An axis of one
    rank gets no group unless the world has one rank, whose two axes
    both get the world's group.  The mesh lives on ``device``, by
    default the device the world was joined with (:func:`init_world`).
    Outside a world: the 1x1 mesh with no group on ``device`` (default
    ``cuda``; raises ``runtime.DeviceUnavailable`` without a card)."""
    dev = runtime.resolve_device(_rank_device if device is None else device)
    if not (tdist.is_available() and tdist.is_initialized()):
        if n_model != 1:
            raise ValueError(f"a {n_model}-way model axis needs a world of "
                             f"{n_model} ranks; none was joined")
        return Mesh(1, 1, device=dev)
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if world % n_model:
        raise ValueError(f"{world} ranks not divisible by n_model={n_model}")
    n_data = world // n_model
    groups = {}
    if world == 1:
        groups = {DATA_AXIS: tdist.group.WORLD, MODEL_AXIS: tdist.group.WORLD}
    else:
        mine = Mesh(n_data, n_model, rank=rank, device=dev)
        if n_model > 1:
            for d in range(n_data):
                g = tdist.new_group([d * n_model + m for m in range(n_model)])
                if d == mine.index[DATA_AXIS]:
                    groups[MODEL_AXIS] = g
        if n_data > 1:
            for m in range(n_model):
                g = tdist.new_group([d * n_model + m for d in range(n_data)])
                if m == mine.index[MODEL_AXIS]:
                    groups[DATA_AXIS] = g
    return Mesh(n_data, n_model, rank=rank, device=dev, groups=groups)


# ------------------------------------------------------- the rank-0 protocol
def _world_tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(_device or "cpu")


def _allgather(arr) -> np.ndarray:
    """Every rank's copy of the 1-D array ``arr``, stacked in rank order."""
    t = _world_tensor(arr)
    parts = [torch.empty_like(t) for _ in range(runtime.process_count())]
    tdist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def _broadcast0(value, dtype) -> np.ndarray:
    t = _world_tensor(np.asarray([value], dtype=dtype))
    tdist.broadcast(t, src=0)
    return t.cpu().numpy()[0]


def resolve_time_seed(seed: int) -> int:
    """``[seed] 0`` (the reference's ``srandom(time(NULL))``) turned into
    one seed for every rank: rank 0's clock, broadcast, so that ranks
    loading the conf across a second boundary still build one kernel
    and replay one shuffle.  Identity for a nonzero seed."""
    if seed != 0:
        return seed
    s = int(time.time())
    n = runtime.process_count()
    if n > 1:
        with obs.timer("coll.seed_broadcast", ranks=n):
            s = int(_broadcast0(s, np.int64))
    return s


def census_consistent(names) -> bool:
    """Every rank must hold the same sample files in the same order, or
    the ranks would train different samples in lockstep.  Ranks
    all-gather a hash of their listing and every rank reaches the same
    verdict (none is left behind in a collective).  True outside a
    world."""
    n = runtime.process_count()
    if n < 2:
        return True
    digest = hashlib.sha256("\n".join(names).encode()).digest()[:8]
    mine = np.frombuffer(digest, dtype=np.int64)
    with obs.timer("coll.census_allgather", ranks=n, files=len(names)):
        every = _allgather(mine)
    return bool((every == every[0]).all())


def allgather_checksums(vec) -> np.ndarray:
    """Every rank's checksum vector as an ``(n_ranks, n)`` float64
    matrix (every rank sees all of them, so every rank reaches the same
    divergence verdict); ``(1, n)`` outside a world."""
    v = np.asarray(vec, dtype=np.float64).reshape(-1)
    n = runtime.process_count()
    if n < 2:
        return v.reshape(1, -1)
    with obs.timer("coll.checksum_allgather", ranks=n, n=v.size):
        return _allgather(v).reshape(n, -1)


def sync_rank0_ok(ok: bool) -> bool:
    """Rank 0's outcome on every rank, so every rank takes the same
    branch (rank 0's kernel-file write: peers must not go on into
    collective training while rank 0 aborts).  The reference's load-time
    bail-out protocol (ref: src/ann.c:242-248)."""
    n = runtime.process_count()
    if n < 2:
        return ok
    with obs.timer("coll.rank0_sync", ranks=n):
        return bool(_broadcast0(1 if ok else 0, np.int32))


def process_summary() -> str:
    """One-line world summary for logs (rank, #ranks, devices)."""
    n = runtime.process_count()
    return (f"process {runtime.process_index()}/{n} local_devices=1 "
            f"global_devices={n}")


# ------------------------------------------------------- starting a world
def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relay(pipe, out):
    for line in iter(pipe.readline, b""):
        out.write(line.decode(errors="replace"))
        out.flush()
    pipe.close()


def launch(argv: list[str], world: int, *, timeout: float | None = None) -> int:
    """Run ``python <argv>`` as ``world`` local ranks of one world (the
    torchrun environment set for each, ``PYTHONPATH`` led by the
    package root) and wait for them.  Rank 0's standard output goes to
    ``sys.stdout``, the other ranks' and every standard error to
    ``sys.stderr``.  When a rank exits non-zero the survivors are
    killed at once; past ``timeout`` seconds every rank is.  Returns
    rank 0's exit code (255 read as -1), or the first other non-zero
    one, or 124 after a timeout."""
    port = free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p])
    # c10d warns on stderr for every rank whose peer has no host name
    base.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
    # as torchrun: one intra-op thread a rank unless the caller set it
    base.setdefault("OMP_NUM_THREADS", "1")
    procs, relays = [], []
    for r in range(world):
        env = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world))
        p = subprocess.Popen([sys.executable, *argv], env=env,
                             stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        procs.append(p)
        for pipe, out in ((p.stdout, sys.stdout if r == 0 else sys.stderr),
                          (p.stderr, sys.stderr)):
            t = threading.Thread(target=_relay, args=(pipe, out), daemon=True)
            t.start()
            relays.append(t)
    deadline = None if timeout is None else time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            rcs = [p.poll() for p in procs]   # every rank polled each round
            if None not in rcs:
                break
            failed = any(rc not in (None, 0) for rc in rcs)
            timed_out = deadline is not None and time.monotonic() > deadline
            if failed or timed_out:
                _kill(procs)
                break
            time.sleep(0.02)
    finally:
        _kill(procs)
        for t in relays:
            t.join(timeout=10)
    if timed_out:
        sys.stderr.write(f"dist.launch: {world} ranks killed after {timeout} s\n")
        return 124
    rcs = [-1 if p.returncode == 255 else p.returncode for p in procs]
    if rcs[0] != 0:
        return rcs[0]
    return next((rc for rc in rcs if rc != 0), 0)


def _kill(procs) -> None:
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.send_signal(signal.SIGTERM)
    t_end = time.monotonic() + 5.0
    for p in alive:
        try:
            p.wait(timeout=max(0.0, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run(target: str, world: int, *, mesh=(None, 1), backend: str | None = None,
        device=None, args: tuple = (), timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Call ``target(mesh, *args)`` on each of ``world`` local ranks and
    return the ranks' results in rank order.

    ``target`` is ``"module:function"``, the module a dotted name or a
    path to a ``.py`` file (loaded by path, so nothing else of its
    package is imported).  Each rank joins the world with ``backend``
    and ``device`` (:func:`init_world`: ``cuda`` unless the caller asks
    for the CPU; raises ``runtime.DeviceUnavailable`` here, before any
    rank starts, when there is no card), builds its ``mesh``
    (``(n_data, n_model)``; ``n_data`` None: the world over
    ``n_model``) with :func:`hybrid_mesh`, calls the target and pickles
    its result back.  ``args`` and results must pickle.  Every
    collective waits at most ``timeout`` seconds, the launch a minute
    more.  Raises ``RuntimeError`` with the exit code when the launch
    fails."""
    runtime.resolve_device(device)
    n_data, n_model = mesh
    if n_data is not None and n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                         f"not {world}")
    work = tempfile.mkdtemp(prefix="hpnn-world-")
    try:
        with open(os.path.join(work, "payload.pkl"), "wb") as fp:
            pickle.dump(dict(target=target, args=tuple(args), backend=backend,
                             device=device, n_model=n_model, timeout=timeout), fp)
        # the launch outlives a collective's own timeout, so a rank
        # stuck in one fails by itself before the launcher kills it
        rc = launch(["-m", "hpnn_tpu_torch.parallel.dist", work], world,
                    timeout=timeout + 60.0)
        if rc != 0:
            raise RuntimeError(f"dist.run({target!r}, world={world}) exited {rc}")
        out = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as fp:
                out.append(pickle.load(fp))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _load_target(target: str):
    mod_name, fn_name = target.rsplit(":", 1)
    if mod_name.endswith(".py"):
        import importlib.util

        spec = importlib.util.spec_from_file_location("_hpnn_rank_target", mod_name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _rank_main(work: str) -> int:
    """One rank of :func:`run`."""
    with open(os.path.join(work, "payload.pkl"), "rb") as fp:
        job = pickle.load(fp)
    fn = _load_target(job["target"])
    init_world(device=job["device"], backend=job["backend"], timeout=job["timeout"])
    try:
        result = fn(hybrid_mesh(job["n_model"]), *job["args"])
        rank = runtime.process_index()
        path = os.path.join(work, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as fp:
            pickle.dump(result, fp)
        os.replace(path + ".tmp", path)
        tdist.barrier()
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    # run through the package's module, not this __main__ copy, so the
    # world state lives where the rest of the package looks for it
    from hpnn_tpu_torch.parallel import dist as _dist

    sys.exit(_dist._rank_main(sys.argv[1]))
