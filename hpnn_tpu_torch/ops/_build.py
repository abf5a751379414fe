"""Build and load the package's native sources.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a
shared library with a plain C interface, ``csrc/build/lib<name>.so``,
and loaded with ``ctypes``; the host library ``csrc/<name>.cpp`` is
compiled the same way by ``g++`` (:func:`build_host`).  A library older
than its source is rebuilt, into a per-process temporary file renamed
into place, so concurrent first uses never load a half-written library.
A variant built with a ``-D`` define goes to ``lib<name>.<define>.so``.
Nothing here runs at import time: the CPU-only test machine has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# no --use_fast_math: expf/logf/exp/log keep their full accuracy
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
# name (or (name, define)) -> (seconds, compiler output) of the build this process ran
build_log: dict = {}


class NvccError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise NvccError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(src: str, out: str, cmd: list, force: bool, key) -> str:
    """Run ``cmd + ["-o", tmp, src]`` unless ``out`` is newer than
    ``src``, then rename ``tmp`` to ``out``."""
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise NvccError(
                f"{os.path.basename(cmd[0])} failed ({proc.returncode}) on {src}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[key] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def build(name: str, *, force: bool = False, define: str | None = None) -> str:
    """Compile ``csrc/<name>.cu`` (with ``-D<define>``) unless an
    up-to-date library exists; returns the library path."""
    out = os.path.join(BUILD_DIR, f"lib{name}{'.' + define if define else ''}.so")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, *([f"-D{define}"] if define else [])]
    return _compile(os.path.join(CSRC, name + ".cu"), out, cmd, force,
                    (name, define) if define else name)


def build_host(name: str, *, force: bool = False) -> str:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` unless
    an up-to-date library exists; returns the library path.  Raises
    :class:`NvccError` (the build error of this module) when g++ fails."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    return _compile(os.path.join(CSRC, name + ".cpp"), out,
                    [shutil.which("g++") or "g++", *GXX_FLAGS], force, name)


def load(name: str, define: str | None = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get((name, define))
        if lib is None:
            lib = ctypes.CDLL(build(name, define=define))
            _libs[(name, define)] = lib
        return lib
