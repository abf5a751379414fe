"""The native (C++) host library, built on first use and bound with ctypes.

The counterpart of the JAX package's ``native`` module, over the same
source (``csrc/hpnn_native.cpp``): the glibc ``random()`` clone and the
file-visit shuffle, the GET_DOUBLE walk of a text row, and the
``%17.15f`` kernel-row formatting.  ``ops/_build.py`` compiles it with
``g++`` into ``csrc/build/libhpnn_native.so``.

:func:`lib` returns the loaded library or ``None``; every caller keeps
its pure-Python walk, which gives the same results.  ``HPNN_NO_NATIVE=1``
forces the Python walks (read on every call).  A failed build or load
says so once on stderr and leaves the Python walks in place: this is
host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _bind(libc: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    libc.glibc_new.argtypes = [ctypes.c_uint32]
    libc.glibc_new.restype = ctypes.c_void_p
    libc.glibc_delete.argtypes = [ctypes.c_void_p]
    libc.glibc_delete.restype = None
    libc.glibc_next.argtypes = [ctypes.c_void_p]
    libc.glibc_next.restype = ctypes.c_int32
    libc.glibc_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32p]
    libc.glibc_fill.restype = None
    libc.glibc_weights.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, f64p,
    ]
    libc.glibc_weights.restype = None
    libc.glibc_shuffle.argtypes = [ctypes.c_uint32, ctypes.c_int64, i32p]
    libc.glibc_shuffle.restype = None
    libc.parse_doubles.argtypes = [ctypes.c_char_p, ctypes.c_int64, f64p]
    libc.parse_doubles.restype = ctypes.c_int64
    libc.format_row.argtypes = [f64p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    libc.format_row.restype = ctypes.c_int64
    return libc


def lib() -> ctypes.CDLL | None:
    """The native library, built on first use; None when
    ``HPNN_NO_NATIVE`` is set or the build or load failed."""
    global _lib, _tried
    if os.environ.get("HPNN_NO_NATIVE"):
        return None
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        from hpnn_tpu_torch.ops import _build

        try:
            _lib = _bind(ctypes.CDLL(_build.build_host("hpnn_native")))
        except (OSError, _build.NvccError) as exc:
            sys.stderr.write(f"hpnn native library unavailable, using the "
                             f"Python walks: {exc}\n")
            _lib = None
        _tried = True
    return _lib


# ------------------------------------------------------- typed wrappers
def glibc_shuffle(seed: int, n: int):
    """The file-visit order as an int32 array, or None without the
    library."""
    L = lib()
    if L is None or n == 0:
        return None
    out = np.empty(n, dtype=np.int32)
    L.glibc_shuffle(ctypes.c_uint32(seed & 0xFFFFFFFF), n,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def parse_doubles(text: str | bytes, maxn: int):
    """The first ``maxn`` doubles of a text line by the GET_DOUBLE walk,
    or None without the library."""
    L = lib()
    if L is None:
        return None
    if isinstance(text, str):
        text = text.encode()
    # maxn may come from an untrusted file header; the walk advances at
    # least one byte a slot inside the line, so it writes at most
    # len + 1 slots (the caller zero-fills the rest)
    maxn = min(maxn, len(text) + 1)
    out = np.empty(maxn, dtype=np.float64)
    got = L.parse_doubles(text, maxn,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:got]


def format_row(row) -> str | None:
    """One kernel dump row ``'%17.15f ...\\n'``, or None without the
    library."""
    L = lib()
    if L is None:
        return None
    row = np.ascontiguousarray(row, dtype=np.float64)
    cap = 32 * row.size + 2
    buf = ctypes.create_string_buffer(cap)
    got = L.format_row(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       row.size, buf, cap)
    if got < 0:
        return None
    return buf.raw[:got].decode()


def _reset_for_tests() -> None:
    """Forget the load verdict so the next :func:`lib` call tries again."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None, False
