"""Bitwise weight checkpoints (``.ckpt``): the port of
``hpnn_tpu/fileio/checkpoint.py``.

A kernel file may be a promotion checkpoint written by the JAX
package's online trainer instead of the reference text grammar, and the
tenant pager (tenant/pager.py) writes its page store in this format:

* line 1: ``MAGIC`` (self-identifying; ``kernel.load`` dispatches on it);
* line 2: one JSON header — kernel name, version, per-layer shapes and
  dtypes, payload byte count, and a SHA-256 over the payload;
* then the concatenated raw bytes of each weight array in layer order.

Writes are crash-atomic (temp file + fsync + ``os.replace``).  A torn
or tampered file raises :class:`CheckpointError`.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

MAGIC = b"#hpnn-ckpt-v1\n"


class CheckpointError(Exception):
    """Torn, truncated, or malformed checkpoint file."""


def is_checkpoint(path: str) -> bool:
    try:
        with open(path, "rb") as fp:
            return fp.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def dump_checkpoint(path: str, name: str, weights, *, version: int = 0,
                    model: str = "ann", meta: dict | None = None):
    """Atomically write ``weights`` (a sequence of 2-D arrays) to
    ``path``.  Returns the registry-compatible staleness signature
    ``(st_mtime_ns, st_size)`` of the final file."""
    arrays = [np.ascontiguousarray(np.asarray(w)) for w in weights]
    payload = b"".join(a.tobytes() for a in arrays)
    header = {
        "kernel": str(name),
        "version": int(version),
        "model": str(model),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [a.dtype.str for a in arrays],
        "nbytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    if meta:
        header["meta"] = dict(meta)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fp:
            fp.write(MAGIC)
            fp.write(json.dumps(header, sort_keys=True).encode("utf-8"))
            fp.write(b"\n")
            fp.write(payload)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


def load_checkpoint(path: str):
    """-> ``(name, [np.ndarray, ...], header)``; raises
    :class:`CheckpointError` on any integrity failure."""
    try:
        with open(path, "rb") as fp:
            if fp.read(len(MAGIC)) != MAGIC:
                raise CheckpointError(f"{path}: not a checkpoint file")
            line = fp.readline()
            try:
                header = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as exc:
                raise CheckpointError(f"{path}: bad header: {exc}") from exc
            payload = fp.read()
    except OSError as exc:
        raise CheckpointError(f"{path}: unreadable: {exc}") from exc
    for key in ("kernel", "shapes", "dtypes", "nbytes", "sha256"):
        if key not in header:
            raise CheckpointError(f"{path}: header missing {key!r}")
    if len(payload) != int(header["nbytes"]):
        raise CheckpointError(
            f"{path}: torn payload ({len(payload)} bytes, header says "
            f"{header['nbytes']})")
    if hashlib.sha256(payload).hexdigest() != header["sha256"]:
        raise CheckpointError(f"{path}: payload checksum mismatch")
    arrays = []
    off = 0
    for shape, dt in zip(header["shapes"], header["dtypes"]):
        dtype = np.dtype(dt)
        n = int(np.prod(shape)) * dtype.itemsize
        if off + n > len(payload):
            raise CheckpointError(f"{path}: payload shorter than shapes")
        arrays.append(np.frombuffer(payload[off:off + n], dtype=dtype)
                      .reshape(shape).copy())
        off += n
    if off != len(payload):
        raise CheckpointError(f"{path}: {len(payload) - off} trailing bytes")
    return header["kernel"], arrays, header
