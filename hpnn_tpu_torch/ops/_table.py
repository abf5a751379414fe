"""The per-layer tables of the kernels' launches, and the scratch
buffers kept beside them.

A net of any depth hands its kernel one table of L fixed-size records
(the layer widths, the weight pointers, offsets), packed by the
kernel's wrapper.  A net of at most ``PARAM_LAYERS`` layers passes its
records' values by value in the kernel parameters, filled on the host
from the table's host copy; a deeper one passes the table's address in
device memory, and the kernel reads it through the read-only path.  A
table is packed once and kept: its key is everything its bytes are made
of (and the stream), so a hit is exact, and a launch that hits adds no
packing and no copy.  The device copy is made only for a deeper net,
one copy from pinned memory on the stream of the launch that first
needs it: no synchronize, nothing device-wide, and never inside a
CUDA-graph capture (a capture would keep it in the graph's memory
pool).

A device copy is freed only when its table leaves the cache, and every
launch that used it ran on the stream it was allocated on, so the
caching allocator hands its memory out again only behind those
launches.

:class:`Scratch` keeps a kernel's device-memory scratch by the same
rules: one buffer a key (the stream, the type, the launch's layout),
allocated once on the stream that first needs it and never inside a
capture, so a round of launches on that stream allocates nothing.
"""

from __future__ import annotations

import collections
import threading

import torch

PARAM_LAYERS = 16  # HPNN_PARAM_LAYERS in csrc/*.cu: deeper nets read the device copy
MAX_TABLES = 64    # tables kept per cache, least recently used out first


class Tables:
    """Layer tables by key: ``get(key, pack, device)`` returns the cached
    ``(device copy or None, *extra)`` or packs one with ``pack() ->
    (bytes, *extra)``, copying the bytes to ``device`` unless it is
    None.  ``uploads`` counts the device copies made."""

    def __init__(self):
        self.uploads = 0
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()  # launching threads share the cache

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, key, pack, device):
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        blob, *extra = pack()
        table = None
        if device is not None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a kernel's layer table is copied to the card outside a CUDA-graph "
                    "capture: launch once on these tensors before capturing")
            host = torch.frombuffer(bytearray(blob), dtype=torch.uint8).pin_memory()
            table = torch.empty(len(blob), dtype=torch.uint8, device=device)
            table.copy_(host, non_blocking=True)
        entry = (table, *extra)
        with self._lock:
            self.uploads += table is not None
            self._cache[key] = entry
            if len(self._cache) > MAX_TABLES:
                self._cache.popitem(last=False)
        return entry


def device_copy(n_layers: int, device):
    """Where a table of ``n_layers`` records needs a device copy: the
    launch's device for a net deeper than ``PARAM_LAYERS``, else None."""
    return device if n_layers > PARAM_LAYERS else None


class Scratch:
    """Device scratch buffers by key: ``get(key, nbytes, device)``
    returns the cached uint8 tensor of ``nbytes`` bytes or allocates
    one on ``device``'s current stream.  ``allocs`` counts the
    allocations; an allocation that fails raises (no other route)."""

    def __init__(self):
        self.allocs = 0
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, key, nbytes: int, device):
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a kernel's scratch is allocated outside a CUDA-graph capture: "
                "launch once on these tensors before capturing")
        buf = torch.empty(int(nbytes), dtype=torch.uint8, device=device)
        with self._lock:
            self.allocs += 1
            self._cache[key] = buf
            if len(self._cache) > MAX_TABLES:
                self._cache.popitem(last=False)
        return buf
