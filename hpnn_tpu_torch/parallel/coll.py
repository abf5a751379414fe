"""Instrumented collectives over a mesh axis: ``all_gather``, ``psum``
and ``pmean`` (the port of ``hpnn_tpu/parallel/coll.py``).

The JAX collectives run inside compiled ``shard_map`` bodies, so the
JAX package records a trace-time census (one ``coll.*`` event per call
site each time the program is traced) and cannot time them.  In torch
the collectives run eagerly, so each wrapper here is both:

* the census: one ``coll.all_gather``/``coll.psum``/``coll.pmean``
  event per distinct call site (op, axis, shape, caller fields) per
  process, with the JAX event's fields (``axis``, ``shape``, ``bytes``
  and the caller's ``layer=...``) — the counterpart of "once per
  compile";
* a real timer: an ``obs.timer`` of the same name around the call,
  and the process-wide totals of :func:`totals` (calls and seconds an
  op), which cost two clock reads a call with the sink off.

``psum`` gathers the partial sums and adds them in rank order on every
rank: its bits do not depend on the backend's reduction order (with two
ranks the sum is ``a + b``, as XLA's), which keeps the per-sample
tokens the JAX package's.  It mirrors the reference's column split plus
allgather (ref: libhpnn src/ann.c:1279-1592); its vectors are at most a
hidden layer long.  ``pmean``, the data-parallel gradient mean, is the
backend's all-reduce, which leaves the same buffer on every rank.  Only
list-form ``all_gather`` and ``all_reduce`` are used: gloo has both for
CPU and CUDA tensors.

An axis without a process group (a mesh of one rank on that axis, see
``Mesh.group``) makes every wrapper the identity.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as tdist

from hpnn_tpu_torch import obs

_seen: set = set()
_totals: dict = {}   # op -> [calls, seconds]


def totals() -> dict:
    """``{op: (calls, seconds)}`` of this process's collectives since
    the last :func:`reset_totals`."""
    return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset_totals() -> None:
    _totals.clear()


def _census(name: str, axis, x, **fields) -> None:
    if not obs.enabled():
        return
    shape = [int(s) for s in x.shape]
    key = (name, str(axis), tuple(shape), tuple(sorted(fields.items())))
    if key in _seen:
        return
    _seen.add(key)
    obs.event(name, axis=str(axis), shape=shape,
              bytes=math.prod(shape) * x.element_size(), **fields)


class _Clock:
    """Adds the block's wall time to ``_totals[op]``."""

    __slots__ = ("op", "t0")

    def __init__(self, op):
        self.op = op

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        tot = _totals.setdefault(self.op, [0, 0.0])
        tot[0] += 1
        tot[1] += time.perf_counter() - self.t0
        return False


def _gather_list(x, group, n):
    parts = [torch.empty_like(x) for _ in range(n)]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return parts


def all_gather(x, mesh, axis, *, dim: int = 0, **fields):
    """The axis' blocks of ``x`` concatenated along ``dim`` in axis
    order (the JAX ``all_gather(..., tiled=True)``)."""
    group = mesh.group(axis)
    if group is None:
        return x
    _census("coll.all_gather", axis, x, tiled=True, **fields)
    with obs.timer("coll.all_gather", axis=axis, **fields), _Clock("all_gather"):
        return torch.cat(_gather_list(x, group, mesh.shape[axis]), dim=dim)


def psum(x, mesh, axis, **fields):
    """Sum of ``x`` over the axis, added in rank order on every rank."""
    group = mesh.group(axis)
    if group is None:
        return x
    _census("coll.psum", axis, x, **fields)
    with obs.timer("coll.psum", axis=axis, **fields), _Clock("psum"):
        return _ordered_sum(_gather_list(x, group, mesh.shape[axis]))


def pmean(x, mesh, axis, **fields):
    """Mean of ``x`` over the axis: the backend's all-reduce (every
    rank receives the same reduced buffer), then / axis size."""
    group = mesh.group(axis)
    if group is None:
        return x
    _census("coll.pmean", axis, x, **fields)
    with obs.timer("coll.pmean", axis=axis, **fields), _Clock("pmean"):
        out = x.clone()
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=group)
        return out / mesh.shape[axis]


def _ordered_sum(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out
