"""Tensor parallelism: layer rows split over the mesh's ``model`` axis
(the port of ``hpnn_tpu/parallel/tp.py``).

The reference's MPI mode, collective for collective (SURVEY.md §2.7):

| reference (MPI)                                   | here                          |
|---------------------------------------------------|-------------------------------|
| row-block gemv per rank (src/ann.c:918-920)       | local ``w_loc @ v``           |
| ``MPI_Allgather(IN_PLACE)`` of activations (:925) | ``coll.all_gather``           |
| transposed-gemv col split + allgather (:1279-1592)| local ``w.T @ d_blk`` + ``coll.psum`` |
| ``MPI_Allreduce`` of softmax dv (src/snn.c:303)   | masked full-vector sum (after the gather) |
| weight-row update + allgather (:1630-1706)        | local rank-1 update, no collective |
| remainder rows computed redundantly (:928-936)    | zero padding to mesh multiples (``parallel/mesh.py``) |

The JAX package runs the whole per-sample do-while inside one
``shard_map``; here every rank runs the port's own do-while
(``train/loop.py``'s ``convergence_loop``) over its row blocks, with
the collectives eager.  The convergence decision needs no collective of
its own: after each gather every rank holds the whole output vector
with the same bits, so every rank computes the same ``dEp`` and argmax
and leaves the loop on the same iteration.

Every function takes 1-D vectors (one sample) or ``(rows, n)`` batches
(the eval forward, the minibatch step); activations are gathered along
their last dim.  Weights and vectors are this rank's tensors on the
mesh's device.
"""

from __future__ import annotations

import numpy as np
import torch

from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.ops.convergence import EpochStats, learn_rate
from hpnn_tpu_torch.parallel import coll
from hpnn_tpu_torch.parallel.mesh import MODEL_AXIS
from hpnn_tpu_torch.train import loop

TINY = snn.TINY


def _my_block(vec, mesh):
    """This rank's row block of a full vector (or of a batch's rows)."""
    k = mesh.shape[MODEL_AXIS]
    n = vec.shape[-1] // k
    i = mesh.index[MODEL_AXIS]
    return vec[..., i * n:(i + 1) * n]


def _lin(w, v):
    """``w @ v`` for a vector, ``v @ w.T`` for a batch of rows."""
    return torch.mv(w, v) if v.dim() == 1 else torch.matmul(v, w.mT)


def _out_mask(n_padded: int, n_out: int, like):
    return (torch.arange(n_padded, device=like.device) < n_out).to(like.dtype)


def _mesh_rows(mesh):
    """The ranks' layer step: ``f`` of this rank's rows of the layer,
    gathered whole over the model axis."""
    def rows(l, w, v, f):
        return coll.all_gather(f(_lin(w, v)), mesh, MODEL_AXIS, dim=-1, layer=l)

    return rows


def forward_local(weights_loc, x, *, model: str, n_out: int, mesh=None, rows=None):
    """Per-shard forward; the activations are gathered whole after each
    layer.  ``rows(l, w, v, f)`` is the whole vector ``f(w @ v)`` of
    layer ``l`` from its row blocks ``w`` (default: this rank's block of
    the ``mesh``, gathered over its model axis).  SNN keeps the
    reference's softmax quirks (``exp(z - 1)``, the TINY-seeded
    denominator, ref: src/snn.c:282-335) with the padded logits masked
    out of the sum."""
    rows = rows or _mesh_rows(mesh)
    acts = [x]
    v = x
    last = len(weights_loc) - 1
    for l, w in enumerate(weights_loc):
        if model == "snn" and l == last:
            e = rows(l, w, v, lambda z: torch.exp(z - 1.0))
            e = e * _out_mask(e.shape[-1], n_out, e)
            v = e / (TINY + torch.sum(e, dim=-1, keepdim=True))
        else:
            v = rows(l, w, v, ann.act)
        acts.append(v)
    return tuple(acts)


def deltas_local(weights_loc, acts, target, *, model: str, mesh):
    """Whole delta vectors per layer from row-split weights: the hidden
    rule ``δ_l = (W_{l+1}ᵀ·δ_{l+1})·dact(v_l)`` with each shard's
    ``W_locᵀ·δ_blk`` summed over the model axis (``coll.psum``)."""
    out = acts[-1]
    # SNN: the softmax+CE shortcut (ref: src/snn.c:510-512)
    d = target - out if model == "snn" else (target - out) * ann.dact(out)
    ds = [d]
    for l in range(len(weights_loc) - 1, 0, -1):
        blk = _my_block(ds[0], mesh)
        w = weights_loc[l]
        part = torch.mv(w.T, blk) if blk.dim() == 1 else torch.matmul(blk, w)
        ds.insert(0, coll.psum(part, mesh, MODEL_AXIS, layer=l) * ann.dact(acts[l]))
    return tuple(ds)


def bp_update_local(weights_loc, acts, ds, lr, mesh):
    """Rank-1 update of the local rows only: no collective."""
    return tuple(w + lr * torch.outer(_my_block(d, mesh), v)
                 for w, d, v in zip(weights_loc, ds, acts[:-1]))


def bpm_update_local(weights_loc, dw_loc, acts, ds, lr, alpha, mesh):
    new_w, new_dw = [], []
    for w, m, d, v in zip(weights_loc, dw_loc, ds, acts[:-1]):
        m = m + lr * torch.outer(_my_block(d, mesh), v)
        new_w.append(w + m)
        new_dw.append(alpha * m)
    return tuple(new_w), tuple(new_dw)


def train_error(out, target, model: str, n_out: int):
    """The sample error; SNN divides by the REAL output count."""
    if model == "snn":
        return -torch.sum(target * torch.log(out + TINY), dim=-1) / n_out
    d = target - out
    return 0.5 * torch.sum(d * d, dim=-1)


def masked_argmax(out_np: np.ndarray, n_out: int) -> int:
    """First index of the max over the real outputs (padding excluded)."""
    return loop.first_argmax(out_np[:n_out])


def train_sample_local(weights_loc, dw_loc, x, target, alpha, delta, *, model: str,
                       momentum: bool, min_iter: int, max_iter: int, n_out: int, mesh):
    """One sample's convergence do-while over row-split weights (the
    per-shard body of the JAX ``make_train_fn``); ``target`` padded with
    zeros to the padded output rows.  Returns ``loop.SampleResult``."""
    lr = learn_rate(model, momentum)
    acts0 = forward_local(weights_loc, x, model=model, n_out=n_out, mesh=mesh)
    ep0 = train_error(acts0[-1], target, model, n_out)

    def one_iteration(w, m, acts):
        ep = train_error(acts[-1], target, model, n_out)
        ds = deltas_local(w, acts, target, model=model, mesh=mesh)
        if momentum:
            w, m = bpm_update_local(w, m, acts, ds, lr, alpha, mesh)
        else:
            w = bp_update_local(w, acts, ds, lr, mesh)
        acts = forward_local(w, x, model=model, n_out=n_out, mesh=mesh)
        return w, m, acts, ep - train_error(acts[-1], target, model, n_out)

    return loop.convergence_loop(
        one_iteration, weights_loc, dw_loc, acts0, ep0, loop.target_argmax(target),
        delta, min_iter=min_iter, max_iter=max_iter,
        argmax=lambda out: masked_argmax(out, n_out))


def train_epoch(weights_loc, X, T, alpha, delta, *, model: str, momentum: bool,
                min_iter: int, max_iter: int, n_out: int, mesh) -> EpochStats:
    """A chunk of the per-sample round (the JAX ``make_train_epoch_fn``):
    the rows of ``(X, T)`` in order, the row-split weights carried
    sample to sample and updated in place, the momentum zeroed at every
    sample start (the "raz" quirk, ref: src/ann.c:1921-1938).  ``T`` is
    padded with zero columns to the padded output rows."""
    dw0 = tuple(torch.zeros_like(w) for w in weights_loc) if momentum else ()
    w = tuple(weights_loc)
    rows = []
    for s in range(X.shape[0]):
        res = train_sample_local(w, dw0, X[s], T[s], alpha, delta, model=model,
                                 momentum=momentum, min_iter=min_iter,
                                 max_iter=max_iter, n_out=n_out, mesh=mesh)
        w = res.weights
        rows.append(res)
    with torch.no_grad():
        for dst, src in zip(weights_loc, w):
            dst.copy_(src)

    def ints(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int32, device=X.device)

    return EpochStats(
        torch.stack([r.ep0 for r in rows]), ints(r.n_iter for r in rows),
        torch.stack([r.dep for r in rows]), ints(r.first_ok for r in rows),
        ints(r.final_ok for r in rows), torch.stack([r.out for r in rows]))


def make_run_fn(mesh, *, model: str = "ann", n_out: int):
    """``run(weights_loc, x) -> out``: the forward of one sample over the
    mesh (``ann/snn_kernel_run``); ``out`` has the padded rows."""
    def run(weights_loc, x):
        with torch.inference_mode():
            return forward_local(weights_loc, x, model=model, n_out=n_out, mesh=mesh)[-1]

    return run


def make_batched_run_fn(mesh, *, model: str = "ann", n_out: int):
    """``run(weights_loc, X) -> out``: the forward of a ``(rows, n_in)``
    batch over the mesh, matmuls in full float32 (TF32 off) as the
    single-device eval's."""
    def run(weights_loc, X):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                return forward_local(weights_loc, X, model=model, n_out=n_out,
                                     mesh=mesh)[-1]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return run


def shard_kernel(weights, mesh, dtype=None):
    """This rank's row block of every layer of the host-global (padded)
    ``weights``, as tensors on the mesh's device."""
    k, i = mesh.shape[MODEL_AXIS], mesh.index[MODEL_AXIS]
    out = []
    for w in weights:
        w = np.asarray(w)
        n = w.shape[0] // k
        t = torch.from_numpy(np.ascontiguousarray(w[i * n:(i + 1) * n]))
        out.append(t.to(device=mesh.device, dtype=dtype or t.dtype))
    return tuple(out)


def gather_kernel(weights_loc, mesh) -> tuple:
    """The whole (padded) kernel from every rank's row blocks, as host
    arrays on every rank (the reference's G2C + ``MPI_Allgather`` before
    ``ann_dump``, ref: src/ann.c:787-856)."""
    return tuple(coll.all_gather(w, mesh, MODEL_AXIS, dim=0, role="kernel").cpu().numpy()
                 for w in weights_loc)


def make_spill_forward(weights, devices, *, model: str, n_out: int):
    """The serve router's spill: one process's forward of a row block
    with the kernel's rows split over ``devices`` (one block a device,
    padded to a multiple of their count) and the activations gathered
    in process onto the first device after each layer
    (:func:`forward_local` with a ``torch.cat`` for the gather).
    Returns ``forward(rows_np) -> out_np`` (the real outputs only)."""
    from hpnn_tpu_torch.parallel.mesh import pad_kernel

    devices = [torch.device(d) for d in devices]
    k = len(devices)
    padded, _ = pad_kernel(tuple(np.asarray(w) for w in weights), k)
    blocks = []   # blocks[l][i]: layer l's row block i on devices[i]
    for w in padded:
        n = w.shape[0] // k
        blocks.append([torch.from_numpy(np.ascontiguousarray(w[i * n:(i + 1) * n])).to(d)
                       for i, d in enumerate(devices)])
    home = devices[0]

    def cat_rows(l, w, v, f):
        return torch.cat([f(_lin(b, v.to(b.device))).to(home) for b in w], dim=-1)

    def forward(x):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                v = torch.from_numpy(np.ascontiguousarray(x)).to(
                    device=home, dtype=blocks[0][0].dtype)
                out = forward_local(blocks, v, model=model, n_out=n_out, rows=cat_rows)[-1]
                return out[:, :n_out].cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return forward
