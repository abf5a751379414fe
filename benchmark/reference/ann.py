"""Plain reference of the ANN training the benchmark times.

libhpnn's math (``src/ann.c``): activation ``act(z) = 2/(1+e^-z) - 1``,
computed as ``tanh(z/2)``, which is the same function; derivative in
terms of the output ``dact(y) = -0.5·(y² - 1)``; sample error
``Ep = ½ Σ (t - o)²``; deltas ``δ_out = (t - o)·dact(o)``,
``δ_l = (W_{l+1}ᵀ δ_{l+1})·dact(v_l)``, all from the weights before the
update.

* :class:`SampleLoop`: the per-sample round (``ann_train_BP`` /
  ``ann_train_BPM``, src/ann.c:2281-2467).  One iteration updates every
  layer (BP ``W += η δ⊗v``, η = 0.001; BPM ``dw += η δ⊗v; W += dw;
  dw *= α``, η = 0.0005, α = 0.2, dw zeroed at each sample's start),
  re-runs the forward and yields ``dEp = Ep - Epr``.  The do-while runs
  while ``it <= MAX_ITER and (dEp > DELTA or not (ok and it > MIN_ITER))``
  with ``ok`` the output's first argmax equal to the last index where
  the target is 1 (BP 31..102399, BPM 15..102399, DELTA 1e-6;
  include/libhpnn.h:67-74).  The loop runs a given number of
  iterations and records each one's ``dEp`` and the output's margin for
  the target (its value less the largest other output), so that the
  decisions can be judged afterwards (``benchmark/drivers/round.py``).
* :func:`fleet_reference`: minibatch steepest descent on each block's
  mean error, every member of a fleet at once along a leading axis
  (BP ``W -= η g``; BPM ``m -= η g; W += m; m *= α``), the loss after
  the update on the same block, and after each epoch the count over all
  rows with the evaluation's quirks (``hpnn_tpu_torch/train/batch.py``
  ``count_correct``).

``mode`` "exact" computes in float64.  "tf32" is the control: float32
with every operand of a product rounded to TF32 (a 10-bit mantissa),
the products summed in float32; "f32" is plain float32, for planting
faults in the reference put in the program's place.  Imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np
import torch

BP = dict(lr=0.001, min_iter=31, max_iter=102399, delta=1e-6)
BPM = dict(lr=0.0005, min_iter=15, max_iter=102399, delta=1e-6, alpha=0.2)
BLOCKS = (64, 16, 4, 1)     # iterations a captured graph runs


def tf32(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Ops:
    """The products in the reference's precision or the control's."""

    def __init__(self, mode):
        self.round = tf32 if mode == "tf32" else (lambda x: x)
        self.dtype = torch.float64 if mode == "exact" else torch.float32

    def mv(self, w, v):
        return torch.mv(self.round(w), self.round(v))

    def addr_(self, w, d, v, alpha):
        return w.addr_(self.round(d), self.round(v), alpha=alpha)

    def mm(self, a, b):
        return torch.matmul(self.round(a), self.round(b))


def act(z):
    return torch.tanh(z * 0.5)


def dact(y, half):
    return torch.addcmul(half, y, y, value=-0.5)


def target_index(t) -> int:
    """The last index where the target is exactly 1, else 0."""
    hits = np.flatnonzero(np.asarray(t) == 1.0)
    return int(hits[-1]) if hits.size else 0


class SampleLoop:
    """The per-sample round's state on one device, advanced by whole
    iterations.  ``layers`` are float64 host arrays.  On a card
    each block of iterations in :data:`BLOCKS` is one captured graph."""

    def __init__(self, layers, *, momentum, device, mode="exact"):
        self.p = BPM if momentum else BP
        self.momentum = momentum
        self.ops = _Ops(mode)
        self.dtype = self.ops.dtype
        dev = torch.device(device)
        kw = dict(device=dev, dtype=self.dtype)
        self.W = [torch.tensor(w, **kw) for w in layers]
        self.M = [torch.zeros_like(w) for w in self.W]
        sizes = [self.W[0].shape[1]] + [w.shape[0] for w in self.W]
        self.A = [torch.zeros(n, **kw) for n in sizes]
        self.half = [torch.full((n,), 0.5, **kw) for n in sizes]
        self.t = torch.zeros(sizes[-1], **kw)
        self.e = torch.zeros(sizes[-1], **kw)
        self.ep2 = torch.zeros((), **kw)
        self.mask = torch.zeros(sizes[-1], device=dev, dtype=torch.bool)
        self.onehot = torch.zeros(sizes[-1], **kw)
        k = max(BLOCKS)
        self.dep_slot = torch.zeros(k, **kw)
        self.margin_slot = torch.zeros(k, **kw)
        self.graphs = {}
        if dev.type == "cuda":
            self._capture()

    # ---------------------------------------------------------- the math
    def _iteration(self, j):
        W, M, A, ops, p = self.W, self.M, self.A, self.ops, self.p
        L = len(W)
        d = self.e * dact(A[L], self.half[L])
        ds = [d]
        for l in range(L - 1, 0, -1):
            d = ops.mv(W[l].T, d) * dact(A[l], self.half[l])
            ds.insert(0, d)
        for l in range(L):
            if self.momentum:
                ops.addr_(M[l], ds[l], A[l], p["lr"])
                W[l].add_(M[l])
                M[l].mul_(p["alpha"])
            else:
                ops.addr_(W[l], ds[l], A[l], p["lr"])
        for l in range(L):
            torch.tanh(ops.mv(W[l], A[l]).mul_(0.5), out=A[l + 1])
        torch.sub(self.t, A[L], out=self.e)
        epr2 = torch.dot(self.e, self.e)
        torch.sub(self.ep2, epr2, out=self.dep_slot[j])
        self.ep2.copy_(epr2)
        # the target's output less the largest other one
        other = torch.where(self.mask, -torch.inf, A[L]).amax()
        torch.sub(torch.dot(self.onehot, A[L]), other, out=self.margin_slot[j])

    def _block(self, k):
        for j in range(k):
            self._iteration(j)

    def _capture(self):
        saved = self.snapshot()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._block(2)  # warm the libraries before capture
        torch.cuda.current_stream().wait_stream(side)
        for k in BLOCKS:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self._block(k)
            self.graphs[k] = g
        self.restore(saved)

    # ------------------------------------------------------------ driving
    def snapshot(self):
        return [x.clone() for x in (*self.W, *self.M, *self.A, self.e, self.ep2)]

    def restore(self, saved):
        for dst, src in zip((*self.W, *self.M, *self.A, self.e, self.ep2), saved):
            dst.copy_(src)

    def start(self, x, t, p_trg):
        """Set the next sample (host float64 vectors); returns its
        ``Ep`` before the first iteration (a device scalar)."""
        self.A[0].copy_(torch.as_tensor(x, dtype=self.dtype))
        self.t.copy_(torch.as_tensor(t, dtype=self.dtype))
        self.mask.zero_()
        self.mask[p_trg] = True
        self.onehot.copy_(self.mask)
        for m in self.M:
            m.zero_()
        v = self.A[0]
        for l, w in enumerate(self.W):
            v = act(self.ops.mv(w, v))
            self.A[l + 1].copy_(v)
        torch.sub(self.t, self.A[-1], out=self.e)
        self.ep2.copy_(torch.dot(self.e, self.e))
        return 0.5 * self.ep2.clone()

    def run(self, n, dep_out, margin_out):
        """Run ``n`` iterations; their ``dEp`` and margins go to the
        device vectors ``dep_out[:n]`` and ``margin_out[:n]``."""
        done = 0
        while done < n:
            k = next(b for b in BLOCKS if b <= n - done)
            if self.graphs:
                self.graphs[k].replay()
            else:
                self._block(k)
            dep_out[done:done + k].copy_(self.dep_slot[:k])
            margin_out[done:done + k].copy_(self.margin_slot[:k])
            done += k
        dep_out[:n].mul_(0.5)


def fleet_reference(layers, X, T, perms, orders, *, batch, momentum, lr, alpha=0.2,
                    mode="exact", rows_used=None):
    """Train the stacked members ``layers`` (list of ``(N, out, in)``
    float64 host arrays) over ``X``, ``T`` (float64 device tensors) on
    the plans ``perms (N, G, rows)``, ``orders (N, G, R, S)``.

    ``rows_used`` below ``batch`` plants a fault: each step's mean taken
    over only that many of its rows.

    Returns ``(layers_out, losses (N, E, S), counts (N, E))`` as numpy."""
    dev = X.device
    ops = _Ops(mode)
    dtype = ops.dtype
    used = batch if rows_used is None else rows_used
    W = [torch.tensor(w, device=dev, dtype=dtype) for w in layers]
    M = [torch.zeros_like(w) for w in W]
    X, T = X.to(dtype), T.to(dtype)
    lr_b = lr * (1.0 / used)
    losses, counts = [], []
    for g in range(orders.shape[1]):
        idx = torch.as_tensor(perms[:, g], device=dev)
        for r in range(orders.shape[2]):
            ep_loss = []
            for s in range(orders.shape[3]):
                blk = torch.as_tensor(orders[:, g, r, s], device=dev)
                rows = blk[:, None] * batch + torch.arange(used, device=dev)[None, :]
                rows = idx.gather(1, rows)
                Xb, Tb = X[rows], T[rows]
                acts = [Xb]
                for w in W:
                    acts.append(act(ops.mm(acts[-1], w.mT)))
                d = (Tb - acts[-1]) * (0.5 - 0.5 * acts[-1] * acts[-1])
                ds = [d]
                for l in range(len(W) - 1, 0, -1):
                    d = ops.mm(d, W[l]) * (0.5 - 0.5 * acts[l] * acts[l])
                    ds.insert(0, d)
                for l in range(len(W)):
                    step = ops.mm(ds[l].mT, acts[l])    # = -B·gradient
                    if momentum:
                        M[l] += lr_b * step
                        W[l] += M[l]
                        M[l] *= alpha
                    else:
                        W[l] += lr_b * step
                v = Xb
                for w in W:
                    v = act(ops.mm(v, w.mT))
                ep_loss.append((0.5 * ((Tb - v) ** 2).sum(-1)).mean(-1))
            losses.append(torch.stack(ep_loss, dim=1))
            counts.append(_count(W, X, T, ops))
    return ([w.cpu().numpy() for w in W], torch.stack(losses, 1).cpu().numpy(),
            torch.stack(counts, 1).cpu().numpy())


def _count(W, X, T, ops):
    """Rows per member whose guess is the target class, with the
    evaluation's quirks: no guess unless some output exceeds -1, and a
    target with no entry above 0.5 is class 1."""
    v = X[None].expand(W[0].shape[0], -1, -1)
    for w in W:
        v = act(ops.mm(v, w.mT))
    n_out = T.shape[1]
    guess = torch.where(v.amax(-1) > -1.0, v.argmax(-1), n_out)
    above = T > 0.5
    last = n_out - 1 - torch.flip(above, dims=(1,)).to(torch.uint8).argmax(1)
    want = torch.where(above.any(1), last, 1)
    return (guess == want[None]).sum(-1)
