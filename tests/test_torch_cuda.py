"""The CUDA kernels on the card against their plain PyTorch versions:
the convergence kernel and the four batch-step entry points.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a
machine without a card.  On one, run them with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import batch_step, convergence

pytestmark = pytest.mark.cuda

# float64 kernel vs plain: only the summation order differs
TOL64 = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, dtype, n_in=12, hiddens=(16, 8), n_out=8, S=3, seed=4):
    k, _ = km.generate(99, n_in, list(hiddens), n_out)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (S, n_in))
    T = -np.ones((S, n_out))
    T[np.arange(S), rng.integers(0, n_out, S)] = 1.0
    w, _ = km.to_torch(k.weights, device=dev, dtype=dtype)
    return (w, torch.tensor(X, dtype=dtype, device=dev),
            torch.tensor(T, dtype=dtype, device=dev))


@pytest.mark.parametrize("model,momentum", [
    ("ann", False), ("ann", True), ("snn", False), ("snn", True),
])
def test_kernel_matches_plain_f64(cuda, model, momentum):
    wk, X, T = _inputs(cuda, torch.float64)
    wp = tuple(w.clone() for w in wk)
    kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=300)
    launches = convergence.launches
    sk = convergence.train_epoch(wk, X, T, 0.2, 1e-6, **kw)
    torch.cuda.synchronize()
    assert convergence.launches == launches + 1
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, 1e-6, **kw)
    assert sk.n_iter.tolist() == sp.n_iter.tolist()
    assert sk.first_ok.tolist() == sp.first_ok.tolist()
    assert sk.final_ok.tolist() == sp.final_ok.tolist()
    for a, b in zip(list(wk) + [sk.out, sk.ep0], list(wp) + [sp.out, sp.ep0]):
        assert float((a - b).abs().max()) <= TOL64


def test_kernel_refuses_what_it_cannot_take(cuda):
    w, X, T = _inputs(cuda, torch.float16)
    with pytest.raises(TypeError):
        convergence.train_epoch(w, X, T, 0.2, 1e-6, min_iter=3, max_iter=5)
    w = (torch.zeros(60000, 4, device=cuda), torch.zeros(2, 60000, device=cuda))
    X = torch.zeros(1, 4, device=cuda)
    T = torch.zeros(1, 2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        convergence.train_epoch(w, X, T, 0.2, 1e-6, min_iter=3, max_iter=5)


# ------------------------------------------------------------ batch step
def _bank(dev, dtype, model, momentum, B=16, S=4, shape=(12, (16, 8), 6), seed=5):
    n_in, hiddens, n_out = shape
    k, _ = km.generate(42, n_in, list(hiddens), n_out)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (S * B, n_in))
    T = -np.ones((S * B, n_out))
    T[np.arange(S * B), rng.integers(0, n_out, S * B)] = 1.0
    dw0 = [rng.uniform(-1e-3, 1e-3, w.shape) for w in k.weights] if momentum else None
    w, dw = km.to_torch(k.weights, dw0, device=dev, dtype=dtype)
    return (list(w), list(dw), torch.tensor(X, dtype=dtype, device=dev),
            torch.tensor(T, dtype=dtype, device=dev))


def _clone(ts):
    return [t.clone() for t in ts]


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("model,momentum", [
    ("ann", False), ("ann", True), ("snn", False), ("snn", True),
])
@pytest.mark.parametrize("entry", batch_step.ENTRY_POINTS)
def test_batch_kernel_matches_plain(cuda, entry, model, momentum, dtype, tol):
    """Each entry point on the card against its plain version; only the
    summation order differs, so f64 agrees to rounding and f32 to 1e-5."""
    B, S = 16, 4
    w, dw, X, T = _bank(cuda, dtype, model, momentum, B=B, S=S)
    wp, dwp = _clone(w), _clone(dw)
    kw = dict(model=model, momentum=momentum, lr=0.05, alpha=0.2)
    order = [2, 0, 3, 1]
    fn, plain = getattr(batch_step, entry), getattr(batch_step, entry + "_plain")
    if entry == "train_step_fused_batch":
        args, pargs = (w, dw, X[:B], T[:B]), (wp, dwp, X[:B], T[:B])
    elif entry == "train_step_fused_banked":
        args, pargs = (w, dw, X, T, 2), (wp, dwp, X, T, 2)
        kw["batch"] = B
    else:
        args, pargs = (w, dw, X, T, order), (wp, dwp, X, T, order)
        kw["batch"] = B
    before = batch_step.launches[entry]
    _, _, lk = fn(*args, **kw)
    torch.cuda.synchronize()
    assert batch_step.launches[entry] == before + 1
    _, _, lp = plain(*pargs, **kw)
    assert batch_step.launches[entry] == before + 1
    assert _max_diff(w + dw, wp + dwp) <= tol
    assert float((lk - lp).abs().max()) <= tol * max(1.0, float(lp.abs().max()))


@pytest.mark.parametrize("model,momentum", [("ann", False), ("snn", True)])
def test_batch_kernels_agree_bitwise(cuda, model, momentum):
    """#3 equals #2 on every block, #4 equals S steps of #3, #5 equals #4,
    and a second run of #4 equals the first: every sum has one order."""
    B, S = 16, 4
    order = [3, 1, 0, 2]
    kw = dict(model=model, momentum=momentum, lr=0.05, alpha=0.2)
    w, dw, X, T = _bank(cuda, torch.float32, model, momentum, B=B, S=S)
    runs = {}
    for name in ("step", "banked", "grid", "dbuf", "grid2"):
        wr, dwr = _clone(w), _clone(dw)
        if name == "step":
            losses = [batch_step.train_step_fused_batch(
                wr, dwr, X[k * B:(k + 1) * B].contiguous(),
                T[k * B:(k + 1) * B].contiguous(), **kw)[2] for k in order]
        elif name == "banked":
            losses = [batch_step.train_step_fused_banked(wr, dwr, X, T, k, batch=B, **kw)[2]
                      for k in order]
        else:
            fn = (batch_step.train_epoch_dbuf_banked if name == "dbuf"
                  else batch_step.train_epoch_grid_banked)
            losses = list(fn(wr, dwr, X, T, order, batch=B, **kw)[2])
        runs[name] = [t.cpu() for t in wr + dwr] + [torch.stack(losses).cpu()]
    ref = runs["step"]
    for name, got in runs.items():
        for a, b in zip(got, ref):
            assert torch.equal(a, b), name


def test_batch_kernel_refuses_what_it_cannot_take(cuda):
    w, dw, X, T = _bank(cuda, torch.float16, "ann", False)
    with pytest.raises(TypeError):
        batch_step.train_step_fused_batch(w, dw, X[:16], T[:16])
    w, dw, X, T = _bank(cuda, torch.float32, "ann", False)
    with pytest.raises(ValueError, match="whole blocks"):
        batch_step.train_epoch_grid_banked(w, dw, X[:20], T[:20], [0], batch=16)
    with pytest.raises(ValueError, match="outside"):
        batch_step.train_epoch_grid_banked(w, dw, X, T, [0, 4], batch=16)
