"""The convergence kernel on the card against its plain PyTorch version.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a
machine without a card.  On one, run them with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import convergence

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
