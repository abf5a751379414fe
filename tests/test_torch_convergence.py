"""The port's convergence loop (ops/convergence.py) against the JAX
package's, on the CPU, where the wrapper takes the plain version.

float64: ``train_epoch`` vs ``loop.train_epoch_lax`` — n_iter, first_ok
and final_ok equal; ep0/dep within 1e-12; each weight matrix's abs-sum
within 1e-12 (the reference's cross-backend bar, ChangeLog:33-38).
float32: one case vs the Pallas ``train_epoch_fused`` in interpret
mode, at tests/test_pallas.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.ops import pallas_train
from hpnn_tpu.train import loop as jloop
from hpnn_tpu_torch.ops import convergence
from hpnn_tpu_torch.train import loop


def _data(seed, n_in, hiddens, n_out, n):
    """Random kernel and ``n`` clustered samples with +-1 one-hot
    targets, from one numpy seed."""
    rng = np.random.default_rng(seed)
    sizes = list(hiddens) + [n_out]
    inputs = [n_in] + list(hiddens)
    w = [rng.uniform(-1, 1, (a, b)) / np.sqrt(b) for a, b in zip(sizes, inputs)]
    centers = rng.choice([-1.0, 1.0], (n_out, n_in))
    cls = rng.integers(0, n_out, n)
    X = centers[cls] + 0.1 * rng.normal(size=(n, n_in))
    T = -np.ones((n, n_out))
    T[np.arange(n), cls] = 1.0
    return w, X, T


def _two_class(seed, n):
    """The verify recipe's data: 8 inputs, two clusters at +-1 halves,
    +-1 targets over 2 outputs."""
    rng = np.random.default_rng(seed)
    centers = np.array([[1.0] * 4 + [-1.0] * 4, [-1.0] * 4 + [1.0] * 4])
    cls = np.arange(n) % 2
    X = centers[cls] + 0.1 * rng.normal(size=(n, 8))
    T = -np.ones((n, 2))
    T[np.arange(n), cls] = 1.0
    return X, T


@pytest.mark.parametrize("model,momentum", [
    ("ann", False), ("ann", True), ("snn", False), ("snn", True),
])
def test_plain_epoch_matches_lax_f64(model, momentum):
    """Both start from weights the JAX loop trained on one warm-up
    sample (an untrained 8-6-2 ANN needs ~15k iterations for its
    first sample); the six samples compared then converge in tens to
    hundreds of iterations, so n_iter tests the thresholds."""
    X, T = _two_class(42, 7)
    w0, _ = jkm.generate(1234, 8, [6], 2)
    min_iter = jloop.MIN_BPM_ITER if momentum else jloop.MIN_BP_ITER
    kw = dict(model=model, momentum=momentum, min_iter=min_iter,
              max_iter=jloop.MAX_BP_ITER)
    wj = tuple(jnp.asarray(a) for a in w0.weights)
    dw0 = tuple(jnp.zeros_like(a) for a in wj) if momentum else ()
    w_warm, _ = jloop.train_epoch_lax(
        wj, dw0, jnp.asarray(X[:1]), jnp.asarray(T[:1]), 0.2, 1e-6, **kw)
    w_ref, st_ref = jloop.train_epoch_lax(
        w_warm, dw0, jnp.asarray(X[1:]), jnp.asarray(T[1:]), 0.2, 1e-6, **kw)

    wt = tuple(torch.tensor(np.asarray(a)) for a in w_warm)
    launches = convergence.launches
    st = loop.train_epoch(wt, torch.tensor(X[1:]), torch.tensor(T[1:]), 0.2, 1e-6, **kw)
    assert convergence.launches == launches  # CPU tensors: no kernel

    n_ref = [int(v) for v in st_ref[1]]
    assert st.n_iter.tolist() == n_ref
    assert max(n_ref) < 5000  # converged on the thresholds, not a cap
    assert st.first_ok.tolist() == [int(v) for v in st_ref[3]]
    assert st.final_ok.tolist() == [int(v) for v in st_ref[4]]
    np.testing.assert_allclose(st.ep0.numpy(), np.asarray(st_ref[0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(st.dep.numpy(), np.asarray(st_ref[2]), rtol=0, atol=1e-12)
    for a, b in zip(wt, w_ref):
        assert abs(float(a.abs().sum()) - float(jnp.abs(b).sum())) <= 1e-12


def test_deep_kernel_matches_lax_f64():
    """12-[16,8]-8: two hidden layers through the hidden-delta chain."""
    w, X, T = _data(23, 12, [16, 8], 8, 4)
    kw = dict(model="ann", momentum=False, min_iter=5, max_iter=400)
    wj = tuple(jnp.asarray(a) for a in w)
    w_ref, st_ref = jloop.train_epoch_lax(
        wj, (), jnp.asarray(X), jnp.asarray(T), 0.2, 1e-6, **kw)
    wt = tuple(torch.tensor(a) for a in w)
    st = convergence.train_epoch(wt, torch.tensor(X), torch.tensor(T), 0.2, 1e-6, **kw)
    assert st.n_iter.tolist() == [int(v) for v in st_ref[1]]
    for a, b in zip(wt, w_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_plain_epoch_matches_pallas_f32():
    """float32 against the TPU kernel itself (interpret mode), on
    tests/test_pallas.py's epoch inputs and at its tolerances.  SNN-BPM:
    in the ANN cases dep, a difference of two O(1) errors, moves by
    ~2e-7 absolute with the summation order, outside atol 1e-7."""
    k, _ = jkm.generate(3, 10, [8], 4)
    rng = np.random.RandomState(9)
    n = 5
    X = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    T = np.full((n, 4), -1.0, dtype=np.float32)
    T[np.arange(n), rng.randint(0, 4, n)] = 1.0
    kw = dict(model="snn", momentum=True, min_iter=3, max_iter=40)
    w32 = tuple(jnp.asarray(np.asarray(a), dtype=jnp.float32) for a in k.weights)
    dw0 = tuple(jnp.zeros_like(a) for a in w32)
    w_ref, st_ref = pallas_train.train_epoch_fused(
        w32, dw0, jnp.asarray(X), jnp.asarray(T), 0.2, 1e-6, interpret=True, **kw)
    wt = tuple(torch.tensor(np.asarray(a), dtype=torch.float32) for a in k.weights)
    st = convergence.train_epoch(wt, torch.tensor(X), torch.tensor(T), 0.2, 1e-6, **kw)
    assert st.n_iter.tolist() == [int(v) for v in st_ref[1]]
    for a, b in zip(st[:5], st_ref):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=1e-5, atol=1e-7)
    for a, b in zip(wt, w_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_loop_quirks():
    """max-iter break before the min-iter clamp; first_ok at it==1;
    p_trg is the LAST index equal to 1.0; NaN wins the argmax."""
    assert loop.target_argmax(torch.tensor([1.0, -1.0, 1.0, 0.5])) == 2
    assert loop.target_argmax(torch.tensor([0.9, -1.0])) == 0
    assert loop.first_argmax(np.array([0.5, 0.7, 0.7, np.nan, np.nan])) == 3
    assert loop.first_argmax(np.array([0.5, 0.7, 0.7])) == 1
    w, X, T = _data(5, 6, [4], 2, 1)
    wt = tuple(torch.tensor(a) for a in w)
    # delta=-1e30 never stops on dEp: exactly max_iter+1 iterations, and
    # final_ok = ok & (it > min_iter) although min_iter > max_iter
    st = convergence.train_epoch(wt, torch.tensor(X), torch.tensor(T), 0.2, -1e30,
                                 model="ann", min_iter=50, max_iter=7)
    assert st.n_iter.tolist() == [8]
    assert st.final_ok.tolist() == [0]


def test_wrapper_checks_and_routes():
    w, X, T = _data(7, 6, [4], 2, 3)
    wt = tuple(torch.tensor(a) for a in w)
    kw = dict(min_iter=3, max_iter=5)
    with pytest.raises(ValueError):
        convergence.train_epoch(wt, torch.tensor(X[:, :5]), torch.tensor(T), 0.2, 1e-6, **kw)
    with pytest.raises(ValueError):
        convergence.train_epoch(wt, torch.tensor(X, dtype=torch.float32),
                                torch.tensor(T), 0.2, 1e-6, **kw)
    with pytest.raises(ValueError):
        convergence.train_epoch(wt, torch.tensor(X), torch.tensor(T), 0.2, 1e-6,
                                model="lnn", **kw)
    launches = convergence.launches
    convergence.train_epoch(wt, torch.tensor(X), torch.tensor(T), 0.2, 1e-6, **kw)
    assert convergence.launches == launches
    # one block's shared memory bounds the layer widths; the wrapper says so
    big = [torch.empty(30000, 10), torch.empty(2, 30000)]
    assert convergence.shared_bytes(big, torch.float32) > convergence.MAX_SHARED_BYTES


# the kernel's owner of row i of a layer of n rows over C CTAs
# (csrc/convergence.cu, `owner`)
def _owner(i, n, C):
    return ((i + 1) * C + n - 1) // n - 1


@pytest.mark.parametrize("dims,dtype,momentum,dw_resident", [
    ((784, 300, 10), torch.float32, False, False),
    ((784, 300, 10), torch.float32, True, True),
    ((784, 300, 10), torch.float64, False, False),
    ((784, 300, 10), torch.float64, True, False),   # 244 KB of dw a CTA
    ((851, 230, 230), torch.float32, False, False),
    ((851, 230, 230), torch.float32, True, True),
    ((851, 230, 230), torch.float64, False, False),
    ((851, 230, 230), torch.float64, True, False),
    ((12, 16, 8, 4, 2), torch.float32, True, True),  # 4 layers, n_out < C
    ((8, 2), torch.float64, False, False),           # 1 layer
])
def test_cluster_plan(dims, dtype, momentum, dw_resident):
    """The launch plan of the cluster kernel: each row of each layer has
    one owner (the same as the kernel's), a CTA's shared memory fits,
    the weights' row blocks are resident at these shapes, dw only where
    it fits beside them."""
    weights = [torch.empty(n, m, dtype=dtype) for m, n in zip(dims[:-1], dims[1:])]
    p = convergence.plan(weights, dtype, momentum)
    assert p.cluster == convergence.CLUSTER
    assert p.weights_resident and p.dbuf and p.stage == convergence.STAGE
    assert p.dw_resident == dw_resident
    assert p.smem_bytes <= convergence.MAX_SHARED_BYTES
    b = torch.empty((), dtype=dtype).element_size()
    rows = [n for n in dims[1:]]
    wtot = sum(-(-n // p.cluster) * m for m, n in zip(dims[:-1], dims[1:]))
    assert p.smem_bytes == (2 * b + 8 + b * (dims[0] + dims[-1] + 3 * sum(rows) + p.stage)
                            + b * wtot * (2 if dw_resident else 1))
    for n, starts in zip(rows, p.row_starts):
        assert len(starts) == p.cluster + 1 and starts[0] == 0 and starts[-1] == n
        owners = [r for r in range(p.cluster) for _ in range(starts[r], starts[r + 1])]
        assert owners == [_owner(i, n, p.cluster) for i in range(n)]
        assert max(starts[r + 1] - starts[r] for r in range(p.cluster)) == -(-n // p.cluster)
    for C in (8, 16):  # a forced size keeps the same ownership rule
        q = convergence.plan(weights, dtype, momentum, cluster=C)
        assert q.smem_bytes <= convergence.MAX_SHARED_BYTES
        for n, starts in zip(rows, q.row_starts):
            assert [_owner(i, n, C) for i in range(n)] == [
                r for r in range(C) for _ in range(starts[r], starts[r + 1])]
    for C in (0, convergence.CLUSTER + 1):
        with pytest.raises(ValueError, match="cluster size"):
            convergence.plan(weights, dtype, momentum, cluster=C)
    s = convergence.plan(weights, dtype, momentum, weights_resident=False)
    assert not s.weights_resident and not s.dw_resident
    # a net whose vectors overflow one CTA keeps them in device memory;
    # forced into shared memory, the plan says the bytes
    big = [torch.empty(30000, dims[0], dtype=dtype), torch.empty(2, 30000, dtype=dtype)]
    assert not convergence.plan(big, dtype, momentum).vectors_resident
    with pytest.raises(ValueError, match="shared memory"):
        convergence.plan(big, dtype, momentum, vectors_resident=True)


def test_cluster_plan_keeps_every_shape_the_single_block_kernel_took():
    """The single-block kernel took any net whose input, target, two
    copies of the activations and its 16 or 24 bytes of scalars fit one
    block; the plan takes the same, giving up the second activation
    buffer, the staging tile and resident weights first; a wider net
    keeps its vectors in device memory."""
    for dtype in (torch.float32, torch.float64):
        b = torch.empty((), dtype=dtype).element_size()
        room = (convergence.MAX_SHARED_BYTES - 2 * b - 8) // b   # values
        hid = (room - 4 - 2) // 2 - 2                            # 4-hid-2, the widest
        weights = [torch.empty(hid, 4, dtype=dtype), torch.empty(2, hid, dtype=dtype)]
        p = convergence.plan(weights, dtype, True, grid=False)
        assert not p.dbuf and p.stage <= 1 and not p.weights_resident
        assert p.smem_bytes == convergence.shared_bytes(weights, dtype) + b * p.stage
        assert p.smem_bytes <= convergence.MAX_SHARED_BYTES
        wider = [torch.empty(hid + 1, 4, dtype=dtype), torch.empty(2, hid + 1, dtype=dtype)]
        assert not convergence.plan(wider, dtype, True).vectors_resident
        with pytest.raises(ValueError, match="shared memory"):
            convergence.plan(wider, dtype, True, vectors_resident=True)
        with pytest.raises(ValueError, match="owned weight rows"):
            convergence.plan(weights, dtype, False, weights_resident=True)
