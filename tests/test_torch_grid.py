"""#1's grid build: a cooperative grid of one CTA an SM for nets whose
owned rows of W overflow a cluster's shared memory.

The convergence kernel (``csrc/convergence.cu``) runs one thread-block
cluster of 16 CTAs where the owned rows of W fit their shared memory,
and a grid of every CTA the card holds at once where they do not
(``convergence.plan``'s ``grid``): each CTA streams its rows of W
through a ring of bulk copies in shared memory, and the vectors are
published once in device memory.  Every sum keeps its order, so the
grid gives the one-cluster build's bits.

* on the CPU: the plan takes the grid where W overflows 16 CTAs and
  reaches the measured crossover (``GRID_MIN_BYTES``), its row blocks cover every row once for any CTA count up to
  132 (at ``MAX_ROWS`` too, with the kernel's 40-bit division), its
  scratch is laid out as the kernel reads it, and the layer table is
  kept per CTA count;
* on the card (``cuda``-marked): the grid against the plain version
  and bitwise the forced one-cluster build at 8-[30000]-2, 13-[30001]-3
  (rows off the 16-byte grid), 784-[4000]-10, a 19-layer net (the
  device table) and a 5000-wide output layer (the output deltas in
  device memory); bitwise the shared build at 784-300-10 at every CTA
  count; a grid the card cannot hold at once raises.
"""

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import convergence

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
FIT = {torch.float32: 1041, torch.float64: 481}  # 784-[H]-10: W past 16 CTAs from H


def _net(dims, dtype=torch.float32, device="cpu"):
    return [torch.zeros(n, m, dtype=dtype, device=device)
            for m, n in zip(dims[:-1], dims[1:])]


# ------------------------------------------------------------------ plan
def _w_bytes(dims, dtype):
    return torch.empty((), dtype=dtype).element_size() * sum(
        m * n for m, n in zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("momentum", [False, True])
def test_plan_takes_the_grid_where_w_overflows_16_ctas_past_the_crossover(dtype, momentum):
    """784-[H]-10: one cluster with W's rows resident up to the last H
    whose owned rows fit 16 CTAs; past it one cluster streaming W until
    W reaches ``GRID_MIN_BYTES`` (the measured crossover), the grid from
    there on, keeping W and the vectors in device memory."""
    h = FIT[dtype]
    p = convergence.plan(_net((784, h - 1, 10), dtype), dtype, momentum)
    assert not p.grid and p.weights_resident and p.cluster == convergence.CLUSTER
    q = convergence.plan(_net((784, h, 10), dtype), dtype, momentum)
    assert not q.weights_resident
    assert q.grid == (_w_bytes((784, h, 10), dtype) >= convergence.GRID_MIN_BYTES)
    hg = next(x for x in range(h, 30000)
              if _w_bytes((784, x, 10), dtype) >= convergence.GRID_MIN_BYTES)
    assert not convergence.plan(_net((784, hg - 1, 10), dtype), dtype, momentum).grid
    g = convergence.plan(_net((784, hg, 10), dtype), dtype, momentum)
    assert g.grid and g.cluster == convergence.GRID_CTAS
    assert not (g.weights_resident or g.dw_resident or g.vectors_resident) and g.dbuf
    assert g.smem_bytes == convergence.GRID_SMEM
    for dims in ((784, 300, 10), (851, 230, 230), (8, 30000, 2), (784, 300, 1000),
                 (784, 30000, 10), (784,) + (300,) * 19 + (10,)):
        w = _net(dims, dtype)
        assert convergence.plan(w, dtype, momentum).grid == (
            not convergence.plan(w, dtype, momentum, grid=False).weights_resident
            and _w_bytes(dims, dtype) >= convergence.GRID_MIN_BYTES)
    assert convergence.plan(_net((784, 30000, 10), dtype), dtype, momentum).grid


def test_plan_overrides_pick_the_build():
    """``grid`` forces either build; forcing W or the vectors into
    shared memory keeps one cluster; the grid refuses both, and a CTA
    count the card cannot hold at once."""
    wide = _net((784, 30000, 10))
    small = _net((784, 300, 10))
    c = convergence.plan(wide, torch.float32, False, grid=False)
    assert not c.grid and c.cluster == convergence.CLUSTER and not c.vectors_resident
    assert convergence.plan(wide, torch.float32, False, grid=False, cluster=8).cluster == 8
    g = convergence.plan(small, torch.float32, True, grid=True, cluster=8)
    assert g.grid and g.cluster == 8 and not g.weights_resident
    assert convergence.plan(wide, torch.float32, False, vectors_resident=False,
                            weights_resident=False).grid
    with pytest.raises(ValueError, match="shared memory"):
        convergence.plan(wide, torch.float32, False, weights_resident=True)
    with pytest.raises(ValueError, match="device memory"):
        convergence.plan(wide, torch.float32, False, grid=True, vectors_resident=True)
    with pytest.raises(ValueError, match="the card holds 96"):
        convergence.plan(wide, torch.float32, False, cluster=97, capacity=96)
    with pytest.raises(ValueError, match="grid of 0 CTAs"):
        convergence.plan(wide, torch.float32, False, cluster=0)
    assert convergence.plan(wide, torch.float32, False, capacity=96).cluster == 96


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_scratch_is_the_published_vectors(dtype):
    """The barrier's word, both activation buffers (each padded to 4
    values, so both start 16-byte aligned) and the hidden deltas once
    for all CTAs; each CTA's output deltas beside them only where they
    overflow ``GRID_OUT_SMEM`` bytes of shared memory."""
    b = torch.empty((), dtype=dtype).element_size()
    for dims, pad in (((784, 30000, 10), 30012), ((8, 64, 5000), 5064), ((8, 40, 40, 2), 84)):
        w = _net(dims, dtype)
        p = convergence.plan(w, dtype, False, grid=True, cluster=100)
        total = sum(dims[1:])
        private = 100 * dims[-1] if dims[-1] * b > convergence.GRID_OUT_SMEM else 0
        assert p.scratch_bytes == 16 + b * (2 * pad + total + private)
        assert p.scratch_bytes == convergence.grid_scratch_bytes(w, dtype, 100)


def _row_start(r, n, C):
    """csrc/convergence.cu's row_start: div40(r * n, inv40(C)), the
    product in 64 bits."""
    x, inv = r * n, convergence._inv40(C)
    assert x * inv < 1 << 64
    return (x * inv) >> 40


@pytest.mark.parametrize("n", [1, 2, 10, 300, 30000, convergence.MAX_ROWS - 1,
                               convergence.MAX_ROWS])
def test_grid_row_blocks_cover_every_row_once(n):
    """Every CTA count up to 132: CTA r owns [r*n/C, (r+1)*n/C), the
    kernel's 40-bit division gives the plan's bounds exactly, and the
    blocks cover the rows once, in order."""
    w = [torch.empty(n, 1), torch.empty(2, n)]
    for C in range(1, 133):
        starts = convergence.plan(w, torch.float32, False, grid=True, cluster=C,
                                  capacity=132).row_starts[0]
        assert len(starts) == C + 1 and starts[0] == 0 and starts[-1] == n
        assert all(a <= b for a, b in zip(starts, starts[1:]))
        assert list(starts) == [_row_start(r, n, C) for r in range(C + 1)]
        assert max(b - a for a, b in zip(starts, starts[1:])) == -(-n // C)
    assert _row_start(convergence.MAX_GRID, n, convergence.MAX_GRID) == n


def test_the_grid_asks_no_owner():
    """owner()'s 40-bit division (the cluster build's, exact for C <=
    16) misses at 2^18 - 1 rows over 132 CTAs, so the grid reads
    published vectors and never asks who owns a row; row_start's stays
    exact there (test_grid_row_blocks_cover_every_row_once)."""
    n, C = convergence.MAX_ROWS - 1, 132
    inv = convergence._inv40(n)
    i = np.arange(n, dtype=object)
    owner40 = ((i + 1) * C - 1) * inv >> 40
    assert any(owner40 != ((i + 1) * C - 1) // n)
    for C in (1, 7, 16):
        x = (i + 1) * C - 1
        assert all(x * inv >> 40 == x // n)


def test_layer_table_is_keyed_by_the_cta_count():
    """The table's records hold each layer's owned-row offset in a
    weight block, which depends on the CTA count: a grid of 132 and a
    cluster of 16 get tables of their own, each packed once."""
    w = _net((784, 300, 10))
    t16 = convergence._layer_table(w, 16, 0, "cpu")
    t132 = convergence._layer_table(w, 132, 0, "cpu")
    assert t16[0] is None and t132[0] is None   # by value in the kernel parameters
    r16 = [convergence.LAYER.unpack_from(t16[1], k * convergence.LAYER.size) for k in (0, 1)]
    r132 = [convergence.LAYER.unpack_from(t132[1], k * convergence.LAYER.size) for k in (0, 1)]
    assert r16[1][-1] == -(-300 // 16) * 784 and r132[1][-1] == -(-300 // 132) * 784
    assert convergence._layer_table(w, 132, 0, "cpu") is t132
    assert convergence._layer_table(w, 16, 0, "cpu") is t16


def test_grid_on_cpu_tensors_is_the_plain_version():
    """CPU tensors take the plain version whatever the build asked."""
    rng = np.random.default_rng(5)
    w0 = [rng.uniform(-0.3, 0.3, (40, 6)), rng.uniform(-0.3, 0.3, (3, 40))]
    X = torch.tensor(rng.uniform(-1, 1, (2, 6)))
    T = torch.tensor([[1.0, -1.0, -1.0], [-1.0, 1.0, -1.0]], dtype=torch.float64)
    kw = dict(model="ann", momentum=True, min_iter=2, max_iter=4)
    a, b = (tuple(torch.tensor(x) for x in w0) for _ in range(2))
    launches = convergence.launches
    sa = convergence.train_epoch(a, X, T, 0.2, -1e30, grid=True, **kw)
    sb = convergence.train_epoch_plain(b, X, T, 0.2, -1e30, **kw)
    assert convergence.launches == launches
    assert sa.n_iter.tolist() == sb.n_iter.tolist() == [5, 5]
    assert all(x.equal(y) for x, y in zip(a, b))


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, dtype, dims, S, seed=23):
    rng = np.random.default_rng(seed)
    w = [rng.uniform(-1, 1, (n, m)) / m ** 0.5 for m, n in zip(dims[:-1], dims[1:])]
    X = rng.uniform(0, 1, (S, dims[0]))
    T = -np.ones((S, dims[-1]))
    T[np.arange(S), rng.integers(0, dims[-1], S)] = 1.0
    return ([torch.tensor(a, dtype=dtype, device=dev) for a in w],
            torch.tensor(X, dtype=dtype, device=dev), torch.tensor(T, dtype=dtype, device=dev))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True), ("snn", False)])
@pytest.mark.parametrize("dims", [(8, 30000, 2), (13, 30001, 3), (784, 4000, 10)])
def test_grid_matches_plain_and_one_cluster(cuda, dims, model, momentum, dtype):
    w0, X, T = _inputs(cuda, dtype, dims, S=2)
    if model == "snn":
        T = (T > 0).to(dtype)
    kw = dict(model=model, momentum=momentum, min_iter=2, max_iter=8)
    wg, wc, wp = ([t.clone() for t in w0] for _ in range(3))
    launches = convergence.launches
    sg = convergence.train_epoch(wg, X, T, 0.2, -1e30, grid=True, **kw)
    sc = convergence.train_epoch(wc, X, T, 0.2, -1e30, grid=False, **kw)
    torch.cuda.synchronize()
    assert convergence.launches == launches + 2
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
    assert sg.n_iter.tolist() == sp.n_iter.tolist() == [9, 9]
    err = max(float((a - b).abs().max()) for a, b in zip(wg + [sg.out], wp + [sp.out]))
    assert err <= TOL[dtype]
    assert _same(wg + list(sg), wc + list(sc))
    assert any(not torch.equal(a, b) for a, b in zip(wg, w0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True), ("snn", False)])
@pytest.mark.parametrize("dims", [(8,) + (40,) * 18 + (4,), (8, 64, 5000)])
def test_grid_deep_and_wide_output_bitwise_one_cluster(cuda, dims, model, momentum, dtype):
    """19 layers (the table in device memory, hidden deltas below the
    top one, a barrier each) and an output layer whose deltas overflow
    shared memory (each lane of the loss sums 157 terms): the grid gives
    one cluster's bits."""
    w0, X, T = _inputs(cuda, dtype, dims, S=2)
    if model == "snn":
        T = (T > 0).to(dtype)
    kw = dict(model=model, momentum=momentum, min_iter=2, max_iter=6)
    runs = []
    for build in (dict(grid=True), dict(grid=True, cluster=7), dict(grid=False)):
        w = [t.clone() for t in w0]
        runs.append(w + list(convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **build)))
    torch.cuda.synchronize()
    assert _same(runs[0], runs[1]) and _same(runs[0], runs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True),
                                            ("snn", False), ("snn", True)])
def test_grid_is_the_shared_build_bitwise(cuda, model, momentum, dtype):
    """784-300-10 fits a cluster: the grid forced at every CTA count
    the card holds, 16 and 8 gives the shared build's bits."""
    k, _ = km.generate(10958, 784, [300], 10)
    w0, _ = km.to_torch(k.weights, device=cuda, dtype=dtype)
    rng = np.random.default_rng(10958)
    X = torch.tensor(rng.random((4, 784)), dtype=dtype, device=cuda)
    T = -np.ones((4, 10))
    T[np.arange(4), rng.integers(0, 10, 4)] = 1.0
    if model == "snn":
        T = np.where(T > 0, 1.0, 0.0)
    T = torch.tensor(T, dtype=dtype, device=cuda)
    kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=20)
    runs = []
    for plan in ({}, dict(grid=True), dict(grid=True, cluster=16), dict(grid=True, cluster=8)):
        w = [t.clone() for t in w0]
        runs.append(w + list(convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)))
    torch.cuda.synchronize()
    assert runs[0][len(w0) + 1].tolist() == [21] * 4
    for r in runs[1:]:
        assert _same(r, runs[0])


@pytest.mark.cuda
def test_grid_the_card_cannot_hold_raises(cuda):
    """The plan's CTA count is the card's co-resident count; one more
    raises in the plan, and a launch of that many (past the plan) is
    refused by the card and raises: no other build runs instead."""
    w0, X, T = _inputs(cuda, torch.float32, (8, 30000, 2), S=1)
    cap = convergence.grid_capacity(torch.float32, cuda)
    assert cap >= torch.cuda.get_device_properties(cuda).multi_processor_count
    assert convergence.plan(w0, torch.float32, False, grid=True, capacity=cap).cluster == cap
    kw = dict(model="ann", min_iter=1, max_iter=2)
    launches = convergence.launches
    with pytest.raises(ValueError, match=f"the card holds {cap}"):
        convergence.train_epoch(w0, X, T, 0.2, -1e30, grid=True, cluster=cap + 1, **kw)
    p = convergence.plan(w0, torch.float32, False, grid=True, cluster=cap + 1,
                         capacity=cap + 1)
    with pytest.raises(RuntimeError, match="cooperative grid"):
        convergence._launch(convergence._library(), p, w0, X, T, 0.2, -1e30, "ann", False,
                            1, 2)
    assert convergence.launches == launches


@pytest.mark.cuda
def test_grid_phase_clock_build(cuda):
    """The grid's -DHPNN_PHASE_CLOCKS build gives the kernel's bits,
    counts no launch, and, from the CTA that owns the output layer's
    row, finds cycles in its lone row and its waits on the ring."""
    w0, X, T = _inputs(cuda, torch.float32, (784, 4000, 10), S=2)
    kw = dict(model="ann", momentum=False, min_iter=2, max_iter=6)
    starts = convergence.plan(w0, torch.float32, False, grid=True,
                              capacity=convergence.grid_capacity(torch.float32, cuda)).row_starts
    owner = next(r for r in range(len(starts[-1]) - 1) if starts[-1][r + 1] > 0)
    wa, wb = ([t.clone() for t in w0] for _ in range(2))
    launches = convergence.launches
    sa, clocks = convergence.phase_clocks(wa, X, T, 0.2, -1e30, grid=True, cta=owner, **kw)
    assert convergence.launches == launches
    sb = convergence.train_epoch(wb, X, T, 0.2, -1e30, grid=True, **kw)
    torch.cuda.synchronize()
    assert _same(wa + list(sa), wb + list(sb))
    assert list(clocks) == list(convergence.PHASES)
    for k in ("hidden deltas", "update and forward rows", "cluster barrier",
              "output layer's rows", "waiting on a ring slot's fill"):
        assert clocks[k] > 0, k
