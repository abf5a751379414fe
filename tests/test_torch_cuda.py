"""The CUDA kernels on the card against their plain PyTorch versions:
the convergence kernel (and itself across its cluster plans), the four
batch-step entry points and the fleet epoch (#6), and the fleet path
through ``train.fleet``.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a
machine without a card.  On one, run them with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import batch_step, convergence
from hpnn_tpu_torch.train import fleet

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


# the plans a net can be launched with: both cluster sizes, the owned
# weight rows in shared memory where they fit and streamed
def _plans(weights, dtype, momentum):
    out = [{}]
    for C in (8, 16):
        p = convergence.plan(weights, dtype, momentum, cluster=C)
        out.append(dict(cluster=C))
        if p.weights_resident:
            out.append(dict(cluster=C, weights_resident=False))
    return out


def _run_plans(dev, dtype, model, momentum, n_in, hiddens, n_out, S=2, max_iter=20):
    """The kernel under every plan on the same inputs, pinned to
    max_iter + 1 iterations a sample; returns [(plan, weights, stats)]."""
    w0, X, T = _inputs(dev, dtype, n_in=n_in, hiddens=hiddens, n_out=n_out, S=S)
    if model == "snn":
        T = (T > 0).to(dtype)
    kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=max_iter)
    runs = []
    for plan in _plans(w0, dtype, momentum):
        w = tuple(t.clone() for t in w0)
        launches = convergence.launches
        st = convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)
        torch.cuda.synchronize()
        assert convergence.launches == launches + 1
        assert st.n_iter.tolist() == [max_iter + 1] * S
        runs.append((plan, w, st))
    wp = tuple(t.clone() for t in w0)
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
    return runs, (wp, sp)


def _assert_bitwise(runs):
    _, w_ref, st_ref = runs[0]
    for plan, w, st in runs[1:]:
        for a, b in zip(list(w) + list(st), list(w_ref) + list(st_ref)):
            assert torch.equal(a, b), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", True), ("snn", False)])
def test_cluster_kernel_bitwise_across_plans(cuda, model, momentum, dtype):
    """784-300-10: 8 and 16 CTAs, resident and streamed weights, one
    result bitwise: every sum keeps one order whatever the plan."""
    runs, (wp, sp) = _run_plans(cuda, dtype, model, momentum, 784, (300,), 10)
    _assert_bitwise(runs)
    if dtype == torch.float64:
        _, w, st = runs[0]
        assert _max_diff(list(w) + [st.out], list(wp) + [sp.out]) <= TOL64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("momentum", [False, True])
def test_cluster_kernel_snn_stress(cuda, momentum, dtype):
    """SNN at 16 CTAs, launched again and again on the same inputs: every
    launch bitwise the 8-CTA run.  Other CTAs read a CTA's published
    output exponentials after the barrier; a CTA that rewrote its own
    before all had read them would show here as launches that differ.
    The iterations are pinned, so no CTA can leave the loop early."""
    w0, X, T = _inputs(cuda, dtype, n_in=784, hiddens=(300,), n_out=10, S=8)
    T = (T > 0).to(dtype)
    kw = dict(model="snn", momentum=momentum, min_iter=5, max_iter=100)
    runs = []
    for plan in [dict(cluster=8)] + [dict(cluster=16)] * 30:
        w = tuple(t.clone() for t in w0)
        runs.append((plan, w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)))
    torch.cuda.synchronize()
    _assert_bitwise(runs)


def test_cluster_kernel_phase_clock_build(cuda):
    """The -DHPNN_PHASE_CLOCKS build (``chip_smoke.py --phase-split``)
    gives the kernel's bits, counts no launch, and finds cycles in every
    phase an SNN iteration with two activation buffers runs."""
    w0, X, T = _inputs(cuda, torch.float32, n_in=784, hiddens=(300,), n_out=10, S=2)
    T = (T > 0).to(torch.float32)
    kw = dict(model="snn", momentum=False, min_iter=5, max_iter=20)
    wa, wb = [tuple(t.clone() for t in w0) for _ in range(2)]
    launches = convergence.launches
    sa, clocks = convergence.phase_clocks(wa, X, T, 0.2, -1e30, **kw)
    assert convergence.launches == launches
    sb = convergence.train_epoch(wb, X, T, 0.2, -1e30, **kw)
    torch.cuda.synchronize()
    _assert_bitwise([({}, wb, sb), ({"phase clocks": True}, wa, sa)])
    assert list(clocks) == list(convergence.PHASES)
    assert all(v > 0 for k, v in clocks.items() if k != "update (one activation buffer)")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_kernel_four_layers(cuda, dtype):
    """Hidden deltas gathered across the cluster below the top hidden
    layer: 12-16-8-6-4, BPM."""
    runs, (wp, sp) = _run_plans(cuda, dtype, "ann", True, 12, (16, 8, 6), 4, max_iter=40)
    _assert_bitwise(runs)
    if dtype == torch.float64:
        _, w, st = runs[0]
        assert _max_diff(list(w) + [st.out, st.ep0], list(wp) + [sp.out, sp.ep0]) <= TOL64


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_cluster_kernel_fewer_outputs_than_ctas(cuda, model):
    """n_out = 2 < C: most CTAs own no output row."""
    runs, (wp, sp) = _run_plans(cuda, torch.float64, model, False, 12, (40,), 2, S=3,
                                max_iter=60)
    _assert_bitwise(runs)
    _, w, st = runs[0]
    assert st.first_ok.tolist() == sp.first_ok.tolist()
    assert _max_diff(list(w) + [st.out, st.ep0, st.dep], list(wp) + [sp.out, sp.ep0, sp.dep]) <= TOL64


def test_cluster_kernel_f64_bpm_dw_in_device_memory(cuda):
    """784-300-10 double BPM: the owned rows of dw do not fit beside W
    and stay in device memory."""
    w, X, T = _inputs(cuda, torch.float64, n_in=784, hiddens=(300,), n_out=10, S=2)
    p = convergence.plan(w, torch.float64, True)
    assert p.weights_resident and not p.dw_resident
    wp = tuple(t.clone() for t in w)
    kw = dict(model="ann", momentum=True, min_iter=5, max_iter=30)
    sk = convergence.train_epoch(w, X, T, 0.2, 1e-6, **kw)
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, 1e-6, **kw)
    torch.cuda.synchronize()
    assert sk.n_iter.tolist() == sp.n_iter.tolist()
    assert _max_diff(list(w) + [sk.out, sk.ep0], list(wp) + [sp.out, sp.ep0]) <= TOL64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_kernel_widest_single_block_shape(cuda, dtype):
    """The widest 4-H-2 net the single-block kernel took: one activation
    buffer (the update behind its own barrier), no staging tile in float
    (1 value in double), weights streamed from device memory."""
    b = torch.empty((), dtype=dtype).element_size()
    room = (convergence.MAX_SHARED_BYTES - 2 * b - 8) // b
    hid = (room - 4 - 2) // 2 - 2
    rng = np.random.default_rng(11)
    w0 = [torch.tensor(rng.uniform(-0.5, 0.5, (hid, 4)), dtype=dtype, device=cuda),
          torch.tensor(rng.uniform(-1, 1, (2, hid)) / hid ** 0.5, dtype=dtype, device=cuda)]
    p = convergence.plan(w0, dtype, True)
    assert not p.dbuf and p.stage <= 1 and not p.weights_resident
    X = torch.tensor(rng.uniform(-1, 1, (2, 4)), dtype=dtype, device=cuda)
    T = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=dtype, device=cuda)
    kw = dict(model="ann", momentum=True, min_iter=1, max_iter=3)
    wk, wp = [t.clone() for t in w0], [t.clone() for t in w0]
    sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
    torch.cuda.synchronize()
    assert sk.n_iter.tolist() == [4, 4]
    tol = TOL64 if dtype == torch.float64 else 1e-5
    assert _max_diff(wk + [sk.out, sk.ep0], wp + [sp.out, sp.ep0]) <= tol
    assert not torch.equal(wk[0], w0[0]) and not torch.equal(wk[1], w0[1])


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
@pytest.mark.parametrize("entry", batch_step.BATCH_ENTRY_POINTS)
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


@pytest.mark.parametrize("shape", [(12, (16, 8), 6), (20, (24,), 40)])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("snn", True)])
def test_batch_kernels_agree_bitwise(cuda, model, momentum, shape):
    """#3 equals #2 on every block, #4 equals S steps of #3, #5 equals #4,
    and a second run of #4 equals the first, on the grid and on a
    cluster team of 1 and 16 CTAs: every sum has one order.  n_out = 6
    takes the output rows in the last layer's tiles, n_out = 40 apart."""
    B, S = 16, 4
    order = [3, 1, 0, 2]
    kw = dict(model=model, momentum=momentum, lr=0.05, alpha=0.2)
    w, dw, X, T = _bank(cuda, torch.float32, model, momentum, B=B, S=S, shape=shape)
    runs = {}
    for name in ("step", "banked", "grid", "dbuf", "grid2", "grid on 16", "dbuf on 16",
                 "grid on 1", "step on 16"):
        wr, dwr = _clone(w), _clone(dw)
        team = (batch_step._cluster_team(int(name.split(" on ")[1])) if " on " in name
                else contextlib.nullcontext())
        with team:
            if name.startswith("step"):
                losses = [batch_step.train_step_fused_batch(
                    wr, dwr, X[k * B:(k + 1) * B].contiguous(),
                    T[k * B:(k + 1) * B].contiguous(), **kw)[2] for k in order]
            elif name == "banked":
                losses = [batch_step.train_step_fused_banked(wr, dwr, X, T, k, batch=B,
                                                             **kw)[2] for k in order]
            else:
                fn = (batch_step.train_epoch_dbuf_banked if name.startswith("dbuf")
                      else batch_step.train_epoch_grid_banked)
                losses = list(fn(wr, dwr, X, T, order, batch=B, **kw)[2])
        runs[name] = [t.cpu() for t in wr + dwr] + [torch.stack(losses).cpu()]
    ref = runs["step"]
    for name, got in runs.items():
        for a, b in zip(got, ref):
            assert torch.equal(a, b), name


def test_batch_shared_bytes_match_the_kernel(cuda):
    """ops.batch_step.shared_bytes mirrors the kernel's layout."""
    lib = batch_step._library()
    for dtype, code in batch_step._DTYPE_CODE.items():
        assert lib.hpnn_batch_smem_bytes(code) == batch_step.shared_bytes(dtype)


@pytest.mark.parametrize("cluster", [0, 16])
def test_batch_phase_clock_build(cuda, cluster):
    """The -DHPNN_PHASE_CLOCKS build gives the kernel's bits, counts no
    launch, and clocks the tiles and the syncs of each step."""
    B, S = 16, 4
    kw = dict(model="snn", momentum=True, lr=0.05, alpha=0.2, batch=B)
    w, dw, X, T = _bank(cuda, torch.float32, "snn", True, B=B, S=S)
    wa, dwa, wb, dwb = _clone(w), _clone(dw), _clone(w), _clone(dw)
    before = dict(batch_step.launches)
    with batch_step._cluster_team(cluster) if cluster else contextlib.nullcontext():
        la, clocks = batch_step.phase_clocks(
            lambda: batch_step.train_epoch_grid_banked(wa, dwa, X, T, [3, 1, 0, 2], **kw)[2])
        assert batch_step.launches == before
        lb = batch_step.train_epoch_grid_banked(wb, dwb, X, T, [3, 1, 0, 2], **kw)[2]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip([la] + wa + dwa, [lb] + wb + dwb))
    assert set(clocks) == set(batch_step.PHASES)
    for phase in ("forward tiles", "hidden-delta tiles", "update tiles", "team syncs"):
        assert clocks[phase] > 0, phase
    assert clocks["output rows apart"] == 0  # n_out = 6: folded into the forward


def test_batch_kernel_refuses_what_it_cannot_take(cuda):
    w, dw, X, T = _bank(cuda, torch.float16, "ann", False)
    with pytest.raises(TypeError):
        batch_step.train_step_fused_batch(w, dw, X[:16], T[:16])
    w, dw, X, T = _bank(cuda, torch.float32, "ann", False)
    with pytest.raises(ValueError, match="whole blocks"):
        batch_step.train_epoch_grid_banked(w, dw, X[:20], T[:20], [0], batch=16)
    with pytest.raises(ValueError, match="outside"):
        batch_step.train_epoch_grid_banked(w, dw, X, T, [0, 4], batch=16)


# ------------------------------------------------------------- fleet (#6)
def _fleet(dev, dtype, model, momentum, N=3, B=16, S=4, shape=(12, (16, 8), 6), seed=6):
    """Stacked member weights (and a small dw), per-member banks and
    block orders."""
    n_in, hiddens, n_out = shape
    rng = np.random.default_rng(seed)
    ks = [km.generate(50 + i, n_in, list(hiddens), n_out)[0] for i in range(N)]
    w = [torch.tensor(np.stack([k.weights[l] for k in ks]), dtype=dtype, device=dev)
         for l in range(len(hiddens) + 1)]
    dw = ([torch.tensor(rng.uniform(-1e-3, 1e-3, tuple(t.shape)), dtype=dtype, device=dev)
           for t in w] if momentum else [])
    X = rng.uniform(-1, 1, (N, S * B, n_in))
    T = -np.ones((N, S * B, n_out))
    for i in range(N):
        T[i, np.arange(S * B), rng.integers(0, n_out, S * B)] = 1.0
    orders = np.stack([rng.permutation(S) for _ in range(N)])
    return (w, dw, torch.tensor(X, dtype=dtype, device=dev),
            torch.tensor(T, dtype=dtype, device=dev), orders)


@pytest.mark.parametrize("model,momentum", [
    ("ann", False), ("ann", True), ("snn", False), ("snn", True),
])
def test_fleet_kernel_matches_plain_f64(cuda, model, momentum):
    w, dw, X, T, orders = _fleet(cuda, torch.float64, model, momentum)
    wp, dwp = _clone(w), _clone(dw)
    kw = dict(batch=16, model=model, momentum=momentum, lr=0.05, alpha=0.2)
    before = batch_step.launches["train_fleet_epoch_dbuf_banked"]
    _, _, lk = batch_step.train_fleet_epoch_dbuf_banked(w, dw, X, T, orders, **kw)
    torch.cuda.synchronize()
    assert batch_step.launches["train_fleet_epoch_dbuf_banked"] == before + 1
    _, _, lp = batch_step.train_fleet_epoch_dbuf_banked_plain(wp, dwp, X, T, orders, **kw)
    assert batch_step.launches["train_fleet_epoch_dbuf_banked"] == before + 1
    assert lk.shape == (3, 4)
    assert _max_diff(w + dw, wp + dwp) <= TOL64
    assert float((lk - lp).abs().max()) <= TOL64 * max(1.0, float(lp.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, TOL64), (torch.float32, 1e-5)])
@pytest.mark.parametrize("model,momentum", [
    ("ann", False), ("ann", True), ("snn", False), ("snn", True),
])
def test_fleet_kernel_matches_plain_one_row(cuda, model, momentum, dtype, tol):
    """The HPNN-sized fleet's shape (64 x 32-16-4, B = 1, S = 1): one-row
    tiles and the loss warp over one row; the weights must move."""
    w, dw, X, T, orders = _fleet(cuda, dtype, model, momentum, N=64, B=1, S=1,
                                 shape=(32, (16,), 4))
    w0, wp, dwp = _clone(w), _clone(w), _clone(dw)
    kw = dict(batch=1, model=model, momentum=momentum)
    _, _, lk = batch_step.train_fleet_epoch_dbuf_banked(w, dw, X, T, orders, **kw)
    _, _, lp = batch_step.train_fleet_epoch_dbuf_banked_plain(wp, dwp, X, T, orders, **kw)
    torch.cuda.synchronize()
    assert lk.shape == (64, 1)
    assert _max_diff(w + dw, wp + dwp) <= tol
    assert float((lk - lp).abs().max()) <= tol * max(1.0, float(lp.abs().max()))
    for a, b in zip(w, w0):
        assert all(not torch.equal(a[i], b[i]) for i in range(64))


@pytest.mark.parametrize("shape,B", [((12, (16, 8), 6), 16), ((130, (70,), 10), 64),
                                     ((40, (36,), 40), 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True), ("snn", False),
                                            ("snn", True)])
def test_fleet_member_equals_dbuf_and_grid_bitwise(cuda, model, momentum, dtype, shape, B):
    """Member i of #6 equals #5 and #4 on bank i with orders[i], for every
    cluster size: 130-70-10 at B = 64 spreads 15 update tiles over the
    CTAs' workers, 40-36-40 takes its output rows apart (n_out > 32)."""
    w, dw, X, T, orders = _fleet(cuda, dtype, model, momentum, B=B, S=3, shape=shape)
    kw = dict(batch=B, model=model, momentum=momentum, lr=0.05, alpha=0.2)
    w0, dw0 = _clone(w), _clone(dw)
    _, _, lf = batch_step.train_fleet_epoch_dbuf_banked(w, dw, X, T, orders, **kw)
    for i in range(len(orders)):
        for fn in (batch_step.train_epoch_dbuf_banked, batch_step.train_epoch_grid_banked):
            wi = [t[i].clone() for t in w0]
            dwi = [t[i].clone() for t in dw0]
            _, _, li = fn(wi, dwi, X[i], T[i], orders[i], **kw)
            assert torch.equal(li, lf[i]), fn.__name__
            for a, b in zip(wi + dwi, w + dw):
                assert torch.equal(a, b[i]), fn.__name__
    for C in batch_step.CLUSTER_SIZES:
        wc, dwc = _clone(w0), _clone(dw0)
        _, _, lc = batch_step.train_fleet_epoch_dbuf_banked(wc, dwc, X, T, orders, cluster=C,
                                                            **kw)
        assert torch.equal(lc, lf), C
        assert all(torch.equal(a, b) for a, b in zip(wc + dwc, w + dw)), C


def test_fleet_many_members_and_waves(cuda):
    """32 members at the planned cluster size and at 4 CTAs equal their
    #5 epochs; 40 members of 16 CTAs, more clusters than the card holds
    at once, run in waves and equal the planned launch bitwise."""
    cap = batch_step.cluster_capacity(torch.float32, cuda)
    assert all(n >= 1 for n in cap.values())
    w, dw, X, T, orders = _fleet(cuda, torch.float32, "ann", True, N=40, B=32, S=2,
                                 shape=(130, (70,), 10))
    kw = dict(batch=32, model="ann", momentum=True, lr=0.05, alpha=0.2)
    shapes = [tuple(t.shape[1:]) for t in w]
    assert batch_step.fleet_cluster(32, shapes, 32, cap) in batch_step.CLUSTER_SIZES
    runs32 = []
    for C in (None, 4):
        w32, dw32 = [t[:32].clone() for t in w], [t[:32].clone() for t in dw]
        _, _, l32 = batch_step.train_fleet_epoch_dbuf_banked(
            w32, dw32, X[:32].contiguous(), T[:32].contiguous(), orders[:32], cluster=C, **kw)
        runs32.append([l32] + w32 + dw32)
    assert all(torch.equal(a, b) for a, b in zip(*runs32))
    l32, w32, dw32 = runs32[0][0], runs32[0][1:3], runs32[0][3:]
    for i in (0, 17, 31):
        wi, dwi = [t[i].clone() for t in w], [t[i].clone() for t in dw]
        _, _, li = batch_step.train_epoch_dbuf_banked(wi, dwi, X[i], T[i], orders[i], **kw)
        assert torch.equal(li, l32[i])
        assert all(torch.equal(a, b[i]) for a, b in zip(wi + dwi, w32 + dw32))
    runs = []
    for C in (None, 16):
        wc, dwc = _clone(w), _clone(dw)
        _, _, lc = batch_step.train_fleet_epoch_dbuf_banked(wc, dwc, X, T, orders,
                                                            cluster=C, **kw)
        runs.append([lc] + wc + dwc)
    assert 40 > cap[16]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.equal(a, b[:32]) for a, b in zip([l32] + w32 + dw32, runs[0]))


@pytest.mark.parametrize("momentum", [False, True])
def test_fleet_cluster_snn_stress(cuda, momentum):
    """The cluster barrier orders the device-memory scratch: 24 launches
    of an SNN fleet at 16 CTAs a member from the same start, bitwise
    equal to the first and to 1 CTA a member."""
    w, dw, X, T, orders = _fleet(cuda, torch.float32, "snn", momentum, N=4, B=64, S=3,
                                 shape=(130, (70,), 10))
    kw = dict(batch=64, model="snn", momentum=momentum, lr=0.05, alpha=0.2)
    ref = None
    for rep in range(25):
        wc, dwc = _clone(w), _clone(dw)
        _, _, lc = batch_step.train_fleet_epoch_dbuf_banked(
            wc, dwc, X, T, orders, cluster=1 if rep == 0 else 16, **kw)
        run = [lc] + wc + dwc
        if ref is None:
            ref = run
        assert all(torch.equal(a, b) for a, b in zip(run, ref)), rep


def test_train_fleet_equals_sequential_bitwise(cuda):
    ks = [km.generate(60 + i, 12, [16], 6)[0] for i in range(4)]
    rng = np.random.default_rng(8)
    X = rng.uniform(-1, 1, (64, 12))
    T = -np.ones((64, 6))
    T[np.arange(64), rng.integers(0, 6, 64)] = 1.0
    kw = dict(epochs=3, batch=16, seeds=[4, 0, 9, 2], lr=0.5)
    before = dict(batch_step.launches)
    out_f, loss_f, cnt_f = fleet.train_fleet(ks, X, T, **kw)
    assert batch_step.launches["train_fleet_epoch_dbuf_banked"] == (
        before["train_fleet_epoch_dbuf_banked"] + 3)  # one launch per epoch
    out_s, loss_s, cnt_s = fleet.train_sequential(ks, X, T, **kw)
    assert batch_step.launches["train_epoch_grid_banked"] == (
        before["train_epoch_grid_banked"] + 4 * 3)
    assert loss_f.dtype == np.float32 and loss_f.shape == (4, 3, 4)
    for a, b in zip(out_f, out_s):
        for wa, wb in zip(a.weights, b.weights):
            assert wa.dtype == np.float64 and np.array_equal(wa, wb)
    assert np.array_equal(loss_f, loss_s) and np.array_equal(cnt_f, cnt_s)


def test_fleet_kernel_refuses_what_it_cannot_take(cuda):
    w, dw, X, T, orders = _fleet(cuda, torch.float32, "ann", False)
    kw = dict(batch=16)
    run = batch_step.train_fleet_epoch_dbuf_banked
    with pytest.raises(TypeError):
        run([t.half() for t in w], dw, X.half(), T.half(), orders, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        run(w, dw, X.transpose(1, 2).contiguous().transpose(1, 2), T, orders, **kw)
    with pytest.raises(ValueError, match="member counts"):
        run(w, dw, X[:2], T[:2], orders, **kw)
    with pytest.raises(ValueError, match="member counts"):
        run([w[0], w[1][:2].contiguous()], dw, X, T, orders, **kw)
    with pytest.raises(ValueError, match="outside"):
        run(w, dw, X, T, orders + 1, **kw)
    with pytest.raises(ValueError, match="cluster size"):
        run(w, dw, X, T, orders, cluster=3, **kw)
