"""Model math of the PyTorch port against the JAX package, float64 on
the CPU, on the same numpy-seeded inputs.  Tolerance 1e-14 absolute:
the two packages evaluate the same expressions and differ only in the
summation order of each dot product (values here are O(1))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpnn_tpu.models import ann as jann
from hpnn_tpu.models import snn as jsnn
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as km

TOL = 1e-14


def _setup(seed=5, n_in=12, hiddens=(16, 8), n_out=8, snn_target=False):
    rng = np.random.default_rng(seed)
    sizes = list(hiddens) + [n_out]
    inputs = [n_in] + list(hiddens)
    w = [rng.uniform(-0.5, 0.5, (n, m)) for n, m in zip(sizes, inputs)]
    x = rng.uniform(-1, 1, n_in)
    t = np.full(n_out, 0.0 if snn_target else -1.0)
    t[int(rng.integers(0, n_out))] = 1.0
    dw = [rng.uniform(-1e-3, 1e-3, a.shape) for a in w]
    return w, x, t, dw


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)


def _close(got, ref, tol=TOL):
    got = [np.asarray(g) for g in (got if isinstance(got, (tuple, list)) else [got])]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, (tuple, list)) else [ref])]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)


def test_act_dact():
    z = np.linspace(-40, 40, 161)
    _close(ann.act(_t(z)), jann.act(_j(z)))
    y = np.linspace(-1, 1, 41)
    _close(ann.dact(_t(y)), jann.dact(_j(y)))


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_forward_error_deltas(model):
    w, x, t, _ = _setup(snn_target=model == "snn")
    mod, jmod = (snn, jsnn) if model == "snn" else (ann, jann)
    wt, wj = [_t(a) for a in w], [_j(a) for a in w]
    acts = mod.forward(wt, _t(x))
    jacts = jmod.forward(wj, _j(x))
    _close(acts, jacts)
    _close(mod.run(wt, _t(x)), jmod.run(wj, _j(x)))
    _close(mod.train_error(acts[-1], _t(t)), jmod.train_error(jacts[-1], _j(t)))
    _close(mod.deltas(wt, acts, _t(t)), jmod.deltas(wj, jacts, _j(t)))


def test_bp_and_bpm_updates():
    w, x, t, dw = _setup()
    wt, wj = [_t(a) for a in w], [_j(a) for a in w]
    acts = ann.forward(wt, _t(x))
    jacts = jann.forward(wj, _j(x))
    ds = ann.deltas(wt, acts, _t(t))
    jds = jann.deltas(wj, jacts, _j(t))
    _close(ann.bp_update(wt, acts, ds, ann.BP_LEARN_RATE),
           jann.bp_update(wj, jacts, jds, jann.BP_LEARN_RATE))
    nw, ndw = ann.bpm_update(wt, [_t(a) for a in dw], acts, ds, ann.BPM_LEARN_RATE, 0.2)
    jw, jdw = jann.bpm_update(wj, [_j(a) for a in dw], jacts, jds, jann.BPM_LEARN_RATE, 0.2)
    _close(nw, jw)
    _close(ndw, jdw)


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_train_iterations(model):
    """One BP and one BPM iteration: weights, momentum, acts and dEp."""
    w, x, t, dw = _setup(seed=11, snn_target=model == "snn")
    mod, jmod = (snn, jsnn) if model == "snn" else (ann, jann)
    wt, wj = [_t(a) for a in w], [_j(a) for a in w]
    acts, jacts = mod.forward(wt, _t(x)), jmod.forward(wj, _j(x))
    got = mod.train_iteration(wt, acts, _t(x), _t(t))
    ref = jmod.train_iteration(wj, jacts, _j(x), _j(t))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _close(got[2], ref[2])
    got = mod.train_iteration_momentum(wt, [_t(a) for a in dw], acts, _t(x), _t(t), 0.2)
    ref = jmod.train_iteration_momentum(wj, [_j(a) for a in dw], jacts, _j(x), _j(t), 0.2)
    for g, r in zip(got, ref):
        _close(g, r)


def test_snn_quirks():
    """exp(z-1) with no max shift, TINY seeding the denominator and
    +TINY inside the log — on logits large enough to show each."""
    z = np.array([30.0, 29.0, -5.0, -700.0])
    w = [np.eye(4)]
    out = snn.run([_t(a) for a in w], _t(z))
    _close(out, jsnn.run([_j(a) for a in w], _j(z)))
    e = np.exp(z - 1.0)
    np.testing.assert_allclose(np.asarray(out), e / (snn.TINY + e.sum()), rtol=1e-15)
    # a zero output still gives a finite error through +TINY
    t = np.array([0.0, 0.0, 0.0, 1.0])
    err = snn.train_error(out, _t(t))
    assert np.isfinite(float(err))
    _close(err, jsnn.train_error(_j(np.asarray(out)), _j(t)))
    assert snn.SNN_LEARN_RATE == jsnn.SNN_LEARN_RATE == 0.01
    assert (ann.BP_LEARN_RATE, ann.BPM_LEARN_RATE) == (jann.BP_LEARN_RATE, jann.BPM_LEARN_RATE)


def test_snn_out_exp_subnormal_results():
    """``out_exp`` is ``torch.exp(z - 1)`` bit for bit wherever the result
    is a normal float64, and in float32; below it is within one subnormal
    ulp of the correctly rounded exp, zero exactly where that is zero
    (the CPU's exp, which an SNN stop rests on once every output has
    underflowed)."""
    import math

    z = torch.linspace(-746.0, 40.0, 200_001, dtype=torch.float64) + 1.0
    got, plain = snn.out_exp(z), torch.exp(z - 1.0)
    normal = (z - 1.0) >= snn.SUBNORMAL_BELOW
    assert torch.equal(got[normal], plain[normal])
    z32 = z.to(torch.float32)
    assert torch.equal(snn.out_exp(z32), torch.exp(z32 - 1.0))
    sub = z[~normal][::7]
    ref = torch.tensor([math.exp(v - 1.0) for v in sub.tolist()], dtype=torch.float64)
    low = got[~normal][::7]
    assert torch.equal(low == 0, ref == 0)
    assert float((low - ref).abs().max()) <= math.ulp(0.0)
    # the least subnormal where the exp's argument is -744.878 (a stop
    # that the card's exp moved by one iteration)
    assert float(snn.out_exp(torch.tensor(-743.878, dtype=torch.float64))) == math.ulp(0.0)


def test_snn_stops_finds_the_round_order():
    """``tools/snn_stops`` recovers the order a round trained its samples
    in from the round's N_ITER list (exact: the same plain loop)."""
    from hpnn_tpu_torch.tools import snn_stops
    from hpnn_tpu_torch.train import loop

    rng = np.random.default_rng(7)
    w0 = tuple(_t(rng.uniform(-0.5, 0.5, s)) for s in ((8, 12), (4, 8)))
    X = _t(rng.uniform(0.0, 1.0, (4, 12)))
    T = _t(np.where(np.eye(4)[[2, 0, 3, 1]] > 0, 1.0, -1.0))
    order, w, n_iter = [2, 0, 3, 1], w0, []
    for i in order:
        r = loop.train_sample(w, (), X[i], T[i], 0.2, loop.DELTA_BP, model="snn",
                              max_iter=400)
        w = r.weights
        n_iter.append(r.n_iter)
    found = snn_stops.orders(w0, X, T, n_iter, 400)
    assert order in [o for o, _ in found]
    assert all(len(stops) == 4 for _, stops in found)


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_batched_run_matches_per_sample(model):
    """The eval path's batched forward (KernelModule) equals the JAX
    per-sample run on every row."""
    w, _, _, _ = _setup(seed=3)
    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, (7, 12))
    jmod = jsnn if model == "snn" else jann
    wt, _ = km.to_torch(w, device="cpu", dtype=torch.float64)
    net = km.KernelModule(wt, model=model)
    got = net(_t(X))
    ref = np.stack([np.asarray(jmod.run([_j(a) for a in w], _j(x))) for x in X])
    _close(got, ref)


def test_to_torch_round_trip():
    w, _, _, dw = _setup()
    wt, dwt = km.to_torch(w, dw, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 and t.is_contiguous() for t in wt + dwt)
    back, back_dw = km.to_numpy(wt, dwt)
    for a, b in zip(w + dw, back + back_dw):
        assert np.array_equal(a, b)
    w32, none = km.to_torch(w, device="cpu", dtype=torch.float32)
    assert none == () and all(t.dtype == torch.float32 for t in w32)
    np.testing.assert_array_equal(km.to_numpy(w32)[0][0], w[0].astype(np.float32))
