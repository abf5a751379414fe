"""The fleet path of the port (``hpnn_tpu_torch.train.fleet`` and the
plain twin of kernel #6) held against the JAX package on the CPU.

* ``stack_kernels``/``unstack_kernels`` and the plans, equal array for
  array to ``hpnn_tpu.train.fleet``'s;
* ``train_fleet``, ``train_fleet_multi`` and ``train_sequential`` with
  ``device="cpu"`` against the JAX functions in float64 (conftest
  enables x64): weights within 1e-12, losses within 1e-12 relative,
  counts equal;
* inside the port, fleet == sequential and K rounds == K chained
  rounds, bitwise (the claims tests/test_fleet.py and
  tests/test_quant.py make for the JAX package);
* ``train_fleet_epoch_dbuf_banked_plain`` against the Pallas kernel in
  interpret mode, float32: weights and dw within 1e-5, losses within
  1e-5 relative (the epoch tolerance of tests/test_torch_batch_step.py);
* the refusals.

Inputs are made from a seed with numpy and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.ops import pallas_train
from hpnn_tpu.train import fleet as jfleet
from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.train import fleet


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: a test elsewhere in this worker may have left one set
    (``hpnn_tpu.obs.configure`` exports HPNN_METRICS), and a ``--metrics``
    or ``--ledger`` flag here exports one.  Clear them all and forget
    the port's memos before the test; drop what the test exported and
    forget again after it."""
    from hpnn_tpu_torch import obs as port_obs

    for knob in (*runtime.DEFERRED_ENV, *port_obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    port_obs._reset_for_tests()
    yield
    for knob in port_obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    port_obs._reset_for_tests()


MODES = [("ann", False), ("ann", True), ("snn", False), ("snn", True)]
LR = 0.3  # large enough that two epochs of 2-row steps move the weights


def _kernels(n, seed0=7, n_in=8, hiddens=(5,), n_out=2):
    return [jkm.generate(seed0 + i, n_in, list(hiddens), n_out)[0] for i in range(n)]


def _data(n_rows=8, n_in=8, n_out=2, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (n_rows, n_in))
    T = np.full((n_rows, n_out), -1.0)
    T[np.arange(n_rows), rng.randint(0, n_out, n_rows)] = 1.0
    return X, T


def _assert_close_to_jax(got, ref):
    (kg, lg, cg), (kr, lr, cr) = got, ref
    assert lg.shape == np.shape(lr) and cg.shape == np.shape(cr)
    for a, b in zip(kg, kr):
        for wa, wb in zip(a.weights, b.weights):
            assert wa.dtype == np.float64
            np.testing.assert_allclose(wa, np.asarray(wb), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lg, np.asarray(lr), rtol=1e-12, atol=0)
    assert np.array_equal(cg, np.asarray(cr))


def _assert_bitwise(a, b):
    (ka, la, ca), (kb, lb, cb) = a, b
    for x, y in zip(ka, kb):
        for wx, wy in zip(x.weights, y.weights):
            assert np.array_equal(wx, wy)
    assert np.array_equal(la, lb) and np.array_equal(ca, cb)


# ---------------------------------------------------------- stacking
def test_stack_unstack_roundtrip_and_topology_validation():
    ks = _kernels(3)
    stacked = fleet.stack_kernels(ks, device="cpu")
    assert stacked[0].shape == (3, 5, 8) and stacked[1].shape == (3, 2, 5)
    assert stacked[0].dtype == torch.float64 and stacked[0].is_contiguous()
    ref = jfleet.stack_kernels(ks)
    for a, b in zip(stacked, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = fleet.unstack_kernels(stacked)
    for a, b in zip(ks, back):
        for wa, wb in zip(a.weights, b.weights):
            assert np.array_equal(np.asarray(wa), wb)
    # host copies: later in-place updates of the stack leave them as they were
    stacked[0].zero_()
    assert np.array_equal(back[0].weights[0], np.asarray(ks[0].weights[0]))
    assert fleet.stack_kernels(ks, device="cpu", dtype=torch.float32)[0].dtype == torch.float32
    odd = jkm.generate(1, 8, [6], 2)[0]  # different hidden width
    with pytest.raises(ValueError, match="topology"):
        fleet.stack_kernels(ks + [odd], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        fleet.stack_kernels([], device="cpu")


# ---------------------------------------------------------- planning
@pytest.mark.parametrize("epochs,refresh", [(16, 8), (3, 8), (4, 2)])
def test_plans_equal_the_jax_package(epochs, refresh):
    """(3, 8) is the refresh degrade: 8 does not divide 3, so every
    epoch draws a fresh permutation."""
    kw = dict(n_rows=8, batch=2, epochs=epochs, refresh=refresh)
    for got, ref in ((fleet.member_plan(5, **kw), jfleet.member_plan(5, **kw)),
                     (fleet.fleet_plan([4, 9, 2], **kw), jfleet.fleet_plan([4, 9, 2], **kw)),
                     (fleet.multi_round_plan([[1, 2], [3, 4], [5, 6]], **kw),
                      jfleet.multi_round_plan([[1, 2], [3, 4], [5, 6]], **kw))):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.int32
            assert np.array_equal(a, b)
    perms, orders = fleet.member_plan(5, n_rows=8, batch=2, epochs=3, refresh=8)
    assert perms.shape == (3, 8) and orders.shape == (3, 1, 4)
    with pytest.raises(ValueError, match="member"):
        fleet.multi_round_plan([[1, 2], [3]], n_rows=8, batch=2, epochs=2)
    with pytest.raises(ValueError, match="divide"):
        fleet.member_plan(1, n_rows=8, batch=3, epochs=1)


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("model,momentum", MODES)
def test_train_fleet_matches_jax_f64(model, momentum):
    ks = _kernels(3)
    X, T = _data()
    kw = dict(epochs=2, batch=2, seeds=[3, 1, 4], model=model, momentum=momentum, lr=LR)
    got = fleet.train_fleet(ks, X, T, device="cpu", **kw)
    ref = jfleet.train_fleet(ks, X, T, **kw)
    assert got[1].shape == (3, 2, 4) and got[2].shape == (3, 2)
    _assert_close_to_jax(got, ref)


@pytest.mark.parametrize("model,momentum", [("ann", False), ("snn", True)])
def test_train_fleet_multi_and_sequential_match_jax_f64(model, momentum):
    ks = _kernels(2)
    X, T = _data()
    kw = dict(epochs=2, batch=2, model=model, momentum=momentum, lr=LR)
    got = fleet.train_fleet_multi(ks, X, T, rounds=2, device="cpu", **kw)
    ref = jfleet.train_fleet_multi(ks, X, T, rounds=2, **kw)
    assert got[1].shape == (2, 2, 2, 4) and got[2].shape == (2, 2, 2)
    _assert_close_to_jax(got, ref)
    got = fleet.train_sequential(ks, X, T, seeds=[5, 6], device="cpu", **kw)
    ref = jfleet.train_sequential(ks, X, T, seeds=[5, 6], **kw)
    _assert_close_to_jax(got, ref)


# ----------------------------------------------- bitwise inside the port
@pytest.mark.parametrize("model,momentum", MODES)
def test_fleet_equals_sequential_bitwise(model, momentum):
    ks = _kernels(4)
    X, T = _data(n_rows=12)
    kw = dict(epochs=3, batch=3, seeds=[8, 0, 2, 7], model=model, momentum=momentum,
              lr=LR, device="cpu")
    _assert_bitwise(fleet.train_fleet(ks, X, T, **kw), fleet.train_sequential(ks, X, T, **kw))


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_multi_round_equals_chained_rounds_bitwise(model):
    """Without momentum: the K-round run carries dw from round to round,
    as the JAX scan does, where chained rounds start each from zero."""
    n, rounds = 3, 3
    ks = _kernels(n)
    X, T = _data()
    seed_rounds = [[100 * r + i for i in range(n)] for r in range(rounds)]
    kw = dict(epochs=2, batch=2, model=model, lr=LR, device="cpu")
    out_m, loss_m, cnt_m = fleet.train_fleet_multi(ks, X, T, rounds=rounds,
                                                   seed_rounds=seed_rounds, **kw)
    cur = ks
    for r in range(rounds):
        cur, loss_r, cnt_r = fleet.train_fleet(cur, X, T, seeds=seed_rounds[r], **kw)
        assert np.array_equal(loss_m[:, r], loss_r) and np.array_equal(cnt_m[:, r], cnt_r)
    _assert_bitwise((out_m, 0, 0), (cur, 0, 0))


def test_epoch_fns_update_in_place_and_skip_the_count():
    ks = _kernels(2)
    X, T = (torch.tensor(a) for a in _data())
    stacked = fleet.stack_kernels(ks, device="cpu")
    before = [w.clone() for w in stacked]
    perms, orders = fleet.fleet_plan([1, 2], n_rows=8, batch=2, epochs=2)
    fn = fleet.make_fleet_epoch_fn(4, lr=LR, count=False)
    w, dw, losses, counts = fn(stacked, (), X, T, perms, orders)
    assert w is stacked and dw == ()
    assert not torch.equal(stacked[0], before[0])
    assert losses.shape == (2, 2, 4) and counts.tolist() == [[0, 0], [0, 0]]


# ------------------------------------------------- kernel #6, plain twin
def _plain_against_interpret(N, B, S, momentum):
    ks = _kernels(N)
    rng = np.random.RandomState(0)
    X_banks = rng.uniform(-1, 1, (N, S * B, 8)).astype(np.float32)
    T_banks = np.where(rng.rand(N, S * B, 2) > 0.5, 1.0, -1.0).astype(np.float32)
    orders = np.stack([rng.permutation(S) for _ in range(N)]).astype(np.int32)
    kw = dict(batch=B, momentum=momentum, lr=LR)
    stacked = jfleet.stack_kernels(ks)
    jw = tuple(jnp.asarray(w, jnp.float32) for w in stacked)
    jdw = tuple(jnp.zeros_like(w) for w in jw) if momentum else ()
    rw, rdw, rl = pallas_train.train_fleet_epoch_dbuf_banked(
        jw, jdw, X_banks, T_banks, jnp.asarray(orders), interpret=True, **kw)
    w = [torch.tensor(np.asarray(a)) for a in jw]
    dw = [torch.zeros_like(a) for a in w] if momentum else []
    out = batch_step.train_fleet_epoch_dbuf_banked_plain(
        w, dw, torch.tensor(X_banks), torch.tensor(T_banks), orders, **kw)
    assert out[0] is w and out[1] is dw  # updated in place
    assert out[2].shape == (N, S)
    for a, b in zip(w + dw, list(rw) + list(rdw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(rl), rtol=1e-5)
    for a, b in zip(w, jw):  # the epoch moved every member's weights
        assert all(not np.array_equal(a[i].numpy(), np.asarray(b[i])) for i in range(N))


@pytest.mark.parametrize("momentum", [False, True])
def test_fleet_epoch_plain_matches_pallas_interpret(momentum):
    _plain_against_interpret(3, 4, 3, momentum)


@pytest.mark.parametrize("momentum", [False, True])
def test_fleet_epoch_plain_matches_pallas_interpret_one_row(momentum):
    """The HPNN-sized fleet's shape: one row a step, one step a tick."""
    _plain_against_interpret(4, 1, 1, momentum)


def test_fleet_epoch_refuses_bad_inputs():
    ks = _kernels(2)
    w = list(fleet.stack_kernels(ks, device="cpu"))
    X = torch.zeros(2, 8, 8, dtype=torch.float64)
    T = torch.zeros(2, 8, 2, dtype=torch.float64)
    orders = np.array([[0, 1], [1, 0]])
    run = batch_step.train_fleet_epoch_dbuf_banked
    with pytest.raises(ValueError, match="member counts"):
        run(w, [], X[:1].contiguous(), T[:1].contiguous(), orders, batch=4)
    with pytest.raises(ValueError, match="member counts"):
        run(w, [], X, T, orders[:1], batch=4)
    with pytest.raises(ValueError, match="outside"):
        run(w, [], X, T, [[0, 2], [1, 0]], batch=4)
    with pytest.raises(ValueError, match=r"\(N, S\)"):
        run(w, [], X, T, [0, 1], batch=4)
    with pytest.raises(TypeError, match="float32 and float64"):
        run(w, [], X.half(), T.half(), orders, batch=4)
    with pytest.raises(ValueError, match="contiguous"):
        run(w, [], X.transpose(1, 2).contiguous().transpose(1, 2), T, orders, batch=4)
    with pytest.raises(ValueError, match="momentum"):
        run(w, [], X, T, orders, batch=4, momentum=True)


# ----------------------------------------------------------- refusals
def test_train_fleet_refusals(monkeypatch):
    ks = _kernels(2)
    X, T = _data()
    with pytest.raises(ValueError, match="seeds"):
        fleet.train_fleet(ks, X, T, epochs=1, batch=2, seeds=[1], device="cpu")
    with pytest.raises(NotImplementedError, match="bf16"):
        fleet.train_fleet(ks, X, T, epochs=1, batch=2, dtype="bf16", device="cpu")
    with pytest.raises(NotImplementedError, match="bf16"):
        fleet.quant_probe_fleet(ks, X, T, epochs=1, batch=2, device="cpu")
    with pytest.raises(ValueError, match="unknown train dtype"):
        fleet.train_fleet(ks, X, T, epochs=1, batch=2, dtype="f16", device="cpu")
    monkeypatch.setenv("HPNN_COMPILE_CACHE_DIR", "xla_cache")
    with pytest.raises(NotImplementedError,
                       match="HPNN_COMPILE_CACHE_DIR=xla_cache selects XLA's persistent"):
        fleet.train_fleet(ks, X, T, epochs=1, batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="a CUDA graph cannot be written"):
        fleet.train_sequential(ks, X, T, epochs=1, batch=2, device="cpu")
    monkeypatch.delenv("HPNN_COMPILE_CACHE_DIR")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.DeviceUnavailable):
        fleet.train_fleet(ks, X, T, epochs=1, batch=2)
    with pytest.raises(runtime.DeviceUnavailable):
        fleet.stack_kernels(ks)


def test_quant_probe_fleet_f32_against_native():
    ks = _kernels(2)
    X, T = _data()
    out_low, out_ref, err = fleet.quant_probe_fleet(ks, X, T, epochs=2, batch=2, dtype="f32",
                                                    lr=LR, device="cpu")
    assert out_low[0].weights[0].dtype == np.float64  # cast back to the members' dtype
    assert 0.0 < err < 1e-5
