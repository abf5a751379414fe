"""The batch-step kernels' plain versions and the step math, held
against the JAX package on the CPU.

* Each ``*_plain`` entry point of ``hpnn_tpu_torch.ops.batch_step``
  against the Pallas kernel it replaces (``hpnn_tpu.ops.pallas_train``)
  run in interpret mode, in float32, as ``tests/test_pallas.py`` runs
  them: a step to 1e-6 on weights and dw and 1e-5 relative on the loss;
  an epoch (S = 4 steps) to 1e-5 and 1e-5.
* ``parallel.dp.train_step_math`` against the JAX package's, in
  float64, within 1e-12.

Inputs are made from a seed with numpy and handed to both packages.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpnn_tpu.ops import pallas_train
from hpnn_tpu.parallel import dp as jdp
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.parallel import dp

MODES = [("ann", False), ("ann", True), ("snn", False), ("snn", True)]
LR = 0.05


def _data(seed, n_in, hiddens, n_out, rows, momentum):
    """Generated weights, a small random dw, and ±1 one-hot targets (the
    sample containers' convention, so the SNN clamp is exercised)."""
    k, _ = km.generate(seed, n_in, list(hiddens), n_out)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (rows, n_in))
    T = -np.ones((rows, n_out))
    T[np.arange(rows), rng.integers(0, n_out, rows)] = 1.0
    dw = [rng.uniform(-1e-3, 1e-3, np.shape(w)) for w in k.weights] if momentum else []
    return [np.asarray(w) for w in k.weights], dw, X, T


def _jax(arrs):
    return tuple(jnp.asarray(a, dtype=jnp.float32) for a in arrs)


def _torch(arrs, dtype=torch.float32):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in arrs]


def _assert_state(got_w, got_dw, ref_w, ref_dw, atol):
    for a, b in zip(list(got_w) + list(got_dw), list(ref_w) + list(ref_dw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("model,momentum", MODES)
def test_step_batch_plain_matches_pallas(model, momentum):
    w, dw, X, T = _data(42, 12, [16], 6, 16, momentum)
    kw = dict(model=model, momentum=momentum, lr=LR, alpha=0.2)
    rw, rdw, rloss = pallas_train.train_step_fused_batch(
        _jax(w), _jax(dw), jnp.asarray(X, jnp.float32), jnp.asarray(T, jnp.float32),
        interpret=True, **kw)
    gw, gdw = _torch(w), _torch(dw)
    out = batch_step.train_step_fused_batch_plain(
        gw, gdw, torch.tensor(X, dtype=torch.float32),
        torch.tensor(T, dtype=torch.float32), **kw)
    assert out[0] is gw and out[1] is gdw  # updated in place
    _assert_state(gw, gdw, rw, rdw, 1e-6)
    np.testing.assert_allclose(float(out[2]), float(rloss), rtol=1e-5)


@pytest.mark.parametrize("model,momentum", MODES)
def test_step_banked_plain_matches_pallas(model, momentum):
    B, S, k = 8, 4, 2
    w, dw, X, T = _data(21, 16, [12], 5, S * B, momentum)
    kw = dict(model=model, momentum=momentum, lr=LR, alpha=0.2)
    rw, rdw, rloss = pallas_train.train_step_fused_banked(
        _jax(w), _jax(dw), jnp.asarray(X, jnp.float32), jnp.asarray(T, jnp.float32),
        jnp.int32(k), batch=B, interpret=True, **kw)
    gw, gdw = _torch(w), _torch(dw)
    _, _, loss = batch_step.train_step_fused_banked_plain(
        gw, gdw, torch.tensor(X, dtype=torch.float32),
        torch.tensor(T, dtype=torch.float32), torch.tensor([k]), batch=B, **kw)
    _assert_state(gw, gdw, rw, rdw, 1e-6)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


@pytest.mark.parametrize("model,momentum", MODES)
@pytest.mark.parametrize("entry", ["train_epoch_grid_banked", "train_epoch_dbuf_banked"])
def test_epoch_plain_matches_pallas(entry, model, momentum):
    B, S = 8, 4
    w, dw, X, T = _data(31, 16, [12], 5, S * B, momentum)
    order = np.array([2, 0, 3, 1], dtype=np.int32)
    kw = dict(model=model, momentum=momentum, lr=LR, alpha=0.2)
    rw, rdw, rlosses = getattr(pallas_train, entry)(
        _jax(w), _jax(dw), jnp.asarray(X, jnp.float32), jnp.asarray(T, jnp.float32),
        jnp.asarray(order), batch=B, interpret=True, **kw)
    gw, gdw = _torch(w), _torch(dw)
    _, _, losses = getattr(batch_step, entry + "_plain")(
        gw, gdw, torch.tensor(X, dtype=torch.float32),
        torch.tensor(T, dtype=torch.float32), order, batch=B, **kw)
    assert losses.shape == (S,)
    _assert_state(gw, gdw, rw, rdw, 1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(rlosses), rtol=1e-5)


@pytest.mark.parametrize("model,momentum", MODES)
def test_epoch_plain_is_steps_of_step_plain(model, momentum):
    """The grid epoch's plain version is exactly S plain steps on the
    blocks in ``order`` (bitwise, the same operations in the same order),
    and the default learning rate is the model's."""
    B, S = 8, 4
    w, dw, X, T = _data(7, 12, [16, 8], 6, S * B, momentum)
    Xt, Tt = torch.tensor(X), torch.tensor(T)
    kw = dict(model=model, momentum=momentum)
    w1, dw1 = _torch(w, torch.float64), _torch(dw, torch.float64)
    ref = [batch_step.train_step_fused_batch_plain(
        w1, dw1, Xt[k * B:(k + 1) * B], Tt[k * B:(k + 1) * B], **kw)[2]
        for k in (3, 1, 0, 2)]
    w2, dw2 = _torch(w, torch.float64), _torch(dw, torch.float64)
    _, _, losses = batch_step.train_epoch_grid_banked_plain(
        w2, dw2, Xt, Tt, [3, 1, 0, 2], batch=B, **kw)
    assert torch.equal(losses, torch.stack(ref))
    for a, b in zip(w1 + dw1, w2 + dw2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model,momentum", MODES)
def test_train_step_math_matches_jax_f64(model, momentum):
    w, dw, X, T = _data(3, 12, [16, 8], 6, 10, momentum)
    kw = dict(model=model, momentum=momentum, lr=LR, alpha=0.2)
    rw, rdw, rloss = jdp.train_step_math(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, dw)),
        jnp.asarray(X), jnp.asarray(T), **kw)
    assert rloss.dtype == jnp.float64
    gw, gdw, gloss = dp.train_step_math(
        tuple(_torch(w, torch.float64)), tuple(_torch(dw, torch.float64)),
        torch.tensor(X), torch.tensor(T), **kw)
    _assert_state(gw, gdw, rw, rdw, 1e-12)
    assert abs(float(gloss) - float(rloss)) <= 1e-12


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_losses_and_lr_match_jax_f64(model):
    w, _, X, T = _data(11, 12, [16], 6, 10, False)
    jw = tuple(map(jnp.asarray, w))
    tw = tuple(_torch(w, torch.float64))
    got = float(dp.batch_loss(tw, torch.tensor(X), torch.tensor(T), model=model))
    ref = float(jdp.batch_loss(jw, jnp.asarray(X), jnp.asarray(T), model=model))
    assert abs(got - ref) <= 1e-12
    got = float(dp.sample_loss(tw, torch.tensor(X[0]), torch.tensor(T[0]), model=model))
    ref = float(jdp.sample_loss(jw, jnp.asarray(X[0]), jnp.asarray(T[0]), model=model))
    assert abs(got - ref) <= 1e-12
    for momentum in (False, True):
        assert dp.default_lr(model, momentum) == jdp.default_lr(model, momentum)


def test_wrappers_refuse_bad_inputs():
    w, _, X, T = _data(5, 12, [16], 6, 16, False)
    gw, Xt, Tt = _torch(w, torch.float64), torch.tensor(X), torch.tensor(T)
    with pytest.raises(ValueError, match="model"):
        batch_step.train_step_fused_batch(gw, [], Xt, Tt, model="lnn")
    with pytest.raises(ValueError, match="whole blocks"):
        batch_step.train_epoch_grid_banked(gw, [], Xt, Tt, [0], batch=5)
    with pytest.raises(ValueError, match="outside"):
        batch_step.train_epoch_grid_banked(gw, [], Xt, Tt, [0, 2], batch=8)
    with pytest.raises(ValueError, match="one block index"):
        batch_step.train_step_fused_banked(gw, [], Xt, Tt, [0, 1], batch=8)
    with pytest.raises(ValueError, match="momentum"):
        batch_step.train_step_fused_batch(gw, [], Xt, Tt, momentum=True)
    with pytest.raises(ValueError, match="dtype and device"):
        batch_step.train_step_fused_batch(gw, [], Xt.float(), Tt)
    with pytest.raises(ValueError, match="chain"):
        batch_step.train_step_fused_batch(
            [gw[0], torch.zeros(6, 15, dtype=torch.float64)], [], Xt, Tt)


# ------------------------------------------------- teams and their plan
MNIST = [(300, 784), (10, 300)]


# a card of 132 SMs that all take clusters of every size
PACKED = {C: 132 // C for C in batch_step.CLUSTER_SIZES}
# clusters of C CTAs of the fleet kernel an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters; chip_smoke.py phase 12 prints them): a
# cluster lives inside one GPC, so fewer than 132 / C fit
H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("members,shapes,batch,cap,want", [
    (8, MNIST, 256, PACKED, 16),             # 8 x 16 = 128 CTAs of 132, one wave
    (32, MNIST, 256, PACKED, 4),             # one wave of 4, or two of 8: the smaller
    (9, MNIST, 256, PACKED, 8),              # 9 x 16 = 144 > 132
    (200, MNIST, 256, PACKED, 1),            # more members than SMs: waves of one-CTA members
    (1, MNIST, 256, H100, 16),
    (7, MNIST, 256, H100, 16),               # the 7 clusters of 16 the card holds
    (8, MNIST, 256, H100, 8),                # 16 CTAs would run in 2 waves of 7
    (32, MNIST, 256, H100, 16),              # 5 waves of 7 x 16 beat 3 of 15 x 8
    (64, [(16, 32), (4, 16)], 1, H100, 1),   # the HPNN-sized fleet: one tile a product
    (2, [(16, 12), (6, 16)], 16, H100, 1),   # one tile a product, whatever N
    (2, [(70, 130), (10, 70)], 64, H100, 8),  # 3 x 5 tiles in the update
    (8, MNIST, 256, {1: 132, 2: 66, 4: 33, 8: 0, 16: 0}, 4),  # no 8- or 16-CTA cluster fits
])
def test_fleet_cluster_plan(members, shapes, batch, cap, want):
    assert batch_step.fleet_cluster(members, shapes, batch, cap) == want


def test_fleet_cluster_plan_refuses_a_card_that_holds_none():
    with pytest.raises(RuntimeError, match="holds no cluster"):
        batch_step.fleet_cluster(8, MNIST, 256, dict.fromkeys(batch_step.CLUSTER_SIZES, 0))


@pytest.mark.parametrize("forced", [1, 2, 4, 8, 16])
def test_fleet_cluster_forced(forced):
    """A forced size is taken as it is, even past the SM count: the
    kernel then runs the members in waves."""
    assert batch_step.fleet_cluster(200, MNIST, 256, PACKED, cluster=forced) == forced


@pytest.mark.parametrize("bad", [0, 3, 6, 32, -4, 2.5])
def test_fleet_cluster_refuses_other_sizes(bad):
    with pytest.raises(ValueError, match="cluster size"):
        batch_step.fleet_cluster(8, MNIST, 256, PACKED, cluster=bad)


def test_largest_gemm_tiles():
    assert batch_step.largest_gemm_tiles(MNIST, 256) == 250   # the update of W_0
    assert batch_step.largest_gemm_tiles(MNIST, 1024) == 320  # the forward of layer 0
    assert batch_step.largest_gemm_tiles([(230, 851), (230, 230)], 256) == 8 * 27


def test_shared_bytes_of_the_stages():
    """Two workers, each two stages of two 32 x (32 + 16 bytes) k-tiles
    and a 32 x 33 output tile: within one H100 block's shared memory."""
    f32 = 2 * (4 * 32 * 36 + 32 * 33) * 4
    f64 = 2 * (4 * 32 * 34 + 32 * 33) * 8
    assert batch_step.shared_bytes(torch.float32) == f32 == 45312
    assert batch_step.shared_bytes(torch.float64) == f64 == 86528
    assert f64 <= batch_step.MAX_SHARED_BYTES
    # each stage row and each worker's share keep 16-byte alignment
    assert (32 + 16 // 4) * 4 % 16 == 0 and (32 + 16 // 8) * 8 % 16 == 0
    assert f32 // 4 % 16 == 0 and f64 // 4 % 16 == 0


def test_entry_points_check_the_team_on_the_cpu():
    """The plain versions refuse a team the kernel would refuse and give
    the same result whatever team is named: #6's ``cluster=`` and #2-#5's
    private cluster team; #2-#5 take no ``cluster=``."""
    w, dw, X, T = _data(5, 12, [16], 6, 16, True)
    kw = dict(model="ann", momentum=True, batch=8)
    Xs, Ts = torch.tensor(X).reshape(2, 8, 12), torch.tensor(T).reshape(2, 8, 6)
    runs = []
    for cluster in (None, 1, 16):
        gw, gdw = _torch(w, torch.float64), _torch(dw, torch.float64)
        with (batch_step._cluster_team(cluster) if cluster else contextlib.nullcontext()):
            losses = batch_step.train_epoch_grid_banked(
                gw, gdw, torch.tensor(X), torch.tensor(T), [1, 0], **kw)[2]
        ws = [torch.stack([a, a]) for a in _torch(w, torch.float64)]
        dws = [torch.stack([a, a]) for a in _torch(dw, torch.float64)]
        fl = batch_step.train_fleet_epoch_dbuf_banked(ws, dws, Xs, Ts, [[0], [0]],
                                                      cluster=cluster, **kw)[2]
        runs.append([losses, fl] + gw + gdw + ws + dws)
    assert batch_step._team == 0
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster size"):
            with batch_step._cluster_team(bad):
                pass
    assert batch_step._team == 0
    with pytest.raises(TypeError, match="cluster"):
        batch_step.train_epoch_grid_banked(
            _torch(w, torch.float64), _torch(dw, torch.float64), torch.tensor(X),
            torch.tensor(T), [1, 0], cluster=16, **kw)
    ws = [torch.stack([a, a]) for a in _torch(w, torch.float64)]
    with pytest.raises(ValueError, match="cluster size"):
        batch_step.train_fleet_epoch_dbuf_banked(ws, [], Xs, Ts, [[0], [0]], batch=8,
                                                 cluster=12)
