"""The batch-step kernels' plain versions and the step math, held
against the JAX package on the CPU.

* Each ``*_plain`` entry point of ``hpnn_tpu_torch.ops.batch_step``
  against the Pallas kernel it replaces (``hpnn_tpu.ops.pallas_train``)
  run in interpret mode, in float32, as ``tests/test_pallas.py`` runs
  them: a step to 1e-6 on weights and dw and 1e-5 relative on the loss;
  an epoch (S = 4 steps) to 1e-5 and 1e-5.
* ``parallel.dp.train_step_math`` against the JAX package's, in
  float64, within 1e-12.
* A lane-by-lane model of the bf16 tile's maps (stage loads, ldmatrix,
  mma fragments) against ``A @ B``, within 1e-12 in float64.

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
# and the blocks of its cooperative grid, one an SM
GRID = batch_step.GRID
H100_GRID = {GRID: 132, **H100}
RRUFF = [(230, 851), (230, 230)]


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
    # with the cooperative grid (bf16 #6 plans alike: the plan reads no
    # dtype): the two benchmark fleets, where 8 clusters of 8 leave 68 SMs
    # idle, and 32 members, where 16-CTA clusters take 5 waves
    (8, MNIST, 256, H100_GRID, GRID),
    (8, RRUFF, 256, H100_GRID, GRID),
    (32, MNIST, 256, H100_GRID, GRID),
    (4, MNIST, 256, H100_GRID, GRID),        # train_fleet_multi, quant_probe_fleet (chip_smoke)
    # the HPNN-sized tick: one tile a member a phase, so the grid's syncs
    # cost more than the rounds it saves
    (64, [(16, 32), (4, 16)], 1, H100_GRID, 1),
    (2, [(16, 12), (6, 16)], 16, H100_GRID, 1),
    # the online trainer's two members of 784-300-10 (chip_smoke.py phase
    # 17: rows 256, batch 32; the trainer's default batch 8): the grid's
    # 73 k-tile rounds a step against 80 on 16-CTA clusters (PERF.md, PR
    # 23: 0.780 against 0.966 ms an 8-step epoch on the card)
    (2, MNIST, 32, H100_GRID, GRID),
    (2, MNIST, 8, H100_GRID, GRID),
    (8, MNIST, 256, {GRID: 0, **H100}, 8),    # no cooperative launch: the cluster plan
    (8, MNIST, 256, {GRID: 132, **dict.fromkeys(batch_step.CLUSTER_SIZES, 0)}, GRID),
])
def test_fleet_cluster_plan(members, shapes, batch, cap, want):
    assert batch_step.fleet_cluster(members, shapes, batch, cap) == want


def test_fleet_cluster_plan_refuses_a_card_that_holds_none():
    with pytest.raises(RuntimeError, match="holds no cluster"):
        batch_step.fleet_cluster(8, MNIST, 256, dict.fromkeys(batch_step.CLUSTER_SIZES, 0))


@pytest.mark.parametrize("forced", [1, 2, 4, 8, 16, GRID])
def test_fleet_cluster_forced(forced):
    """A forced size is taken as it is, even past the SM count: the
    kernel then runs the members in waves; GRID (0) forces the grid, even
    where the plan takes a cluster."""
    cap = {GRID: 132, **PACKED}
    assert batch_step.fleet_cluster(200, MNIST, 256, cap, cluster=forced) == forced
    assert batch_step.fleet_cluster(64, [(16, 32), (4, 16)], 1, cap, cluster=forced) == forced


@pytest.mark.parametrize("cap", [H100, {GRID: 0, **H100}])
def test_fleet_cluster_forced_grid_needs_a_cooperative_card(cap):
    """A card without cooperative launches falls to the cluster plan,
    and refuses the grid forced."""
    assert batch_step.fleet_cluster(8, MNIST, 256, cap) == 8
    with pytest.raises(RuntimeError, match="no cooperative launch"):
        batch_step.fleet_cluster(8, MNIST, 256, cap, cluster=GRID)


def test_step_estimate_counts_the_tile_rounds():
    """The plan's step: MNIST 784-300-10 at B = 256 is 411 k-tile rounds
    on one 8-CTA cluster a member and 237 on a grid of 132 blocks for 8
    members; RRUFF 851-230-230 456 and 228 (its output rows take 2 more
    syncs); the HPNN-sized fleet one round a phase on either team."""
    phases, syncs = batch_step.step_phases(MNIST, 256)
    assert phases == [(80, 25), (8, 10), (80, 1), (260, 8), (80, 25), (8, 10)] and syncs == 6
    assert batch_step.step_phases(RRUFF, 256)[1] == 8

    K, S = batch_step.KTILE_NS, batch_step.SYNC_NS

    def step(team, members, shapes, batch):
        return batch_step.step_ns(team, members, shapes, batch, H100_GRID)

    assert step(8, 8, MNIST, 256) == 411 * K + 6 * S[8]
    assert step(GRID, 8, MNIST, 256) == 237 * K + 6 * S[GRID]
    assert step(8, 8, RRUFF, 256) == 456 * K + 8 * S[8]
    assert step(GRID, 8, RRUFF, 256) == 228 * K + 8 * S[GRID]
    assert step(1, 64, [(16, 32), (4, 16)], 1) == 6 * K + 6 * S[1]
    assert step(GRID, 64, [(16, 32), (4, 16)], 1) == 6 * K + 6 * S[GRID]
    assert step(16, 8, MNIST, 256) == 2 * (245 * K + 6 * S[16])   # 7 at once: 2 waves


@pytest.mark.parametrize("bad", [12, 3, 6, 32, -4, 2.5])
def test_fleet_cluster_refuses_other_sizes(bad):
    with pytest.raises(ValueError, match="cluster size"):
        batch_step.fleet_cluster(8, MNIST, 256, PACKED, cluster=bad)


def test_largest_gemm_tiles():
    assert batch_step.largest_gemm_tiles(MNIST, 256) == 250   # the update of W_0
    assert batch_step.largest_gemm_tiles(MNIST, 1024) == 320  # the forward of layer 0
    assert batch_step.largest_gemm_tiles([(230, 851), (230, 230)], 256) == 8 * 27


def test_shared_bytes_of_the_stages():
    """Two workers, each two stages of two 32 x (32 + 16 bytes) k-tiles
    and a 32 x 33 output tile: within one H100 block's shared memory.
    bf16 stages its k-tiles raw (rows of 40 bf16) and its output tile
    in float."""
    f32 = 2 * (4 * 32 * 36 + 32 * 33) * 4
    f64 = 2 * (4 * 32 * 34 + 32 * 33) * 8
    bf16 = 2 * (4 * 32 * 40 * 2 + 32 * 33 * 4)
    assert batch_step.shared_bytes(torch.float32) == f32 == 45312
    assert batch_step.shared_bytes(torch.float64) == f64 == 86528
    assert batch_step.shared_bytes(torch.bfloat16) == bf16 == 28928
    assert f64 <= batch_step.MAX_SHARED_BYTES
    # each stage row and each worker's share keep 16-byte alignment
    assert (32 + 16 // 4) * 4 % 16 == 0 and (32 + 16 // 8) * 8 % 16 == 0
    assert (32 + 16 // 2) * 2 % 16 == 0 and (4 * 32 * 40 * 2) % 16 == 0
    assert f32 // 4 % 16 == 0 and f64 // 4 % 16 == 0 and bf16 // 2 % 16 == 0


def test_entry_points_check_the_team_on_the_cpu():
    """The plain versions refuse a team the kernel would refuse and give
    the same result whatever team is named: #6's ``cluster=`` and #2-#5's
    private cluster team; #2-#5 take no ``cluster=``."""
    w, dw, X, T = _data(5, 12, [16], 6, 16, True)
    kw = dict(model="ann", momentum=True, batch=8)
    Xs, Ts = torch.tensor(X).reshape(2, 8, 12), torch.tensor(T).reshape(2, 8, 6)
    runs = []
    for cluster in (None, 1, 16, GRID):
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


# ---- a model of the bf16 tile's maps (csrc/batch_step.cu, gemm_tile_mma)
#
# tile16/load16/store16, frag_off and the PTX fragment layouts of
# ldmatrix.x4[.trans] and mma.m16n8k16.row.col, lane by lane in numpy,
# walking every tile and k-tile of C = A . Bm as the 128-thread worker
# does.  A change to those maps in the kernel is made here too; the card
# tests hold the kernel itself.

_TILE, _LD, _WORKER = 32, 40, 128  # HPNN_TILE, stage_ld<bf16>(), HPNN_WORKER


def _tile16(P0, sx, sk, x0, xlim, K, w):
    """tile16: the thread w's share of an operand's k-tiles, P(x, k) =
    P[P0 + x*sx + k*sk] (P0: the pointer's offset in values)."""
    kfast = sk == 1
    rs = sx if kfast else sk
    vec = rs % 8 == 0 and (K if kfast else xlim) % 8 == 0 and P0 % 8 == 0
    row, col = (w >> 2, 8 * (w & 3)) if vec else (w >> 5, w & 31)
    base = P0 + ((x0 + row) * sx + col if kfast else x0 + col + row * sk)
    return dict(base=base, rstep=4 * rs, kstep=_TILE if kfast else _TILE * sk, row=row,
                col=col, xleft=xlim - x0, kfast=kfast, vec=vec)


def _load_store16(S, P, o, kt, K):
    """load16 of k-tile kt, then store16 into the stage S (32 x 40)."""
    kleft = K - kt * _TILE
    rows, cols = (o["xleft"], kleft) if o["kfast"] else (kleft, o["xleft"])
    p = o["base"] + kt * o["kstep"]
    r, c = o["row"], o["col"]
    if o["vec"]:
        S[r, c:c + 8] = P[p:p + 8] if r < rows and c < cols else 0.0
    else:
        for j in range(8):
            S[r + 4 * j, c] = P[p + j * o["rstep"]] if r + 4 * j < rows and c < cols else 0.0


def _frag_off(kfast, a_order, xw, lane):
    m = lane >> 3
    xo = 8 * ((m & 1) if a_order else (m >> 1))
    ko = 8 * ((m >> 1) if a_order else (m & 1))
    return (xw + xo + (lane & 7)) * _LD + ko if kfast else (ko + (lane & 7)) * _LD + xw + xo


def _ldsm4(S, offs, trans):
    """ldmatrix.x4[.trans]: lanes 8m..8m+7 name the rows of matrix m;
    lane t gets row t/4, columns 2(t%4), +1 (transposed: column t/4,
    rows 2(t%4), +1) of each.  Registers [lane, m, half]."""
    flat = S.reshape(-1)
    regs = np.empty((32, 4, 2))
    for m in range(4):
        mat = np.stack([flat[offs[8 * m + i]:offs[8 * m + i] + 8] for i in range(8)])
        for t in range(32):
            g, q = t >> 2, t & 3
            regs[t, m] = mat[2 * q:2 * q + 2, g] if trans else mat[g, 2 * q:2 * q + 2]
    return regs


def _mma16816(d, a, b0, b1):
    """mma.m16n8k16.row.col: the 16 x 16 A, 16 x 8 B and 16 x 8 D
    fragments of PTX's layout, lane by lane."""
    A, B = np.empty((16, 16)), np.empty((16, 8))
    for t in range(32):
        g, q = t >> 2, t & 3
        for h in range(2):
            A[g, 2 * q + h], A[g + 8, 2 * q + h] = a[t, 0, h], a[t, 1, h]
            A[g, 2 * q + 8 + h], A[g + 8, 2 * q + 8 + h] = a[t, 2, h], a[t, 3, h]
            B[2 * q + h, g], B[2 * q + 8 + h, g] = b0[t, h], b1[t, h]
    D = A @ B
    for t in range(32):
        g, q = t >> 2, t & 3
        d[t] += [D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q], D[g + 8, 2 * q + 1]]


def _gemm_mma_model(M, N, K, A, A0, sar, sak, Bm, B0, sbk, sbc):
    """C = A . Bm through the model of gemm_tile_mma, every tile; stage
    values that no store16 wrote are NaN, so a fragment that reads one
    shows.  Returns C and the load widths taken (vec for A, for Bm)."""
    C = np.full((M, N), np.nan)
    widths = set()
    for tm in range(-(-M // _TILE)):
        for tn in range(-(-N // _TILE)):
            r0, c0 = tm * _TILE, tn * _TILE
            oa = [_tile16(A0, sar, sak, r0, M, K, w) for w in range(_WORKER)]
            ob = [_tile16(B0, sbc, sbk, c0, N, K, w) for w in range(_WORKER)]
            widths.add((oa[0]["vec"], ob[0]["vec"]))
            acc = np.zeros((4, 2, 32, 4))
            for kt in range(-(-K // _TILE)):
                Sa, Sb = np.full((_TILE, _LD), np.nan), np.full((_TILE, _LD), np.nan)
                for w in range(_WORKER):
                    _load_store16(Sa, A, oa[w], kt, K)
                    _load_store16(Sb, Bm, ob[w], kt, K)
                ka, kb = oa[0]["kfast"], ob[0]["kfast"]
                for warp in range(4):
                    wr, wc = 16 * (warp >> 1), 16 * (warp & 1)
                    if not (r0 + wr < M and c0 + wc < N):
                        continue
                    ia, ib = (16 if ka else 16 * _LD), (16 if kb else 16 * _LD)
                    for h in range(2 if K - kt * _TILE > 16 else 1):
                        a = _ldsm4(Sa, [_frag_off(ka, True, wr, ln) + h * ia
                                        for ln in range(32)], not ka)
                        b = _ldsm4(Sb, [_frag_off(kb, False, wc, ln) + h * ib
                                        for ln in range(32)], not kb)
                        _mma16816(acc[warp, 0], a, b[:, 0], b[:, 1])
                        _mma16816(acc[warp, 1], a, b[:, 2], b[:, 3])
            for warp in range(4):
                wr, wc = 16 * (warp >> 1), 16 * (warp & 1)
                for ln in range(32):
                    g, q = ln >> 2, ln & 3
                    for f in range(2):
                        for e in range(4):
                            r, c = r0 + wr + g + 8 * (e >> 1), c0 + wc + 8 * f + 2 * q + (e & 1)
                            if r < M and c < N:
                                C[r, c] = acc[warp, f, ln, e]
    return C, widths


@pytest.mark.parametrize("product,rows,n_out,n_in,vec", [
    # the forward, NT: acts (B, n) = vin (B, m) . W (n, m)^T
    ("forward", 40, 24, 72, True),
    ("forward", 40, 10, 30, False),
    # the hidden deltas, NN: d (B, k) = dn (B, n) . W (n, k)
    ("deltas", 48, 40, 72, True),
    ("deltas", 36, 10, 30, False),
    # the update, TN: dW (M, N) = d (B, M)^T . v (B, N)
    ("update", 56, 24, 72, True),
    ("update", 37, 10, 30, False),
])
def test_bf16_tile_maps_model_is_the_product(product, rows, n_out, n_in, vec):
    """The maps of the bf16 tile, modelled lane by lane, give A . Bm for
    each of the step's three products with the strides the kernel passes
    (batch_step.cu's gemm_tile calls), on ragged edges, with 16-byte loads
    (rows and edge on 8 values) and with 2-byte loads."""
    rng = np.random.default_rng(rows + n_out + n_in)
    off = 8 if vec else 3  # each operand at an offset into its buffer
    if product == "forward":
        X, W = rng.standard_normal((rows, n_in)), rng.standard_normal((n_out, n_in))
        want = X @ W.T
        args = (rows, n_out, n_in, np.r_[np.zeros(off), X.ravel()], off, n_in, 1,
                np.r_[np.zeros(off), W.ravel()], off, 1, n_in)
    elif product == "deltas":
        D, W = rng.standard_normal((rows, n_in)), rng.standard_normal((n_in, n_out))
        want = D @ W
        args = (rows, n_out, n_in, np.r_[np.zeros(off), D.ravel()], off, n_in, 1,
                np.r_[np.zeros(off), W.ravel()], off, n_out, 1)
    else:
        M, N = n_out, n_in
        D, V = rng.standard_normal((rows, M)), rng.standard_normal((rows, N))
        want = D.T @ V
        args = (M, N, rows, np.r_[np.zeros(off), D.ravel()], off, 1, M,
                np.r_[np.zeros(off), V.ravel()], off, N, 1)
    C, widths = _gemm_mma_model(*args)
    assert widths == {(vec, vec)}
    np.testing.assert_allclose(C, want, rtol=1e-12, atol=1e-12)
