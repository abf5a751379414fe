"""The frozen yardstick: work counts against hand counts, the frozen
draws against the program's, the plain reference against the port's
float64 CPU path."""

import numpy as np
import pytest
import torch

from benchmark.frozen import draws, work
from benchmark.reference import ann as ref


@pytest.mark.parametrize("sizes,momentum", [((784, 300, 10), False), ((851, 230, 230), True)])
def test_work_of_by_hand(sizes, momentum):
    shapes = [(o, i) for i, o in zip(sizes[:-1], sizes[1:])]
    n_w = sum(o * i for o, i in shapes)
    n_tail = sum(o * i for o, i in shapes[1:])
    S, iters = 1024, 700_000
    nbytes, flops = work.work_of(shapes, S, iters, momentum, 4)
    assert flops == 2 * n_w * S + iters * ((7 if momentum else 5) * n_w + 2 * n_tail)
    assert nbytes == (2 * n_w + S * (sizes[0] + 2 * sizes[-1] + 2)) * 4 + 12 * S
    # 784-300-10: 238,200 weights; BP 1.197 MFLOP an iteration
    if sizes == (784, 300, 10):
        assert n_w == 238_200 and 5 * n_w + 2 * n_tail == 1_197_000
    else:
        assert n_w == 248_630 and 7 * n_w + 2 * n_tail == 1_846_210


@pytest.mark.parametrize("sizes,momentum,S", [((784, 300, 10), False, 234),
                                              ((851, 230, 230), True, 14)])
def test_batch_work_by_hand(sizes, momentum, S):
    shapes = [(o, i) for i, o in zip(sizes[:-1], sizes[1:])]
    n_w = sum(o * i for o, i in shapes)
    n_tail = sum(o * i for o, i in shapes[1:])
    B = 256
    nbytes, flops = work.batch_work(shapes, S, momentum, 4, B)
    assert flops == S * (6 * B * n_w + 2 * B * n_tail + (4 if momentum else 2) * n_w)
    assert nbytes == (S * B * (sizes[0] + sizes[-1]) + 2 * n_w * (2 if momentum else 1)
                      + S) * 4 + 4 * S
    t, what = work.bound_s(nbytes, flops, "float32")
    assert what == "operations" and t == pytest.approx(flops / 67e12)


def test_work_matches_the_program_today():
    from hpnn_tpu_torch.obs import cost

    shapes = [(300, 784), (10, 300)]
    w = [torch.zeros(s) for s in shapes]
    assert work.work_of(shapes, 64, 5000, False, 4) == cost.work_of(w, 64, 5000, False, 4)
    assert work.batch_work(shapes, 14, True, 4, 256) == cost.batch_work(shapes, 14, True, 4, 256)
    assert work.PEAK_FLOPS == cost.PEAK_FLOPS and work.PEAK_BYTES == cost.PEAK_BYTES


@pytest.mark.parametrize("seed,n", [(10958, 1024), (1, 17), (2**31 + 77, 300)])
def test_shuffle_matches_the_program(seed, n):
    from hpnn_tpu_torch.utils.glibc_random import shuffled_order

    assert draws.shuffled_order(seed, n) == shuffled_order(seed, n)


def test_fleet_plan_matches_the_program():
    from hpnn_tpu_torch.train import fleet

    for epochs in (1, 16, 3):
        a = draws.fleet_plan([5, 2**31 + 9], n_rows=512, batch=64, epochs=epochs)
        b = fleet.fleet_plan([5, 2**31 + 9], n_rows=512, batch=64, epochs=epochs)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _net(rng, sizes):
    return [rng.uniform(-1, 1, (o, i)) / np.sqrt(i) for i, o in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("momentum", [False, True])
def test_sample_loop_against_the_port(momentum):
    """8-5-2 on six samples: the reference run for the port's plain
    float64 loop's iteration counts gives its tokens and weights, and
    judges each of its decisions right; a count is judged
    wrong where it reports half the iterations."""
    from benchmark.drivers.round import decision_gap
    from hpnn_tpu_torch.train import loop

    rng = np.random.default_rng(3)
    layers = _net(rng, (8, 5, 2))
    X = rng.uniform(0, 1, (6, 8))
    T = -np.ones((6, 2))
    T[np.arange(6), rng.integers(0, 2, 6)] = 1.0
    p = ref.BPM if momentum else ref.BP
    ws = [torch.tensor(w) for w in layers]
    ep0, n_iter, dep_p, first_ok, final_ok = (np.asarray(s) for s in loop.train_epoch(
        ws, torch.tensor(X), torch.tensor(T), 0.2, p["delta"], model="ann",
        momentum=momentum, min_iter=p["min_iter"], max_iter=p["max_iter"])[:5])
    sl = ref.SampleLoop(layers, momentum=momentum, device="cpu")
    dep = torch.empty(int(n_iter.sum()), dtype=torch.float64)
    margin = torch.empty_like(dep)
    off = 0
    for k in range(6):
        assert float(sl.start(X[k], T[k], ref.target_index(T[k]))) == pytest.approx(
            float(ep0[k]), rel=1e-12)
        sl.run(int(n_iter[k]), dep[off:], margin[off:])
        off += int(n_iter[k])
        assert float(dep[off - 1]) == pytest.approx(float(dep_p[k]), rel=1e-6, abs=1e-15)
    for a, b in zip(sl.W, ws):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    toks = [(f"s{k}", float(ep0[k]), bool(first_ok[k]), int(n_iter[k]), float(dep_p[k]),
             bool(final_ok[k])) for k in range(6)]
    assert decision_gap(toks, dep.numpy(), margin.numpy(), p) < 1e-6
    k, half = int(np.argmax(n_iter)), int(n_iter.max()) // 2
    short = toks[:k] + [toks[k][:3] + (half,) + toks[k][4:]] + toks[k + 1:]
    start = int(n_iter[:k].sum())
    cut = np.r_[0:start + half, start + int(n_iter[k]):dep.numel()]
    assert decision_gap(short, dep.numpy()[cut], margin.numpy()[cut], p) > 1.0


@pytest.mark.parametrize("momentum", [False, True])
def test_fleet_reference_against_the_port(momentum):
    """A two-member 8-5-2 fleet, 3 epochs of 4 blocks of 16 rows."""
    from hpnn_tpu_torch.models.kernel import Kernel
    from hpnn_tpu_torch.train import fleet

    rng = np.random.default_rng(4)
    members = [_net(rng, (8, 5, 2)) for _ in range(2)]
    X = rng.uniform(0, 1, (64, 8))
    T = -np.ones((64, 2))
    T[np.arange(64), rng.integers(0, 2, 64)] = 1.0
    seeds = [11, 2**31 + 3]
    out, losses, counts = fleet.train_fleet([Kernel(tuple(m)) for m in members], X, T,
                                            epochs=3, batch=16, seeds=seeds,
                                            momentum=momentum, lr=0.3, device="cpu")
    perms, orders = draws.fleet_plan(seeds, n_rows=64, batch=16, epochs=3)
    start = [np.stack([m[l] for m in members]) for l in range(2)]
    w, l, c = ref.fleet_reference(start, torch.tensor(X), torch.tensor(T), perms, orders,
                                  batch=16, momentum=momentum, lr=0.3)
    np.testing.assert_allclose(l, losses, rtol=1e-12)
    np.testing.assert_array_equal(c, counts)
    for i, k in enumerate(out):
        for a, b in zip(k.weights, w):
            np.testing.assert_allclose(a, b[i], rtol=0, atol=1e-12)


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 1.0 + 2**-12], dtype=torch.float32)
    assert ref.tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0]
