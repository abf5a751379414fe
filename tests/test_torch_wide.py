"""Per-sample nets wider than one CTA's shared memory.

The convergence kernel (#1, ``csrc/convergence.cu``) keeps one copy of
the input, the target, the activations and the deltas in each CTA's
shared memory where it fits (232448 bytes), and in a device-memory
scratch of C copies where it does not (``convergence.plan``'s
``vectors_resident``).  The JAX package has no such limit (past its
VMEM gate it runs the lax body), so neither may the port:

* on the CPU, ``plan`` picks the device build for a net over the limit,
  refuses to force it into shared memory (saying the bytes), and lays
  the scratch out as the kernel reads it; ``train_nn --device cpu`` at
  8-[30000]-2 (60,014 values: ~240 KB in float32, ~480 KB in float64)
  matches the JAX package in float64, ANN/SNN x BP/BPM: stdout and
  ``kernel.tmp`` byte for byte, ``kernel.opt`` within 1e-12;
* on the card (``cuda``-marked), the device build against its plain
  version at 8-[30000]-2 and 784-[30000]-10 (float32 within 1e-4,
  float64 within 1e-10), and forced on 784-300-10 bitwise equal to the
  shared build, ANN/SNN x BP/BPM x float32/float64.
"""

import os

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.cli import train_nn
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.ops import convergence
from hpnn_tpu_torch.train import loop

WIDE = 30000          # hidden units: past one CTA in either type
MAX_ITER = 12         # per-sample cap of both packages' loops in the parity test
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
CONF = ("[name] W\n[type] {kind}\n[init] generate\n[seed] 1234\n[input] 8\n"
        f"[hidden] {WIDE}\n[output] 2\n[train] {{train}}\n"
        "[sample_dir] ./samples\n[test_dir] ./samples\n")


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The environment restored whole, the port's obs memos and
    verbosity reset, around each test."""
    from hpnn_tpu_torch import obs as port_obs
    from hpnn_tpu_torch.utils import logging as port_log

    saved = dict(os.environ)
    for knob in (*port_obs.ENV_KNOBS, "HPNN_FUSE_STATE", "HPNN_FUSE_EPOCH",
                 "HPNN_PALLAS", "HPNN_DTYPE"):
        os.environ.pop(knob, None)
    port_obs._reset_for_tests()
    port_log.set_verbose(0)
    yield
    os.environ.clear()
    os.environ.update(saved)
    port_obs._reset_for_tests()
    port_log.set_verbose(0)


def _net(dims, dtype=torch.float32, device="cpu"):
    return [torch.zeros(n, m, dtype=dtype, device=device)
            for m, n in zip(dims[:-1], dims[1:])]


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("dims", [(8, WIDE, 2), (784, WIDE, 10), (784, 1500, 1500, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_puts_the_vectors_of_a_wide_net_in_device_memory(dims, dtype):
    """Past one CTA the one-cluster plan keeps C copies of the vectors in
    device memory: the scalars and the staging tile in shared memory,
    both activation buffers in the scratch, W streamed where it does not
    fit (where the plan takes the grid build instead once W passes the
    crossover); forcing the vectors into shared memory says the bytes."""
    weights = _net(dims, dtype)
    need = convergence.shared_bytes(weights, dtype)
    if need <= convergence.MAX_SHARED_BYTES:   # 784-1500-1500-10 in float32 fits
        assert convergence.plan(weights, dtype, True, grid=False).vectors_resident
        return
    b = torch.empty((), dtype=dtype).element_size()
    for momentum in (False, True):
        p = convergence.plan(weights, dtype, momentum, grid=False)
        wbytes = b * sum(w.numel() for w in weights)
        assert convergence.plan(weights, dtype, momentum).grid == (
            not p.weights_resident and wbytes >= convergence.GRID_MIN_BYTES)
        assert not p.vectors_resident and p.dbuf and p.stage == convergence.STAGE
        assert p.cluster == convergence.CLUSTER
        wtot = sum(-(-n // p.cluster) * m for m, n in zip(dims[:-1], dims[1:]))
        used = 2 * b + 8 + b * p.stage
        assert p.weights_resident == (used + b * wtot <= convergence.MAX_SHARED_BYTES)
        assert p.smem_bytes == used + b * wtot * (p.weights_resident + p.dw_resident)
        # one copy a CTA, by rank: the input, the target, both activation
        # buffers and the deltas (csrc/convergence.cu's Net::vcopy)
        copy = dims[0] + dims[-1] + 3 * sum(dims[1:])
        assert convergence.vector_values(weights) == copy
        assert p.scratch_bytes == p.cluster * b * copy
        for C in (1, 8):
            q = convergence.plan(weights, dtype, momentum, cluster=C, grid=False)
            assert q.scratch_bytes == C * b * copy and not q.vectors_resident
    with pytest.raises(ValueError, match=f"need {need} bytes of shared memory"):
        convergence.plan(weights, dtype, False, vectors_resident=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_forces_the_device_build_on_a_net_that_fits(dtype):
    """784-300-10 fits a CTA; ``vectors_resident=False`` moves only the
    vectors: W's rows stay resident, and the shared memory the vectors
    held is free."""
    weights = _net((784, 300, 10), dtype)
    b = torch.empty((), dtype=dtype).element_size()
    for momentum in (False, True):
        s = convergence.plan(weights, dtype, momentum)
        d = convergence.plan(weights, dtype, momentum, vectors_resident=False)
        assert s.vectors_resident and s.scratch_bytes == 0
        assert not d.vectors_resident and d.weights_resident and d.dbuf
        assert d.scratch_bytes == 16 * b * (784 + 10 + 3 * 310)
        assert d.dw_resident == s.dw_resident
        assert d.smem_bytes == s.smem_bytes - b * (784 + 10 + 3 * 310)
        assert convergence.plan(weights, dtype, momentum, vectors_resident=True) == s


def test_plan_refuses_layers_past_the_row_arithmetic():
    """``owner()`` divides by multiplying by ceil(2^40 / n): exact up to
    2^18 rows a layer, so the plan refuses a wider layer by name."""
    ok = [torch.empty(convergence.MAX_ROWS, 1), torch.empty(2, convergence.MAX_ROWS)]
    assert not convergence.plan(ok, torch.float32, False).vectors_resident
    n = convergence.MAX_ROWS + 1
    with pytest.raises(ValueError, match=f"a layer of {n} rows"):
        convergence.plan([torch.empty(n, 1), torch.empty(2, n)], torch.float32, False)
    # the kernel's integer division: exact for every row of the widest layer
    for n in (convergence.MAX_ROWS, 30000, 300, 10, 2):
        inv = convergence._inv40(n)
        i = np.arange(n, dtype=np.int64)
        for C in (1, 7, 16):
            x = (i + 1) * C - 1
            assert np.array_equal((x * inv) >> 40, x // n)


def test_scratch_is_kept_by_key():
    """``ops/_table.py``'s scratch: one buffer a key, allocated once."""
    from hpnn_tpu_torch.ops import _table

    sc = _table.Scratch()
    a = sc.get(("s", 1), 64, "cpu")
    assert sc.get(("s", 1), 64, "cpu") is a and sc.allocs == 1
    assert a.numel() == 64 and a.dtype == torch.uint8
    sc.get(("s", 2), 32, "cpu")
    assert sc.allocs == 2 and len(sc) == 2


def test_wide_epoch_on_cpu_is_the_plain_version():
    """CPU tensors of a net past one CTA take the plain version, with no
    plan in front of it."""
    rng = np.random.default_rng(3)
    w0 = [rng.uniform(-0.1, 0.1, (WIDE, 8)), rng.uniform(-0.01, 0.01, (2, WIDE))]
    X = torch.tensor(rng.uniform(-1, 1, (2, 8)))
    T = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=torch.float64)
    kw = dict(model="ann", momentum=True, min_iter=2, max_iter=4)
    a, b = (tuple(torch.tensor(w) for w in w0) for _ in range(2))
    launches = convergence.launches
    sa = convergence.train_epoch(a, X, T, 0.2, -1e30, **kw)
    sb = convergence.train_epoch_plain(b, X, T, 0.2, -1e30, **kw)
    assert convergence.launches == launches
    assert sa.n_iter.tolist() == sb.n_iter.tolist() == [5, 5]
    assert all(x.equal(y) for x, y in zip(a, b))


# ------------------------------------------------- CPU parity with JAX
def _write_samples(d, n, seed=42):
    rng = np.random.default_rng(seed)
    centers = np.array([[1.0] * 4 + [-1.0] * 4, [-1.0] * 4 + [1.0] * 4])
    os.makedirs(d)
    for i in range(n):
        c = i % 2
        x = centers[c] + 0.3 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(os.path.join(d, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n" + " ".join("%7.5f" % v for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join("%.1f" % v for v in t) + "\n")


def _train(main, argv, capsys):
    """One ``train_nn`` round: (stdout, kernel.tmp, kernel.opt weights)."""
    capsys.readouterr()
    assert main(argv + ["-v", "-v", "-v", "nn.conf"]) == 0
    out = capsys.readouterr().out
    with open("kernel.tmp") as fp:
        tmp = fp.read()
    weights = kernel_format.load_kernel("kernel.opt")[1]
    os.remove("kernel.tmp")
    os.remove("kernel.opt")
    return out, tmp, weights


@pytest.mark.parametrize("kind,train", [("ANN", "BP"), ("ANN", "BPM"),
                                        ("SNN", "BP"), ("SNN", "BPM")])
def test_per_sample_round_8_30000_2_matches_jax(tmp_path, monkeypatch, capsys, kind, train):
    """8-[30000]-2, past one CTA in float32 and in float64: the port's
    ``train_nn --device cpu`` against the JAX package's float64 run."""
    from hpnn_tpu.cli import train_nn as jtrain_nn
    from hpnn_tpu.train import loop as jloop

    for mod in (jloop, loop):
        monkeypatch.setattr(mod, "MAX_BP_ITER", MAX_ITER)
        monkeypatch.setattr(mod, "MAX_BPM_ITER", MAX_ITER)
    monkeypatch.chdir(tmp_path)
    _write_samples("samples", 3)
    (tmp_path / "nn.conf").write_text(CONF.format(kind=kind, train=train))
    net = _net((8, WIDE, 2))
    for dtype in (torch.float32, torch.float64):
        assert convergence.shared_bytes(net, dtype) > convergence.MAX_SHARED_BYTES
    ref = _train(jtrain_nn.main, [], capsys)
    launches = convergence.launches
    got = _train(train_nn.main, ["--device", "cpu"], capsys)
    assert convergence.launches == launches  # CPU tensors: the plain version
    assert got[0].count("TRAINING FILE") == 3
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert [w.shape for w in got[2]] == [w.shape for w in ref[2]] == [(WIDE, 8), (2, WIDE)]
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, dtype, n_in, hid, n_out, S, seed=17):
    rng = np.random.default_rng(seed)
    w = [rng.uniform(-1, 1, (hid, n_in)) / n_in ** 0.5,
         rng.uniform(-1, 1, (n_out, hid)) / hid ** 0.5]
    X = rng.uniform(0, 1, (S, n_in))
    T = -np.ones((S, n_out))
    T[np.arange(S), rng.integers(0, n_out, S)] = 1.0
    return ([torch.tensor(a, dtype=dtype, device=dev) for a in w],
            torch.tensor(X, dtype=dtype, device=dev), torch.tensor(T, dtype=dtype, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True), ("snn", False)])
@pytest.mark.parametrize("shape", [(8, WIDE, 2), (784, WIDE, 10)])
def test_device_build_matches_plain(cuda, shape, model, momentum, dtype):
    w0, X, T = _inputs(cuda, dtype, *shape, S=2)
    if model == "snn":
        T = (T > 0).to(dtype)
    p = convergence.plan(w0, dtype, momentum)
    assert not p.vectors_resident
    kw = dict(model=model, momentum=momentum, min_iter=2, max_iter=8)
    wk, wp = [t.clone() for t in w0], [t.clone() for t in w0]
    launches = convergence.launches
    sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
    torch.cuda.synchronize()
    assert convergence.launches == launches + 1
    sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
    assert sk.n_iter.tolist() == sp.n_iter.tolist() == [9, 9]
    assert sk.first_ok.tolist() == sp.first_ok.tolist()
    err = max(float((a - b).abs().max()) for a, b in zip(wk + [sk.out], wp + [sp.out]))
    assert err <= TOL[dtype]
    assert any(not torch.equal(a, b) for a, b in zip(wk, w0))
    # the scratch is kept: a second launch allocates nothing
    allocs = convergence.scratch.allocs
    convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
    assert convergence.scratch.allocs == allocs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,momentum", [("ann", False), ("ann", True),
                                            ("snn", False), ("snn", True)])
def test_forced_device_build_is_the_shared_build_bitwise(cuda, model, momentum, dtype):
    """784-300-10 fits a CTA: the device build gives the shared build's
    bits, at 16 and 8 CTAs."""
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
    for plan in ({}, dict(vectors_resident=False), dict(vectors_resident=False, cluster=8)):
        w = [t.clone() for t in w0]
        runs.append((plan, w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)))
    torch.cuda.synchronize()
    _, w_ref, st_ref = runs[0]
    assert st_ref.n_iter.tolist() == [21] * 4
    for plan, w, st in runs[1:]:
        for a, b in zip(list(w) + list(st), list(w_ref) + list(st_ref)):
            assert torch.equal(a, b), plan
