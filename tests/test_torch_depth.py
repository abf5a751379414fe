"""Nets deeper than 16 layers on every training path of the port, held
against the JAX package on the CPU in float64.

One topology, 8-(6x16)-2 (17 layers), whose depth the JAX package takes
as it takes any (its kernels loop over the layers, its conf parser has
no cap):

* per-sample ``train_nn`` rounds, ANN/SNN x BP/BPM: stdout and
  ``kernel.tmp`` byte-identical, ``kernel.opt`` within 1e-12;
* ``train_nn --batch`` for two epochs: the ``BATCH EPOCH`` count exact,
  its loss within 1e-12, ``kernel.tmp`` byte-identical, ``kernel.opt``
  within 1e-12;
* a two-member fleet (``train/fleet.py``) against the JAX fleet:
  weights within 1e-12, losses within 1e-12 relative, counts equal.

A net this deep from the reference's generator (weights within
1/sqrt(m)) is dead: each tanh-sigmoid layer shrinks the signal, its
outputs sit at 0 (ANN) or 0.5 (SNN) and its dEp at the rounding level,
where the two packages' float64 ``exp``, which part in the last bit,
decide the sign the token prints.  So the per-sample rounds start from
a kernel file of numpy-seeded weights whose gain carries the signal
through every layer (``[init] deep.opt``), and the batch and fleet runs
from the generator (``kernel.tmp`` of ``--batch`` holds its output).
Both packages' per-sample loops are capped at ``MAX_ITER`` iterations
a sample: the point is the path, not convergence.

Beside them, the layer tables the CUDA kernels read (one record a
layer, packed by the wrappers) hold every layer's widths and offsets at
this depth, and #1's plan refuses only what shared memory cannot hold,
saying the bytes.
"""

import os
import re

import numpy as np
import pytest
import torch

from hpnn_tpu.cli import train_nn as jtrain_nn
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.train import fleet as jfleet
from hpnn_tpu.train import loop as jloop
from hpnn_tpu_torch.cli import train_nn
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.ops import batch_step, convergence
from hpnn_tpu_torch.train import fleet
from hpnn_tpu_torch.train import loop

HIDDEN = [6] * 16   # 17 layers
MAX_ITER = 40       # per-sample cap of both packages' loops here
CONF = ("[name] D\n[type] {kind}\n[init] {init}\n[seed] 1234\n[input] 8\n"
        "[hidden] " + " ".join(map(str, HIDDEN)) + "\n[output] 2\n[train] {train}\n"
        "[sample_dir] ./samples\n[test_dir] ./samples\n")
EPOCH = re.compile(r"BATCH EPOCH +(\d+) loss= (\S+) acc= +(\S+)% \((\d+)/(\d+)\)")


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


@pytest.fixture
def capped(monkeypatch):
    for mod in (jloop, loop):
        monkeypatch.setattr(mod, "MAX_BP_ITER", MAX_ITER)
        monkeypatch.setattr(mod, "MAX_BPM_ITER", MAX_ITER)


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


def _write_kernel(path, seed=11):
    """An 8-(6x16)-2 kernel file of uniform(-1.5, 1.5) weights: a gain
    that keeps each layer's activations away from 0."""
    rng = np.random.default_rng(seed)
    dims = [8] + HIDDEN + [2]
    weights = [rng.uniform(-1.5, 1.5, (n, m)) for m, n in zip(dims[:-1], dims[1:])]
    with open(path, "w") as fp:
        kernel_format.dump_kernel("D", weights, fp)


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


def _assert_weights(got, ref):
    assert [w.shape for w in got] == [w.shape for w in ref]
    assert len(got) == len(HIDDEN) + 1
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,train", [("ANN", "BP"), ("ANN", "BPM"),
                                        ("SNN", "BP"), ("SNN", "BPM")])
def test_per_sample_round_17_layers_matches_jax(tmp_path, monkeypatch, capsys, capped,
                                                kind, train):
    monkeypatch.chdir(tmp_path)
    _write_samples("samples", 4)
    _write_kernel("deep.opt")
    (tmp_path / "nn.conf").write_text(CONF.format(kind=kind, train=train, init="deep.opt"))
    ref = _train(jtrain_nn.main, [], capsys)
    launches = convergence.launches
    got = _train(train_nn.main, ["--device", "cpu"], capsys)
    assert convergence.launches == launches  # CPU tensors: the plain version
    assert got[0].count("TRAINING FILE") == 4
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    _assert_weights(got[2], ref[2])


def test_batch_17_layers_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write_samples("samples", 8)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP", init="generate"))
    args = ["--batch", "4", "--epochs", "2", "--lr", "0.5"]
    ref = _train(jtrain_nn.main, ["--mesh", "1x1"] + args, capsys)
    before = dict(batch_step.launches)
    got = _train(train_nn.main, ["--device", "cpu"] + args, capsys)
    assert batch_step.launches == before
    ref_ep, got_ep = EPOCH.findall(ref[0]), EPOCH.findall(got[0])
    assert len(ref_ep) == 2 and len(got_ep) == len(ref_ep)
    for r, g in zip(ref_ep, got_ep):
        assert g[0] == r[0] and g[2:] == r[2:]  # epoch, acc, (ok/n)
        assert abs(float(g[1]) - float(r[1])) <= 1e-12
    assert got[1] == ref[1]
    _assert_weights(got[2], ref[2])


def test_fleet_17_layers_matches_jax():
    ks = [jkm.generate(7 + i, 8, HIDDEN, 2)[0] for i in range(2)]
    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, (8, 8))
    T = np.full((8, 2), -1.0)
    T[np.arange(8), rng.randint(0, 2, 8)] = 1.0
    kw = dict(epochs=2, batch=2, seeds=[3, 1], lr=0.3)
    before = dict(batch_step.launches)
    kg, lg, cg = fleet.train_fleet(ks, X, T, device="cpu", **kw)
    assert batch_step.launches == before
    kr, lr, cr = jfleet.train_fleet(ks, X, T, **kw)
    for k0, a, b in zip(ks, kg, kr):
        _assert_weights(a.weights, b.weights)
        assert any(not np.array_equal(w0, w) for w0, w in zip(k0.weights, a.weights))
    np.testing.assert_allclose(lg, np.asarray(lr), rtol=1e-12, atol=0)
    assert np.array_equal(cg, np.asarray(cr))


# ------------------------------------------------ the kernels' tables
class _Unpacked:
    """A stand-in for ``_table.Tables``: returns what ``pack`` makes."""

    def get(self, key, pack, device):
        return pack()


def _net(dims, dtype=torch.float64):
    return [torch.zeros(n, m, dtype=dtype) for m, n in zip(dims[:-1], dims[1:])]


def test_convergence_layer_table_at_depth(monkeypatch):
    """One 40-byte record a layer: W's address, its dw's offset in the
    dw scratch, ceil(2^40 / rows), columns, rows, the layer's offset in
    the activations, its owned rows' offset in a weight block of C
    CTAs."""
    monkeypatch.setattr(convergence, "tables", _Unpacked())
    dims = [8] + HIDDEN + [2]
    weights = _net(dims)
    for C in (1, 16):
        blob, host = convergence._layer_table(weights, C, 0, "cpu")
        assert len(blob) == convergence.LAYER.size * len(weights) == 40 * 17
        assert host.raw == blob
        recs = list(convergence.LAYER.iter_unpack(blob))
        off = wblk = dwo = 0
        for (w, o_dw, inv_n, m, n, o, b), t, (m0, n0) in zip(recs, weights,
                                                             zip(dims[:-1], dims[1:])):
            assert (w, m, n) == (t.data_ptr(), m0, n0)
            assert (o_dw, o, b) == (dwo, off, wblk)
            assert inv_n == -(-(1 << 40) // n0)
            off, wblk, dwo = off + n0, wblk + -(-n0 // C) * m0, dwo + n0 * m0
        assert off == sum(dims[1:])


def test_batch_step_layer_table_at_depth(monkeypatch):
    """One 32-byte record a layer: W's and dw's addresses (0 without
    momentum), the rows of the layers below (the activations' offset
    over B), columns, rows; the scratch a row holds 2 x n_act values and
    the row loss."""
    monkeypatch.setattr(batch_step, "tables", _Unpacked())
    dims = [8] + HIDDEN + [2]
    for dtype, per_loss in ((torch.float64, 1), (torch.float32, 1), (torch.bfloat16, 2)):
        weights = _net(dims, dtype)
        dw = [torch.zeros_like(w) for w in weights]
        for momentum in (False, True):
            blob, host, per_row = batch_step._layer_table(weights, dw, momentum, 0, "cpu")
            assert host.raw == blob
            recs = list(batch_step.LAYER.iter_unpack(blob))
            assert len(recs) == 17 and batch_step.LAYER.size == 32
            cum = 0
            for (w, d, c, m, n), t, g in zip(recs, weights, dw):
                assert (w, m, n, c) == (t.data_ptr(), t.shape[1], t.shape[0], cum)
                assert d == (g.data_ptr() if momentum else 0)
                cum += n
            assert cum == sum(dims[1:])
            assert per_row == 2 * cum + per_loss
    # a fleet's stacked (N, n, m) layers: member 0's addresses, one
    # member's widths
    stacked = [torch.zeros(3, n, m) for m, n in zip(dims[:-1], dims[1:])]
    blob, _, _ = batch_step._layer_table(stacked, (), False, 0, "cpu")
    for (w, _, _, m, n), t in zip(batch_step.LAYER.iter_unpack(blob), stacked):
        assert (w, m, n) == (t.data_ptr(), t.shape[2], t.shape[1])


def test_convergence_plan_at_depth_says_the_bytes():
    """784-(300x19)-10: the activations and deltas fit one CTA, the
    weights (1.86 M values) do not, so they stream from device memory;
    a net whose activations cannot fit keeps them in device memory, and
    forced into shared memory raises with the bytes."""
    deep = _net([784] + [300] * 19 + [10])
    for dtype in (torch.float32, torch.float64):
        p = convergence.plan(deep, dtype, True)
        assert not p.weights_resident and not p.dw_resident
        assert p.smem_bytes <= convergence.MAX_SHARED_BYTES
    too_deep = _net([8] + [40] * 400 + [2])
    need = convergence.shared_bytes(too_deep, torch.float64)
    assert not convergence.plan(too_deep, torch.float64, False).vectors_resident
    with pytest.raises(ValueError, match=f"need {need} bytes of shared memory"):
        convergence.plan(too_deep, torch.float64, False, vectors_resident=True)


def test_deep_epoch_on_cpu_is_the_plain_version():
    """``train_epoch`` on CPU tensors of a 17-layer net runs the plain
    version (no depth check stands in front of it), bitwise."""
    rng = np.random.default_rng(5)
    dims = [8] + HIDDEN + [2]
    w0 = [rng.uniform(-0.5, 0.5, (n, m)) for m, n in zip(dims[:-1], dims[1:])]
    X = torch.tensor(rng.uniform(-1, 1, (3, 8)))
    T = torch.tensor([[1.0, -1.0], [-1.0, 1.0], [1.0, -1.0]], dtype=torch.float64)
    kw = dict(model="ann", momentum=True, min_iter=2, max_iter=6)
    a = tuple(torch.tensor(w) for w in w0)
    b = tuple(torch.tensor(w) for w in w0)
    sa = convergence.train_epoch(a, X, T, 0.2, -1e30, **kw)
    sb = convergence.train_epoch_plain(b, X, T, 0.2, -1e30, **kw)
    assert sa.n_iter.tolist() == sb.n_iter.tolist() == [7, 7, 7]
    assert all(x.equal(y) for x, y in zip(a, b))
    assert any(not x.equal(torch.tensor(w)) for x, w in zip(a, w0))
    batch_w = tuple(torch.tensor(w) for w in w0)
    Xb = torch.tensor(rng.uniform(-1, 1, (4, 8)))
    Tb = torch.tensor([[1.0, -1.0], [-1.0, 1.0]] * 2, dtype=torch.float64)
    _, _, losses = batch_step.train_epoch_grid_banked(batch_w, (), Xb, Tb, [1, 0], batch=2)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())


def test_layer_table_cache_keeps_the_recent_tables():
    """``ops/_table.py``: a hit returns the packed entry without packing
    again; a table of at most 16 layers gets no device copy; past
    ``MAX_TABLES`` keys the least recently used table goes."""
    from hpnn_tpu_torch.ops import _table

    tables, packed = _table.Tables(), []

    def pack(tag):
        def fn():
            packed.append(tag)
            return b"rec" + tag.encode(), tag
        return fn

    assert _table.device_copy(16, "cuda") is None
    assert _table.device_copy(17, "cuda") == "cuda"
    assert tables.get(("a",), pack("a"), None) == (None, "a")
    assert tables.get(("a",), pack("again"), None) == (None, "a")
    assert packed == ["a"]
    for i in range(_table.MAX_TABLES):
        tables.get((i,), pack(str(i)), None)
    assert len(tables) == _table.MAX_TABLES and tables.uploads == 0
    tables.get(("a",), pack("a2"), None)   # evicted: packed again
    tables.get((_table.MAX_TABLES - 1,), pack("hit"), None)
    assert packed[-1] == "a2" and "hit" not in packed
