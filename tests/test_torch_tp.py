"""Per-sample tensor parallelism (``--mesh 1xM``) through both packages
on the CPU in float64.

The JAX package runs its mesh in this process, on the 8 virtual CPU
devices of ``tests/conftest.py``; the port starts M gloo ranks through
``parallel/dist.py``.  ``train_nn --mesh 1xM`` then ``run_nn --mesh
1xM`` print byte-identical stdout, write a byte-identical
``kernel.tmp``, and their ``kernel.opt`` agree within 1e-12 (the
reference's bar on weight matrices, ``ChangeLog:33-38``).  A world of
4 ranks holds ``tp.train_sample_local`` and the run functions against
``hpnn_tpu.parallel.tp`` on a 4-way model axis with the bars of
``tests/test_parallel.py`` (equal n_iter and OK flags, 1e-11).

The rank children load this file by path to find their functions, so
nothing at its top level imports JAX: the JAX modules are imported in
the test functions.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.parallel import dist, mesh as mesh_mod, tp

HERE = os.path.abspath(__file__)
CONF = ("[name] V\n[type] {kind}\n[init] {init}\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] {train}\n[sample_dir] ./samples\n"
        "[test_dir] ./tests\n")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: a test elsewhere in this worker may have left one set.
    Clear them all and forget the port's memos before the test; drop
    what the test exported and forget again after it."""
    from hpnn_tpu_torch import obs as port_obs

    for knob in (*runtime.DEFERRED_ENV, *port_obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_PALLAS", "HPNN_NO_BATCH_EVAL"):
        monkeypatch.delenv(knob, raising=False)
    port_obs._reset_for_tests()
    yield
    for knob in port_obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    port_obs._reset_for_tests()


@pytest.fixture(autouse=True)
def _reset_port_verbosity():
    from hpnn_tpu_torch.utils import logging as port_log

    port_log.set_verbose(0)
    yield
    port_log.set_verbose(0)


def _write_samples(d, n=16, mismatch=True):
    """The verify recipe's two clusters, an unreadable file and (the
    training dir only: both packages' run_nn raise on it) a file whose
    dims are not the kernel's."""
    rng = np.random.default_rng(42)
    centers = np.array([[1.0] * 4 + [-1.0] * 4, [-1.0] * 4 + [1.0] * 4])
    os.makedirs(d)
    for i in range(n):
        c = i % 2
        x = centers[c] + 0.1 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(os.path.join(d, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n" + " ".join("%7.5f" % v for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join("%.1f" % v for v in t) + "\n")
    with open(os.path.join(d, "zz_bad.txt"), "w") as fp:
        fp.write("[input] 8\n")
    if mismatch:
        with open(os.path.join(d, "zz_dims.txt"), "w") as fp:
            fp.write("[input] 3\n1 2 3\n[output] 2\n1.0 -1.0\n")


@pytest.fixture(scope="module")
def ann_start(tmp_path_factory):
    """An ANN kernel after one single-device JAX round of the recipe.
    From a generated kernel the first ANN sample takes ~15000
    iterations, ~1 ms each over gloo; from this one every sample takes
    the ~32 of a continuation round (the tutorials' rounds 2 and on),
    so the mesh runs stay a few seconds."""
    from hpnn_tpu.cli import train_nn as jtrain_nn
    from hpnn_tpu.utils import logging as jlog

    d = tmp_path_factory.mktemp("ann_start")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        _write_samples("samples")
        (d / "nn.conf").write_text(CONF.format(kind="ANN", init="generate", train="BP"))
        assert jtrain_nn.main(["nn.conf"]) == 0
        jlog.set_verbose(0)
        return (d / "kernel.opt").read_text()
    finally:
        os.chdir(cwd)


def _weights(text, tmp_path):
    p = tmp_path / "cmp.opt"
    p.write_text(text)
    return kernel_format.load_kernel(str(p))[1]


def _drive(pkg_train, pkg_run, extra, capsys):
    """train_nn, then run_nn on its kernel.opt; (stdout, tmp, opt)."""
    capsys.readouterr()
    assert pkg_train(extra + ["-v", "-v", "-v", "nn.conf"]) == 0
    out = capsys.readouterr().out
    with open("kernel.tmp") as fp:
        tmp = fp.read()
    with open("kernel.opt") as fp:
        opt = fp.read()
    shutil.copy("kernel.opt", "trained.opt")
    assert pkg_run(extra + ["-v", "-v", "-v", "cont.conf"]) == 0
    out += capsys.readouterr().out
    os.remove("kernel.tmp")
    os.remove("kernel.opt")
    return out, tmp, opt


@pytest.mark.parametrize("kind,train,m", [
    ("ANN", "BP", 2), ("ANN", "BPM", 2), ("SNN", "BP", 2), ("SNN", "BPM", 2),
    # 6 hidden rows split 3 ways; 2 outputs pad to 3
    ("ANN", "BP", 3), ("SNN", "BP", 3),
])
def test_mesh_train_then_run_matches_jax(tmp_path, monkeypatch, capsys, ann_start,
                                         kind, train, m):
    from hpnn_tpu.cli import run_nn as jrun_nn
    from hpnn_tpu.cli import train_nn as jtrain_nn

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "5")  # several chunks per round
    _write_samples("samples")
    _write_samples("tests", mismatch=False)
    init = "generate"
    if kind == "ANN":
        (tmp_path / "start.opt").write_text(ann_start)
        init = "start.opt"
    conf = CONF.format(kind=kind, init=init, train=train)
    (tmp_path / "nn.conf").write_text(conf)
    (tmp_path / "cont.conf").write_text(conf.replace(f"[init] {init}", "[init] trained.opt"))
    mesh = ["--mesh", f"1x{m}"]
    ref = _drive(jtrain_nn.main, jrun_nn.main, mesh, capsys)
    got = _drive(train_nn.main, run_nn.main, ["--device", "cpu"] + mesh, capsys)
    assert "TRAINING FILE" in got[0] and "TESTING FILE" in got[0]
    assert "[PASS]" in got[0]
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    for a, b in zip(_weights(got[2], tmp_path), _weights(ref[2], tmp_path)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


# ------------------------------------------------- the unit check, 4 ranks
def _unit_cases():
    """(model, momentum, n_in, hiddens, n_out): divisible by 4, and a
    net where nothing is (padding, the masked SNN softmax)."""
    return [("ann", False, 12, [16, 8], 8), ("ann", True, 12, [16, 8], 8),
            ("snn", False, 12, [16, 8], 8), ("snn", True, 12, [16, 8], 8),
            ("ann", False, 10, [7, 5], 3), ("snn", False, 10, [6], 5)]


def _unit_inputs(model, n_in, hiddens, n_out):
    from hpnn_tpu_torch.models import kernel as km

    k, _ = km.generate(1234, n_in, hiddens, n_out)
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, n_in)
    t = np.where(np.arange(n_out) == 1, 1.0, 0.0 if model == "snn" else -1.0)
    X = np.random.RandomState(5).uniform(-1, 1, (6, n_in))
    return [np.asarray(w) for w in k.weights], x, t, X


def _unit_rank(mesh, min_iter, max_iter):
    """Each case on this rank's row blocks: the trained sample (n_iter,
    flags, ep0, output, the gathered unpadded weights) and the single
    and batched run functions' outputs."""
    k = mesh.shape[mesh_mod.MODEL_AXIS]
    out = []
    for model, momentum, n_in, hiddens, n_out in _unit_cases():
        weights, x, t, X = _unit_inputs(model, n_in, hiddens, n_out)
        padded, rows = mesh_mod.pad_kernel(weights, k)
        w = tp.shard_kernel(padded, mesh)
        dw = tuple(torch.zeros_like(a) for a in w) if momentum else ()
        t_pad = torch.from_numpy(mesh_mod.pad_vector(t, k))
        res = tp.train_sample_local(
            w, dw, torch.from_numpy(x), t_pad, 0.2, 1e-6, model=model,
            momentum=momentum, min_iter=min_iter, max_iter=max_iter, n_out=n_out,
            mesh=mesh)
        w0 = tp.shard_kernel(padded, mesh)
        one = tp.make_run_fn(mesh, model=model, n_out=n_out)(w0, torch.from_numpy(x))
        rows_out = tp.make_batched_run_fn(mesh, model=model, n_out=n_out)(
            w0, torch.from_numpy(X))
        out.append(dict(
            n_iter=res.n_iter, first_ok=res.first_ok, final_ok=res.final_ok,
            ep0=float(res.ep0), out=res.out[:n_out].numpy(),
            weights=mesh_mod.unpad_kernel(tp.gather_kernel(res.weights, mesh), rows),
            run=one[:n_out].numpy(), run_batch=rows_out[:, :n_out].numpy(),
            modules=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu"))))
    return out


def test_tp_unit_matches_jax_on_a_4_rank_world():
    import jax.numpy as jnp

    from hpnn_tpu.parallel import mesh as jmesh
    from hpnn_tpu.parallel import tp as jtp

    min_it, max_it = 5, 40
    got = dist.run(f"{HERE}:_unit_rank", 4, mesh=(1, 4), args=(min_it, max_it),
                   device="cpu", timeout=300)
    mesh4 = jmesh.make_mesh(n_data=2, n_model=4)
    for i, (model, momentum, n_in, hiddens, n_out) in enumerate(_unit_cases()):
        weights, x, t, X = _unit_inputs(model, n_in, hiddens, n_out)
        padded, rows = jmesh.pad_kernel(weights, 4)
        fn = jtp.make_train_fn(mesh4, len(padded), model=model, momentum=momentum,
                               min_iter=min_it, max_iter=max_it, n_out=n_out)
        dw = jtp.shard_kernel(tuple(np.zeros_like(p) for p in padded), mesh4) \
            if momentum else ()
        ref = fn(jtp.shard_kernel(padded, mesh4), dw, jtp.replicate(x, mesh4),
                 jtp.replicate(jmesh.pad_vector(t, 4), mesh4),
                 jnp.asarray(0.2), jnp.asarray(1e-6))
        run1 = np.asarray(jtp.make_run_fn(mesh4, len(padded), model=model, n_out=n_out)(
            jtp.shard_kernel(padded, mesh4), jtp.replicate(x, mesh4)))[:n_out]
        runb = np.asarray(jtp.make_batched_run_fn(
            mesh4, len(padded), model=model, n_out=n_out)(
            jtp.shard_kernel(padded, mesh4), jtp.replicate(X, mesh4)))[:, :n_out]
        ref_w = jmesh.unpad_kernel([np.asarray(w) for w in ref.weights], rows)
        for r in got:   # every rank holds the same replicated results
            g = r[i]
            assert g["modules"] == []   # no rank imported JAX or hpnn_tpu
            assert g["n_iter"] == int(ref.n_iter)
            assert g["first_ok"] == bool(ref.first_ok)
            assert g["final_ok"] == bool(ref.final_ok)
            np.testing.assert_allclose(g["ep0"], float(ref.ep0), rtol=1e-12)
            np.testing.assert_allclose(g["out"], np.asarray(ref.out)[:n_out], atol=1e-11)
            for a, b in zip(g["weights"], ref_w):
                np.testing.assert_allclose(a, b, atol=1e-11)
            np.testing.assert_allclose(g["run"], run1, atol=1e-11)
            np.testing.assert_allclose(g["run_batch"], runb, atol=1e-11)


def test_pad_helpers_match_jax():
    """The copied padding helpers give the JAX package's arrays."""
    from hpnn_tpu.parallel import mesh as jmesh

    weights, _, t, _ = _unit_inputs("ann", 10, [7, 5], 3)
    for k in (1, 2, 3, 4):
        a, ra = mesh_mod.pad_kernel(weights, k)
        b, rb = jmesh.pad_kernel(weights, k)
        assert ra == rb
        for u, v in zip(a, b):
            assert np.array_equal(u, v)
        for u, v in zip(mesh_mod.unpad_kernel(a, ra), jmesh.unpad_kernel(b, rb)):
            assert np.array_equal(u, v)
        assert np.array_equal(mesh_mod.pad_vector(t, k), jmesh.pad_vector(t, k))


# ------------------------------------------------------------ on the card
def _card_tp_rank(mesh, dtype_name):
    """The two-rank card check's body: a 784-300-10-shaped sample
    (cut to 64 inputs) trained over two gloo ranks on one card, and the
    devices of the rank's mesh and of a batch run's own mesh."""
    from hpnn_tpu_torch.train import batch

    dtype = getattr(torch, dtype_name)
    weights, x, t, _ = _unit_inputs("ann", 64, [30], 10)
    padded, rows = mesh_mod.pad_kernel(weights, 2)
    w = tp.shard_kernel(padded, mesh, dtype=dtype)
    res = tp.train_sample_local(
        w, (), torch.tensor(x, dtype=dtype, device=mesh.device),
        torch.tensor(mesh_mod.pad_vector(t, 2), dtype=dtype, device=mesh.device),
        0.2, 1e-6, model="ann", momentum=False, min_iter=5, max_iter=60, n_out=10,
        mesh=mesh)
    return (res.n_iter, mesh_mod.unpad_kernel(tp.gather_kernel(res.weights, mesh), rows),
            (str(mesh.device), str(batch.default_mesh().device)))


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_cpu_world():
    """Two gloo ranks on one card train the sample the CPU world trains
    (float64: the same n_iter, weights within 1e-12); each world's
    meshes are on the device it joined with."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = dist.run(f"{HERE}:_card_tp_rank", 2, mesh=(1, 2), backend="gloo",
                    device="cuda:0", args=("float64",), timeout=300)
    cpu = dist.run(f"{HERE}:_card_tp_rank", 2, mesh=(1, 2), args=("float64",),
                   device="cpu", timeout=300)
    assert card[0][0] == cpu[0][0]
    assert card[1][2] == ("cuda:0", "cuda:0") and cpu[1][2] == ("cpu", "cpu")
    for a, b in zip(card[0][1], cpu[0][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
