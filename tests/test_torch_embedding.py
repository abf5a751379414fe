"""The library surface of the port (``hpnn_tpu_torch/__init__.py`` and
the runtime accessors), held against the JAX package's on the CPU.

* docs/api.md's embedding flow (the reference's "train an ANN on the
  fly" story, ``tests/test_embedding.py`` for ``hpnn_tpu``) through
  ``hpnn_tpu_torch.`` with ``device="cpu"``, in float64: its stdout
  byte-identical to ``hpnn_tpu``'s on the same samples, the trained
  weights within 1e-12, the dumped kernel read back and queried;
* ``import hpnn_tpu_torch`` stays light: no ``train.driver`` until an
  execute-op is first touched;
* the runtime accessors of ``hpnn_tpu/runtime.py`` answer on a fresh
  runtime as the JAX package's do.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hpnn_tpu
import hpnn_tpu_torch
from hpnn_tpu.utils import logging as jlog
from hpnn_tpu_torch.utils import logging as plog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURFACE = ("runtime", "NNConf", "NNType", "NNTrain", "load_conf", "dump_conf", "Kernel",
           "generate_kernel", "load_kernel", "dump_kernel", "train_kernel", "run_kernel",
           "train_kernel_batched", "run_kernel_batched", "read_sample", "serve")


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The environment and both packages' runtimes restored as they
    were, their verbosity reset, after each test."""
    saved = dict(os.environ)
    runtimes = [(rt, rt._runtime) for rt in (hpnn_tpu.runtime, hpnn_tpu_torch.runtime)]
    yield
    os.environ.clear()
    os.environ.update(saved)
    for rt, was in runtimes:
        rt._runtime = was
    for log in (jlog, plog):
        log.set_verbose(0)


def _write_samples(d, n=16):
    rng = np.random.default_rng(1)
    os.makedirs(d)
    for i in range(n):
        c = i % 2
        x = (1 - 2 * c) * np.r_[np.ones(4), -np.ones(4)] + 0.1 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(os.path.join(d, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n" + " ".join(f"{v:.5f}" for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join(f"{v:.1f}" for v in t) + "\n")


def _embedded_round(pkg, log, sdir, dump_path, **device):
    """docs/api.md's flow: runtime up, a conf in code, a generated
    kernel, one training round and one eval over ``sdir``, the kernel
    dumped to ``dump_path``; returns the conf."""
    pkg.runtime.init_all(0)
    log.set_verbose(2)
    conf = pkg.NNConf(name="embedded", type=pkg.NNType.ANN, train=pkg.NNTrain.BP,
                      seed=10958)
    assert pkg.generate_kernel(conf, n_in=8, hiddens=[6], n_out=2)
    assert conf.kernel.n_inputs == 8 and conf.kernel.n_outputs == 2
    assert conf.kernel.hidden_sizes == (6,)
    conf.samples = conf.tests = sdir
    assert pkg.train_kernel(conf, **device)
    pkg.run_kernel(conf, **device)
    with open(dump_path, "w") as fp:
        pkg.dump_kernel(conf, fp)
    log.set_verbose(0)
    return conf


def test_embedded_flow_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sdir = str(tmp_path / "samples")
    _write_samples(sdir)
    capsys.readouterr()
    jconf = _embedded_round(hpnn_tpu, jlog, sdir, "jax.opt")
    ref = capsys.readouterr().out
    conf = _embedded_round(hpnn_tpu_torch, plog, sdir, "kernel.opt", device="cpu")
    got = capsys.readouterr().out
    assert got.count("TRAINING FILE:") == 16 and got.count("SUCCESS!") == 16
    assert got.count("[PASS]") == 16
    assert got == ref
    for a, b in zip(conf.kernel.weights, jconf.kernel.weights):
        assert np.asarray(a).dtype == np.float64
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)

    # "the next program run": a fresh handle loads the dumped kernel and
    # queries it in memory
    conf2 = hpnn_tpu_torch.NNConf(type=hpnn_tpu_torch.NNType.ANN, f_kernel="kernel.opt")
    assert hpnn_tpu_torch.load_kernel(conf2)
    from hpnn_tpu_torch.train import loop

    x, t = hpnn_tpu_torch.read_sample(os.path.join(sdir, "s00000.txt"))
    o = loop.run_sample(tuple(torch.tensor(w) for w in conf2.kernel.weights),
                        torch.tensor(x), model="ann")
    assert int(torch.argmax(o)) == int(np.argmax(t))
    for a, b in zip(conf.kernel.weights, conf2.kernel.weights):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-15)


def test_surface_mirrors_the_jax_package():
    assert set(hpnn_tpu_torch.__all__) == set(hpnn_tpu.__all__) == set(SURFACE)
    for name in SURFACE:
        obj = getattr(hpnn_tpu_torch, name)
        home = obj.__name__ if name in ("runtime", "serve") else obj.__module__
        assert home.startswith("hpnn_tpu_torch."), (name, home)
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        hpnn_tpu_torch.nope


def test_execute_ops_default_to_cuda(tmp_path, monkeypatch):
    """Without ``device=`` an execute-op asks for the card, and without
    one it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = hpnn_tpu_torch.NNConf(name="e", type=hpnn_tpu_torch.NNType.ANN,
                                 train=hpnn_tpu_torch.NNTrain.BP, seed=10958)
    assert hpnn_tpu_torch.generate_kernel(conf, n_in=8, hiddens=[6], n_out=2)
    _write_samples(str(tmp_path / "s"), n=2)
    conf.samples = conf.tests = str(tmp_path / "s")
    with pytest.raises(hpnn_tpu_torch.runtime.DeviceUnavailable):
        hpnn_tpu_torch.train_kernel(conf)
    with pytest.raises(hpnn_tpu_torch.runtime.DeviceUnavailable):
        hpnn_tpu_torch.run_kernel(conf)


def test_import_is_light():
    """``import hpnn_tpu_torch`` loads no training stack; the
    execute-ops resolve on first touch."""
    code = (
        "import sys; import hpnn_tpu_torch; "
        "assert 'hpnn_tpu_torch.train.driver' not in sys.modules, 'eager driver'; "
        "assert 'hpnn_tpu_torch.train.loop' not in sys.modules, 'eager loop'; "
        "assert 'hpnn_tpu_torch.serve' not in sys.modules, 'eager serve'; "
        "hpnn_tpu_torch.train_kernel; "
        "assert 'hpnn_tpu_torch.train.driver' in sys.modules; "
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'hpnn_tpu')]"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)


def test_runtime_accessors_match_jax():
    """On a fresh runtime each accessor of ``hpnn_tpu/runtime.py`` that
    the port mirrors answers as the JAX package's, and the setters move
    the getters alike."""
    j, p = hpnn_tpu.runtime, hpnn_tpu_torch.runtime
    for rt in (j, p):
        rt.init_runtime()
    names = ("get_omp_threads", "get_omp_blas", "get_cuda_streams", "get_mpi_tasks",
             "n_devices", "return_verbose")
    assert [getattr(p, n)() for n in names] == [getattr(j, n)() for n in names]
    assert p.set_mpi_tasks(4) is j.set_mpi_tasks(4) is False
    assert p.get_mpi_tasks() == j.get_mpi_tasks() == 1
    threads = torch.get_num_threads()
    try:
        for rt in (j, p):
            assert rt.set_omp_threads(3) and rt.set_omp_blas(2) and rt.set_cuda_streams(5)
        assert [getattr(p, n)() for n in names] == [getattr(j, n)() for n in names]
        assert (p.get_omp_threads(), p.get_omp_blas(), p.get_cuda_streams()) == (3, 2, 5)
    finally:
        torch.set_num_threads(threads)
    for rt in (j, p):
        rt.runtime().capability = rt.NNCap.OMP | rt.NNCap.PBLAS
        rt.unset_capability(rt.NNCap.OMP)
    assert int(p.get_capabilities()) == int(j.get_capabilities()) == int(p.NNCap.PBLAS)
    assert p.init_cuda() is True
    assert p.n_devices() == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    p.init_runtime()
    assert p.runtime() == p.NNRuntime() and p.n_devices() == 0


def test_packaging_ships_the_port():
    """An installed port has its native sources and its CLIs, under
    console-script names that leave the JAX package's alone."""
    import glob
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fp:
        proj = tomllib.load(fp)
    data = proj["tool"]["setuptools"]["package-data"]["hpnn_tpu_torch"]
    pkg = os.path.join(ROOT, "hpnn_tpu_torch")
    shipped = {os.path.relpath(p, pkg) for pat in data for p in glob.glob(os.path.join(pkg, pat))}
    assert {"csrc/convergence.cu", "csrc/batch_step.cu", "csrc/hpnn_native.cpp"} <= shipped
    scripts = proj["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if v.startswith("hpnn_tpu_torch.")}
    assert {v.split(":")[0].rsplit(".", 1)[1] for v in port.values()} == {
        "train_nn", "run_nn", "serve_nn", "online_nn", "obs_collector"}
    for name, target in port.items():
        assert not scripts.get(name, "").startswith("hpnn_tpu.")
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn)), target
    for name in ("train_nn", "run_nn", "serve_nn", "online_nn"):
        assert scripts[name].startswith("hpnn_tpu.cli.")
