"""``train_nn`` then ``run_nn`` through both packages on the CPU in
float64, on the verify recipe's synthetic data: stdout byte-identical,
``kernel.tmp`` byte-identical, ``kernel.opt`` weights within 1e-12."""

import os
import shutil

import numpy as np
import pytest
import torch

from hpnn_tpu.cli import run_nn as jrun_nn
from hpnn_tpu.cli import train_nn as jtrain_nn
from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.ops import convergence


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


CONF = ("[name] V\n[type] {kind}\n[init] generate\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] {train}\n[sample_dir] ./samples\n"
        "[test_dir] ./tests\n")


@pytest.fixture(autouse=True)
def _reset_port_verbosity():
    """The port keeps its own module-global verbosity (the CLIs raise
    it with -v); it must not leak into other tests of this worker."""
    from hpnn_tpu_torch.utils import logging as port_log

    port_log.set_verbose(0)
    yield
    port_log.set_verbose(0)


def _write_samples(d, n=16, mismatch=True):
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
    # an unreadable file and (training only: both packages' run_nn
    # raise on it) a dimension mismatch; each gets a header-only line
    with open(os.path.join(d, "zz_bad.txt"), "w") as fp:
        fp.write("[input] 8\n")
    if not mismatch:
        return
    with open(os.path.join(d, "zz_dims.txt"), "w") as fp:
        fp.write("[input] 3\n1 2 3\n[output] 2\n1.0 -1.0\n")


def _drive(pkg_train, pkg_run, extra, capsys):
    """train_nn, then run_nn on kernel.opt; returns (stdout, tmp, opt)."""
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


@pytest.mark.parametrize("kind,train", [("ANN", "BP"), ("SNN", "BPM")])
def test_train_then_run_matches_jax(tmp_path, monkeypatch, capsys, kind, train):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "5")  # several chunks per round
    _write_samples("samples")
    _write_samples("tests", mismatch=False)
    conf = CONF.format(kind=kind, train=train)
    (tmp_path / "nn.conf").write_text(conf)
    (tmp_path / "cont.conf").write_text(
        conf.replace("[init] generate", "[init] trained.opt"))
    capsys.readouterr()
    ref = _drive(jtrain_nn.main, jrun_nn.main, [], capsys)
    launches = convergence.launches
    got = _drive(train_nn.main, run_nn.main, ["--device", "cpu"], capsys)
    assert convergence.launches == launches
    assert "TRAINING FILE" in got[0] and "[PASS]" in got[0]
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    wa = [np.asarray(w) for w in _weights(got[2], tmp_path)]
    wb = [np.asarray(w) for w in _weights(ref[2], tmp_path)]
    for a, b in zip(wa, wb):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _weights(text, tmp_path):
    p = tmp_path / "cmp.opt"
    p.write_text(text)
    return kernel_format.load_kernel(str(p))[1]


def test_missing_cuda_is_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_samples("samples", n=2)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    assert train_nn.main(["nn.conf"]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "kernel.tmp").exists()
    assert run_nn.main(["--device", "cuda", "nn.conf"]) != 0
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("argv,env", [
    (["--batch", "4", "--mesh", "1x1", "--device", "cpu"], {}),
    (["--mesh", "1x2", "--device", "cpu"], {}),
    (["--mesh", "1x2", "--metrics", "m.jsonl", "--device", "cpu"], {}),
    (["--device", "tpu"], {}),
    (["--device", "cpu"], {"HPNN_COLLECTOR": "http://localhost:8790"}),
    (["--device", "cpu"], {"HPNN_ALERTS": "rules.json"}),
])
def test_unported_options_are_refused(tmp_path, monkeypatch, capsys, argv, env):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    assert train_nn.main(argv + ["nn.conf"]) != 0
    err = capsys.readouterr().err
    assert "not supported" in err or "does not have" in err or "bad --device" in err
    assert not (tmp_path / "kernel.tmp").exists()


def test_runtime_probe_sets_cuda_bit_only_with_a_card(monkeypatch):

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime.init_all()
    assert not runtime.get_capabilities() & runtime.NNCap.CUDA
    assert runtime.compute_dtype(torch.device("cpu")) == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    runtime.init_all()
    assert runtime.get_capabilities() & runtime.NNCap.CUDA
    assert runtime.compute_dtype(torch.device("cuda")) == torch.float32
    monkeypatch.setenv("HPNN_DTYPE", "float64")
    assert runtime.compute_dtype(torch.device("cuda")) == torch.float64
    runtime.deinit_all()


def test_run_nn_refuses_batch(tmp_path, monkeypatch, capsys):
    """``run_nn --batch`` is a flag: it is refused with a value, and
    beside an option of a path not ported (``--mesh``)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    assert run_nn.main(["--batch=4", "--device", "cpu", "nn.conf"]) != 0
    assert "unrecognized option --batch" in capsys.readouterr().err
    assert run_nn.main(["--batch", "--mesh", "1x1", "--device", "cpu", "nn.conf"]) != 0
    assert "--mesh is not supported" in capsys.readouterr().err
