"""Minibatch training over a mesh (``train_nn --batch B --mesh DxM``)
through both packages on the CPU in float64, and the two batch-path
knobs the port honours (``HPNN_FAST_COUNT``, ``HPNN_NO_BATCH_EVAL``).

The JAX package runs its mesh in this process on the 8 virtual CPU
devices of ``tests/conftest.py``; the port starts D×M gloo ranks.  The
bars are ``tests/test_torch_batch.py``'s: the ``BATCH EPOCH`` lines
agree (the same count and ``(ok/n)``, loss within 1e-12), ``kernel.tmp``
is byte-identical, ``kernel.opt`` agrees within 1e-12, and ``run_nn
--batch`` prints byte-identical stdout.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.fileio import kernel_format

CONF = ("[name] V\n[type] {kind}\n[init] generate\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] {train}\n[sample_dir] ./samples\n"
        "[test_dir] ./tests\n")
EPOCH = re.compile(r"BATCH EPOCH +(\d+) loss= (\S+) acc= +(\S+)% \((\d+)/(\d+)\)")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: a test elsewhere in this worker may have left one set.
    Clear them all and forget the port's memos before the test; drop
    what the test exported and forget again after it."""
    from hpnn_tpu_torch import obs as port_obs

    for knob in (*runtime.DEFERRED_ENV, *port_obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_PALLAS", "HPNN_FAST_COUNT",
                 "HPNN_NO_BATCH_EVAL", "HPNN_BANK", "HPNN_BANK_REFRESH"):
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


def _write_samples(d, n=18, seed=42):
    """Two clusters; 18 samples, so batches of 8 wrap the tail; plus an
    unreadable file (skipped by both)."""
    rng = np.random.default_rng(seed)
    centers = np.array([[1.0] * 4 + [-1.0] * 4, [-1.0] * 4 + [1.0] * 4])
    os.makedirs(d)
    for i in range(n):
        c = i % 2
        x = centers[c] + 0.6 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(os.path.join(d, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n" + " ".join("%7.5f" % v for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join("%.1f" % v for v in t) + "\n")
    with open(os.path.join(d, "zz_bad.txt"), "w") as fp:
        fp.write("[input] 8\n")


def _setup(tmp_path, monkeypatch, kind, train):
    monkeypatch.chdir(tmp_path)
    _write_samples("samples")
    _write_samples("tests", n=12, seed=7)
    conf = CONF.format(kind=kind, train=train)
    (tmp_path / "nn.conf").write_text(conf)
    (tmp_path / "cont.conf").write_text(
        conf.replace("[init] generate", "[init] trained.opt"))


def _drive(pkg_train, pkg_run, extra, capsys, train_args, run_extra=()):
    """train_nn --batch, then run_nn --batch and run_nn on kernel.opt;
    returns (train stdout, run --batch stdout, run stdout, kernel.tmp,
    kernel.opt)."""
    capsys.readouterr()
    assert pkg_train(extra + train_args + ["-v", "-v", "nn.conf"]) == 0
    out = capsys.readouterr().out
    with open("kernel.tmp") as fp:
        tmp = fp.read()
    with open("kernel.opt") as fp:
        opt = fp.read()
    shutil.copy("kernel.opt", "trained.opt")
    assert pkg_run(list(run_extra) + ["--batch", "-v", "-v", "-v", "cont.conf"]) == 0
    run_batch = capsys.readouterr().out
    assert pkg_run(list(run_extra) + ["-v", "-v", "-v", "cont.conf"]) == 0
    run_out = capsys.readouterr().out
    os.remove("kernel.tmp")
    os.remove("kernel.opt")
    return out, run_batch, run_out, tmp, opt


def _weights(text, tmp_path):
    p = tmp_path / "cmp.opt"
    p.write_text(text)
    return kernel_format.load_kernel(str(p))[1]


def _held(got, ref, tmp_path, epochs):
    ref_ep, got_ep = EPOCH.findall(ref[0]), EPOCH.findall(got[0])
    assert len(ref_ep) == epochs and len(got_ep) == len(ref_ep)
    for r, g in zip(ref_ep, got_ep):
        assert g[0] == r[0] and g[2:] == r[2:]  # epoch, acc, (ok/n)
        assert abs(float(g[1]) - float(r[1])) <= 1e-12
    assert got[1] == ref[1]  # run_nn --batch stdout
    assert got[2] == ref[2]  # run_nn stdout
    assert "TESTING FILE" in got[1] and "[PASS]" in got[1]
    assert got[3] == ref[3]  # kernel.tmp
    for a, b in zip(_weights(got[4], tmp_path), _weights(ref[4], tmp_path)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


# ANN-BP at its per-sample rate barely moves in a few mean-gradient
# steps of 8 rows, so its runs pass --lr as tests/test_torch_batch.py's
@pytest.mark.parametrize("kind,train,lr", [
    ("ANN", "BP", ["--lr", "0.5"]), ("SNN", "BPM", []),
])
@pytest.mark.parametrize("mesh", ["2x1", "2x2", "1x2"])
def test_batch_mesh_matches_jax(tmp_path, monkeypatch, capsys, kind, train, lr, mesh):
    """2x1: pure data parallelism (each rank 4 of the 8 rows, the
    gradient mean an all-reduce, the host permutation once an epoch);
    2x2: DP × TP; 1x2: one data shard of two row blocks on the bank
    path."""
    from hpnn_tpu.cli import run_nn as jrun_nn
    from hpnn_tpu.cli import train_nn as jtrain_nn

    _setup(tmp_path, monkeypatch, kind, train)
    args = ["--batch", "8", "--epochs", "3", "--mesh", mesh] + lr
    ref = _drive(jtrain_nn.main, jrun_nn.main, [], capsys, args)
    got = _drive(train_nn.main, run_nn.main, ["--device", "cpu"], capsys, args,
                 run_extra=["--device", "cpu"])
    _held(got, ref, tmp_path, 3)


@pytest.mark.parametrize("knob", ["HPNN_FAST_COUNT", "HPNN_NO_BATCH_EVAL"])
def test_batch_path_knobs_match_jax(tmp_path, monkeypatch, capsys, knob):
    """``HPNN_FAST_COUNT=1`` (TF32 allowed on the in-training count's
    matmul only: nothing moves on the CPU, as nothing moves in the JAX
    package's float64 run) and ``HPNN_NO_BATCH_EVAL=1`` (run_nn's
    per-file forward) are honoured: train_nn --batch, run_nn --batch
    and run_nn print the JAX package's stdout byte for byte."""
    from hpnn_tpu.cli import run_nn as jrun_nn
    from hpnn_tpu.cli import train_nn as jtrain_nn

    _setup(tmp_path, monkeypatch, "ANN", "BP")
    monkeypatch.setenv(knob, "1")
    args = ["--batch", "8", "--epochs", "2", "--lr", "0.5"]
    ref = _drive(jtrain_nn.main, jrun_nn.main, ["--mesh", "1x1"], capsys, args)
    got = _drive(train_nn.main, run_nn.main, ["--device", "cpu"], capsys, args,
                 run_extra=["--device", "cpu"])
    assert got[0] == ref[0]
    _held(got, ref, tmp_path, 2)


def test_no_batch_eval_takes_the_per_file_forward(tmp_path, monkeypatch):
    """``HPNN_NO_BATCH_EVAL=1`` sends every readable file through the
    per-file forward: the eval round records no batched file."""
    from hpnn_tpu_torch import config, obs
    from hpnn_tpu_torch.train import driver

    _setup(tmp_path, monkeypatch, "ANN", "BP")
    monkeypatch.setenv("HPNN_METRICS", str(tmp_path / "m.jsonl"))
    conf = config.load_conf("nn.conf")
    for knob, batched in (("", 12), ("1", 0)):
        monkeypatch.setenv("HPNN_NO_BATCH_EVAL", knob)
        driver.run_kernel(conf, device="cpu")
        obs.flush()
        rows = [r for r in map(json.loads, open("m.jsonl"))
                if r.get("ev") == "eval.round"]
        assert rows[-1]["batched"] == batched and rows[-1]["unreadable"] == 1
