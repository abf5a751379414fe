"""``train_nn --batch`` then ``run_nn --batch`` through both packages on
the CPU in float64.

The ``BATCH EPOCH`` lines agree (the same count, identical ``(ok/n)``,
loss within 1e-12), ``kernel.tmp`` is byte-identical, ``kernel.opt``
agrees within 1e-12 (the reference's bar on weight matrices,
``ChangeLog:33-38``), and ``run_nn --batch`` prints byte-identical
stdout.  The JAX ``train_nn`` runs with ``--mesh 1x1``: this suite gives
JAX 8 virtual CPU devices, and the single-shard path the port follows is
the JAX package's path on one device (the JAX ``run_nn`` refuses
``--mesh`` with ``--batch``, and its eval does not depend on the mesh).
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from hpnn_tpu.cli import run_nn as jrun_nn
from hpnn_tpu.cli import train_nn as jtrain_nn
from hpnn_tpu.fileio import samples as jsamples
from hpnn_tpu.train import batch as jbatch
from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.fileio import samples
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.train import batch

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
EPOCH = re.compile(r"BATCH EPOCH +(\d+) loss= (\S+) acc= +(\S+)% \((\d+)/(\d+)\)")


@pytest.fixture(autouse=True)
def _reset_port_verbosity():
    """The port keeps its own module-global verbosity (the CLIs raise
    it with -v); it must not leak into other tests of this worker."""
    from hpnn_tpu_torch.utils import logging as port_log

    port_log.set_verbose(0)
    yield
    port_log.set_verbose(0)


def _write_samples(d, n=18, seed=42):
    """The verify recipe's two clusters; 18 samples, so batches of 8
    wrap the tail; plus an unreadable file (skipped by both)."""
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
    """train_nn --batch, then run_nn --batch on kernel.opt; returns
    (train stdout, run stdout, kernel.tmp, kernel.opt)."""
    capsys.readouterr()
    assert pkg_train(extra + train_args + ["-v", "-v", "nn.conf"]) == 0
    out = capsys.readouterr().out
    with open("kernel.tmp") as fp:
        tmp = fp.read()
    with open("kernel.opt") as fp:
        opt = fp.read()
    shutil.copy("kernel.opt", "trained.opt")
    assert pkg_run(list(run_extra) + ["--batch", "-v", "-v", "-v", "cont.conf"]) == 0
    run_out = capsys.readouterr().out
    os.remove("kernel.tmp")
    os.remove("kernel.opt")
    return out, run_out, tmp, opt


def _weights(text, tmp_path):
    p = tmp_path / "cmp.opt"
    p.write_text(text)
    return kernel_format.load_kernel(str(p))[1]


# ANN-BP at its per-sample rate (0.001) barely moves in 6 mean-gradient
# steps of 8 rows, so its runs also exercise --lr
@pytest.mark.parametrize("kind,train,env,lr", [
    ("ANN", "BP", {}, ["--lr", "0.5"]),
    ("ANN", "BP", {"HPNN_BANK": "0"}, ["--lr", "0.5"]),
    ("ANN", "BP", {"HPNN_BANK_REFRESH": "1"}, ["--lr", "0.5"]),
    ("SNN", "BPM", {}, []),
])
def test_batch_train_then_run_matches_jax(tmp_path, monkeypatch, capsys, kind,
                                          train, env, lr):
    _setup(tmp_path, monkeypatch, kind, train)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = ["--batch", "8", "--epochs", "6"] + lr
    ref = _drive(jtrain_nn.main, jrun_nn.main, ["--mesh", "1x1"], capsys, args)
    before = dict(batch_step.launches)
    got = _drive(train_nn.main, run_nn.main, ["--device", "cpu"], capsys, args,
                 run_extra=["--device", "cpu"])
    assert batch_step.launches == before  # CPU tensors: no kernel
    ref_ep, got_ep = EPOCH.findall(ref[0]), EPOCH.findall(got[0])
    assert len(ref_ep) == 6 and len(got_ep) == len(ref_ep)
    for r, g in zip(ref_ep, got_ep):
        assert g[0] == r[0] and g[2:] == r[2:]  # epoch, acc, (ok/n)
        assert abs(float(g[1]) - float(r[1])) <= 1e-12
    assert float(got_ep[-1][1]) < float(got_ep[0][1])  # it learns
    assert got[1] == ref[1]  # run_nn --batch stdout
    assert "TESTING FILE" in got[1] and "[PASS]" in got[1]
    assert got[2] == ref[2]  # kernel.tmp
    for a, b in zip(_weights(got[3], tmp_path), _weights(ref[3], tmp_path)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


def test_batch_wrap_warns(tmp_path, monkeypatch, capsys):
    """The tail wrap that re-trains samples each epoch is said on
    stderr, never on the stdout token stream, and only when it happens."""
    _setup(tmp_path, monkeypatch, "ANN", "BP")
    assert train_nn.main(["--device", "cpu", "--batch", "8", "-v", "nn.conf"]) == 0
    cap = capsys.readouterr()
    assert "batch wrap: 6 duplicate sample slots per epoch (n=18, batch=8)" in cap.err
    assert "batch wrap" not in cap.out
    assert train_nn.main(["--device", "cpu", "--batch", "9", "-v", "nn.conf"]) == 0
    cap = capsys.readouterr()
    assert "batch wrap" not in cap.err + cap.out


@pytest.mark.parametrize("argv,msg", [
    (["--epochs", "3"], "syntax error: --epochs requires --batch!\n"),
    (["--lr", "0.1"], "syntax error: --lr requires --batch!\n"),
    (["--batch", "0"], "syntax error: bad --batch parameter!\n"),
    (["--batch", "4", "--lr", "-1"], "syntax error: bad --lr parameter!\n"),
])
def test_batch_option_errors_match_jax(tmp_path, monkeypatch, capsys, argv, msg):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    assert jtrain_nn.main(argv + ["nn.conf"]) != 0
    assert capsys.readouterr().err == msg
    assert train_nn.main(["--device", "cpu"] + argv + ["nn.conf"]) != 0
    assert capsys.readouterr().err == msg
    assert not (tmp_path / "kernel.tmp").exists()


@pytest.mark.parametrize("prog,argv", [
    ("train_nn", ["--batch", "4", "--mesh", "1x1"]),
    ("run_nn", ["--batch", "--mesh", "1x1"]),
])
def test_mesh_with_batch_is_refused(tmp_path, monkeypatch, capsys, prog, argv):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    main = train_nn.main if prog == "train_nn" else run_nn.main
    assert main(["--device", "cpu"] + argv + ["nn.conf"]) != 0
    assert "--mesh is not supported" in capsys.readouterr().err
    assert not (tmp_path / "kernel.tmp").exists()


def test_read_dir_matches_jax(tmp_path, capsys):
    """Unreadable files and files whose dims differ from the first
    readable one are skipped, the latter with the same warning."""
    from hpnn_tpu.utils import logging as jlog
    from hpnn_tpu_torch.utils import logging as log

    d = tmp_path / "s"
    _write_samples(str(d), n=5)
    (d / "zz_dims.txt").write_text("[input] 3\n1 2 3\n[output] 2\n1.0 -1.0\n")
    files = samples.list_sample_files(str(d))
    jlog.set_verbose(1)
    ref = jsamples.read_dir(str(d), files=files)
    ref_err = capsys.readouterr().err
    log.set_verbose(1)
    got = samples.read_dir(str(d), files=files)
    assert capsys.readouterr().err == ref_err
    assert "skipping zz_dims.txt: dims 3x2 != 8x2" in ref_err
    assert got[0] == ref[0] and len(got[0]) == 5
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_accuracy_counts_match_jax(model):
    """The eval quirks (probe -1 / 0, the last target above threshold,
    the is_ok defaults) on outputs built to hit each of them."""
    rng = np.random.default_rng(3)
    out = rng.uniform(-1, 1, (64, 5))
    out[:8] = -1.5                      # nothing above the ANN probe
    out[8:16] = 0.0 if model == "snn" else out[8:16]
    T = -np.ones((64, 5))
    T[np.arange(64), rng.integers(0, 5, 64)] = 1.0
    T[16:20] = -1.0                     # no class above threshold
    T[20:24, 3] = 1.0                   # two classes above threshold
    assert batch.accuracy_counts(out, T, model) == jbatch.accuracy_counts(out, T, model)
    w = [torch.tensor(rng.uniform(-1, 1, (6, 5))), torch.tensor(rng.uniform(-1, 1, (5, 6)))]
    X = torch.tensor(rng.uniform(-1, 1, (64, 5)))
    got = batch.make_device_count_fn(model=model)(w, X, torch.tensor(T))
    ev = jbatch.make_eval_fn(model=model)
    ref = jbatch.accuracy_counts(np.asarray(ev(tuple(np.asarray(a) for a in w),
                                               X.numpy())), T, model)
    assert got == ref
