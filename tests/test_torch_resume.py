"""Crash-resume (``HPNN_FUSE_STATE``) and the streaming per-sample loop
(``HPNN_FUSE_EPOCH=0``, ``HPNN_PALLAS=1``) of the port, on the CPU in
float64, held against the JAX package.

The per-sample cases mirror ``tests/test_end_to_end.py``'s
(``test_fused_round_stall_halves_chunk``, ``test_fused_round_crash_resume``,
``test_checkpoint_not_adopted_by_cont_round``,
``test_fused_round_body_binds_checkpoint_key``,
``test_fused_round_chunked_matches_streaming``) and the batch cases
``tests/test_batch.py``'s ``HPNN_FUSE_STATE`` cases and
``test_batch_checkpoint_key_binds_hyperparams``.  A launch error is a
``RuntimeError`` (what a failed CUDA launch raises); a kill that runs no
handler is modelled by ``KeyboardInterrupt``.  Bars: token streams and
``kernel.tmp`` byte-identical, ``kernel.opt`` bytes equal to the port's
uninterrupted run and within 1e-12 of the JAX package's weights.
"""

import os
import re

import numpy as np
import pytest

from hpnn_tpu.cli import train_nn as jtrain_nn
from hpnn_tpu.train import batch as jbatch
from hpnn_tpu_torch import config, runtime
from hpnn_tpu_torch.cli import train_nn
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType
from hpnn_tpu_torch.fileio import kernel_format
from hpnn_tpu_torch.fileio import samples as sample_io
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.ops import batch_step
from hpnn_tpu_torch.parallel import dp
from hpnn_tpu_torch.train import batch, driver, loop
from hpnn_tpu_torch.utils import logging as log

CONF = ("[name] E2E\n[type] {kind}\n[init] generate\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] {train}\n[sample_dir] ./samples\n"
        "[test_dir] ./samples\n")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: clear them all and forget the port's memos around the test;
    drop what the test exported after it."""
    from hpnn_tpu_torch import obs as port_obs

    for knob in (*runtime.DEFERRED_ENV, *port_obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_FUSE_CHUNK", "HPNN_PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    port_obs._reset_for_tests()
    yield
    for knob in port_obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    port_obs._reset_for_tests()
    log.set_verbose(0)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """20 samples of two separated classes in 8 dims (the JAX package's
    end-to-end fixture, the same seed), and the cwd set there."""
    rng = np.random.default_rng(42)
    samples = tmp_path / "samples"
    samples.mkdir()
    centers = np.array([[1.0] * 4 + [-1.0] * 4, [-1.0] * 4 + [1.0] * 4])
    for i in range(20):
        c = i % 2
        x = centers[c] + 0.1 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(samples / f"s{i:05d}.txt", "w") as fp:
            fp.write("[input] 8\n" + " ".join("%7.5f" % v for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join("%.1f" % v for v in t) + "\n")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _conf(workdir, kind="ANN", train="BP"):
    p = workdir / "nn.conf"
    p.write_text(CONF.format(kind=kind, train=train))
    return str(p)


def _training_lines(s):
    return [ln for ln in s.splitlines() if "TRAINING FILE" in ln]


def _run_cli(main, argv, capsys):
    """One CLI run: (stdout, kernel.tmp text, kernel.opt text)."""
    assert main(argv) == 0
    out = capsys.readouterr().out
    return out, open("kernel.tmp").read(), open("kernel.opt").read()


def _opt_weights(text, tmp_path):
    p = tmp_path / "w.opt"
    p.write_text(text)
    return kernel_format.load_kernel(str(p))[1]


# ---------------------------------------------------------------- per-sample
def test_fused_round_stall_halves_chunk(workdir, capsys, monkeypatch):
    """A launch killed with no handler run must still shrink the chunk:
    each resume that finds no progress since the last one halves it."""
    log.set_verbose(2)
    conf_path = _conf(workdir)
    state = workdir / "round.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "128")

    def killed_epoch(*a, **kw):
        raise KeyboardInterrupt  # models SIGKILL: no handler runs

    real_epoch = loop.train_epoch
    monkeypatch.setattr(loop, "train_epoch", killed_epoch)
    for want_chunk in (128, 64, 32):  # the first save, then two halvings
        with pytest.raises(KeyboardInterrupt):
            driver.train_kernel(config.load_conf(conf_path), device="cpu")
        with np.load(state, allow_pickle=False) as z:
            assert int(z["chunk"]) == want_chunk
            assert int(z["done"]) == 0
    capsys.readouterr()

    monkeypatch.setattr(loop, "train_epoch", real_epoch)
    monkeypatch.setenv("HPNN_FUSE_EPOCH", "0")
    monkeypatch.delenv("HPNN_FUSE_STATE")
    assert train_nn.main(["--device", "cpu", "-v", "-v", "-v", conf_path]) == 0
    want = capsys.readouterr().out
    monkeypatch.setenv("HPNN_FUSE_EPOCH", "1")
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    assert driver.train_kernel(config.load_conf(conf_path), device="cpu") is True
    got = capsys.readouterr().out
    assert len(_training_lines(want)) == 20
    assert _training_lines(got) == _training_lines(want)
    assert not state.exists()


@pytest.mark.parametrize("kind,train,chunk,crash_at", [
    ("ANN", "BP", 128, 1), ("ANN", "BP", 8, 2), ("SNN", "BPM", 8, 2)])
def test_fused_round_crash_resume(workdir, tmp_path, capsys, monkeypatch,
                                  kind, train, chunk, crash_at):
    """A round whose chunk ``crash_at`` raises resumes from the
    checkpoint: the two attempts' token streams concatenated and
    ``kernel.opt`` equal an uninterrupted port round's, the tokens and
    ``kernel.tmp`` equal the JAX package's, its weights within 1e-12."""
    conf_path = _conf(workdir, kind, train)
    argv = ["-v", "-v", "-v", conf_path]
    monkeypatch.setenv("HPNN_FUSE_CHUNK", str(chunk))
    jout, jtmp, jopt = _run_cli(jtrain_nn.main, argv, capsys)
    want, want_tmp, want_opt = _run_cli(train_nn.main, ["--device", "cpu"] + argv, capsys)
    assert want_tmp == jtmp
    assert _training_lines(want) == _training_lines(jout)

    state = workdir / "round.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    real_epoch = loop.train_epoch
    calls = {"n": 0}

    def dying_epoch(*a, **kw):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise RuntimeError("convergence kernel launch failed (simulated)")
        return real_epoch(*a, **kw)

    monkeypatch.setattr(loop, "train_epoch", dying_epoch)
    with pytest.raises(RuntimeError, match="simulated"):
        train_nn.main(["--device", "cpu"] + argv)
    part1 = capsys.readouterr().out
    tmp1 = open("kernel.tmp").read()
    # the crash handler's checkpoint: the chunks before the crash done,
    # the chunk hint halved (not below 32, or the configured size when
    # smaller), the weights of the last checkpoint
    with np.load(state, allow_pickle=False) as z:
        assert int(z["done"]) == chunk * (crash_at - 1)
        assert int(z["chunk"]) == max(min(32, chunk), chunk // 2)

    monkeypatch.setattr(loop, "train_epoch", real_epoch)
    part2, tmp2, opt2 = _run_cli(train_nn.main, ["--device", "cpu"] + argv, capsys)
    assert _training_lines(part1 + part2) == _training_lines(want)
    assert tmp1 == tmp2 == jtmp
    assert opt2 == want_opt
    assert not state.exists()  # a completed round cleans up
    for a, b in zip(_opt_weights(opt2, tmp_path), _opt_weights(jopt, tmp_path)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_checkpoint_not_adopted_by_cont_round(workdir, capsys, monkeypatch):
    """With ``[seed] 0``, a leftover checkpoint of a generate round over
    the same dir and topology is not adopted by a continued round
    (``[init] kernel.opt``): the starting weights are in the key."""
    conf_path = _conf(workdir)
    state = workdir / "round.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    log.set_verbose(2)
    conf0 = config.load_conf(conf_path)
    assert driver.train_kernel(conf0, device="cpu") is True
    with open("kernel.opt", "w") as fp:
        config.dump_kernel(conf0, fp)
    shapes = tuple(tuple(int(d) for d in np.asarray(w).shape)
                   for w in conf0.kernel.weights)
    key0 = driver._fuse_state_key(str(workdir / "samples"), "ann", False, shapes,
                                  "plain/generate")
    driver._save_fuse_state(str(state), key0, conf0.seed, 5, 16,
                            [np.zeros(s) for s in shapes])
    capsys.readouterr()
    cont = workdir / "cont.conf"
    cont.write_text(open(conf_path).read()
                    .replace("[init] generate", "[init] kernel.opt")
                    .replace("[seed] 1234", "[seed] 0"))
    assert driver.train_kernel(config.load_conf(str(cont)), device="cpu") is True
    out = capsys.readouterr().out
    assert out.count("TRAINING FILE") == 20
    assert not state.exists()


def test_fused_round_body_binds_checkpoint_key(workdir, capsys, monkeypatch):
    """A checkpoint written by one body (the CUDA kernel or the plain
    version) is not adopted by a round on the other; the same body
    resumes it."""
    log.set_verbose(2)
    conf_path = _conf(workdir)
    state = workdir / "round.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "8")
    real_epoch = loop.train_epoch
    calls = {"n": 0}

    def dying_epoch(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("convergence kernel launch failed (simulated)")
        return real_epoch(*a, **kw)

    def crash_once():
        calls["n"] = 0
        monkeypatch.setattr(loop, "train_epoch", dying_epoch)
        with pytest.raises(RuntimeError):
            driver.train_kernel(config.load_conf(conf_path), device="cpu")
        monkeypatch.setattr(loop, "train_epoch", real_epoch)
        capsys.readouterr()
        with np.load(state, allow_pickle=False) as z:
            assert int(z["done"]) == 8  # one chunk survived

    crash_once()
    # the other body's round: a fresh start over all 20 samples
    monkeypatch.setattr(driver, "_body_of", lambda dev: "cuda-kernel")
    assert driver.train_kernel(config.load_conf(conf_path), device="cpu") is True
    assert len(_training_lines(capsys.readouterr().out)) == 20
    # the same body: resumes after the surviving chunk
    monkeypatch.setattr(driver, "_body_of", lambda dev: "plain")
    crash_once()
    assert driver.train_kernel(config.load_conf(conf_path), device="cpu") is True
    assert len(_training_lines(capsys.readouterr().out)) == 12
    assert not state.exists()


@pytest.mark.parametrize("knob", [("HPNN_FUSE_EPOCH", "0"), ("HPNN_PALLAS", "1")])
@pytest.mark.parametrize("kind,train", [("ANN", "BP"), ("SNN", "BPM")])
def test_streaming_matches_chunked_and_jax(workdir, capsys, monkeypatch, knob,
                                           kind, train):
    """The streaming loop (one one-row launch a sample) prints the
    chunked round's tokens and writes its kernel.opt, byte for byte,
    and the JAX package's streaming path prints the same tokens."""
    conf_path = _conf(workdir, kind, train)
    argv = ["-v", "-v", "-v", conf_path]
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "3")
    chunked = _run_cli(train_nn.main, ["--device", "cpu"] + argv, capsys)
    monkeypatch.delenv("HPNN_FUSE_CHUNK")
    monkeypatch.setenv("HPNN_FUSE_EPOCH", "0")
    jout, jtmp, _ = _run_cli(jtrain_nn.main, argv, capsys)
    monkeypatch.delenv("HPNN_FUSE_EPOCH")
    monkeypatch.setenv(*knob)
    rows = []
    real_epoch = loop.train_epoch

    def spy(weights, X, *a, **kw):
        rows.append(int(X.shape[0]))
        return real_epoch(weights, X, *a, **kw)

    monkeypatch.setattr(loop, "train_epoch", spy)
    streamed = _run_cli(train_nn.main, ["--device", "cpu"] + argv, capsys)
    assert rows == [1] * 20  # one launch a sample
    assert streamed == chunked
    assert streamed[0].count("N_ITER=") == 20
    assert _training_lines(streamed[0]) == _training_lines(jout)
    assert streamed[1] == jtmp


# --------------------------------------------------------------------- batch
def _write_batch_samples(d, n, snn=False):
    """tests/test_batch.py's data: two clusters, 8 inputs, 2 outputs."""
    rng = np.random.RandomState(0)
    centers = np.stack([np.r_[np.ones(4), -np.ones(4)], np.r_[-np.ones(4), np.ones(4)]])
    d.mkdir()
    for i in range(n):
        c = i % 2
        x = centers[c] + 0.1 * rng.normal(size=8)
        t = np.full(2, 0.0 if snn else -1.0)
        t[c] = 1.0
        with open(d / f"s{i:05d}.txt", "w") as fp:
            fp.write("[input] 8\n" + " ".join(f"{v:.5f}" for v in x) + "\n")
            fp.write("[output] 2\n" + " ".join(f"{v:.1f}" for v in t) + "\n")


def _batch_conf(tmp_path, snn=False, train=NNTrain.BP, n=24):
    sdir = tmp_path / "samples"
    if not sdir.exists():
        _write_batch_samples(sdir, n, snn=snn)
    k, _ = kernel_mod.generate(777, 8, [6], 2)
    return NNConf(name="t", type=NNType.SNN if snn else NNType.ANN, seed=1,
                  kernel=k, train=train, samples=str(sdir), tests=str(sdir))


def _jconf(conf):
    """The same round as a JAX package conf."""
    from hpnn_tpu import config as jconfig
    from hpnn_tpu.models import kernel as jkm

    return jconfig.NNConf(
        name=conf.name, type=jconfig.NNType(int(conf.type)), seed=conf.seed,
        kernel=jkm.Kernel(tuple(np.asarray(w) for w in conf.kernel.weights)),
        train=jconfig.NNTrain(int(conf.train)), samples=conf.samples,
        tests=conf.tests)


def _epoch_lines(s):
    return [ln for ln in s.splitlines() if "BATCH EPOCH" in ln]


def _plant_batch_state(state, conf, *, B, epochs, cap, momentum=False, model="ann"):
    """A checkpoint at epoch 0 whose block cap is ``cap`` (the resume
    then walks blocks of ``cap`` epochs)."""
    weights = [np.asarray(w) for w in conf.kernel.weights]
    key = batch._batch_state_key(
        conf.samples, model, momentum, tuple(w.shape for w in weights), B,
        dp.default_lr(model, momentum), epochs, "plain-bank8/generate",
        names=sample_io.list_sample_files(conf.samples))
    driver._save_fuse_state(str(state), key, conf.seed, 0, cap,
                            weights + ([np.zeros_like(w) for w in weights]
                                       if momentum else []))


@pytest.mark.parametrize("snn,train", [
    (False, NNTrain.BP), (False, NNTrain.BPM), (True, NNTrain.BP),
    (True, NNTrain.BPM)])
def test_batch_crash_resume(tmp_path, capsys, monkeypatch, snn, train):
    """A batch run whose 4th epoch launch raises resumes from the
    checkpoint of its last block: the epoch tokens continue the
    numbering, and the weights equal an uninterrupted port run's bitwise
    and the JAX package's within 1e-12."""
    log.set_verbose(2)
    from hpnn_tpu.utils import logging as jlog

    jlog.set_verbose(2)
    epochs = 6
    conf = _batch_conf(tmp_path, snn=snn, train=train)
    jc = _jconf(conf)
    assert jbatch.train_kernel_batched(jc, batch_size=8, epochs=epochs, mesh_spec="1x1")
    jwant = capsys.readouterr().out
    assert batch.train_kernel_batched(conf, batch_size=8, epochs=epochs, device="cpu")
    want = capsys.readouterr().out
    assert _epoch_lines(want) == _epoch_lines(jwant)

    state = tmp_path / "batch.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    model = "snn" if snn else "ann"
    momentum = train == NNTrain.BPM
    # blocks of one epoch, so that each launch is checkpointed
    _plant_batch_state(state, _batch_conf(tmp_path, snn, train), B=8, epochs=epochs,
                       cap=1, momentum=momentum, model=model)
    real = batch_step.train_epoch_grid_banked
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("batch-step kernel launch failed (simulated)")
        return real(*a, **kw)

    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", dying)
    with pytest.raises(RuntimeError, match="simulated"):
        batch.train_kernel_batched(_batch_conf(tmp_path, snn, train), batch_size=8,
                                   epochs=epochs, device="cpu")
    part1 = capsys.readouterr().out
    with np.load(state, allow_pickle=False) as z:
        assert int(z["done"]) == 3  # three epochs survived the crash
    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", real)
    c3 = _batch_conf(tmp_path, snn, train)
    assert batch.train_kernel_batched(c3, batch_size=8, epochs=epochs, device="cpu")
    part2 = capsys.readouterr().out
    assert len(_epoch_lines(want)) == epochs
    assert _epoch_lines(part1) + _epoch_lines(part2) == _epoch_lines(want)
    assert not state.exists()
    for a, b, j in zip(c3.kernel.weights, conf.kernel.weights, jc.kernel.weights):
        assert np.array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(j), rtol=0, atol=1e-12)


def test_batch_stall_halves_dispatch_cap(tmp_path, capsys, monkeypatch):
    """A batch launch killed with no handler run shrinks the block cap
    on each resume without progress, as the JAX package's does; a
    surviving attempt then matches an uninterrupted run."""
    log.set_verbose(2)
    conf = _batch_conf(tmp_path)
    state = tmp_path / "batch.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))

    def killed(*a, **kw):
        raise KeyboardInterrupt  # models SIGKILL: no handler runs

    real = batch_step.train_epoch_grid_banked
    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", killed)
    # n=24, B=8: 3 steps, cap 65536 // 3 = 21845 rounded down to whole
    # refresh groups of 8; each stalled resume halves, then re-rounds
    for want_cap in (21840, 10920, 5456):
        with pytest.raises(KeyboardInterrupt):
            batch.train_kernel_batched(_batch_conf(tmp_path), batch_size=8,
                                       epochs=6, device="cpu")
        with np.load(state, allow_pickle=False) as z:
            assert int(z["chunk"]) == want_cap
            assert int(z["done"]) == 0
    capsys.readouterr()
    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", real)
    c2 = _batch_conf(tmp_path)
    assert batch.train_kernel_batched(c2, batch_size=8, epochs=6, device="cpu")
    got = capsys.readouterr().out
    monkeypatch.delenv("HPNN_FUSE_STATE")
    assert batch.train_kernel_batched(conf, batch_size=8, epochs=6, device="cpu")
    want = capsys.readouterr().out
    assert len(_epoch_lines(want)) == 6 and _epoch_lines(got) == _epoch_lines(want)
    for a, b in zip(c2.kernel.weights, conf.kernel.weights):
        assert np.array_equal(a, b)
    assert not state.exists()


def test_bank_sub_refresh_cap_resumes_exactly(tmp_path, capsys, monkeypatch):
    """A block cap below the refresh period (3 < 8) walks sub-group
    blocks (3/3/2 | 3/3/2 | 3/1) and still reproduces the uninterrupted
    run's tokens and weights exactly."""
    log.set_verbose(2)
    epochs = 20
    c1 = _batch_conf(tmp_path)
    assert batch.train_kernel_batched(c1, batch_size=8, epochs=epochs, device="cpu")
    want = capsys.readouterr().out
    state = tmp_path / "b.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    _plant_batch_state(state, _batch_conf(tmp_path), B=8, epochs=epochs, cap=3)
    monkeypatch.setenv("HPNN_TRACE", "1")  # one #DBG line set a block end
    from hpnn_tpu_torch.utils import trace

    trace._reset_for_tests()
    c2 = _batch_conf(tmp_path)
    assert batch.train_kernel_batched(c2, batch_size=8, epochs=epochs, device="cpu")
    got = capsys.readouterr().out
    blocks = [int(e) for e in re.findall(r"#DBG: acc\[w@(\d+)/0\]", got)]
    assert blocks == [3, 6, 8, 11, 14, 16, 19, 20]
    assert _epoch_lines(got) == _epoch_lines(want) and len(_epoch_lines(want)) == epochs
    for a, b in zip(c1.kernel.weights, c2.kernel.weights):
        assert np.array_equal(a, b)


def test_batch_checkpoint_key_binds_hyperparams(tmp_path, capsys, monkeypatch):
    """A batch checkpoint of another batch size is not adopted (the key
    binds B, lr and the epoch count)."""
    log.set_verbose(2)
    conf = _batch_conf(tmp_path)
    state = tmp_path / "batch.state"
    monkeypatch.setenv("HPNN_FUSE_STATE", str(state))
    _plant_batch_state(state, conf, B=8, epochs=4, cap=1)
    real = batch_step.train_epoch_grid_banked
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("batch-step kernel launch failed (simulated)")
        return real(*a, **kw)

    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", dying)
    with pytest.raises(RuntimeError):
        batch.train_kernel_batched(_batch_conf(tmp_path), batch_size=8, epochs=4,
                                   device="cpu")
    monkeypatch.setattr(batch_step, "train_epoch_grid_banked", real)
    with np.load(state, allow_pickle=False) as z:
        assert int(z["done"]) == 2
    capsys.readouterr()
    # B=4 over the same dir and topology: another key, no adoption: all
    # 4 epochs train, numbered from 1
    assert batch.train_kernel_batched(_batch_conf(tmp_path), batch_size=4, epochs=4,
                                      device="cpu")
    lines = _epoch_lines(capsys.readouterr().out)
    assert len(lines) == 4 and "   1 " in lines[0]
