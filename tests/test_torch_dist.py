"""The rank-0 protocol and the failure rules of a multi-process world
(``parallel/dist.py``), on gloo ranks on the CPU.

* ``[seed] 0`` gives every rank one kernel (rank 0's clock, broadcast).
* A sample directory that differs across ranks stops every rank with
  the JAX package's message.
* A failed ``kernel.tmp`` write on rank 0 ends every rank with -1.
* A rank that raises ends its world within a bounded time, and so does
  one that leaves quietly while its peer waits in a collective.
* ``--mesh 2x1`` without ``--batch`` is refused; ``--mesh 1x2`` on
  ``cuda`` without a card is an error, never a CPU run.

Rank functions live at the top level and import no JAX (the ranks load
this file by path); the JAX modules are imported in the tests.
"""

import contextlib
import io
import os
import sys
import time

import numpy as np
import pytest
import torch

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.parallel import coll, dist, mesh as mesh_mod

HERE = os.path.abspath(__file__)
CONF = ("[name] V\n[type] ANN\n[init] generate\n[seed] {seed}\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] BP\n[sample_dir] {samples}\n"
        "[test_dir] {samples}\n")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: a test elsewhere in this worker may have left one set.
    Clear them all and forget the port's memos before the test; drop
    what the test exported and forget again after it."""
    from hpnn_tpu_torch import obs as port_obs

    for knob in (*runtime.DEFERRED_ENV, *port_obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_PALLAS", *dist.ENV):
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


def _write_samples(d, n):
    rng = np.random.default_rng(3)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        t = np.full(2, -1.0)
        t[i % 2] = 1.0
        with open(os.path.join(d, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n" + " ".join("%7.5f" % v for v in rng.normal(size=8))
                     + "\n[output] 2\n" + " ".join("%.1f" % v for v in t) + "\n")


# ---------------------------------------------------------- rank bodies
def _protocol_rank(mesh, work):
    """Every protocol check of one 2-rank world; returns this rank's
    observations."""
    from hpnn_tpu_torch import config
    from hpnn_tpu_torch.cli import train_nn as cli
    from hpnn_tpu_torch.parallel import dp
    from hpnn_tpu_torch.train import batch, driver
    from hpnn_tpu_torch.utils import logging as log

    rank = mesh.rank
    seen = dict(
        index=runtime.process_index(), count=runtime.process_count(),
        tasks=runtime.runtime().nn_num_tasks,
        mpi=bool(runtime.get_capabilities() & runtime.NNCap.MPI),
        summary=dist.process_summary(), mesh=(mesh.shape, mesh.index))
    # [seed] 0 across a second boundary: rank 1 loads a second later
    conf_path = os.path.join(work, f"seed0_{rank}.conf")
    with open(conf_path, "w") as fp:
        fp.write(CONF.format(seed=0, samples=os.path.join(work, "same")))
    if rank == 1:
        time.sleep(1.1)
    conf = config.load_conf(conf_path)
    seen["seed"] = conf.seed
    seen["kernel"] = [np.asarray(w) for w in conf.kernel.weights]
    # a sample dir that differs across ranks (rank 1 holds one more file)
    mine = os.path.join(work, f"differs{rank}")
    _write_samples(mine, 4 + rank)
    with open(conf_path, "w") as fp:
        fp.write(CONF.format(seed=1234, samples=mine))
    log.set_verbose(2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        seen["train_ok"] = driver.train_kernel(config.load_conf(conf_path),
                                               mesh=mesh, device="cpu")
        seen["batch_ok"] = batch.train_kernel_batched(
            config.load_conf(conf_path), 2, 1, device="cpu", mesh=mesh)
    seen["differs_err"] = err.getvalue()
    # rank 0's kernel.tmp write fails (a directory sits at its path)
    run_dir = os.path.join(work, f"run{rank}")
    os.makedirs(os.path.join(run_dir, "kernel.tmp"))
    cwd = os.getcwd()
    os.chdir(run_dir)
    err = io.StringIO()
    try:
        with open("nn.conf", "w") as fp:
            fp.write(CONF.format(seed=1234, samples=os.path.join(work, "same")))
        if rank == 1:
            os.rmdir("kernel.tmp")   # only rank 0 writes: rank 1's path is free
        with contextlib.redirect_stderr(err):
            seen["write_rc"] = cli._run("nn.conf", {"device": "cpu"}, mesh)
    finally:
        os.chdir(cwd)
    seen["write_err"] = err.getvalue()
    log.set_verbose(0)
    # the divergence sentinel: equal columns agree, a spread is found
    seen["agree"] = dp.divergence_check(["a"], [1.0], [1e-12])
    seen["diverge"] = dp.divergence_check(["a", "b"], [1.0, 2.0 + rank], [1e-12, 1e-12])
    seen["census_same"] = dist.census_consistent(["x", "y"])
    seen["census_differs"] = dist.census_consistent(["x", "y"][:1 + rank])
    # the mesh a batch run makes for itself is on the world's device
    seen["devices"] = (str(mesh.device), str(batch.default_mesh().device))
    seen["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu"))
    return seen


def _raising_rank(mesh):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    coll.psum(torch.ones(3), mesh, mesh_mod.MODEL_AXIS)
    return "unreachable"


def _leaving_rank(mesh):
    """Rank 1 returns at once (exit 0: the launcher kills nobody); rank
    0 waits in a collective that can never complete."""
    if mesh.rank == 1:
        os._exit(0)
    coll.psum(torch.ones(3), mesh, mesh_mod.MODEL_AXIS)
    return "unreachable"


def _coll_rank(mesh):
    x = torch.arange(4, dtype=torch.float64) + 10 * mesh.rank
    return (coll.all_gather(x, mesh, mesh_mod.MODEL_AXIS).tolist(),
            coll.psum(x, mesh, mesh_mod.MODEL_AXIS).tolist(),
            coll.pmean(x, mesh, mesh_mod.DATA_AXIS).tolist(),
            sorted(coll.totals()))


# ---------------------------------------------------------------- tests
def test_rank0_protocol_in_a_2_rank_world(tmp_path, capsys):
    from hpnn_tpu.utils import logging as jlog

    _write_samples(str(tmp_path / "same"), 4)
    got = dist.run(f"{HERE}:_protocol_rank", 2, mesh=(1, 2), args=(str(tmp_path),),
                   device="cpu", timeout=120)
    r0, r1 = got
    for r, seen in enumerate(got):
        assert seen["index"] == r and seen["count"] == 2 and seen["tasks"] == 2
        assert seen["mpi"]
        assert seen["summary"] == f"process {r}/2 local_devices=1 global_devices=2"
        assert seen["mesh"] == ({"data": 1, "model": 2}, {"data": 0, "model": r})
        assert seen["modules"] == []
        assert seen["devices"] == ("cpu", "cpu")
    # one seed, one kernel on both ranks
    assert r0["seed"] == r1["seed"] != 0
    for a, b in zip(r0["kernel"], r1["kernel"]):
        assert np.array_equal(a, b)
    # the differing dir stops every rank; rank 0 alone says so, in the
    # JAX package's words
    assert not any(s["train_ok"] or s["batch_ok"] for s in got)
    buf = io.StringIO()
    jlog.nn_error(buf, "sample dir %s differs across processes (count or order)!\n",
                  os.path.join(str(tmp_path), "differs0"))
    assert buf.getvalue() in r0["differs_err"]
    assert "(count, order, or readable set)" in r0["differs_err"]
    assert r1["differs_err"] == ""
    # rank 0 cannot write kernel.tmp: both ranks end with -1
    assert r0["write_rc"] == r1["write_rc"] == -1
    assert r0["write_err"] == "FAILED to open kernel.tmp for WRITE!\n"
    assert r1["write_err"] == ""
    assert not os.path.exists(tmp_path / "run1" / "kernel.tmp")
    for seen in got:
        assert seen["agree"] == []
        assert [f["tensor"] for f in seen["diverge"]] == ["b"]
        assert seen["census_same"] and not seen["census_differs"]


def test_collectives_on_a_2x2_world():
    got = dist.run(f"{HERE}:_coll_rank", 4, mesh=(2, 2), device="cpu", timeout=120)
    for rank, (gathered, summed, mean, ops) in enumerate(got):
        d = rank // 2
        lo, hi = np.arange(4) + 10 * (2 * d), np.arange(4) + 10 * (2 * d + 1)
        assert gathered == list(np.concatenate([lo, hi]))
        assert summed == list(lo + hi)
        m = rank % 2
        assert mean == list((np.arange(4) + 10 * m + np.arange(4) + 10 * (m + 2)) / 2)
        assert ops == ["all_gather", "pmean", "psum"]


def test_a_raising_rank_ends_its_world_quickly():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        dist.run(f"{HERE}:_raising_rank", 2, mesh=(1, 2), device="cpu", timeout=60)
    assert time.monotonic() - t0 < 45


def test_a_quiet_exit_ends_the_waiting_rank_within_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        dist.run(f"{HERE}:_leaving_rank", 2, mesh=(1, 2), device="cpu", timeout=10)
    assert time.monotonic() - t0 < 45


def test_launch_kills_the_survivors_of_a_failed_rank(tmp_path):
    """A rank that exits non-zero makes the launcher kill the others at
    once (here one that would sleep for minutes)."""
    script = tmp_path / "ranks.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                      "time.sleep(600)\n")
    t0 = time.monotonic()
    assert dist.launch([str(script)], 2) != 0
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("prog", ["train_nn", "run_nn"])
def test_per_sample_mesh_with_a_data_axis_is_refused(tmp_path, monkeypatch, capsys, prog):
    from hpnn_tpu.cli import run_nn as jrun_nn
    from hpnn_tpu.cli import train_nn as jtrain_nn

    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.format(seed=1, samples="./samples"))
    main, jmain = ((train_nn.main, jtrain_nn.main) if prog == "train_nn"
                   else (run_nn.main, jrun_nn.main))
    assert main(["--device", "cpu", "--mesh", "2x1", "nn.conf"]) != 0
    err = capsys.readouterr().err
    assert err.startswith("syntax error: bad --mesh: per-sample training shards")
    assert jmain(["--mesh", "2x1", "nn.conf"]) != 0
    assert capsys.readouterr().err == err
    assert not (tmp_path / "kernel.tmp").exists()


def test_mesh_on_cuda_without_a_card_is_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "nn.conf").write_text(CONF.format(seed=1, samples="./samples"))
    for main in (train_nn.main, run_nn.main):
        assert main(["--mesh", "1x2", "nn.conf"]) != 0
        assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "kernel.tmp").exists()
    # the library entry: a rank asked for cuda raises before it joins
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(dist.free_port()))
    with pytest.raises(runtime.DeviceUnavailable):
        dist.init_world(device="cuda")
    assert runtime.process_count() == 1


def test_outside_a_world_the_protocol_is_the_identity():
    assert runtime.process_index() == 0 and runtime.process_count() == 1
    assert dist.resolve_time_seed(7) == 7
    assert dist.resolve_time_seed(0) > 0
    assert dist.census_consistent(["a"]) and dist.sync_rank0_ok(False) is False
    assert dist.allgather_checksums([1.0, 2.0]).shape == (1, 2)
    m = dist.hybrid_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.group(mesh_mod.MODEL_AXIS) is None
    x = torch.ones(2)
    assert coll.all_gather(x, m, mesh_mod.MODEL_AXIS) is x
    with pytest.raises(ValueError):
        dist.hybrid_mesh(2, device="cpu")


def test_a_mesh_lives_on_the_device_its_world_joined(monkeypatch):
    """Without a card, every parallel entry point that is not told the
    device raises (no rank moves to the CPU quietly); a mesh built in a
    world joined on the CPU is on the CPU without being told."""
    from hpnn_tpu_torch.train import driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.DeviceUnavailable):
        dist.hybrid_mesh()
    with pytest.raises(runtime.DeviceUnavailable):
        mesh_mod.Mesh()
    with pytest.raises(runtime.DeviceUnavailable):
        dist.run(f"{HERE}:_coll_rank", 2, mesh=(1, 2), timeout=10)
    cpu_mesh = mesh_mod.Mesh(device="cpu")
    assert driver._mesh_device(cpu_mesh, None) == driver._mesh_device(cpu_mesh, "cpu") \
        == torch.device("cpu")
    with pytest.raises(runtime.DeviceUnavailable):
        driver._mesh_device(cpu_mesh, "cuda")
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(dist.free_port())).items():
        monkeypatch.setenv(k, v)
    assert dist.init_world(device="cpu") == torch.device("cpu")
    try:
        m = dist.hybrid_mesh()
        assert m.device == torch.device("cpu") and m.group(mesh_mod.MODEL_AXIS) is not None
    finally:
        dist.shutdown()
    with pytest.raises(runtime.DeviceUnavailable):
        dist.hybrid_mesh()


# ------------------------------------------------------------ on the card
def _nccl_world_of_one(mesh):
    x = torch.arange(3, dtype=torch.float32, device=mesh.device)
    return (coll.all_gather(x, mesh, mesh_mod.MODEL_AXIS).cpu().tolist(),
            coll.pmean(x, mesh, mesh_mod.DATA_AXIS).cpu().tolist())


@pytest.mark.cuda
def test_nccl_world_of_one_on_the_card():
    """One NCCL rank: an all_gather and an all-reduce through coll."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (got,) = dist.run(f"{HERE}:_nccl_world_of_one", 1, mesh=(1, 1), device="cuda",
                      timeout=120)
    assert got == ([0.0, 1.0, 2.0], [0.0, 1.0, 2.0])
