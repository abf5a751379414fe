"""The serve router's tensor-parallel spill through both packages on the
CPU in float64.

A row block larger than the bucket menu skips the replicas: the JAX
router runs it through ``tp.make_batched_run_fn`` over the 8 virtual
CPU devices of ``tests/conftest.py``; the port's through
``tp.make_spill_forward`` with the kernel's rows split into 4 blocks on
the CPU.  The answers agree within 4.4e-16 (the serve tests' bar), and
the ``router.spill`` counter and ``router.spill_time`` timer carry the
JAX package's fields.
"""

import json
import os

import numpy as np
import pytest

from hpnn_tpu import obs as jobs
from hpnn_tpu import serve as jserve
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu_torch import obs, runtime, serve
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.parallel import tp


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """The port refuses the knobs of the JAX package's unported planes
    (runtime.DEFERRED_ENV), and its own obs knobs are memoized process
    state: a test elsewhere in this worker may have left one set.
    Clear them all and forget the port's memos before the test; drop
    what the test exported and forget again after it."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, "HPNN_SERVE_SPILL"):
        monkeypatch.delenv(knob, raising=False)
    obs._reset_for_tests()
    yield
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    obs._reset_for_tests()
    jobs._reset_for_tests()


def _kernel(pkg, model):
    k, _ = pkg.generate(7, 12, [9], 5)
    return k


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_spill_matches_the_jax_router(model):
    rows = np.random.default_rng(0).normal(size=(100, 12))
    theirs = jserve.Router(spill=True, max_batch=16)
    mine = serve.Router(spill=True, spill_devices=["cpu"] * 4, device="cpu",
                        max_batch=16)
    try:
        theirs.registry.register("k", _kernel(jkm, model), model=model)
        mine.registry.register("k", _kernel(km, model), model=model)
        a = np.asarray(theirs.infer("k", rows))
        b = np.asarray(mine.infer("k", rows))
        assert a.shape == b.shape == (100, 5)
        assert np.abs(a - b).max() <= 4.4e-16
        assert mine.health()["router"]["spilled_kernels"] == ["k"]
        # a block the bucket menu holds goes to a replica, bitwise the
        # replica's answer
        small = rows[:8]
        np.testing.assert_array_equal(np.asarray(mine.infer("k", small)),
                                      np.asarray(mine.replicas[0].infer("k", small)))
    finally:
        theirs.close()
        mine.close()


def test_spill_forward_is_the_forward_at_any_split():
    """1, 2, 3 and 4 blocks (padding 9 hidden and 5 output rows) give
    the unsplit forward's answers."""
    k = _kernel(km, "snn")
    rows = np.random.default_rng(1).normal(size=(33, 12))
    ref = tp.make_spill_forward(k.weights, ["cpu"], model="snn", n_out=5)(rows)
    for n in (2, 3, 4):
        got = tp.make_spill_forward(k.weights, ["cpu"] * n, model="snn", n_out=5)(rows)
        assert np.abs(got - ref).max() <= 4.4e-16
    assert np.allclose(ref.sum(axis=1), 1.0)


def test_spill_counts_and_times_as_the_jax_router(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_METRICS", str(tmp_path / "m.jsonl"))
    monkeypatch.setenv("HPNN_SERVE_SPILL", "1")
    obs._reset_for_tests()
    mine = serve.Router(device="cpu", max_batch=16)
    try:
        mine.registry.register("k", _kernel(km, "ann"), model="ann")
        mine.infer("k", np.zeros((40, 12)))
    finally:
        mine.close()
    obs.flush()
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    spill = [r for r in recs if r["ev"] == "router.spill"]
    timer = [r for r in recs if r["ev"] == "router.spill_time"]
    assert [(r["kind"], r["kernel"], r["rows"]) for r in spill] == [("count", "k", 40)]
    assert [(r["kind"], r["kernel"], r["rows"]) for r in timer] == [("timer", "k", 40)]
