"""A run with the timed path broken underneath, or the control in the
program's place, comes out not correct.  Everything but the look for a
card runs as in a benchmark run, at tiny widths on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import control, harness


def _run(workload, tiny):
    cfg = tiny[workload.split(".")[0]]
    return harness.run_cell(workload, 2**31 + 101, 0.0, False, device="cpu", config=cfg)


def test_sound_runs_are_correct(tiny):
    for w in ("mnist_ann.round", "mnist_ann.fleet8", "rruff_ann.fleet8"):
        assert _run(w, tiny)["correct"], w


# ------------------------------------------------------------- the round
@pytest.fixture
def unchanged_round(monkeypatch):
    """#1 trains, prints its tokens, and hands the weights back as they
    were."""
    from hpnn_tpu_torch.ops import convergence

    real = convergence.train_epoch

    def train_epoch(weights, *a, **kw):
        saved = [w.clone() for w in weights]
        out = real(weights, *a, **kw)
        for w, s in zip(weights, saved):
            w.copy_(s)
        return out

    monkeypatch.setattr(convergence, "train_epoch", train_epoch)


def _alter_tokens(monkeypatch, per_round):
    """The third sample of every round prints N_ITER as half the
    iterations it ran."""
    from hpnn_tpu_torch.train import driver

    real, seen = driver._print_train_tokens, []

    def print_tokens(ep0, first_ok, n_iter, *a):
        seen.append(1)
        third = (len(seen) - 1) % per_round == 2
        return real(ep0, first_ok, n_iter // 2 if third else n_iter, *a)

    monkeypatch.setattr(driver, "_print_train_tokens", print_tokens)


@pytest.mark.parametrize("workload", ["mnist_ann.round"])
def test_round_state_unchanged(workload, tiny, unchanged_round):
    r = _run(workload, tiny)
    assert not r["correct"] and r["checks"]["w_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["mnist_ann.round"])
def test_round_token_altered(workload, tiny, monkeypatch):
    _alter_tokens(monkeypatch, tiny[workload.split(".")[0]]["samples_per_round"])
    r = _run(workload, tiny)
    assert not r["correct"]


# ------------------------------------------------------------- the fleet
@pytest.fixture
def unchanged_fleet(monkeypatch):
    from hpnn_tpu_torch.ops import batch_step

    real = batch_step.train_fleet_epoch_dbuf_banked

    def epoch(weights, dw, *a, **kw):
        saved = [w.clone() for w in tuple(weights) + tuple(dw)]
        out = real(weights, dw, *a, **kw)
        for w, s in zip(tuple(weights) + tuple(dw), saved):
            w.copy_(s)
        return out

    monkeypatch.setattr(batch_step, "train_fleet_epoch_dbuf_banked", epoch)


@pytest.fixture
def half_batch(monkeypatch):
    """Each step's mean taken over the first half of its rows."""
    from hpnn_tpu_torch.parallel import dp

    real = dp.train_step_math

    def step(weights, dw, X, T, **kw):
        h = X.shape[0] // 2
        return real(weights, dw, X[:h], T[:h], **kw)

    monkeypatch.setattr(dp, "train_step_math", step)


@pytest.fixture
def loss_altered(monkeypatch):
    """The first member's first loss of each epoch off by 1%."""
    from hpnn_tpu_torch.ops import batch_step

    real = batch_step.train_fleet_epoch_dbuf_banked

    def epoch(*a, **kw):
        w, dw, losses = real(*a, **kw)
        losses[0, 0] *= 1.01
        return w, dw, losses

    monkeypatch.setattr(batch_step, "train_fleet_epoch_dbuf_banked", epoch)


@pytest.mark.parametrize("workload", ["mnist_ann.fleet8", "rruff_ann.fleet8"])
@pytest.mark.parametrize("fault", ["unchanged_fleet", "half_batch", "loss_altered"])
def test_fleet_faults(workload, fault, tiny, request):
    request.getfixturevalue(fault)
    assert not _run(workload, tiny)["correct"]


# ------------------------------------------------------------- the control
@pytest.mark.parametrize("workload", ["mnist_ann.round", "mnist_ann.fleet8",
                                      "rruff_ann.fleet8"])
def test_control_is_not_correct(workload, tiny):
    """The reference in TF32 in the program's place fails a limit."""
    limits = harness.load_json("limits", workload + ".json")
    got = control.stand_ins(workload, 2**31 + 101, "cpu", ["control"],
                            tiny[workload.split(".")[0]])[0]
    assert any(got[k] > v for k, v in limits.items() if k in got), got


@pytest.mark.cuda
def test_the_card_runs_a_cell(card):
    r = harness.run_cell("rruff_ann.fleet8", 2**31 + 9, 1.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert np.isfinite(r["metrics"]["fleet_rows_per_s"]["value"])
    assert torch.cuda.max_memory_allocated() > 0
