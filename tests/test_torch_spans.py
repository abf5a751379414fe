"""The port's spans on a profiler's clock (``hpnn_tpu_torch/obs/spans.py``),
on the CPU.

* a per-sample ``train_nn`` round under a ``torch.profiler`` that another
  module started: the round's spans are ranges of the host timeline,
  nested as the layers are, counted in ``spans.totals()``, and the
  round's stdout and ``kernel.opt`` are byte for byte those of the same
  round with no profiler;
* a ``train_fleet`` call under the profiler: one ``fleet.epoch`` and one
  ``fleet.count`` an epoch, one ``fleet.gather`` a refresh group, every
  part inside ``train.fleet_round``, and the losses, counts and weights
  bitwise those of an untraced call;
* a span handed to another thread: counted, no range, nothing raised;
* the span table and ``profiler.collecting()`` outside a profiler.
"""

import os
import threading

import numpy as np
import pytest
import torch

from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.cli import train_nn
from hpnn_tpu_torch.models.kernel import Kernel
from hpnn_tpu_torch.obs import profiler, spans
from hpnn_tpu_torch.train import fleet
from hpnn_tpu_torch.utils import logging as log

CONF = ("[name] V\n[type] ANN\n[init] generate\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] BP\n[sample_dir] ./samples\n")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """No obs knob set, and the port's memos (the span table among them)
    forgotten around the test."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_FUSE_CHUNK", "HPNN_PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    obs._reset_for_tests()
    yield
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    obs._reset_for_tests()
    log.set_verbose(0)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof):
    """``{name: [(start_ns, end_ns), ...]}`` of the host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.setdefault(e.name(), []).append((start, start + e.duration_ns()))
    return out


def _inside(inner, outer):
    return any(s0 <= s and e <= e0 for s0, e0 in outer for s, e in [inner])


def _write_samples(d, n=6, seed=42):
    rng = np.random.default_rng(seed)
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


def _round(tmp_path, name, capsys, traced):
    """One round in its own directory; (stdout, kernel.opt bytes, the
    profiler or None)."""
    d = tmp_path / name
    d.mkdir()
    _write_samples(str(d / "samples"))
    (d / "nn.conf").write_text(CONF)
    os.chdir(d)
    capsys.readouterr()
    if traced:
        with _profile() as prof:
            assert train_nn.main(["--device", "cpu", "-v", "-v", "nn.conf"]) == 0
    else:
        prof = None
        assert train_nn.main(["--device", "cpu", "-v", "-v", "nn.conf"]) == 0
    return capsys.readouterr().out, (d / "kernel.opt").read_bytes(), prof


def test_round_spans_nest_on_the_profiler_clock(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HPNN_FUSE_CHUNK", "2")   # three chunks of the 6 samples
    monkeypatch.chdir(tmp_path)
    out0, opt0, _ = _round(tmp_path, "plain", capsys, traced=False)
    assert spans.totals() == {}   # no profiler, no HPNN_SPANS: nothing real
    out1, opt1, prof = _round(tmp_path, "traced", capsys, traced=True)
    assert out1 == out0 and opt1 == opt0
    got = _ranges(prof)
    root = got["train_nn.round"]
    assert len(root) == 1
    for name, n in (("io.conf_load", 1), ("io.kernel_dump", 2), ("train.samples", 1),
                    ("train.round", 1), ("train.chunk", 3), ("train.tokens", 3)):
        assert len(got[name]) == n, name
        assert all(_inside(r, root) for r in got[name]), name
    for name in ("train.chunk", "train.tokens"):
        assert all(_inside(r, got["train.round"]) for r in got[name]), name
    # the parts follow each other: conf, kernel.tmp, samples, round, kernel.opt
    firsts = [got["io.conf_load"][0], min(got["io.kernel_dump"]), got["train.samples"][0],
              got["train.round"][0], max(got["io.kernel_dump"])]
    assert all(a[1] <= b[0] for a, b in zip(firsts, firsts[1:]))
    table = spans.totals()
    for name, ranges in got.items():
        if name in table:
            assert table[name][0] == len(ranges), name
    assert {"train_nn.round", "io.conf_load", "io.kernel_dump", "train.samples",
            "train.round", "train.chunk", "train.tokens"} <= set(table)
    assert all(s > 0 for _, s in table.values())


def _fleet_call(n=3, epochs=4, refresh=2):
    rng = np.random.RandomState(5)
    kernels = [Kernel((rng.uniform(-1, 1, (5, 8)), rng.uniform(-1, 1, (2, 5))))
               for _ in range(n)]
    X = rng.uniform(-1, 1, (32, 8))
    T = np.full((32, 2), -1.0)
    T[np.arange(32), rng.randint(0, 2, 32)] = 1.0
    return fleet.train_fleet(kernels, X, T, epochs=epochs, batch=8, seeds=[3, 4, 5],
                             momentum=True, lr=0.3, refresh=refresh, device="cpu")


def test_fleet_spans_count_epochs_and_groups():
    ref_k, ref_l, ref_c = _fleet_call()
    assert spans.totals() == {}
    with _profile() as prof:
        got_k, got_l, got_c = _fleet_call()
    assert got_l.tobytes() == ref_l.tobytes() and got_c.tobytes() == ref_c.tobytes()
    for a, b in zip(got_k, ref_k):
        assert all(wa.tobytes() == wb.tobytes() for wa, wb in zip(a.weights, b.weights))
    table = spans.totals()
    assert table["train.fleet_round"][0] == 1
    assert table["fleet.epoch"][0] == 4 and table["fleet.count"][0] == 4
    assert table["fleet.gather"][0] == 2   # 4 epochs in refresh groups of 2
    for name in ("fleet.stage", "fleet.plan", "fleet.sync", "fleet.result"):
        assert table[name][0] == 1, name
    got = _ranges(prof)
    root = got["train.fleet_round"]
    for name in ("fleet.stage", "fleet.plan", "fleet.gather", "fleet.epoch",
                 "fleet.count", "fleet.sync", "fleet.result"):
        assert len(got[name]) == table[name][0], name
        assert all(_inside(r, root) for r in got[name]), name


def test_fleet_epoch_span_names_its_team(monkeypatch):
    """A ``fleet.epoch`` span ends with the team of its launch of #6
    (``batch_step.fleet_team``); on the CPU the plain version launches
    nothing, and the span names no team."""
    from hpnn_tpu_torch.ops import batch_step

    ended = []
    real_finish = spans.finish

    def finish(sp, **fields):
        if isinstance(sp, spans.Span) and sp.name == "fleet.epoch":
            ended.append(dict(sp.fields, **fields))
        return real_finish(sp, **fields)

    monkeypatch.setattr(spans, "finish", finish)
    monkeypatch.setattr(batch_step, "fleet_team", None)
    with _profile():
        _fleet_call()
    assert len(ended) == 4 and not any("team" in f for f in ended)
    real = batch_step.train_fleet_epoch_dbuf_banked

    def launched(*args, **kw):   # as a launch on the grid would leave it
        out = real(*args, **kw)
        batch_step.fleet_team = "grid"
        return out

    monkeypatch.setattr(batch_step, "train_fleet_epoch_dbuf_banked", launched)
    ended.clear()
    with _profile():
        _fleet_call()
    assert [(f["team"], f["members"]) for f in ended] == [("grid", 3)] * 4


def test_span_finished_on_another_thread():
    errors = []

    def finish(sp):
        try:
            spans.finish(sp, where="other")
        except Exception as exc:   # the test's own report of a raise
            errors.append(exc)

    with _profile() as prof:
        assert profiler.collecting()
        sp = spans.start("handoff.x")
        assert isinstance(sp, spans.Span)
        t = threading.Thread(target=finish, args=(sp,))
        t.start()
        t.join()
    assert errors == []
    assert spans.totals()["handoff.x"][0] == 1
    assert "handoff.x" not in _ranges(prof)


def test_span_open_across_the_profiler_edges():
    """A span entered before a profiler starts opens no range; one
    entered under it and closed after it stops closes quietly; both
    count."""
    with spans.span("edge.before") as before:
        assert before is spans._NULL_SPAN   # not real: nothing collects yet
        prof = _profile()
        prof.__enter__()
        with spans.span("edge.inside"):
            late = spans.span("edge.late")
            late.__enter__()
        prof.__exit__(None, None, None)
        late.__exit__(None, None, None)
    assert not profiler.collecting()
    table = spans.totals()
    assert table["edge.inside"][0] == 1 and table["edge.late"][0] == 1
    assert "edge.before" not in table
    assert "edge.inside" in _ranges(prof)


def test_totals_add_up_under_the_knob(monkeypatch):
    monkeypatch.setenv("HPNN_SPANS", "1")
    obs._reset_for_tests()
    for _ in range(3):
        with spans.span("x.y"):
            pass
    spans.finish(spans.start("x.z"))
    table = spans.totals()
    assert table["x.y"][0] == 3 and table["x.z"][0] == 1
    table["x.y"] = (0, 0.0)   # a copy: the process's table is untouched
    assert spans.totals()["x.y"][0] == 3
    obs._reset_for_tests()
    assert spans.totals() == {}
