"""The port's obs core (``hpnn_tpu_torch/obs``, ``utils/trace.py``) on
the CPU in float64, held against the JAX package's.

* the checksum ledger: ``tools/ledger_diff.py`` exits 0 on the port's
  ledger against the JAX package's for a per-sample round (and its
  eval), a batch round and an 8-member fleet, and
  ``tools/check_obs_catalog.py --ledger`` passes on the port's;
* the ``#DBG`` trace: the same tags in the same order, values within
  1e-12 (weight matrices) and 1e-14 (eval output vectors);
* obs is silent: with every knob set, stdout is byte-identical to a run
  with none, and the metrics sink holds the span, cost and MFU records
  that ``check_obs_catalog.py --perf`` accepts;
* probes, the NaN sentinel, the export endpoint, ``--profile``, the
  CLIs' obs options and refusals, and the event catalog.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from hpnn_tpu import obs as jobs
from hpnn_tpu.cli import run_nn as jrun_nn
from hpnn_tpu.cli import train_nn as jtrain_nn
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.train import fleet as jfleet
from hpnn_tpu.utils import trace as jtrace
from hpnn_tpu_torch import obs, runtime
from hpnn_tpu_torch.cli import run_nn, train_nn
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.train import fleet
from hpnn_tpu_torch.utils import logging as log
from hpnn_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = ("[name] V\n[type] {kind}\n[init] generate\n[seed] 1234\n[input] 8\n"
        "[hidden] 6\n[output] 2\n[train] {train}\n[sample_dir] ../samples\n"
        "[test_dir] ../samples\n")
DBG = re.compile(r"#DBG: acc\[(.+)/(\d+)\]=(\S+)")
VEC_TOL, MAT_TOL = 1e-14, 1e-12


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """Both packages' obs knobs are memoized process state: clear every
    knob and forget both packages' memos around the test; drop what a
    test exported after it."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, "HPNN_FUSE_STATE",
                 "HPNN_FUSE_EPOCH", "HPNN_FUSE_CHUNK", "HPNN_PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    _reset_both()
    yield
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    _reset_both()
    log.set_verbose(0)


def _reset_both():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    jtrace._reset_enabled_cache()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ledger_diff(a, b):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ledger_diff.py"),
                          str(a), str(b)], capture_output=True, text=True, timeout=60)
    return out.returncode, out.stdout


def _write_samples(d, n=20, seed=42):
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


def _tokens(out):
    """stdout without its #DBG lines."""
    return [ln for ln in out.splitlines() if not ln.startswith("#DBG")]


def _dbg(out):
    """The #DBG lines as (tag, layer, value)."""
    return [(m.group(1), int(m.group(2)), float(m.group(3))) for m in DBG.finditer(out)]


def _assert_traces_agree(got, ref):
    assert got and [(t, l) for t, l, _ in got] == [(t, l) for t, l, _ in ref]
    for (tag, _, a), (_, _, b) in zip(got, ref):
        tol = VEC_TOL if tag.startswith("out@") else MAT_TOL
        assert abs(a - b) <= tol, (tag, a, b)


def _both(tmp_path, monkeypatch, capsys, argv_train, argv_run, env, kind="ANN",
          train="BP", jax_train=()):
    """train_nn (and run_nn on its kernel.opt) through each package in
    its own directory with ``env`` set (``jax_train``: options of the
    JAX ``train_nn`` only); returns {pkg: (stdout, dir)}."""
    _write_samples(str(tmp_path / "samples"))
    res = {}
    for pkg, tmain, rmain, extra in (
            ("jax", lambda a: jtrain_nn.main(list(jax_train) + a), jrun_nn.main, []),
            ("port", train_nn.main, run_nn.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        conf = CONF.format(kind=kind, train=train)
        (d / "nn.conf").write_text(conf)
        (d / "cont.conf").write_text(conf.replace("[init] generate", "[init] kernel.opt"))
        for k, v in env.items():
            monkeypatch.setenv(k, v.format(d=d))
        _reset_both()
        capsys.readouterr()
        assert tmain(extra + argv_train + ["-v", "-v", "nn.conf"]) == 0
        if argv_run is not None:
            assert rmain(extra + argv_run + ["-v", "-v", "cont.conf"]) == 0
        res[pkg] = (capsys.readouterr().out, d)
        _reset_both()
    return res


# ------------------------------------------------- ledger + trace vs JAX
@pytest.mark.parametrize("kind,train,streaming", [
    ("ANN", "BP", False), ("SNN", "BPM", False), ("ANN", "BPM", True)])
def test_per_sample_ledger_and_trace_match_jax(tmp_path, monkeypatch, capsys, kind,
                                               train, streaming):
    env = {"HPNN_LEDGER": "{d}/ledger.jsonl", "HPNN_TRACE": "1",
           "HPNN_FUSE_CHUNK": "6"}
    if streaming:
        env["HPNN_FUSE_EPOCH"] = "0"
    res = _both(tmp_path, monkeypatch, capsys, [], [], env, kind, train)
    (jout, jdir), (pout, pdir) = res["jax"], res["port"]
    assert _tokens(pout) == _tokens(jout)
    _assert_traces_agree(_dbg(pout), _dbg(jout))
    rc, report = _ledger_diff(jdir / "ledger.jsonl", pdir / "ledger.jsonl")
    assert rc == 0, report
    rows = [json.loads(ln) for ln in open(pdir / "ledger.jsonl")][1:]
    # a row a chunk (or one a streaming round), then the eval's
    assert [r["where"] for r in rows] == (
        ["round"] if streaming else ["fused_chunk"] * 4) + ["eval"]
    assert _tool("check_obs_catalog").lint_ledger(str(pdir / "ledger.jsonl")) == []


@pytest.mark.parametrize("kind", ["ANN", "SNN"])
def test_batch_ledger_and_trace_match_jax(tmp_path, monkeypatch, capsys, kind):
    env = {"HPNN_LEDGER": "{d}/ledger.jsonl", "HPNN_TRACE": "1"}
    # the JAX train_nn on one device (--mesh 1x1): the path the port follows
    res = _both(tmp_path, monkeypatch, capsys, ["--batch", "4", "--epochs", "3"],
                ["--batch"], env, kind, jax_train=["--mesh", "1x1"])
    (jout, jdir), (pout, pdir) = res["jax"], res["port"]
    _assert_traces_agree(_dbg(pout), _dbg(jout))
    tags = [t for t, l, _ in _dbg(pout) if l == 0]
    assert tags[0] == "w@3" and all(t.startswith("out@") for t in tags[1:])
    rc, report = _ledger_diff(jdir / "ledger.jsonl", pdir / "ledger.jsonl")
    assert rc == 0, report


@pytest.mark.parametrize("entry", ["train_fleet", "train_sequential", "train_fleet_multi"])
def test_fleet_ledger_matches_jax(tmp_path, monkeypatch, entry):
    """One ledger row per member, in member order, within the
    reference's bars of the JAX package's."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (16, 6))
    T = -np.ones((16, 3))
    T[np.arange(16), rng.integers(0, 3, 16)] = 1.0
    ks = [jkm.generate(100 + i, 6, [5], 3)[0] for i in range(8)]
    kw = dict(epochs=2, batch=4, lr=0.3)
    if entry == "train_fleet_multi":
        kw["rounds"] = 2
    paths = {}
    for pkg, mod, extra in (("jax", jfleet, {}), ("port", fleet, {"device": "cpu"})):
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("HPNN_LEDGER", str(paths[pkg]))
        _reset_both()
        getattr(mod, entry)(ks, X, T, **kw, **extra)
        _reset_both()
    rc, report = _ledger_diff(paths["jax"], paths["port"])
    assert rc == 0, report
    rows = [json.loads(ln) for ln in open(paths["port"])][1:]
    assert len(rows) == 8 and [r["row"] for r in rows] == list(range(8))


# ------------------------------------------------------------ obs silence
ALL_KNOBS = {"HPNN_METRICS": "{d}/m.jsonl", "HPNN_SPANS": "1", "HPNN_COST": "1",
             "HPNN_PROBES": "1", "HPNN_LEDGER": "{d}/l.jsonl",
             "HPNN_FLIGHT": "{d}/flight.jsonl"}


@pytest.mark.parametrize("argv_train,argv_run", [
    ([], []), (["--batch", "4", "--epochs", "2"], ["--batch"])])
def test_obs_is_silent_and_records(tmp_path, monkeypatch, capsys, argv_train, argv_run):
    _write_samples(str(tmp_path / "samples"))
    outs = {}
    for name, env in (("none", {}), ("all", ALL_KNOBS)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        conf = CONF.format(kind="ANN", train="BP")
        (d / "nn.conf").write_text(conf)
        (d / "cont.conf").write_text(conf.replace("[init] generate", "[init] kernel.opt"))
        for k, v in env.items():
            monkeypatch.setenv(k, v.format(d=d))
        _reset_both()
        capsys.readouterr()
        assert train_nn.main(["--device", "cpu"] + argv_train + ["-v", "-v", "nn.conf"]) == 0
        assert run_nn.main(["--device", "cpu"] + argv_run + ["-v", "-v", "cont.conf"]) == 0
        outs[name] = (capsys.readouterr().out, open(d / "kernel.opt").read())
        obs.flush()
    assert outs["all"] == outs["none"]
    recs = [json.loads(ln) for ln in open(tmp_path / "all" / "m.jsonl")]
    evs = {r["ev"] for r in recs}
    assert {"obs.open", "round.start", "round.end", "span.end", "compile.cost",
            "perf.mfu", "numerics.probe", "numerics.checksum", "eval.round"} <= evs
    exe = "batch.epoch" if argv_train else "driver.train_epoch"
    mfu = [r for r in recs if r["ev"] == "perf.mfu" and r["exe"] == exe]
    assert mfu and all(r["value"] > 0 for r in mfu)
    cat = _tool("check_obs_catalog")
    assert cat.lint_perf(str(tmp_path / "all" / "m.jsonl")) == []
    assert cat.lint_ledger(str(tmp_path / "all" / "l.jsonl")) == []


def test_cost_counts_are_chip_smokes():
    """The work counts behind perf.mfu are the ones behind chip_smoke's
    bound column: one count, the bound read from it."""
    w = [torch.zeros(300, 784), torch.zeros(10, 300)]
    nbytes, flops = obs.cost.work_of(w, 4, 800, False, 4)
    assert (nbytes, flops) == (2 * 238200 * 4 + 4 * (784 + 22) * 4 + 48,
                               2 * 238200 * 4 + 800 * (5 * 238200 + 2 * 3000))
    b_ms, by = obs.cost.bound_ms(nbytes, flops, "float32")
    assert by == "operations" and b_ms == pytest.approx(flops / 67e12 * 1e3)
    nb, fl = obs.cost.batch_work([(300, 784), (10, 300)], 235, False, 4, 256)
    assert fl == 235 * (6 * 256 * 238200 + 2 * 256 * 3000 + 2 * 238200)
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "from hpnn_tpu_torch.obs.cost import" in src
    assert "def work_of" not in src and "def batch_work" not in src


def test_record_dispatch_gauges(monkeypatch):
    monkeypatch.setenv("HPNN_COST", "1")
    monkeypatch.setenv("HPNN_PEAK_FLOPS", "1e9")
    _reset_both()
    seen = []
    monkeypatch.setattr(obs.cost.registry, "gauge",
                        lambda name, v, **f: seen.append((name, v, f["exe"])))
    obs.cost.record_dispatch("x.y", 0.5, nbytes=100, flops=1e9,
                             dtype=torch.float64, device=torch.device("cpu"))
    assert seen == [("perf.flops_per_s", 2e9, "x.y"), ("perf.mfu", 2.0, "x.y"),
                    ("perf.bytes_per_s", 200.0, "x.y")]
    assert obs.cost.catalog()["x.y"]["flops"] == 1e9


def test_unset_knobs_cost_nothing(monkeypatch):
    """Every knob unset: the memoized no-ops, no sink, no trace."""
    assert not obs.enabled() and not obs.probes.enabled() and not obs.cost.enabled()
    assert not obs.spans.enabled() and not trace.enabled()
    assert obs.timer("x.y") is obs.registry._NULL_CTX
    assert obs.probes.check_weights((torch.ones(2, 2),), step=0, where="t") is None
    table = obs.spans.totals()
    calls = []
    with monkeypatch.context() as m:
        m.setattr(os.environ, "get", lambda *a: calls.append(a))
        obs.count("x.y")
        obs.gauge("x.y", 1.0)
        # no profiler collects: the shared null span, whichever form
        with obs.spans.span("train.chunk") as sp:
            assert sp is obs.spans._NULL_SPAN
        sp = obs.spans.start("train.round")
        assert sp is obs.spans._NULL_SPAN
        obs.spans.finish(sp)
        trace.trace("w@1", [np.ones(2)])
        assert obs.probes.check_weights((torch.ones(1, 1),), step=1, where="t") is None
    assert calls == []  # each knob was read once and memoized
    assert obs.spans.totals() == table


# ------------------------------------------------------ probes + sentinel
def test_probes_stats_and_nan_sentinel(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_PROBES", "1")
    monkeypatch.setenv("HPNN_METRICS", str(tmp_path / "m.jsonl"))
    monkeypatch.setenv("HPNN_FLIGHT", str(tmp_path / "flight.jsonl"))
    _reset_both()
    w = (torch.tensor([[1.0, -2.0], [3.0, -4.0]], dtype=torch.float64),
         torch.tensor([[0.5, float("nan")]], dtype=torch.float32))
    mat = obs.probes._stats_matrix(w)
    assert mat.dtype == np.float64
    np.testing.assert_array_equal(mat[0], [10.0, 4.0, np.sqrt(30.0), -0.5, 0, 0])
    assert mat[1, 4] == 1 and mat[1, 5] == 0
    v = obs.probes.check_weights(w[:1], step=3, where="t")
    assert v["clean"] and v["step"] == 3 and v["mode"] == "warn"
    v = obs.probes.check_weights(w, step=4, where="t")  # warn: no raise
    assert not v["clean"] and v["nan"] == 1
    assert json.loads(open(tmp_path / "flight.jsonl").readline())["reason"] == "numerics.nan"
    obs.probes.configure_mode("abort")
    with pytest.raises(obs.probes.NumericsError, match="1 NaN"):
        obs.probes.check_weights(w, step=5, where="t")
    evs = [json.loads(ln)["ev"] for ln in open(tmp_path / "m.jsonl")]
    assert evs.count("numerics.probe") == 1 + 2 + 2 and "numerics.nan" in evs


def test_numerics_abort_fails_the_cli(tmp_path, monkeypatch, capsys):
    _write_samples(str(tmp_path / "samples"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.replace("../samples", "./samples").format(
        kind="ANN", train="BP"))
    real = obs.probes._stats_matrix

    def poisoned(ws):
        m = real(ws)
        m[0, 4] = 1.0  # one NaN in w0
        return m

    monkeypatch.setattr(obs.probes, "_stats_matrix", poisoned)
    assert train_nn.main(["--device", "cpu", "--numerics", "abort", "nn.conf"]) == -1
    assert "FAILED: numerics sentinel abort" in capsys.readouterr().err
    assert not (tmp_path / "kernel.opt").exists()


# ------------------------------------------------- trace, spans, export
def test_trace_line_format(monkeypatch, capsys):
    monkeypatch.setenv("HPNN_TRACE", "1")
    _reset_both()
    trace.trace("w@4", [torch.tensor([[1.5, -2.0]]), np.array([-0.25])])
    assert capsys.readouterr().out == (
        "#DBG: acc[w@4/0]=3.500000000000000\n#DBG: acc[w@4/1]=0.250000000000000\n")


def test_spans_nest_and_feed_aggregates(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_SPANS", "1")
    monkeypatch.setenv("HPNN_METRICS", str(tmp_path / "m.jsonl"))
    _reset_both()
    root = obs.spans.start("train.round", mode="fused")
    with obs.spans.span("train.chunk", parent=root, i=0):
        pass
    obs.spans.finish(root, samples=1)
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    ends = [r for r in recs if r["ev"] == "span.end"]
    assert [r["name"] for r in ends] == ["train.chunk", "train.round"]
    assert ends[0]["parent"] == ends[1]["span"]
    assert "span.train.round" in obs.snapshot_state()["aggregates"]
    assert _tool("check_obs_catalog").lint_perf(str(tmp_path / "m.jsonl")) == []


def test_export_server_serves_metrics_and_health(monkeypatch):
    server = obs.export.start_export_server(port=0)
    try:
        obs.count("train.samples", n=3)
        obs.export.set_health(last_round={"mode": "fused", "ok": True})
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert b"hpnn_train_samples_total 3" in body
        req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                     headers={"Accept": "application/openmetrics-text"})
        assert urllib.request.urlopen(req, timeout=10).read().endswith(b"# EOF\n")
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        assert health["metrics_active"] and health["last_round"]["ok"]
    finally:
        obs.export.stop_export_server(server)


def test_export_render_matches_jax():
    """The same snapshot renders to the same Prometheus text."""
    from hpnn_tpu.obs import export as jexport

    snap = {"uptime_s": 1.5, "counters": {"train.samples": 4},
            "gauges": {"perf.mfu": 0.25},
            "aggregates": {"driver.chunk_dispatch": {
                "n": 3, "total": 0.75, "mean": 0.25, "min": 0.125, "max": 0.5,
                "log2_buckets": {"-2": 1, "-1": 1, "0": 1}}}}
    assert obs.export.render_prometheus(snap) == jexport.render_prometheus(
        snap, local_meter=False)


# ------------------------------------------------------------- the CLIs
def test_cli_obs_options(tmp_path, monkeypatch, capsys):
    """--metrics/--ledger/--numerics/--export-port/--profile are taken,
    leave stdout alone and do what their knobs do."""
    _write_samples(str(tmp_path / "samples"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.replace("../samples", "./samples").format(
        kind="ANN", train="BP"))
    assert train_nn.main(["--device", "cpu", "-v", "-v", "nn.conf"]) == 0
    want = capsys.readouterr().out
    _reset_both()
    argv = ["--device", "cpu", "--metrics", "m.jsonl", "--ledger", "l.jsonl",
            "--numerics", "warn", "--export-port", "0", "--profile", "prof",
            "-v", "-v", "nn.conf"]
    assert train_nn.main(argv) == 0
    cap = capsys.readouterr()
    assert cap.out == want
    assert "metrics export on http://127.0.0.1:" in cap.err
    assert os.path.getsize("m.jsonl") > 0 and os.path.getsize("l.jsonl") > 0
    assert json.load(open("prof/trace.json"))["traceEvents"]
    assert os.environ["HPNN_METRICS"] == "m.jsonl"  # the flag wins over the env


@pytest.mark.parametrize("prog,argv,msg", [
    ("train_nn", ["--numerics", "loud"], "bad --numerics parameter (want warn|abort)"),
    ("run_nn", ["--export-port", "70000"], "bad --export-port parameter"),
    ("run_nn", ["--mesh", "2x1"], "bad --mesh: per-sample training shards the model axis"),
])
def test_cli_obs_option_errors(tmp_path, monkeypatch, capsys, prog, argv, msg):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
    main = train_nn.main if prog == "train_nn" else run_nn.main
    assert main(["--device", "cpu"] + argv + ["nn.conf"]) != 0
    assert msg in capsys.readouterr().err


def test_deferred_holds_only_the_unported_planes():
    """Only XLA's executable cache stays refused: the serving planes,
    ``--mesh`` and the router's tensor-parallel spill are ported."""
    assert sorted(runtime.DEFERRED_ENV) == ["HPNN_COMPILE_CACHE_DIR"]
    assert list(common.DEFERRED_OPTS) == []


# knob -> its value ({d}: the run's directory; {url}: an in-process
# collector) and the plane's health census that must say it is armed
PLANE_KNOBS = {
    "HPNN_COLLECTOR": ("{url}", None),
    "HPNN_ALERTS": ("lat@slo.p99_ms>10000:cooldown=0", "alerts"),
    "HPNN_CAPSULE_DIR": ("{d}/caps", "triggers"),
    "HPNN_METER": ("1", "meter"),
    "HPNN_BLAME": ("1", "blame"),
    "HPNN_DRIFT": ("1", "drift"),
    "HPNN_SAMPLE": ("1", "forensics"),
    "HPNN_TUNE": ("1", None),
}


@pytest.fixture(scope="module")
def _trained(tmp_path_factory):
    """A kernel trained once on one sample: the converted cases start
    ``train_nn`` from it, so each of their rounds converges at once."""
    d = tmp_path_factory.mktemp("trained")
    _write_samples(str(d / "samples"), n=1)
    run = d / "run"
    run.mkdir()
    cwd = os.getcwd()
    os.chdir(run)
    try:
        (run / "nn.conf").write_text(CONF.format(kind="ANN", train="BP"))
        with contextlib.redirect_stdout(io.StringIO()):
            assert train_nn.main(["--device", "cpu", "nn.conf"]) == 0
    finally:
        os.chdir(cwd)
        _reset_both()
        log.set_verbose(0)
    return d


@pytest.mark.parametrize("knob", ["HPNN_COLLECTOR", "HPNN_ALERTS", "HPNN_CAPSULE_DIR",
                                  "HPNN_METER", "HPNN_BLAME", "HPNN_DRIFT",
                                  "HPNN_SAMPLE", "HPNN_TUNE"])
def test_each_unported_knob_is_refused(tmp_path, monkeypatch, capsys, _trained, knob):
    """Each serving plane's knob was refused while its plane was not
    ported; now it arms the plane, and ``train_nn``/``run_nn`` stdout
    and ``kernel.opt`` stay byte-identical to a run without it."""
    shutil.copytree(_trained / "samples", tmp_path / "samples")
    server = obs.collector.start_collector(host="127.0.0.1", port=0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    outs = {}
    try:
        for name in ("off", "on"):
            d = tmp_path / name
            d.mkdir()
            monkeypatch.chdir(d)
            shutil.copy(_trained / "run" / "kernel.opt", d / "start.opt")
            conf = CONF.format(kind="ANN", train="BP").replace(
                "[init] generate", "[init] start.opt")
            (d / "nn.conf").write_text(conf)
            (d / "cont.conf").write_text(conf.replace("start.opt", "kernel.opt"))
            if name == "on":
                monkeypatch.setenv(knob, PLANE_KNOBS[knob][0].format(d=d, url=url))
            _reset_both()
            capsys.readouterr()
            assert train_nn.main(["--device", "cpu", "-v", "-v", "nn.conf"]) == 0
            assert run_nn.main(["--device", "cpu", "-v", "-v", "cont.conf"]) == 0
            cap = capsys.readouterr()
            assert "selects" not in cap.err
            outs[name] = (cap.out, open(d / "kernel.opt").read())
            if name == "on":
                # the registry runs (file-less) for the plane, which is armed
                assert obs.registry._active() is not None
                plane = PLANE_KNOBS[knob][1]
                if plane:
                    assert getattr(obs, plane).health_doc()["armed"]
                from hpnn_tpu_torch import config, tune
                from hpnn_tpu_torch.train import driver

                if knob == "HPNN_TUNE":
                    assert tune.enabled()
                driver.train_kernel(config.load_conf("nn.conf"), device="cpu")
    finally:
        obs.collector.stop_collector(server)
    assert outs["on"] == outs["off"]
    assert "N_ITER" in outs["on"][0] and "[PASS]" in outs["on"][0]


# ------------------------------------------------------------ the catalog
def test_port_event_names_are_in_the_documented_catalog(monkeypatch):
    """Every literal event name the port emits is in the docs catalog
    the JAX package's names are held to."""
    cat = _tool("check_obs_catalog")
    monkeypatch.setattr(cat, "SRC_DIR", "hpnn_tpu_torch")
    emitted = cat.emitted_names(ROOT)
    documented = cat.documented_names(ROOT)
    assert {"round.start", "numerics.checksum", "perf.mfu", "fleet.round",
            "resume.restore", "batch.cap_halved"} <= set(emitted)
    missing = sorted(n for n in emitted if not cat._covered(n, documented))
    assert missing == []
