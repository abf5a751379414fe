"""The port's tail report (``hpnn_tpu_torch/tools/tail_report.py``)
against the repo's ``tools/tail_report.py`` on the same sinks: the
spans, the per-phase blame, the ``--baseline`` comparison and both
renderings agree, over one sink and over two processes' sinks joined by
a remote parent."""

import contextlib
import io
import json

import numpy as np
import pytest
from torch_drill_env import load_tool

from hpnn_tpu_torch.tools import tail_report


@pytest.fixture(scope="module")
def ref():
    return load_tool("tail_report")


def _write(path, recs):
    with open(path, "w") as fp:
        for r in recs:
            fp.write(json.dumps(r) + "\n")
        fp.write('{"ev": "span.end", "torn')   # a crashed writer's tail


def _sinks(tmp_path, seed, n=12):
    """An edge process (``cluster.request`` roots) and a worker process
    whose ``serve.request`` roots hang off them by ``remote_parent``,
    with queue, dispatch, spill and shed-retry children."""
    rng = np.random.RandomState(seed)
    edge = [{"ev": "obs.open", "pid": 4242, "rank": 0, "ts": 1.0}]
    work = [{"ev": "obs.open", "pid": 777, "rank": 1, "ts": 1.0}]
    sid = {"edge": 0, "work": 0}

    def nid(who):
        sid[who] += 1
        return sid[who]

    for i in range(n):
        t0 = float(i)
        dt = float(rng.uniform(0.01, 0.2))
        root = nid("edge")
        wroot = nid("work")
        parts = rng.dirichlet(np.ones(4)) * dt * 0.8
        t = t0 + 0.001
        for name, part in zip(("serve.batch.queue", "serve.dispatch",
                               "serve.spill_reload", "serve.retry_wait"), parts):
            rec = {"ev": "span.end", "span": nid("work"), "parent": wroot,
                   "name": name, "t0": t, "dt": float(part), "ts": 2.0 + t}
            if name == "serve.retry_wait" and i % 3 == 0:
                rec["failed"] = "Shed"
            work.append(rec)
            t += float(part)
        work.append({"ev": "span.end", "span": wroot, "parent": None,
                     "remote_parent": f"{4242:x}:{root}", "name": "serve.request",
                     "t0": t0, "dt": dt * 0.9, "ts": 2.0 + t0, "kernel": "k",
                     "req_id": f"q{i}", "sampled": True})
        edge.append({"ev": "span.end", "span": root, "parent": None,
                     "name": "cluster.request", "t0": t0, "dt": dt,
                     "ts": 2.0 + t0 + dt, "trace": f"t{i:04x}", "promoted": i == 5})
    pe, pw = tmp_path / f"edge{seed}.jsonl", tmp_path / f"work{seed}.jsonl"
    _write(pe, edge)
    _write(pw, work)
    return [str(pe), str(pw)]


@pytest.mark.parametrize("which", ["worker", "both"])
def test_analyze_equals_the_repo_tools(tmp_path, ref, which):
    paths = _sinks(tmp_path, 3)
    paths = paths[1:] if which == "worker" else paths
    spans = tail_report.load_spans(paths)
    assert spans == ref.load_spans(paths)
    for top in (3, 10):
        got = tail_report.analyze(spans, top=top)
        assert got == ref.analyze(ref.load_spans(paths), top=top)
        assert got["requests"] > 0
    for roots in (("serve.request",), ("cluster.request",)):
        assert (tail_report.analyze(spans, root_names=roots)
                == ref.analyze(spans, root_names=roots))


def test_baseline_and_renderings_equal_the_repo_tools(tmp_path, ref):
    run, base = _sinks(tmp_path, 3), _sinks(tmp_path, 9)
    for argv in ([*run, "--json"], [*run, "--top", "4"],
                 [*run, "--baseline", *base], [*run, "--baseline", *base, "--json"],
                 [run[1], "--root", "serve.request", "--json"]):
        outs = []
        for mod in (tail_report, ref):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(argv) == 0
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], argv
    rep = tail_report.analyze(tail_report.load_spans(run))
    brep = tail_report.analyze(tail_report.load_spans(base))
    assert tail_report.compare(rep, brep) == ref.compare(rep, brep)


def test_missing_sink_is_an_error(tmp_path, capsys):
    assert tail_report.main([str(tmp_path / "nope.jsonl")]) == 1
    assert "tail_report:" in capsys.readouterr().err


def test_no_roots_renders_the_hint(tmp_path, ref):
    p = tmp_path / "empty.jsonl"
    p.write_text(json.dumps({"ev": "obs.open", "pid": 1}) + "\n")
    rep = tail_report.analyze(tail_report.load_spans([str(p)]))
    assert rep["requests"] == 0
    assert tail_report.render(rep) == ref.render(rep)
    assert "no request roots" in tail_report.render(rep)
