"""The port's load generator and chaos drills, on the CPU.

``hpnn_tpu_torch/tools/loadgen.py`` and ``chaos_drill.py`` are the twins
of the repo's ``tools/loadgen.py`` and ``tools/chaos_drill.py`` over
``hpnn_tpu_torch``.  Here: the load generator's outcome classes and its
SIGPIPE shield and stop event (as ``tests/test_resilience.py`` holds the
original's), its summaries against the original's on the same records,
and the five drills end to end with ``device="cpu"``: kill9 against a
real ``python -m hpnn_tpu_torch.cli.online_nn --device cpu`` child,
torn, quota, hog and drift in process.  Each drill asserts its own
outcome keys, runs under a 60 s limit of its own, and the report copies
(``lint_conn``, ``blame_table``) are held against the repo's tools on
the drill's own sink.  The other seven drills are in
``tests/test_torch_drills_serve.py`` and ``test_torch_drills_fleet.py``.
"""

import contextlib
import json
import signal
import socket
import threading
import time

import numpy as np
import pytest
from torch_drill_env import DRILL_LIMIT_S, _clean_process_state  # noqa: F401
from torch_drill_env import limit, load_tool

from hpnn_tpu_torch import serve
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.serve.server import make_server
from hpnn_tpu_torch.tools import chaos_drill, loadgen


def _free_port():
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _server(ready=True):
    sess = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=1.0, device="cpu")
    sess.register_kernel("default", km.generate(7, 8, [5], 2)[0])
    if not ready:
        sess.mark_unready("warming")
    server = make_server(sess, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        sess.close()


# ------------------------------------------------------------- loadgen
def test_loadgen_shields_sigpipe_left_by_cli_mains():
    """The CLIs install SIGPIPE=SIG_DFL; the load generator re-arms
    Python's default (ignore), itself on every run, so a torn write is
    a ``lost`` record and never the generator's death."""
    prev = signal.getsignal(signal.SIGPIPE)
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
        loadgen.shield_sigpipe()
        assert signal.getsignal(signal.SIGPIPE) is signal.SIG_IGN
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
        loadgen.run_open_loop(f"http://127.0.0.1:{_free_port()}", rate_rps=20.0,
                              duration_s=0.1, n_workers=2, max_retries=0, timeout_s=0.5)
        assert signal.getsignal(signal.SIGPIPE) is signal.SIG_IGN
    finally:
        signal.signal(signal.SIGPIPE, prev)


@pytest.mark.parametrize("target", ["nobody_listens", "unready_session"])
def test_loadgen_outcome_classes(target):
    """Nothing listening: every request is ``lost`` (the blast-radius
    class).  A warming session: every arrival answered 503, retried,
    then recorded ``shed``; nothing lost, nothing served."""
    kw = dict(rate_rps=40.0, duration_s=0.25, n_workers=4)
    if target == "nobody_listens":
        s = loadgen.run_open_loop(f"http://127.0.0.1:{_free_port()}", max_retries=0,
                                  timeout_s=0.5, **kw)
        assert s["lost"] == s["requests"] > 0
        assert s["ok"] == s["shed"] == s["error"] == 0
        assert s["lost_rate"] == 1.0
    else:
        with _server(ready=False) as url:
            s = loadgen.run_open_loop(url, max_retries=1, retry_cap_s=0.01, timeout_s=2.0,
                                      **kw)
        assert s["shed"] == s["requests"] > 0
        assert s["lost"] == s["ok"] == 0


def test_loadgen_stop_event_ends_the_run_early():
    stop = threading.Event()
    seen = []

    def on_record(rec):
        seen.append(rec)
        if len(seen) >= 3:
            stop.set()

    with _server() as url:
        t0 = time.perf_counter()
        s = loadgen.run_open_loop(url, rate_rps=50.0, duration_s=30.0, n_workers=4,
                                  stop=stop, on_record=on_record)
        wall = time.perf_counter() - t0
    assert wall < 10.0 and s["duration_s"] < 10.0
    assert len(seen) >= 3 and s["requests"] == len(seen)
    assert all(r["status"] == "ok" for r in seen)


def test_loadgen_summaries_match_the_repo_tool():
    """The same arrivals, Zipf draws and summary as ``tools/loadgen.py``
    on the same seeds and records."""
    ref = load_tool("loadgen")
    for process in ("poisson", "burst"):
        a = loadgen.make_arrivals(process, 30.0, 5.0, np.random.RandomState(8))
        b = ref.make_arrivals(process, 30.0, 5.0, np.random.RandomState(8))
        assert a == b
    assert np.array_equal(loadgen.zipf_cdf(9, 1.2), ref.zipf_cdf(9, 1.2))
    rng = np.random.RandomState(3)
    recs = [{"t": float(i) / 10, "kernel": "k", "rows": 1, "status": st,
             "latency_ms": float(rng.uniform(1, 9)), "tenant": f"t{i % 3}"}
            for i, st in enumerate(["ok", "shed", "lost", "ok", "timeout", "error", "ok"] * 3)]
    assert loadgen.summarize(recs, 2.1, offered_rps=10.0) == ref.summarize(
        recs, 2.1, offered_rps=10.0)
    assert loadgen.HOSTILE_MODES == ref.HOSTILE_MODES


def test_loadgen_bench_fold_ins_on_the_cpu():
    """``run_bench_load`` (saturation, then 2x it open-loop against an
    SLO-armed shedding server) and ``run_bench_tenant`` (Zipf tenants
    over a paging cap, the hot tenant quota-shed) on the port's
    ``serve`` and ``tenant``."""
    load = loadgen.run_bench_load(saturation_s=0.5, load_s=0.8, device="cpu")
    assert load["device"] == "cpu" and load["saturation_rps"] > 0
    assert load["offered_rps"] >= 2 * load["saturation_rps"] - 1
    assert load["load"]["lost"] == 0 and load["goodput_rps"] > 0
    ten = loadgen.run_bench_tenant(n_kernels=300, resident=32, traffic_s=0.8, device="cpu")
    assert ten["device"] == "cpu" and ten["errors"] == 0 and ten["ok"] > 0
    assert ten["resident_cap_ok"] and ten["resident"] <= 32 and ten["page_ins"] > 0
    assert ten["quota_shed"] > 0 and set(ten["shed_by_tenant"]) == {ten["hot_tenant"]}


# --------------------------------------------------------------- drills
def test_drill_kill9_end_to_end(tmp_path):
    """A real ``online_nn --device cpu`` child under live traffic is
    SIGKILLed after a WAL-committed promotion and restarted on the same
    port and WAL dir: the resident weights come back bitwise the last
    committed checkpoint's and goodput recovers."""
    with limit(DRILL_LIMIT_S, "kill9"):
        res = chaos_drill.drill_kill9(str(tmp_path), rate=30.0, device="cpu")
    assert res["ok"], res
    assert res["restored_bitwise"] is True
    assert res["wal_version"] >= 1
    assert res["recovery_s"] is not None and res["recovery_s"] >= 0.0
    assert res["lost"] >= 0 and res["requests"] > res["lost"]
    lint = load_tool("check_obs_catalog")
    row_path = tmp_path / "drill.jsonl"
    row_path.write_text(json.dumps(res) + "\n")
    assert lint.lint_chaos(str(row_path)) == []


def test_drill_kill9_that_cannot_start_fails(tmp_path, monkeypatch):
    """A child that never becomes ready is a failed drill with its
    reason, never a skip."""
    monkeypatch.setattr(chaos_drill, "CONF", "[name] drill\n[type] nonsense\n")
    with limit(DRILL_LIMIT_S, "kill9"):
        res = chaos_drill.drill_kill9(str(tmp_path), ready_timeout_s=20.0, device="cpu")
    assert res["ok"] is False and "skipped" not in res
    assert res["error"] == "child never became ready"


def test_drill_torn(tmp_path):
    with limit(DRILL_LIMIT_S, "torn"):
        res = chaos_drill.drill_torn(str(tmp_path), rate=40.0, device="cpu")
    assert res["ok"], res
    assert res["goodput_dip_pct"] <= 10.0 and res["clean_lost"] == 0
    assert res["hung"] == 0 and res["hostile_accounted"] >= 9
    assert res["hostile"]["slowloris"]["outcomes"].get("killed") == 3
    assert res["guard_kills"].get("slowloris", 0) >= 3
    assert res["fired"] and res["capsule_conn"] and res["lint_failures"] == []
    # the port's copy of the lint reads the sink as the repo's does
    sink = str(tmp_path / "torn-drill.metrics.jsonl")
    assert load_tool("check_obs_catalog").lint_conn(sink) == chaos_drill.lint_conn(sink) == []


def test_drill_quota(tmp_path):
    with limit(DRILL_LIMIT_S, "quota"):
        res = chaos_drill.drill_quota(str(tmp_path), rate=40.0, device="cpu")
    assert res["ok"], res
    assert res["victim_goodput_ratio"] >= 0.75 and res["victim_shed"] == 0
    assert res["offender_shed"] > 0 and res["offender_shed_reasons"].keys() == {"quota"}
    assert res["victim_quota_sheds_in_sink"] == 0 and res["alert_fired"]


def test_drill_hog(tmp_path):
    with limit(DRILL_LIMIT_S, "hog"):
        res = chaos_drill.drill_hog(str(tmp_path), rate=40.0, device="cpu")
    assert res["ok"], res
    assert res["detect_s"] <= 1.0 and res["ranked_top"] == "hog"
    assert res["blame_pct"] >= 50.0 and res["hog_shed"] > 0
    assert res["alert_fired"] and res["capsule_meter_axes"]
    # the blame table over the port's meter is tools/tenant_report.py's
    sink = str(tmp_path / "hog-drill.metrics.jsonl")
    rep = load_tool("tenant_report")
    ref = rep.analyze(rep.load_meter_docs([sink]), top=3)
    assert ref["tenants"][0]["tenant"] == "hog"
    assert abs(ref["tenants"][0]["share_pct"] - res["blame_pct"]) <= 0.01


def test_drill_drift(tmp_path):
    with limit(DRILL_LIMIT_S, "drift"):
        res = chaos_drill.drill_drift(str(tmp_path), rate=20.0, device="cpu")
    assert res["ok"], res
    assert res["rounds_to_detect"] is not None and res["lost"] == 0
    assert res["capsule_reason"].startswith("alert:drift")
    assert res["sketches"] == {"reference": True, "live": True}
    assert "eval:mnist" in res["drift_events"]
