"""Six of the port's chaos drills on the CPU: reload, sentinel, replica,
alert, capsule and tune (``hpnn_tpu_torch/tools/chaos_drill.py``, the
twins of the repo's ``tools/chaos_drill.py`` drills).

Each runs with ``device="cpu"`` under a 60 s limit of its own and
asserts its drill's own outcome keys.  The rows of reload, sentinel,
replica, alert and capsule pass the repo's ``check_obs_catalog.py``
chaos lint, as ``tests/test_resilience.py`` holds kill9's; the tune
drill's sink passes the repo's ``--tune`` lint, which the port's copy
(``chaos_drill.lint_tune``) reads alike.  The capsule drill's tail
report is held against the repo's ``tools/tail_report.py`` on the same
sink.
"""

import json

import pytest
from torch_drill_env import DRILL_LIMIT_S, _clean_process_state  # noqa: F401
from torch_drill_env import limit, load_tool

from hpnn_tpu_torch.tools import chaos_drill, tail_report


def _lint_row(tmp_path, row):
    path = tmp_path / "drill-row.jsonl"
    path.write_text(json.dumps(row, default=str) + "\n")
    return load_tool("check_obs_catalog").lint_chaos(str(path))


def _run(name, tmp_path, **kw):
    with limit(DRILL_LIMIT_S, name):
        return chaos_drill.DRILLS[name](str(tmp_path), device="cpu", **kw)


def test_drills_table_is_the_repo_tools():
    """All twelve drills, in the repo tool's order."""
    ref = load_tool("chaos_drill")
    assert list(chaos_drill.DRILLS) == list(ref.DRILLS)


def test_drill_reload(tmp_path):
    res = _run("reload", tmp_path)
    assert res["ok"], res
    assert res["reload_codes"] == [500, 200] and res["chaos_failed_first"]
    assert res["reloaded_bitwise"] is True
    assert res["weights_sha"]["got"] == res["weights_sha"]["expect"]
    assert res["lost"] == 0 and res["requests"] > 0
    assert _lint_row(tmp_path, res) == []


def test_drill_sentinel(tmp_path):
    res = _run("sentinel", tmp_path)
    assert res["ok"], res
    assert res["rejected"] >= 2 and res["promoted"] == 0
    assert res["version"]["after"] == res["version"]["before"]
    assert res["weights_sha"]["after"] == res["weights_sha"]["before"]
    assert res["lost"] == 0 and res["requests"] > 0
    assert _lint_row(tmp_path, res) == []


def test_drill_replica(tmp_path):
    res = _run("replica", tmp_path)
    assert res["ok"], res
    assert res["recovery_s"] is not None and res["survivors_lost"] == 0
    assert res["live_replicas"] == 2 and res["survivor_bitwise"] is True
    assert _lint_row(tmp_path, res) == []


def test_drill_alert(tmp_path):
    res = _run("alert", tmp_path)
    assert res["ok"], res
    assert res["fire_s"] is not None and res["fire_s"] <= 5.0
    assert res["resolve_s"] is not None and res["resolved"] is True
    assert res["flight_attached"] is True and res["fired_total"] >= 1
    assert _lint_row(tmp_path, res) == []


def test_drill_capsule(tmp_path):
    res = _run("capsule", tmp_path)
    assert res["ok"], res
    assert res["capture_s"] is not None and res["capture_s"] <= 10.0
    assert res["capsule_spans"] > 0 and res["profile_files"] > 0
    assert res["sampled_roots"] > 0 and res["dispatch_blame_pct"] > 50.0
    assert _lint_row(tmp_path, res) == []
    # the tail report over the drill's own sink is the repo tool's
    sink = str(tmp_path / "capsule-drill.metrics.jsonl")
    ref = load_tool("tail_report")
    got = tail_report.analyze(tail_report.load_spans([sink]), top=5)
    assert got == ref.analyze(ref.load_spans([sink]), top=5)
    assert got["blame_pct"] == res["blame_pct"]


def test_drill_tune(tmp_path):
    res = _run("tune", tmp_path)
    assert res["ok"], res
    assert res["applies"] == 1.0 and res["recovered"] == 4
    assert res["actions"] == {"queue": "scale_up", "dispatch": "precision_down",
                              "spill": "grow_buckets", "shed_retry": "quota_squeeze"}
    assert res["width_after"] == 3 and len(res["buckets_after"]) == 3
    assert res["squeezed_rate_rps"] == 20.0
    assert res["rollback_bitwise"] == 1.0 and res["version_chain_monotone"]
    assert res["rollback_pairs_ok"] and res["lint_failures"] == []
    sink = str(tmp_path / "tune-drill.metrics.jsonl")
    assert load_tool("check_obs_catalog").lint_tune(sink) == chaos_drill.lint_tune(sink) == []


@pytest.mark.parametrize("drill", ["reload", "sentinel"])
def test_child_drill_that_cannot_start_fails(tmp_path, monkeypatch, drill):
    """A child that never becomes ready is a failed drill with its
    reason, never a skip."""
    monkeypatch.setattr(chaos_drill, "CONF", "[name] drill\n[type] nonsense\n")
    res = _run(drill, tmp_path, ready_timeout_s=20.0)
    assert res["ok"] is False and "skipped" not in res
    assert res["error"] == "child never became ready"
