"""The port's worker drill on the CPU: a ``WorkerSupervisor`` over two
``python -m hpnn_tpu_torch.cli.online_nn --device cpu`` worker processes
(each given ``PYTHONPATH`` = the checkout) sharing one WAL, a
``ClusterRouter`` as the HTTP edge, one worker SIGKILLed under load and
replaced (``hpnn_tpu_torch/tools/chaos_drill.py``'s twin of the repo
tool's ``worker`` drill).
"""

import json
import os

from torch_drill_env import DRILL_LIMIT_S, _clean_process_state  # noqa: F401
from torch_drill_env import limit, load_tool

from hpnn_tpu_torch.tools import chaos_drill


def test_drill_worker(tmp_path):
    with limit(DRILL_LIMIT_S, "worker"):
        res = chaos_drill.drill_worker(str(tmp_path), device="cpu")
    assert res["ok"], res
    assert res["workers"] == 2 and res["width_after"] == 2
    assert res["replaced_s"] is not None and res["replaced_s"] <= 30.0
    assert res["replacement_boot_s"] <= res["replaced_s"]
    assert res["recovery_s"] is not None and res["survivors_lost"] == 0
    assert res["survivor_bitwise"] is True
    # the workers ran the port's driver on the CPU
    logs = [p for p in os.listdir(tmp_path) if p.startswith("worker-r")]
    assert len(logs) == 3
    row = tmp_path / "drill-row.jsonl"
    row.write_text(json.dumps(res) + "\n")
    assert load_tool("check_obs_catalog").lint_chaos(str(row)) == []
