"""The port under the repo's static lint.

``tools/hpnnlint`` holds ``hpnn_tpu/`` and ``tools/`` to no finding
(``tests/test_hpnnlint.py``); this holds ``hpnn_tpu_torch/`` to the
same rules, pragmas with a reason included.
"""

import os
import subprocess
import sys

from tools.hpnnlint import engine

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_is_lint_clean():
    findings, n_files = engine.run(REPO_ROOT, ["hpnn_tpu_torch"])
    assert n_files > 50
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_port_lint_cli_exits_0():
    """``python -m tools.hpnnlint hpnn_tpu_torch``, as a reader runs it."""
    proc = subprocess.run([sys.executable, "-m", "tools.hpnnlint", "hpnn_tpu_torch"],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout + proc.stderr
