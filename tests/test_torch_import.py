"""The PyTorch port stands alone: importing it pulls in neither JAX nor
any module of the JAX package, and its sources import neither."""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hpnn_tpu_torch")

MODULES = (
    "hpnn_tpu_torch",
    "hpnn_tpu_torch.cli.train_nn",
    "hpnn_tpu_torch.cli.run_nn",
    "hpnn_tpu_torch.config",
    "hpnn_tpu_torch.runtime",
    "hpnn_tpu_torch.fileio.checkpoint",
    "hpnn_tpu_torch.fileio.samples",
    "hpnn_tpu_torch.ops.convergence",
    "hpnn_tpu_torch.ops.batch_step",
    "hpnn_tpu_torch.ops._build",
    "hpnn_tpu_torch.parallel.dp",
    "hpnn_tpu_torch.train.driver",
    "hpnn_tpu_torch.train.batch",
)

# an import statement naming jax or the JAX package (hpnn_tpu_torch is
# not hpnn_tpu: "\b" does not split "hpnn_tpu" from "_torch")
_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|hpnn_tpu)\b", re.M)


def test_import_pulls_in_no_jax():
    # a fresh interpreter: this test process already imported jax
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps([m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'hpnn_tpu')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax():
    offenders = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fp:
                    for m in _FORBIDDEN.finditer(fp.read()):
                        offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    with open(os.path.join(ROOT, "chip_smoke.py")) as fp:
        offenders += [f"chip_smoke.py: {m.group(0).strip()}"
                      for m in _FORBIDDEN.finditer(fp.read())]
    assert offenders == []


def test_forbidden_pattern_catches_jax_package_imports():
    """The scan above must see what it is meant to see."""
    assert _FORBIDDEN.search("from hpnn_tpu.models import ann\n")
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert _FORBIDDEN.search("    import hpnn_tpu\n")
    assert not _FORBIDDEN.search("from hpnn_tpu_torch.models import ann\n")
    assert not _FORBIDDEN.search("import hpnn_tpu_torch\n")
