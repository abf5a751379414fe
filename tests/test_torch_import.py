"""The PyTorch port stands alone: importing it pulls in neither JAX nor
any module of the JAX package, and its sources import neither."""

import ctypes
import json
import os
import re
import subprocess
import sys

import pytest

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
    "hpnn_tpu_torch.train.fleet",
    "hpnn_tpu_torch.native",
    "hpnn_tpu_torch.obs",
    "hpnn_tpu_torch.obs.cost",
    "hpnn_tpu_torch.obs.device",
    "hpnn_tpu_torch.obs.export",
    "hpnn_tpu_torch.obs.flight",
    "hpnn_tpu_torch.obs.ledger",
    "hpnn_tpu_torch.obs.probes",
    "hpnn_tpu_torch.obs.profiler",
    "hpnn_tpu_torch.obs.registry",
    "hpnn_tpu_torch.obs.spans",
    "hpnn_tpu_torch.utils.debug",
    "hpnn_tpu_torch.utils.trace",
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


# C parameter type -> the ctypes type the binding must declare for it
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "double": ctypes.c_double}


def _c_params(source: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in ``source``:
    any pointer as ``void*``, else the type name."""
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", source, re.S)
    assert m, f"{fn} is not declared extern \"C\""
    out = []
    for param in m.group(1).split(","):
        words = " ".join(param.replace("*", " * ").split()).split(" ")[:-1]
        out.append("void*" if "*" in words else
                   " ".join(w for w in words if w != "const"))
    return out


@pytest.mark.parametrize("fn", ["hpnn_batch_train", "hpnn_fleet_train"])
def test_batch_step_argtypes_match_the_c_signature(fn):
    """A ctypes argtypes entry that disagrees with the C function passes
    garbage silently: hold each declared tuple to the source text."""
    from hpnn_tpu_torch.ops import batch_step

    with open(os.path.join(PKG, "csrc", "batch_step.cu")) as fp:
        params = _c_params(fp.read(), fn)
    declared = batch_step.ARGTYPES[fn]
    assert len(declared) == len(params)
    want = [ctypes.c_void_p if p == "void*" else _C_TYPES[p] for p in params]
    assert list(declared) == want


def test_convergence_argtypes_match_the_c_signature():
    from hpnn_tpu_torch.ops import convergence

    with open(os.path.join(PKG, "csrc", "convergence.cu")) as fp:
        params = _c_params(fp.read(), "hpnn_convergence_train_epoch")
    declared = convergence.ARGTYPES["hpnn_convergence_train_epoch"]
    assert len(declared) == len(params)
    want = [ctypes.c_void_p if p == "void*" else _C_TYPES[p] for p in params]
    assert list(declared) == want
