"""BENCHMARK.json resolves to the benchmark's files, and nothing the
benchmark runs imports JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = os.path.join(harness.ROOT, "benchmark")


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        for name in ("setup", "warm", "call", "work", "release", "check"):
            assert callable(getattr(cell["driver"], name)), (w["name"], name)
        assert cell["end_to_end"] and cell["per_layer"], w["name"]
        for _, reader in cell["end_to_end"] + cell["per_layer"]:
            assert callable(reader.read)
        limits = harness.load_json("limits", w["name"] + ".json")
        assert limits and all(v >= 0 for v in limits.values())
        names = {m["name"] for m, _ in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2, w["name"]


def test_names_and_references():
    bench = _bench()
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in list(metrics) + list(cells) + [c["name"] for c in bench["configs"]]:
        assert NAME.match(name), name
    for m in bench["per_layer"]:
        assert m["moves"] in metrics and m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            mv = metrics[m["moves"]]
            assert w in mv.get("workloads", cells), (m["name"], w)
    for c in bench["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as fp:
            cfg = json.load(fp)
        assert set(c["reduced"]) <= set(cfg) and cfg["name"] == c["name"]


def _imports(path):
    with open(path) as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("banned", ["jax", "jaxlib", "flax", "hpnn_tpu"])
def test_no_jax_anywhere(banned):
    for path in _sources(BENCH):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert banned not in tops, (path, banned)


def test_reference_imports_nothing_of_the_program():
    for folder in ("reference", "frozen", "datasets"):
        for path in _sources(os.path.join(BENCH, folder)):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"hpnn_tpu_torch", "hpnn_tpu"}, path


def test_a_run_loads_no_jax(tiny):
    """A whole run (here a fleet cell on the CPU) in a fresh process
    leaves no JAX module loaded, by whole top-level names."""
    import subprocess
    import sys

    code = ("import json, sys; sys.path.insert(0, %r); from benchmark import harness; "
            "harness.run_cell('rruff_ann.fleet8', 2**31 + 5, 0.0, False, device='cpu', "
            "config=%r); print(json.dumps(harness.jax_modules()))"
            % (harness.ROOT, tiny["rruff_ann"]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
