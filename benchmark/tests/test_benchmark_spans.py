"""The per-layer metrics that read the program's span table
(``"source": "program_span"``): nothing without a trace or a table, and
the mean per round or per call from a table filled by hand."""

import json
import os

import pytest

from benchmark import harness

ROUND = {"train_nn.round": (4, 8.0), "io.conf_load": (4, 0.4), "io.kernel_dump": (8, 0.6),
         "train.samples": (4, 1.2), "train.round": (4, 5.0), "train.chunk": (4, 4.4),
         "train.tokens": (4, 0.2)}
FLEET = {"train.fleet_round": (5, 1.0), "fleet.stage": (5, 0.05), "fleet.gather": (10, 0.1),
         "fleet.plan": (5, 0.02), "fleet.epoch": (80, 0.2), "fleet.count": (80, 0.3),
         "fleet.sync": (5, 0.25), "fleet.result": (5, 0.04)}
# metric: (table, expected milliseconds)
WANT = {
    "round_kernel_text_ms": (ROUND, (0.4 + 0.6) / 4 * 1e3),
    "round_samples_ms": (ROUND, 1.2 / 4 * 1e3),
    "round_tokens_ms": (ROUND, 0.2 / 4 * 1e3),
    "round_launch_ms": (ROUND, (4.4 - 4.0) / 4 * 1e3),   # 4.0 s of #1 in the trace
    "fleet_stage_ms": (FLEET, (0.05 + 0.1) / 5 * 1e3),
    "fleet_plan_ms": (FLEET, 0.02 / 5 * 1e3),
    "fleet_launch_ms": (FLEET, 0.2 / 5 * 1e3),
    "fleet_count_ms": (FLEET, 0.3 / 5 * 1e3),
    "fleet_result_ms": (FLEET, 0.04 / 5 * 1e3),
}
SUMMARY = {"window_s": 9.0, "busy_s": 4.2, "calls": [],
           "kernels": {"convergence_cluster<float>": 3.0, "convergence_grid<float>": 1.0,
                       "cluster_train_fleet": 0.5}}


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "layer_metrics", name + ".py"),
                               "bench_metric_" + name)


def _run(trace):
    return {"setup_s": 1.0, "window_s": 9.0, "calls": [], "work": {}, "trace": trace}


@pytest.fixture
def table(monkeypatch):
    """Puts a table of the caller's in the program's place."""
    from hpnn_tpu_torch.obs import spans

    def put(t):
        monkeypatch.setattr(spans, "totals", lambda: dict(t))

    return put


def test_every_span_metric_is_declared():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    declared = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    assert set(declared) == set(WANT)
    for name, m in declared.items():
        cells = ["mnist_ann.round"] if name.startswith("round_") else [
            "rruff_ann.fleet8", "mnist_ann.fleet8"]
        assert m["workloads"] == cells and m["unit"] == "ms", name


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_without_a_trace(name, table):
    table(WANT[name][0])
    assert _reader(name).read(_run(None)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_mean_per_root_span(name, table):
    t, want = WANT[name]
    table(t)
    assert _reader(name).read(_run(SUMMARY)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_where_the_table_lacks_the_span(name, table):
    t, _ = WANT[name]
    table({k: v for k, v in t.items() if not k.startswith(("io.", "train.", "fleet."))})
    assert _reader(name).read(_run(SUMMARY)) is None
    table({})
    assert _reader(name).read(_run(SUMMARY)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_from_a_program_without_the_table(name, monkeypatch):
    """An older program (no ``spans.totals``) reads as nothing and
    raises nothing."""
    from hpnn_tpu_torch.obs import spans

    monkeypatch.delattr(spans, "totals")
    assert _reader(name).read(_run(SUMMARY)) is None
