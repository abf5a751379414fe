"""The port's byte-stability lint (``hpnn_tpu_torch/tools/check_tokens.py``,
the twin of the repo's ``tools/check_tokens.py``) on the CPU.

It passes; it bites, as ``tests/test_check_tokens.py`` holds the
original to (a JSON line leaked into the instrumented run's stdout, or a
sink event that never came, is a failure); and its plain round prints
exactly the JAX lint's bytes in float64 on the same six samples.
"""

import pytest
from torch_drill_env import _clean_process_state  # noqa: F401
from torch_drill_env import load_tool

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.tools import check_tokens


def _repo_lint():
    return load_tool("check_tokens")


def test_tokens_byte_stable_under_instrumentation(tmp_path):
    stats = {}
    failures = check_tokens.check(str(tmp_path), device="cpu", stats=stats)
    assert failures == []
    assert stats["token_lines"] >= 12 and stats["ledger_rows"] >= 1
    assert stats["sink_events"] > 0


def test_lint_catches_a_leaked_line(tmp_path, monkeypatch):
    real = check_tokens._run_round

    def leaky(tmpdir, metrics_path, probe=None, *, device="cuda"):
        out = real(tmpdir, metrics_path, probe=probe, device=device)
        if metrics_path is not None:
            out += '{"ev": "leak", "kind": "event"}\n'
        return out

    monkeypatch.setattr(check_tokens, "_run_round", leaky)
    failures = check_tokens.check(str(tmp_path), device="cpu")
    assert any("byte-identical" in f for f in failures)


def test_lint_catches_a_missing_sink_event(tmp_path, monkeypatch):
    """A sink event the round never emits (here: a counter the port
    silences) is named in the failures."""
    real = obs.gauge

    def no_chunk_gauge(name, *args, **kw):
        if name != "fuse.chunk_size":
            return real(name, *args, **kw)

    monkeypatch.setattr(obs, "gauge", no_chunk_gauge)
    failures = check_tokens.check(str(tmp_path), device="cpu")
    assert "metrics sink missing event 'fuse.chunk_size'" in failures


def test_plain_round_prints_the_jax_lints_bytes(tmp_path):
    """The same 6-sample 8-5-2 round through ``hpnn_tpu``'s f64 parity
    mode and the port's CPU path: stdout identical byte for byte."""
    jax_lint = _repo_lint()
    port = check_tokens._run_round(str(tmp_path / "port"), None, device="cpu")
    ref = jax_lint._run_round(str(tmp_path / "jax"), None)
    assert port == ref
    assert "N_ITER" in port and "[PASS]" in port


@pytest.mark.parametrize("line,ok,ok_cuda", [
    ("NN: TESTING FILE: s00000.txt\t [PASS]", True, True),
    ('{"ev": "round.start"}', False, False),
    ("round 3 done", False, False),
    ("NN: [GPU] ANN total allocation: 200 (bytes)", False, True),
])
def test_golden_shapes_match_the_repo_lints(line, ok, ok_cuda):
    """The repo lint's shapes, and on the card the reference's device
    allocation line besides."""
    jax_lint = _repo_lint()
    for device, want in (("cpu", ok), ("cuda", ok_cuda)):
        failures = []
        check_tokens._check_lines(line + "\n", failures, device)
        assert (failures == []) is want, device
    assert check_tokens.GOLDEN[0].pattern == jax_lint.GOLDEN[0].pattern
    assert [g.pattern for g in check_tokens.GOLDEN] == [g.pattern for g in jax_lint.GOLDEN]
    assert check_tokens.TOKEN_PREFIXES == jax_lint.TOKEN_PREFIXES


def test_main_exits_0_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(check_tokens, "check", lambda tmpdir, device: [])
    assert check_tokens.main(["--device", "cpu"]) == 0
    monkeypatch.setattr(check_tokens, "check", lambda tmpdir, device: ["boom"])
    assert check_tokens.main(["--device", "cpu"]) == 1
    assert "check_tokens: FAIL: boom" in capsys.readouterr().err
